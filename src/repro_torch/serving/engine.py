"""Continuous-batching serving engine — thin facade over the
Scheduler/Executor split, in PyTorch.

Counterpart of ``repro/serving/engine.py``, with the same public API
(``submit``/``cancel``/``result``/``drain``/``step``/``run``) and the
same ``metrics``/``stats`` key names.  Control flow (admission, chunked
prefill, preemption, COW, page tables, speculative commit) is the
reference's host Python (``scheduler.Scheduler``, copied); the data flow
is one eager PyTorch step per plan (``executor.Executor``) with the CUDA
paged-attention and Triton Gumbel kernels.  Fault tolerance (quarantine,
the invariant watchdog, the fault injector) wraps the loop as in the
reference.

Sharded serving: a (data, model) ``mesh`` (``launch.mesh``) replicates
the slot space over ``data`` (S slots -> R*S; ``num_pages`` and
``token_budget`` stay PER replica) and tensor-parallels the layers over
``model``; ``n_replicas`` alone (no mesh) runs the same replicated plan
on one device.  Every rank of a mesh builds the same engine, receives the
same submits and runs the same host scheduler over all R*S slots (the
control plane is mesh-oblivious); the executor runs each rank's part and
all-gathers the sampled tokens, so every rank commits the same step.
The async front door (``frontend.AsyncFrontend``) and the legacy
baseline (``legacy.LegacyServingEngine``) sit beside it.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .. import resolve_device
from ..models import lm as LM
from .errors import DeadlineExceeded, RequestFailed
from .executor import Executor
from .faults import FaultInjector
from .kv_cache import PagedKVCache
from .sampling import SamplingParams
from .scheduler import Request, RequestState, Scheduler
from .spec import NgramProposer, Proposer
from .watchdog import Watchdog

__all__ = ["ServingEngine", "Request", "RequestState"]


class ServingEngine:
    """Batched serving for attention LMs over the paged KV pool, on CUDA
    by default (``device=None``); ``device="cpu"`` runs the plain
    PyTorch versions of the kernels.  Without a GPU and without
    ``device="cpu"`` the constructor raises."""

    def __init__(self, cfg: LM.LMConfig, params, *, page_size: int = 16,
                 num_pages: int = 512, max_batch: int = 8,
                 greedy: bool = True,
                 sampling: Optional[SamplingParams] = None,
                 spec_k: int = 0,
                 proposer: Optional[Proposer] = None,
                 chunk_size: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 max_pages_per_seq: Optional[int] = None,
                 max_queue_depth: Optional[int] = None,
                 admit_hwm_frac: float = 1.0,
                 aging_steps: int = 32,
                 watchdog_interval: int = 8,
                 stall_steps: int = 64,
                 max_idle_steps: int = 64,
                 exec_failure_limit: int = 3,
                 faults: Optional[FaultInjector] = None,
                 mesh=None, n_replicas: int = 1,
                 kv_dtype: Optional[str] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 device=None):
        for spec in cfg.pattern:
            if spec.mixer not in ("attn",):
                raise ValueError(
                    "paged engine serves full-attention models; hybrid/ssm "
                    "archs are not ported yet")
            if spec.ffn == "moe":
                # the reference's executor applies "mlp" FFNs only and
                # skips an MoE layer's FFN without a word
                # (repro/serving/executor.py:333); the port refuses
                raise NotImplementedError(
                    "paged engine applies dense FFNs only; MoE serving is "
                    "not ported (ROADMAP.md queue C)")
        if cfg.qkv_bias or cfg.qk_norm:
            # the reference's executor projects q/k/v with neither the
            # bias nor the qk-norm (repro/serving/executor.py:284-292)
            # and so serves another function than decode_step; the port
            # refuses
            raise NotImplementedError(
                "paged engine applies neither qkv bias nor qk-norm; serve "
                "this config through the dense-cache step builders "
                "(ROADMAP.md queue C)")
        # a (data, model) mesh replicates the slot space over `data`
        # (`num_pages` and `token_budget` stay PER replica) and
        # tensor-parallels the layers over `model`; `n_replicas` alone
        # runs the same replicated plan on one device
        if mesh is not None:
            from ..launch.mesh import axis_sizes
            n_replicas = axis_sizes(mesh).get("data", 1)
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params if mesh is not None else \
            LM.params_to(params, self.device)
        self.max_batch = max_batch
        self.mesh = mesh
        self.n_replicas = n_replicas
        # the sampling contract: an explicit ``sampling`` wins;
        # otherwise ``greedy`` picks argmax (temperature 0) or plain
        # temperature-1.0 sampling
        if sampling is None:
            sampling = SamplingParams() if greedy \
                else SamplingParams(temperature=1.0)
        self.sampling = sampling.validate()
        self.greedy = self.sampling.greedy
        if spec_k > 0 and proposer is None:
            proposer = NgramProposer()
        self.spec_k = spec_k
        self.proposer = proposer
        # kv_dtype: None keeps the param-dtype pool (fp32/bf16);
        # "int8"/"fp8_e4m3" store quantized codes + per-(token, head)
        # fp32 scales
        self.kv = PagedKVCache(
            n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.hd, page_size=page_size,
            num_pages=num_pages * n_replicas, n_replicas=n_replicas,
            dtype=torch.float32 if cfg.param_dtype == torch.float32
            else torch.bfloat16, kv_dtype=kv_dtype, device=self.device,
            mesh=mesh)
        self.scheduler = Scheduler(
            self.kv, max_batch=max_batch, chunk_size=chunk_size,
            token_budget=token_budget,
            max_pages_per_seq=max_pages_per_seq,
            max_queue_depth=max_queue_depth,
            admit_hwm_frac=admit_hwm_frac, aging_steps=aging_steps,
            sampling=self.sampling, spec_k=spec_k, proposer=proposer,
            n_replicas=n_replicas, clock=clock)
        # size the device table mirror at the pages bucket cap up front:
        # the delta path then never pays a width-growth rebuild
        self.kv.mirror_width_hint = self.scheduler.p_buckets()[-1]
        self.executor = Executor(cfg, self.params, device=self.device,
                                 kv_quant=self.kv.quant_mode, mesh=mesh,
                                 n_replicas=n_replicas)
        if mesh is not None:
            self.params = self.executor.params     # this rank's shards
        self.watchdog = Watchdog(interval=watchdog_interval,
                                 stall_steps=stall_steps)
        # fault injection: ctor arg, else env (None = zero overhead)
        self.faults = faults if faults is not None \
            else FaultInjector.from_env()
        self.max_idle_steps = max_idle_steps
        self.exec_failure_limit = exec_failure_limit
        self._step_no = 0
        self._exec_fail_streak = 0
        self._counters = {"watchdog_trips": 0, "executor_failures": 0,
                          "steps_exhausted": 0}

    # -- public API ---------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               *, sampling: Optional[SamplingParams] = None,
               ttft_deadline_ms: Optional[float] = None,
               timeout_ms: Optional[float] = None,
               priority: int = 0, tenant: str = "default") -> int:
        """Queue a request; returns its request id.  Admission happens
        lazily at the next step, when pages are available.  Raises
        :class:`~.errors.AdmissionRejected` (over-cap prompt, queue at
        ``max_queue_depth``, or page-watermark backpressure) — the
        typed signal for a front door to shed load.  ``sampling``
        overrides the engine-wide :class:`SamplingParams` for this
        request only (per-request params are step operands).
        ``ttft_deadline_ms`` / ``timeout_ms`` arm per-request deadlines
        checked every step; the TTFT deadline is also an admission
        *ordering* key (earliest-deadline-first within a priority
        tier).  ``priority`` (higher admits first) and ``tenant``
        (fair-share accounting bucket) feed the SLO-aware admission
        rank — all-default submissions keep plain FIFO."""
        return self.scheduler.submit(
            prompt, max_new_tokens, sampling=sampling,
            ttft_deadline_ms=ttft_deadline_ms, timeout_ms=timeout_ms,
            priority=priority, tenant=tenant)

    def cancel(self, req_id: int) -> bool:
        """Cancel a request at any point in its lifecycle — queued,
        mid-prefill, or mid-decode.  Its pages are released refcount-
        safely (COW/prefix sharers keep theirs).  Returns False for an
        unknown or already-terminal id."""
        return self.scheduler.cancel(req_id)

    def result(self, req_id: int) -> Optional[Request]:
        """Terminal-state accessor: the finished/cancelled ``Request``
        (with any partial ``out_tokens``), ``None`` while still in
        flight, or a typed raise — :class:`~.errors.DeadlineExceeded`
        for TIMED_OUT, :class:`~.errors.RequestFailed` for FAILED."""
        req = self.scheduler.done.get(req_id)
        if req is None:
            return None
        if req.state is RequestState.TIMED_OUT:
            raise DeadlineExceeded(f"request {req_id}: {req.error}")
        if req.state is RequestState.FAILED:
            raise RequestFailed(f"request {req_id}: {req.error}",
                                req_id=req_id)
        return req

    def drain(self) -> List[Request]:
        """Cancel every queued and running request (pages freed),
        returning them with whatever partial ``out_tokens`` they had —
        the CLI's Ctrl-C path."""
        reqs = list(self.scheduler.running.values()) \
            + list(self.scheduler.waiting)
        for req in reqs:
            self.scheduler.cancel(req.req_id)
        return reqs

    # -- the fault-tolerant step loop ---------------------------------------
    def _quarantine(self, req_id: int, reason: str) -> None:
        """FAIL one request and repair shared state around it: pages
        reclaimed + scrubbed via pool reconciliation, device block
        tables force-rebuilt.  The step loop never stops."""
        self.scheduler.fail(req_id, reason)
        self._counters["watchdog_trips"] += 1
        self.kv.recover()

    def _run_watchdog(self) -> None:
        violations = self.watchdog.check(self.scheduler, self.kv)
        if not violations:
            return
        for v in violations:
            self._counters["watchdog_trips"] += 1
            if v.seq_id is not None:
                self.scheduler.fail(v.seq_id, f"watchdog[{v.kind}]: "
                                    f"{v.detail}")
        self.kv.recover()

    def _step(self) -> Optional[List[Request]]:
        """One unified continuous-batching step (admission + plan +
        execute + commit), with the executor boundary treated as a
        fault line.  None = nothing runnable."""
        self._step_no += 1
        if self.faults is not None:
            self.faults.before_plan(self._step_no, self.scheduler,
                                    self.kv)
        plan = self.scheduler.plan()
        if plan is None:
            return None
        try:
            if self.faults is not None:
                self.faults.before_execute(self._step_no, plan,
                                           self.scheduler, self.kv)
            next_tokens, bad = self.executor.execute(plan, self.kv)
        except RequestFailed as e:
            # attributed executor fault: fail the culprit, keep serving
            self._counters["executor_failures"] += 1
            if e.req_id is not None and \
                    self.scheduler._lookup(e.req_id) is not None:
                self._quarantine(e.req_id, f"executor fault: {e}")
            else:
                self._unattributed_failure(plan, e)
            return []
        except Exception as e:          # noqa: BLE001 — fault line
            self._counters["executor_failures"] += 1
            self._unattributed_failure(plan, e)
            return []
        self._exec_fail_streak = 0
        if bad.any():
            # finite-logits barrier: quarantine flagged slots BEFORE
            # commit so a poisoned token never enters a history
            for s in plan.spans:
                if s.sample and s.req.slot >= 0 and bad[s.req.slot]:
                    self._quarantine(s.req.req_id,
                                     "non-finite logits (executor "
                                     "fault barrier)")
        done = self.scheduler.commit(plan, next_tokens)
        if self.watchdog.due(self._step_no):
            self._run_watchdog()
        return done

    def _unattributed_failure(self, plan, exc: Exception) -> None:
        """Executor exception with no culprit id: retry the step (the
        plan rebuilds from unchanged cursors); after
        ``exec_failure_limit`` consecutive failures quarantine the
        whole planned batch — bounded blast radius, never a wedge."""
        self._exec_fail_streak += 1
        if self._exec_fail_streak < self.exec_failure_limit:
            return
        for rid in sorted({s.req.req_id for s in plan.spans}):
            if self.scheduler._lookup(rid) is not None:
                self._quarantine(
                    rid, f"executor failed x{self._exec_fail_streak}: "
                         f"{exc!r}")
        self._exec_fail_streak = 0

    def step(self) -> List[Request]:
        """Run one continuous-batching step; returns the requests that
        finished this step (empty when nothing is runnable)."""
        return self._step() or []

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Step until every submitted request reaches a terminal state
        (or ``max_steps`` elapse); returns FINISHED requests in
        completion order.  Cancelled/timed-out/failed requests are in
        :attr:`aborted` (and via :meth:`result`).  Hitting the step cap
        retires everything still live as TIMED_OUT and bumps
        ``metrics["steps_exhausted"]`` — never a silent partial return.
        An idle engine (every waiting request blocked on pages) spins at
        most ``max_idle_steps`` before giving up."""
        finished: List[Request] = []
        idle = 0
        for _ in range(max_steps):
            if not self.scheduler.waiting and not self.scheduler.running:
                return finished
            done = self._step()
            if done is None:
                # nothing runnable: spin briefly (deadlines may expire,
                # fault holds may release), then bail rather than hang
                idle += 1
                if idle > self.max_idle_steps:
                    return finished
            else:
                idle = 0
                finished.extend(done)
        if self.scheduler.waiting or self.scheduler.running:
            self._counters["steps_exhausted"] += 1
            self.scheduler.timeout_all(
                f"engine step cap max_steps={max_steps} exhausted")
        return finished

    # -- introspection ------------------------------------------------------
    @property
    def waiting(self) -> List[Request]:
        return self.scheduler.waiting

    @property
    def running(self) -> Dict[int, Request]:
        return self.scheduler.running

    @property
    def aborted(self) -> List[Request]:
        """Requests retired CANCELLED / TIMED_OUT / FAILED (each holds
        its partial ``out_tokens`` and an ``error`` string)."""
        return self.scheduler.aborted

    @property
    def metrics(self) -> Dict[str, Any]:
        """Counter snapshot.  Scheduler counters: ``steps``,
        ``prefills``, ``prefill_chunks``, ``decoded_tokens``,
        ``preemptions``, ``zero_decode_steps``, ``cancellations``,
        ``timeouts``, ``failed_requests``, ``aged_admissions``,
        ``rejected_admissions``, ``rejected_submits``,
        ``ttft_deadline_misses`` (requests whose first-token SLO
        lapsed — the front door's gate signal); speculative
        decoding: ``spec_steps``, ``proposed_tokens``,
        ``accepted_tokens`` and the derived ``spec_acceptance_rate``
        (accepted / proposed — the first-class signal for how much
        speculative work paid off); fault tolerance:
        ``watchdog_trips``, ``executor_failures``, ``steps_exhausted``;
        executor/KV: ``bucket_compiles`` (distinct (T, P) step
        buckets executed — must stay ≤ :attr:`bucket_count`), ``page_hwm``
        (live-page high-water mark), ``page_hwm_per_replica`` (same,
        per data replica), ``kv_bytes`` (this rank's resident page-pool
        bytes — codes plus scale overhead for a quantized pool),
        ``kv_dtype`` (the pool storage: "float32"/"bfloat16"/"int8"/
        "fp8_e4m3"), ``kv_bytes_per_seq`` (resident bytes of one
        max-length sequence: page bytes × ``max_pages_per_seq`` — the
        capacity-planning number that shows the quantization win),
        ``n_replicas``, ``lse_merges`` and ``collectives`` (the
        executor's context-parallel merges and model-axis collectives;
        0 without a mesh), ``table_upload_rows`` (host→device
        block-table rows flushed by the delta mirror), and
        ``table_full_rebuilds``."""
        m = dict(self.scheduler.metrics)
        m.update(self._counters)
        m["bucket_compiles"] = self.executor.compile_count
        m["page_hwm"] = self.kv.pool.stats.page_hwm
        m["page_hwm_per_replica"] = list(self.kv.pool.page_hwm_per_replica)
        ms = self.kv.memory_stats()
        m["kv_bytes"] = ms["kv_bytes"]
        m["kv_dtype"] = ms["kv_dtype"]
        m["kv_bytes_per_seq"] = (ms["page_bytes"]
                                 * self.scheduler.max_pages_per_seq)
        m["n_replicas"] = self.n_replicas
        m.update(self.executor.stats)
        m["table_upload_rows"] = self.kv.upload_rows_total
        m["table_full_rebuilds"] = self.kv.upload_full_rebuilds
        m["spec_acceptance_rate"] = (
            m["accepted_tokens"] / m["proposed_tokens"]
            if m["proposed_tokens"] else 0.0)
        return m

    @property
    def bucket_count(self) -> int:
        return self.scheduler.bucket_count

    def stats(self) -> Dict[str, Any]:
        """:attr:`metrics` merged with the page-pool memory stats
        (pages used/free, prefix hit rate, COW copies, ...)."""
        return {**self.metrics, **self.kv.memory_stats()}
