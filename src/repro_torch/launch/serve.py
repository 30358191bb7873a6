"""Serving entry point for the scheduler/executor engine.

    PYTHONPATH=src python -m repro_torch.launch.serve [--preset tiny|small]
        [--requests 32] [--max-new 8] [--chunk 16] [--json PATH]
        [--timeout-ms T] [--ttft-deadline-ms T] [--max-queue-depth N]
        [--faults SPEC] [--fault-seed S] [--dp D] [--tp T]
        [--device cuda|cpu]

Counterpart of ``repro/launch/serve.py``, with the same flags plus
``--device``: the engine runs on CUDA unless ``--device cpu`` is given
(without a GPU and without it, it raises; there is no fallback to the
CPU).  ``--dp D --tp T`` with D*T > 1 serves on a (data, model) mesh of
D*T ranks: the reference's command is one process over D*T devices;
here the command starts its D*T ranks itself (``torch.multiprocessing``,
start method ``spawn``, ``launch.mesh.run_ranks``: NCCL with a card a
rank when there are enough, else gloo with the ranks sharing the card),
every rank builds the same engine and serves the same workload, and
rank 0's report is printed.

Builds a synthetic mixed-length workload (long prompts interleaved with
short ones), serves it through the paged continuous-batching engine, and
prints the metrics that make a throughput regression attributable:
decode tokens/s, mean TTFT, prefill chunks, preemptions, step buckets
vs the bucket budget, and the page high-water mark — plus the
fault-tolerance ledger (cancellations, timeouts, failed requests,
watchdog trips).

Failure handling is per-request, not per-process: a rejected submit
(typed ``AdmissionRejected``) is reported and skipped, a timed-out or
quarantined request is listed with its error, and Ctrl-C drains the
engine and prints partial outputs instead of dying mid-decode.  Fault
injection (``--faults "nan_logits@6;pool_exhaustion@4:pages=16"``, or
env ``REPRO_FAULTS``) exercises those paths deterministically.

The presets' weights are random, made from seed 0.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import torch

from ..models.lm import LMConfig, init_params
from ..serving.engine import ServingEngine
from ..serving.errors import ServingError
from ..serving.faults import FaultInjector

PRESETS = {
    "tiny": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                 d_ff=128, vocab_size=97),
    "small": dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
                  d_ff=512, vocab_size=1024),
}


def synthetic_workload(n_requests: int, vocab: int):
    prompts = []
    for i in range(n_requests):
        n = 48 if i % 4 == 0 else 8          # 1 long : 3 short
        prompts.append([(7 + 13 * i + j) % (vocab - 1) + 1
                        for j in range(n)])
    return prompts


def preset_config(preset: str, name: str) -> LMConfig:
    """The preset's fp32 config (``attn_backend`` selects nothing in the
    port: every attention call goes through the kernel wrappers)."""
    return LMConfig(name=f"{name}-{preset}", **PRESETS[preset],
                    param_dtype=torch.float32, remat="none",
                    attn_backend="ref")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default="tiny")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--num-pages", type=int, default=256)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--kv-dtype", choices=["fp32", "int8", "fp8_e4m3"],
                    default=None,
                    help="KV page-pool storage; int8/fp8_e4m3 store "
                         "quantized codes + per-token scales and "
                         "dequantize in the attention kernel")
    ap.add_argument("--timeout-ms", type=float, default=None,
                    help="per-request total deadline")
    ap.add_argument("--ttft-deadline-ms", type=float, default=None,
                    help="per-request first-token deadline")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="bounded admission (AdmissionRejected beyond)")
    ap.add_argument("--faults", default=None,
                    help='fault spec, e.g. "nan_logits@6;'
                         'executor_crash@9" (see serving.faults)')
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--dp", type=int, default=1,
                    help="data replicas (slot space becomes dp*max_batch;"
                         " dp*tp ranks are started for dp*tp > 1)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree over the model axis")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    ap.add_argument("--json", default=None,
                    help="also dump metrics JSON to this path")
    return ap


def _serve_rank(rank: int, world: int, argv) -> dict:
    """One rank of ``--dp``/``--tp``: the engine on the serving mesh."""
    from .mesh import mesh_for_serving
    args = parser().parse_args(argv)
    return serve(args, mesh_for_serving(world, tp=args.tp),
                 quiet=rank != 0)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser().parse_args(argv)
    if args.dp < 1 or args.tp < 1:
        raise ValueError(f"--dp {args.dp} --tp {args.tp}: both must be "
                         f">= 1")
    if args.dp * args.tp > 1:
        from .mesh import run_ranks
        report = run_ranks(_serve_rank, args.dp * args.tp,
                           (list(argv) if argv is not None else None,),
                           timeout=3600)[0]
    else:
        report = serve(args)
    for k, v in report.items():
        print(f"{k:>22}: {v}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"[json] {args.json}")
    return report


def serve(args, mesh=None, quiet: bool = False) -> dict:
    """Serve the synthetic workload on one engine (on ``mesh`` when
    given); returns the report.  ``quiet`` keeps a rank other than 0
    from printing the per-request lines."""
    say = (lambda *a: None) if quiet else print
    cfg = preset_config(args.preset, "serve")
    params = init_params(cfg, seed=0, device="cpu")
    faults = FaultInjector.parse(args.faults, seed=args.fault_seed) \
        if args.faults else None
    eng = ServingEngine(cfg, params, page_size=args.page_size,
                        num_pages=args.num_pages,
                        max_batch=args.max_batch,
                        chunk_size=args.chunk,
                        max_queue_depth=args.max_queue_depth,
                        kv_dtype=args.kv_dtype,
                        faults=faults, device=args.device, mesh=mesh)

    prompts = synthetic_workload(args.requests, cfg.vocab_size)
    t0 = time.perf_counter()
    rejected = 0
    for i, p in enumerate(prompts):
        try:
            eng.submit(p, max_new_tokens=args.max_new,
                       ttft_deadline_ms=args.ttft_deadline_ms,
                       timeout_ms=args.timeout_ms)
        except ServingError as e:
            # typed per-request rejection — report it, keep serving
            rejected += 1
            say(f"[rejected] request {i}: "
                  f"{type(e).__name__}: {e}")
    interrupted = False
    try:
        done = eng.run()
    except KeyboardInterrupt:
        # drain: cancel everything, keep the partial outputs
        interrupted = True
        done = []
        partial = eng.drain()
        say(f"\n[interrupt] drained {len(partial)} in-flight "
            f"request(s); partial outputs:")
        for r in partial:
            say(f"  req {r.req_id}: {len(r.out_tokens)} token(s) "
                f"{r.out_tokens}")
    wall = time.perf_counter() - t0

    for r in eng.aborted:
        if r.state.value != "cancelled":
            say(f"[{r.state.value}] request {r.req_id}: {r.error} "
                f"({len(r.out_tokens)} partial token(s))")

    m = eng.stats()
    ttfts = [r.first_token_at - r.submitted_at for r in done]
    report = {
        "device": str(eng.device),
        "served": len(done),
        "rejected_submits": rejected,
        "aborted": len(eng.aborted),
        "interrupted": interrupted,
        "wall_s": round(wall, 3),
        "decode_tokens_per_s": round(m["decoded_tokens"] / wall, 1),
        "ttft_mean_s": round(sum(ttfts) / max(len(ttfts), 1), 4),
        "bucket_compiles": m["bucket_compiles"],
        "bucket_budget": eng.bucket_count,
        "n_replicas": m["n_replicas"],
        "tp": args.tp,
        "lse_merges": m["lse_merges"],
        **{k: m[k] for k in ("steps", "prefills", "prefill_chunks",
                             "preemptions", "zero_decode_steps",
                             "decoded_tokens", "page_hwm",
                             "page_hwm_per_replica", "kv_bytes",
                             "kv_bytes_per_seq", "kv_dtype",
                             "table_upload_rows", "prefix_hit_rate",
                             "cancellations", "timeouts",
                             "ttft_deadline_misses",
                             "failed_requests", "watchdog_trips",
                             "aged_admissions", "executor_failures",
                             "steps_exhausted")},
    }
    return report


if __name__ == "__main__":
    main()
