"""Pre-refactor monolithic serving engine, in PyTorch — kept as the
measured baseline that the scheduler/executor engine must beat (the
reference's gate: unified >= 1.5x legacy decode tokens/s).

Counterpart of ``repro/serving/legacy.py``.  Its characteristic costs
are kept on purpose (do not "fix" them here — they ARE the baseline):
an un-batched prefill per admitted prompt (one forward per request), a
full per-layer ``PagedKVCache.gather`` of every running sequence's cache
every decode step, and per-sequence KV appends (``kv.append``, one
scatter per layer) driven from the host after every step.  The prefill
page writes go through the batched ``write_prompt``, and a preempted
request carries its ``out_tokens`` through re-prefill, as in the
reference.

Kernels.  The reference calls its attention oracles by name (``sdpa_ref``
in prefill, ``decode_attention(..., backend="ref")`` in decode).  The
port instead calls the kernel wrappers: prefill through
``kernels.ops.flash_attention`` and decode through
``kernels.ops.decode_attention``, so on a CUDA tensor the flash and
decode kernels launch (18 flash launches per prefill and 18 decode
launches per step for gemma-2b) and no plain attention runs on the card;
on the CPU the wrappers take their plain versions, the same math as the
reference's oracles.

A fault of the reference, fixed here.  The reference appends the fresh
token's K/V after the gathered cache, at index ``max_len`` (the longest
sequence's length) of every row, but attends ``lens + 1`` keys: a row
shorter than the longest one sees a stale pool slot at its own length
instead of its fresh key, and decodes wrong tokens whenever the running
lengths differ.  The port writes each row's fresh K/V at that row's own
length, so every row sees exactly its history plus its fresh token.
With equal lengths the two agree token for token.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Sequence, Tuple

import torch

from .. import resolve_device
from ..kernels import ops as kops
from ..models import layers as L
from ..models import lm as LM
from .kv_cache import PagedKVCache
from .scheduler import Request

__all__ = ["LegacyServingEngine"]


class LegacyServingEngine:
    """Batched greedy serving with host-interleaved control and compute
    (the pre-scheduler/executor design), on CUDA by default
    (``device=None``); ``device="cpu"`` runs the plain PyTorch versions
    of the kernels.  Greedy only, as the reference (whose ``greedy``
    argument selects nothing)."""

    def __init__(self, cfg: LM.LMConfig, params, *, page_size: int = 16,
                 num_pages: int = 512, max_batch: int = 8, device=None):
        for spec in cfg.layer_specs():
            if spec.mixer != "attn" or spec.ffn == "moe":
                raise ValueError(
                    "paged engine serves full-attention models with dense "
                    "FFNs; use the dense-cache step builders for "
                    "hybrid/ssm archs")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = LM.params_to(params, self.device)
        self.max_batch = max_batch
        self.kv = PagedKVCache(
            n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.hd, page_size=page_size, num_pages=num_pages,
            dtype=torch.float32 if cfg.param_dtype == torch.float32
            else torch.bfloat16, device=self.device)
        self.waiting: List[Request] = []
        self.running: Dict[int, Request] = {}
        self._next_id = 0
        self.metrics = {"steps": 0, "prefills": 0, "decoded_tokens": 0,
                        "rejected_admissions": 0}

    # -- public API ---------------------------------------------------------
    def submit(self, prompt: Sequence[int],
               max_new_tokens: int = 16) -> int:
        req = Request(self._next_id, list(prompt), max_new_tokens,
                      submitted_at=time.perf_counter())
        self._next_id += 1
        self.waiting.append(req)
        return req.req_id

    def run(self, max_steps: int = 10_000) -> List[Request]:
        finished: List[Request] = []
        for _ in range(max_steps):
            if not self.waiting and not self.running:
                break
            self._admit()
            finished.extend(self.step())
            self.metrics["steps"] += 1
        return finished

    # -- scheduling -----------------------------------------------------------
    def _admit(self) -> None:
        while self.waiting and len(self.running) < self.max_batch:
            req = self.waiting[0]
            hist = req.history      # prompt + any pre-preemption tokens
            if not self.kv.can_admit(len(hist) + 1):
                self.metrics["rejected_admissions"] += 1
                break
            self.waiting.pop(0)
            if not self.kv.create(req.req_id, hist):
                self.waiting.insert(0, req)
                break
            self._prefill(req)
            self.running[req.req_id] = req

    def step(self) -> List[Request]:
        """One continuous-batching decode step for all running seqs."""
        if not self.running:
            return []
        seq_ids = sorted(self.running)
        last_tokens = []
        for s in seq_ids:
            r = self.running[s]
            last_tokens.append(r.out_tokens[-1] if r.out_tokens
                               else r.prompt[-1])
        next_tokens, layer_kv = self._decode_batch(seq_ids, last_tokens)

        finished = []
        for i, s in enumerate(seq_ids):
            r = self.running[s]
            ok = self.kv.append(s, [(k[i], v[i]) for k, v in layer_kv])
            if not ok:
                # out of pages mid-flight: preempt (requeue) this request
                self.kv.free_seq(s)
                del self.running[s]
                self.waiting.insert(0, r)
                continue
            r.out_tokens.append(int(next_tokens[i]))
            if r.first_token_at is None:
                r.first_token_at = time.perf_counter()
            self.metrics["decoded_tokens"] += 1
            if r.done:
                r.finished_at = time.perf_counter()
                self.kv.free_seq(s)
                del self.running[s]
                finished.append(r)
        return finished

    # -- compute -------------------------------------------------------------
    def _qkv(self, lp, x: torch.Tensor, positions: torch.Tensor):
        """norm1 -> (B, H, S, hd) q and (B, Hkv, S, hd) k, v with RoPE at
        ``positions`` ((S,) or (B, S))."""
        cfg = self.cfg
        h = LM._norm(cfg, x, lp["norm1"], lp.get("norm1_b"))
        b, s, _ = h.shape
        q = (h @ lp["attn"]["wq"]).reshape(
            b, s, cfg.n_heads, cfg.hd).transpose(1, 2)
        k = (h @ lp["attn"]["wk"]).reshape(
            b, s, cfg.n_kv_heads, cfg.hd).transpose(1, 2)
        v = (h @ lp["attn"]["wv"]).reshape(
            b, s, cfg.n_kv_heads, cfg.hd).transpose(1, 2)
        if cfg.rope_theta is not None:
            q = L.apply_rope(q, positions, cfg.rope_theta)
            k = L.apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _finish_layer(self, lp, x: torch.Tensor,
                      o: torch.Tensor) -> torch.Tensor:
        """Attention output projection, then the MLP."""
        cfg = self.cfg
        b, _, s, _ = o.shape
        x = x + o.transpose(1, 2).reshape(b, s, -1) @ lp["attn"]["wo"]
        if "mlp" in lp:
            h2 = LM._norm(cfg, x, lp["norm2"], lp.get("norm2_b"))
            x = x + L.mlp(lp["mlp"], h2, cfg.act)
        return x

    def _prefill(self, req: Request) -> None:
        """Run the whole history through the model (one request at a
        time — the baseline cost), write K/V past the reused prefix in
        one batched scatter per layer, and emit the first token only for
        a FRESH request (a resumed one already holds its tokens)."""
        hist = req.history
        tokens = torch.tensor([hist], dtype=torch.long, device=self.device)
        kvs, logits = self._prefill_fn(tokens)
        # resumed requests keep their last generated token OUT of the
        # cache: the next decode step feeds it (writing it here too would
        # double-append its K/V and derail the continuation)
        n_write = len(hist) - (1 if req.out_tokens else 0)
        layer_kv = [(k[0].transpose(0, 1)[:n_write],
                     v[0].transpose(0, 1)[:n_write]) for k, v in kvs]
        self.kv.write_prompt(req.req_id, layer_kv, n_write)
        self.kv.lengths[req.req_id] = min(self.kv.lengths[req.req_id],
                                          n_write)
        self.metrics["prefills"] += 1
        if not req.out_tokens:
            req.out_tokens.append(int(torch.argmax(logits[0, -1])))
            req.first_token_at = time.perf_counter()

    @torch.no_grad()
    def _prefill_fn(self, tokens: torch.Tensor
                    ) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]],
                               torch.Tensor]:
        """(1, S) tokens -> per-layer (k, v) (1, Hkv, S, hd) and the
        (1, S, V) logits; attention through the flash kernel."""
        cfg = self.cfg
        x = LM._embed(cfg, self.params, tokens)
        pos = torch.arange(tokens.shape[1], device=self.device)
        kvs = []
        for lp in self.params["layers"]:
            q, k, v = self._qkv(lp, x, pos)
            kvs.append((k, v))
            o = kops.flash_attention(q, k, v, causal=cfg.causal,
                                     scale=cfg.query_scale
                                     or cfg.hd ** -0.5)
            x = self._finish_layer(lp, x, o)
        return kvs, LM._head(cfg, self.params, x)

    @torch.no_grad()
    def _token_compute(self, tokens: torch.Tensor, pos: torch.Tensor,
                       gathered) -> Tuple[torch.Tensor, List]:
        """One decode step given the pre-gathered per-layer K/V; attention
        through the decode kernel over each row's cache plus its fresh
        token, written at the row's own length."""
        cfg = self.cfg
        x = LM._embed(cfg, self.params, tokens[:, None])
        b = tokens.shape[0]
        rows = torch.arange(b, device=self.device)
        new_kv = []
        for lp, (k_cache, v_cache, lens) in zip(self.params["layers"],
                                                gathered):
            q, k, v = self._qkv(lp, x, pos[:, None])
            hkv, n, hd = k_cache.shape[1:]
            k_full = torch.zeros((b, hkv, n + 1, hd), dtype=k_cache.dtype,
                                 device=self.device)
            v_full = torch.zeros_like(k_full)
            k_full[:, :, :n] = k_cache
            v_full[:, :, :n] = v_cache
            k_full[rows, :, lens.long()] = k[:, :, 0].to(k_cache.dtype)
            v_full[rows, :, lens.long()] = v[:, :, 0].to(v_cache.dtype)
            o = kops.decode_attention(q, k_full, v_full, lens + 1,
                                      scale=cfg.query_scale
                                      or cfg.hd ** -0.5)
            x = self._finish_layer(lp, x, o)
            new_kv.append((k[:, :, 0], v[:, :, 0]))
        logits = LM._head(cfg, self.params, x)
        return torch.argmax(logits[:, -1], dim=-1), new_kv

    def _decode_batch(self, seq_ids, last_tokens):
        gathered = [self.kv.gather(seq_ids, li)
                    for li in range(self.cfg.n_layers)]
        pos = torch.tensor([self.kv.lengths[s] for s in seq_ids],
                           dtype=torch.long, device=self.device)
        tokens = torch.tensor(last_tokens, dtype=torch.long,
                              device=self.device)
        next_tokens, new_kv = self._token_compute(tokens, pos, gathered)
        return next_tokens.cpu().numpy(), new_kv

    def stats(self) -> Dict[str, Any]:
        return {**self.metrics, **self.kv.memory_stats()}
