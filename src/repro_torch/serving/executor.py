"""Serving data plane: the unified continuous-batching step in eager
PyTorch.

Counterpart of ``repro/serving/executor.py``.  The executor consumes a
``StepPlan`` (host-built by the Scheduler) and runs the step on the
device:

  * a padded FLAT token batch (T,) mixing prefill-chunk tokens and
    decode tokens;
  * per layer: norm, Q/K/V, RoPE, then ONE scatter of the batch's K/V
    into the page pool, quantized on the way for an int8/fp8 pool.  The
    reference scatters with ``mode="drop"`` so padding and reused-prefix
    rows (``write_idx`` = the OOB slot ``num_pages*page_size``,
    ``scheduler.py:626``) vanish; torch has no drop mode, so the
    in-bounds rows are selected on the host from the plan, before the
    upload, and only those are written (no device-side masking, hence no
    device-to-host sync);
  * attention reads the pages in place through the device block-table
    mirror with the CUDA paged-attention kernel;
  * sampling (greedy / temperature / top-k / top-p, plus the K
    speculative verify rows per slot) runs on the device with the Gumbel
    kernel, so the (rows, vocab) logits never reach the host.  The only
    device-to-host copies per step are the (S, K+1) tokens and the (S,)
    fault flags.

The page tensors are single-owner and updated in place (``take_kv`` /
``put_kv``), which replaces the reference's buffer donation.

``compile_count`` counts the distinct (T, P) shape buckets executed, as
the reference's fallback does; capturing one CUDA graph per bucket is
later work.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..models import layers as L
from ..models.attention import paged_attention, select_paged_backend
from ..models import lm as LM
from . import quant, sampling
from .kv_cache import PagedKVCache
from .scheduler import StepPlan


class Executor:
    """Runs the step; stateless between calls except the bucket
    bookkeeping."""

    def __init__(self, cfg: LM.LMConfig, params, *, device,
                 kv_quant=None):
        self.cfg = cfg
        self.device = device
        self._kv_quant = quant.canonical(kv_quant)
        self.params = params
        self._layer_params = params["layers"]
        select_paged_backend(cfg.attn_backend, sharded=False)
        self._compiled: set = set()

    @property
    def compile_count(self) -> int:
        return len(self._compiled)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- host entry -------------------------------------------------------
    def execute(self, plan: StepPlan, kv: PagedKVCache
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Run one unified step; returns ((max_batch, K+1) sampled tokens
        and a (max_batch,) bool non-finite-logits flag array)."""
        if plan.tokens.ndim != 1:
            raise NotImplementedError("replicated plans are not ported yet")
        tables = kv.device_tables(plan.slot_seqs, plan.p_bucket)
        n_flat = kv.pool.num_pages * kv.page_size
        widx = np.asarray(plan.write_idx)
        rows = np.nonzero((widx >= 0) & (widx < n_flat))[0]
        ks, vs = kv.take_kv()
        kss, vss = kv.take_scales()
        try:
            with torch.no_grad():
                toks, bad = self._unified_step(
                    plan.p_bucket, ks, vs, kss, vss,
                    self._put(plan.tokens.astype(np.int64)),
                    self._put(plan.seg_ids.astype(np.int32)),
                    self._put(plan.positions.astype(np.int32)),
                    self._put(rows.astype(np.int64)),
                    self._put(widx[rows].astype(np.int64)),
                    tables, self._put(plan.sample_idx.astype(np.int64)),
                    self._put(plan.sample_pos.astype(np.int64)),
                    self._put(plan.temps.astype(np.float32)),
                    self._put(plan.top_ks.astype(np.int64)),
                    self._put(plan.top_ps.astype(np.float32)),
                    self._put(plan.seeds.astype(np.int64)))
                next_tokens = toks.cpu().numpy()
                bad = bad.cpu().numpy()
        finally:
            kv.put_kv(ks, vs)
            kv.put_scales(kss, vss)
        self._compiled.add((plan.t_bucket, plan.p_bucket))
        return next_tokens, bad

    # -- the device step ----------------------------------------------------
    def _unified_step(self, p_bucket: int, k_pages: List[torch.Tensor],
                      v_pages: List[torch.Tensor],
                      k_scales: List[torch.Tensor],
                      v_scales: List[torch.Tensor], tokens: torch.Tensor,
                      seg_ids: torch.Tensor, positions: torch.Tensor,
                      write_rows: torch.Tensor, write_slots: torch.Tensor,
                      tables: torch.Tensor, sample_idx: torch.Tensor,
                      sample_pos: torch.Tensor, temps: torch.Tensor,
                      top_ks: torch.Tensor, top_ps: torch.Tensor,
                      seeds: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        x = self._body(k_pages, v_pages, k_scales, v_scales, tokens,
                       seg_ids, positions, write_rows, write_slots,
                       tables[:, :p_bucket].contiguous())
        s, kp1 = sample_idx.shape
        xs = x[sample_idx.reshape(-1)]                         # (S*(K+1), D)
        logits = xs @ (self.params["embed"].T if cfg.tie_embeddings
                       else self.params["lm_head"])
        bad = (~torch.isfinite(logits).all(dim=-1)).reshape(s, kp1).any(-1)
        gen_pos = sample_pos[:, None] + torch.arange(
            kp1, device=sample_pos.device)[None, :]
        # the sampling tail is profiled as one range, read by chip_smoke.py
        with torch.profiler.record_function("sampling"):
            toks = sampling.sample_tokens(
                logits, temps.repeat_interleave(kp1),
                top_ks.repeat_interleave(kp1),
                top_ps.repeat_interleave(kp1),
                seeds.repeat_interleave(kp1), gen_pos.reshape(-1))
        return toks.reshape(s, kp1), bad

    def _body(self, k_pages: List[torch.Tensor],
              v_pages: List[torch.Tensor], k_scales: List[torch.Tensor],
              v_scales: List[torch.Tensor], tokens: torch.Tensor,
              seg_ids: torch.Tensor, positions: torch.Tensor,
              write_rows: torch.Tensor, write_slots: torch.Tensor,
              tables: torch.Tensor) -> torch.Tensor:
        """embed -> layers (KV scatter + paged attention in place) ->
        final norm.  Returns the (T, D) normed hidden states; the page
        (and scale) tensors are updated in place.  ``write_rows`` are the
        token-batch rows whose K/V is written, ``write_slots`` their flat
        (page*page_size + offset) destinations."""
        cfg = self.cfg
        t = tokens.shape[0]
        n_pages, ps = k_pages[0].shape[0], k_pages[0].shape[1]
        hkv, hd = cfg.n_kv_heads, cfg.hd
        scale = cfg.query_scale or hd ** -0.5

        x = LM._embed(cfg, self.params, tokens)                # (T, D)
        qmode = self._kv_quant
        for li, lp in enumerate(self._layer_params):
            h = LM._norm(cfg, x, lp["norm1"], lp.get("norm1_b"))
            q = (h @ lp["attn"]["wq"]).reshape(t, cfg.n_heads, hd)
            k = (h @ lp["attn"]["wk"]).reshape(t, hkv, hd)
            v = (h @ lp["attn"]["wv"]).reshape(t, hkv, hd)
            if cfg.rope_theta is not None:
                pos2 = positions[:, None]
                q = L.apply_rope(q[:, :, None], pos2, cfg.rope_theta)[:, :, 0]
                k = L.apply_rope(k[:, :, None], pos2, cfg.rope_theta)[:, :, 0]

            kf = k_pages[li].view(n_pages * ps, hkv, hd)
            vf = v_pages[li].view(n_pages * ps, hkv, hd)
            ks_p = vs_p = None
            k_w, v_w = k[write_rows], v[write_rows]
            if qmode is None:
                kf[write_slots] = k_w.to(kf.dtype)
                vf[write_slots] = v_w.to(vf.dtype)
            else:
                kq, k_sc = quant.quantize(k_w, qmode)
                vq, v_sc = quant.quantize(v_w, qmode)
                kf[write_slots] = kq
                vf[write_slots] = vq
                ks_p, vs_p = k_scales[li], v_scales[li]
                ks_p.view(n_pages * ps, hkv)[write_slots] = k_sc
                vs_p.view(n_pages * ps, hkv)[write_slots] = v_sc

            o = paged_attention(q.to(k_pages[li].dtype) if qmode is None
                                else q, k_pages[li], v_pages[li], tables,
                                seg_ids, positions, scale=scale,
                                k_scale=ks_p, v_scale=vs_p)
            x = x + o.reshape(t, -1).to(x.dtype) @ lp["attn"]["wo"]
            if "mlp" in lp:
                h2 = LM._norm(cfg, x, lp["norm2"], lp.get("norm2_b"))
                x = x + L.mlp(lp["mlp"], h2, cfg.act)
        return LM._norm(cfg, x, self.params["final_norm"],
                        self.params.get("final_norm_b"))
