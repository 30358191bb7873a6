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
    rows (``write_idx`` = the OOB slot ``pages_per_replica*page_size``,
    ``scheduler.py:629``) vanish; torch has no drop mode, so the
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

Data replicas.  With ``n_replicas = R`` the plan's operands carry a
leading replica axis, replica-local lanes and page indices.  The
reference vmaps its step over that axis (``executor.py:199-237``); on one
device the port flattens it instead: the R token rows become one batch
of R*T tokens, replica r's lanes and sample rows are offset by r*S and
r*T, its write slots by its page range, and the device table rows hold
global page ids (``PagedKVCache.device_tables``), so ONE paged-kernel
launch a layer serves every replica.

On a (data, model) mesh (``launch.mesh``) every rank runs this same
program on the same plan (SPMD).  The ``data`` rank takes its replica's
row of the plan and its own part of the pool; the ``model`` axis is
tensor parallel as ``distributed.sharding.serving_param_specs`` places
the weights, with explicit collectives (``distributed.collectives``):

  * ``wq``/``wk``/``wv``, ``w_up``/``w_gate`` and the vocab of ``embed``
    / ``lm_head`` are column-parallel; ``wo`` and ``w_down`` are
    row-parallel, each followed by an ``all_reduce``; the embedding is a
    vocab-parallel lookup (a masked gather, then an ``all_reduce``); the
    logits are all-gathered to full rows before the sampling tail, so
    the keyed Gumbel noise is the same on every rank;
  * KV heads that divide the model axis split with the query heads
    (each rank attends its heads; no exchange);
  * otherwise (gemma-2b's one KV head at tp = 2) the replica's pages
    split over ``model`` (context-parallel KV): the K/V pieces and q are
    all-gathered, each rank writes the tokens whose page it holds and
    attends the pages it holds through the paged kernel, which returns
    each row's log-sum-exp beside its output; (o, lse) are all-gathered
    and merged (``models.attention.merge_attention_partials``), and each
    rank keeps its heads for the row-parallel ``wo``;
  * the sampled tokens and the non-finite flags are all-gathered over
    ``data``, so every rank commits the same step.

``compile_count`` counts the distinct (T, P) shape buckets executed, as
the reference's fallback does; capturing one CUDA graph per bucket is
later work.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..distributed import collectives as C
from ..models import layers as L
from ..models.attention import (merge_attention_partials, paged_attention,
                                select_paged_backend)
from ..models import lm as LM
from . import quant, sampling
from .kv_cache import PagedKVCache
from .scheduler import StepPlan


class Executor:
    """Runs the step; stateless between calls except the bucket
    bookkeeping (and, on a mesh, counts of its collectives)."""

    def __init__(self, cfg: LM.LMConfig, params, *, device,
                 kv_quant=None, mesh=None, n_replicas: int = 1):
        self.cfg = cfg
        self.device = device
        self._kv_quant = quant.canonical(kv_quant)
        self.mesh = mesh
        self.n_replicas = n_replicas
        select_paged_backend(cfg.attn_backend,
                             sharded=mesh is not None or n_replicas > 1)
        self.tp = 1
        self._pool_mode = "full"
        self.stats = {"lse_merges": 0, "collectives": 0}
        if mesh is not None:
            params = self._shard_params(params)
        self.params = params
        self._layer_params = params["layers"]
        self._compiled: set = set()

    # -- the mesh --------------------------------------------------------
    def _shard_params(self, params):
        """This rank's shards of ``params`` (contiguous copies, so the
        caller may free the full tensors) and, per weight, whether its
        output or input dimension is split over ``model``."""
        from ..distributed.sharding import (local_shard, serving_param_specs,
                                            tree_map_with_path)
        from ..launch.mesh import axis_sizes, coords
        mesh = self.mesh
        sizes = axis_sizes(mesh)
        self.tp = sizes.get("model", 1)
        self.model_rank = mesh.get_local_rank("model")
        self.data_group = mesh.get_group("data")
        self.model_group = mesh.get_group("model")
        here = coords(mesh)
        specs = serving_param_specs(self.cfg, params, mesh)
        self.split: Dict[str, Tuple[bool, ...]] = {}

        def cut(path, leaf):
            spec = _lookup(specs, path)
            self.split[path] = tuple(e is not None for e in spec)
            piece = local_shard(leaf, spec, mesh, here)
            return torch.empty(piece.shape, dtype=piece.dtype,
                               device=self.device).copy_(piece)

        return tree_map_with_path(cut, params)

    def _cols_split(self, path: str) -> bool:
        """The weight's output (last) dimension is split over model."""
        return self.mesh is not None and self.split[path][-1]

    def _rows_split(self, path: str) -> bool:
        """The weight's input (first) dimension is split over model."""
        return self.mesh is not None and self.split[path][0]

    def _gather_cols(self, x: torch.Tensor) -> torch.Tensor:
        self.stats["collectives"] += 1
        return C.all_gather_cat(x, self.model_group, dim=-1)

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        self.stats["collectives"] += 1
        return C.all_reduce_sum(x, self.model_group)

    @property
    def compile_count(self) -> int:
        return len(self._compiled)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- host entry -------------------------------------------------------
    def execute(self, plan: StepPlan, kv: PagedKVCache
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Run one unified step; returns ((R*max_batch, K+1) sampled
        tokens and an (R*max_batch,) bool non-finite-logits flag
        array)."""
        tables = kv.device_tables(plan.slot_seqs, plan.p_bucket)
        ops = self._operands(plan, kv)
        self._pool_mode = kv.shard.mode
        ks, vs = kv.take_kv()
        kss, vss = kv.take_scales()
        try:
            with torch.no_grad():
                toks, bad = self._unified_step(
                    plan.p_bucket, ks, vs, kss, vss, tables, **ops)
                if self.mesh is not None and self.n_replicas > 1:
                    toks = C.all_gather_cat(toks, self.data_group, dim=0)
                    bad = C.all_gather_cat(bad.to(torch.uint8),
                                           self.data_group, dim=0).bool()
                next_tokens = toks.cpu().numpy()
                bad = bad.cpu().numpy()
        finally:
            kv.put_kv(ks, vs)
            kv.put_scales(kss, vss)
        self._compiled.add((plan.t_bucket, plan.p_bucket))
        return next_tokens, bad

    def _operands(self, plan: StepPlan, kv: PagedKVCache
                  ) -> Dict[str, torch.Tensor]:
        """The step's device operands from the plan: one replica's row on
        a mesh rank, every replica's rows flattened into one batch
        without a mesh (the module docstring)."""
        R = self.n_replicas
        arrs = [plan.tokens, plan.seg_ids, plan.positions, plan.write_idx,
                plan.sample_idx, plan.sample_pos, plan.temps, plan.top_ks,
                plan.top_ps, plan.seeds]
        if plan.tokens.ndim == 1:
            arrs = [a[None] for a in arrs]
        (tokens, seg, pos, widx, sample_idx, sample_pos, temps, top_ks,
         top_ps, seeds) = arrs
        s, t = sample_idx.shape[1], tokens.shape[1]
        replicas = np.arange(R)
        slot_seqs = list(plan.slot_seqs)
        if self.mesh is not None:
            replicas = replicas[kv.shard.replica:kv.shard.replica + 1]
            slot_seqs = slot_seqs[replicas[0] * s:(replicas[0] + 1) * s]
            arrs = [a[replicas] for a in arrs]
            (tokens, seg, pos, widx, sample_idx, sample_pos, temps, top_ks,
             top_ps, seeds) = arrs
        # each replica's rows into one batch: lanes, token rows and write
        # slots offset by the replica (a mesh rank has one, at offset 0)
        n_local = len(replicas)
        lane_off = (np.arange(n_local) * s)[:, None]
        seg = np.where(seg >= 0, seg + lane_off, -1)
        sample_idx = sample_idx + (np.arange(n_local) * t)[:, None, None]
        ppr_flat = kv.pages_per_replica * kv.page_size
        offs = np.array([kv.flat_offset(r) for r in replicas])[:, None]
        local = np.where((widx >= 0) & (widx < ppr_flat), widx + offs, -1)
        n_flat = kv.shard.n_pages * kv.page_size
        local = np.where(local < n_flat, local, -1).reshape(-1)
        rows = np.nonzero(local >= 0)[0]
        seg, pos = seg.reshape(-1), pos.reshape(-1)
        attn_pos = kv.local_positions(slot_seqs, seg, pos)
        return dict(
            tokens=self._put(tokens.reshape(-1).astype(np.int64)),
            seg_ids=self._put(seg.astype(np.int32)),
            positions=self._put(pos.astype(np.int32)),
            attn_positions=self._put(attn_pos),
            write_rows=self._put(rows.astype(np.int64)),
            write_slots=self._put(local[rows].astype(np.int64)),
            sample_idx=self._put(sample_idx.reshape(-1, sample_idx.shape[-1])
                                 .astype(np.int64)),
            sample_pos=self._put(sample_pos.reshape(-1).astype(np.int64)),
            temps=self._put(temps.reshape(-1).astype(np.float32)),
            top_ks=self._put(top_ks.reshape(-1).astype(np.int64)),
            top_ps=self._put(top_ps.reshape(-1).astype(np.float32)),
            seeds=self._put(seeds.reshape(-1).astype(np.int64)))

    # -- the device step ----------------------------------------------------
    def _unified_step(self, p_bucket: int, k_pages: List[torch.Tensor],
                      v_pages: List[torch.Tensor],
                      k_scales: List[torch.Tensor],
                      v_scales: List[torch.Tensor], tables: torch.Tensor, *,
                      tokens: torch.Tensor, seg_ids: torch.Tensor,
                      positions: torch.Tensor, attn_positions: torch.Tensor,
                      write_rows: torch.Tensor, write_slots: torch.Tensor,
                      sample_idx: torch.Tensor, sample_pos: torch.Tensor,
                      temps: torch.Tensor, top_ks: torch.Tensor,
                      top_ps: torch.Tensor, seeds: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        x = self._body(k_pages, v_pages, k_scales, v_scales, tokens,
                       seg_ids, positions, write_rows, write_slots,
                       tables[:, :p_bucket].contiguous(), attn_positions)
        s, kp1 = sample_idx.shape
        xs = x[sample_idx.reshape(-1)]                         # (S*(K+1), D)
        if cfg.tie_embeddings:
            logits = xs @ self.params["embed"].T
            if self._rows_split("embed"):
                logits = self._gather_cols(logits)
        else:
            logits = xs @ self.params["lm_head"]
            if self._cols_split("lm_head"):
                logits = self._gather_cols(logits)
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

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        if not self._rows_split("embed"):
            return LM._embed(self.cfg, self.params, tokens)
        # vocab-parallel lookup: this rank's rows, zeros elsewhere, summed
        table = self.params["embed"]
        lo = self.model_rank * table.shape[0]
        idx = tokens - lo
        ok = (idx >= 0) & (idx < table.shape[0])
        x = table[torch.where(ok, idx, torch.zeros_like(idx))]
        x = self._reduce(torch.where(ok[:, None], x, torch.zeros_like(x)))
        return LM.scale_embeddings(self.cfg, x)

    def _body(self, k_pages: List[torch.Tensor],
              v_pages: List[torch.Tensor], k_scales: List[torch.Tensor],
              v_scales: List[torch.Tensor], tokens: torch.Tensor,
              seg_ids: torch.Tensor, positions: torch.Tensor,
              write_rows: torch.Tensor, write_slots: torch.Tensor,
              tables: torch.Tensor,
              attn_positions: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
        """embed -> layers (KV scatter + paged attention in place) ->
        final norm.  Returns the (T, D) normed hidden states; the page
        (and scale) tensors are updated in place.  ``write_rows`` are the
        token-batch rows whose K/V is written, ``write_slots`` their flat
        (page*page_size + offset) destinations in this rank's pool;
        ``attn_positions`` each token's position in its table row
        (``PagedKVCache.local_positions``; ``positions`` by default)."""
        if attn_positions is None:
            attn_positions = positions
        cfg = self.cfg
        t = tokens.shape[0]
        n_pages, ps, hkv_l = k_pages[0].shape[:3]
        hd = cfg.hd
        scale = cfg.query_scale or hd ** -0.5

        x = self._embed(tokens)                                # (T, D)
        qmode = self._kv_quant
        for li, lp in enumerate(self._layer_params):
            path = f"layers/{li}"
            h = LM._norm(cfg, x, lp["norm1"], lp.get("norm1_b"))
            q, k, v = (self._project(h, lp, path, w)
                       for w in ("wq", "wk", "wv"))
            q = q.reshape(t, -1, hd)
            k = k.reshape(t, -1, hd)
            v = v.reshape(t, -1, hd)
            if cfg.rope_theta is not None:
                pos2 = positions[:, None]
                q = L.apply_rope(q[:, :, None], pos2, cfg.rope_theta)[:, :, 0]
                k = L.apply_rope(k[:, :, None], pos2, cfg.rope_theta)[:, :, 0]

            kf = k_pages[li].view(n_pages * ps, hkv_l, hd)
            vf = v_pages[li].view(n_pages * ps, hkv_l, hd)
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
                ks_p.view(n_pages * ps, hkv_l)[write_slots] = k_sc
                vs_p.view(n_pages * ps, hkv_l)[write_slots] = v_sc

            q_in = q.to(k_pages[li].dtype) if qmode is None else q
            if self._pool_mode != "pages":
                o = paged_attention(q_in, k_pages[li], v_pages[li], tables,
                                    seg_ids, attn_positions, scale=scale,
                                    k_scale=ks_p, v_scale=vs_p)
            else:
                o = self._context_attention(q_in, k_pages[li], v_pages[li],
                                            tables, seg_ids, attn_positions,
                                            scale, ks_p, vs_p)
            o = o.reshape(t, -1).to(x.dtype)
            if self._pool_mode != "heads" and \
                    self._rows_split(f"{path}/attn/wo"):
                # the full heads: keep this rank's rows of wo
                width = o.shape[1] // self.tp
                o = o[:, self.model_rank * width:(self.model_rank + 1)
                      * width]
            out = o @ lp["attn"]["wo"]
            if self._rows_split(f"{path}/attn/wo"):
                out = self._reduce(out)
            x = x + out
            if "mlp" in lp:
                h2 = LM._norm(cfg, x, lp["norm2"], lp.get("norm2_b"))
                y = L.mlp(lp["mlp"], h2, cfg.act)
                if self._rows_split(f"{path}/mlp/w_down"):
                    y = self._reduce(y)
                x = x + y
        return LM._norm(cfg, x, self.params["final_norm"],
                        self.params.get("final_norm_b"))

    def _project(self, h: torch.Tensor, lp, path: str, w: str
                 ) -> torch.Tensor:
        """``h @ attn[w]``: this rank's heads when the KV heads split over
        model (pool mode "heads"), else the full projection (its column
        pieces gathered)."""
        y = h @ lp["attn"][w]
        if self._cols_split(f"{path}/attn/{w}") and \
                self._pool_mode != "heads":
            y = self._gather_cols(y)
        return y

    def _context_attention(self, q, k_pages, v_pages, tables, seg_ids,
                           positions, scale, ks_p, vs_p) -> torch.Tensor:
        """Context-parallel KV: attend the pages this rank holds, then
        merge every model rank's (output, log-sum-exp)."""
        o, lse = paged_attention(q, k_pages, v_pages, tables, seg_ids,
                                 positions, scale=scale, k_scale=ks_p,
                                 v_scale=vs_p, return_lse=True)
        self.stats["collectives"] += 2
        outs = C.all_gather(o.contiguous(), self.model_group)
        lses = C.all_gather(lse.contiguous(), self.model_group)
        self.stats["lse_merges"] += 1
        return merge_attention_partials(outs, lses)


def _lookup(tree, path: str):
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else \
            tree[key]
    return tree
