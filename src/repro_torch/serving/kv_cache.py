"""Paged KV-cache allocator, in PyTorch.

Counterpart of ``repro/serving/kv_cache.py``: fixed-size pages, a
free-list that never returns pages to the system, refcounts for
immediate reuse, a generation-stamped hash prefix index, copy-on-write,
quarantine/recovery with scrubbing, and page-shaped fp32 scales beside
an int8/fp8 pool.  The host bookkeeping (``PagePool`` and the table /
length dictionaries) is the reference's, line for line.

What changes with torch:

  * The page tensors are SINGLE-OWNER and updated IN PLACE.  The
    reference donates its immutable arrays to the jitted step and gets
    new ones back; here ``take_kv``/``put_kv`` keep the same contract
    (while the executor holds the tensors, ``self.k``/``self.v`` are
    None, so a stray host access raises), and the executor scatters into
    the very tensors it was handed.
  * The device block-table mirror is updated by delta rows as one
    in-place ``index_copy_`` over only the dirty rows, replacing the
    jitted donated scatter (``kv_cache.py:58-64``).  Nothing needs to be
    pre-compiled, so the rows are not padded to a power of two and
    ``upload_rows_total`` counts the rows actually sent.

  * The host write paths (``append``, ``write_batch``, ``write_prompt``)
    scatter in place into the single-owner tensors through
    :meth:`flat_slots`, quantizing on the way for an int8/fp8 pool; the
    reference rebinds a new array per layer.  ``append`` copies a shared
    page first (COW); the prompt writes go through, as every sharer
    pledges the same content.
  * :meth:`gather` (the legacy engine's and the gathered-cache path's
    read) returns contiguous (B, Hkv, L, D) K/V and (B,) int32 lengths
    on the pool's device, dequantized to fp32 for a quantized pool, as
    the reference does.

Not ported: ``n_replicas > 1`` or a mesh (which raise).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from . import quant
from .errors import MeshConfigError


@dataclass
class PageStats:
    allocated_pages: int = 0
    freed_pages: int = 0
    prefix_hits: int = 0
    prefix_misses: int = 0
    cow_copies: int = 0
    oom_rejections: int = 0
    page_hwm: int = 0          # high-water mark of live pages

    @property
    def hit_rate(self) -> float:
        tot = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / tot if tot else 0.0


class PagePool:
    """Refcounted free-list of physical page ids (one replica)."""

    def __init__(self, num_pages: int, n_replicas: int = 1):
        if n_replicas != 1:
            raise MeshConfigError(
                f"n_replicas={n_replicas}: data-parallel serving is not "
                f"ported yet (ROADMAP.md queue A7)")
        self.num_pages = num_pages
        self.n_replicas = 1
        self.pages_per_replica = num_pages
        self.free: List[int] = list(range(num_pages - 1, -1, -1))
        self.refs: Dict[int, int] = {}
        # content generation per page: bumped on every alloc, so prefix
        # index entries stamped with an older generation are stale
        self.gen: List[int] = [0] * num_pages
        # tokens actually WRITTEN into each live page
        self.filled: Dict[int, int] = {}
        self.stats = PageStats()
        self.page_hwm_per_replica: List[int] = [0]

    def free_in(self, replica: int) -> int:
        return len(self.free)

    def alloc(self, replica: Optional[int] = None) -> Optional[int]:
        if not self.free:
            self.stats.oom_rejections += 1
            return None
        page = self.free.pop()
        self.refs[page] = 1
        self.gen[page] += 1
        self.filled[page] = 0
        self.stats.allocated_pages += 1
        self.stats.page_hwm = max(self.stats.page_hwm, len(self.refs))
        self.page_hwm_per_replica[0] = self.stats.page_hwm
        return page

    def retain(self, page: int) -> None:
        self.refs[page] += 1

    def release(self, page: int) -> None:
        self.refs[page] -= 1
        if self.refs[page] == 0:
            del self.refs[page]
            self.free.append(page)       # immediate reuse — no deferred GC
            self.stats.freed_pages += 1

    @property
    def num_free(self) -> int:
        return len(self.free)


class PagedKVCache:
    """Physical paged KV storage + per-sequence block tables."""

    def __init__(self, *, n_layers: int, n_kv_heads: int, head_dim: int,
                 page_size: int = 16, num_pages: int = 256,
                 dtype: torch.dtype = torch.bfloat16, n_replicas: int = 1,
                 kv_dtype: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.n_layers = n_layers
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.page_size = page_size
        self.pool = PagePool(num_pages, n_replicas)
        self.n_replicas = 1
        self.pages_per_replica = self.pool.pages_per_replica
        self.quant_mode = quant.canonical(kv_dtype)
        if self.quant_mode is not None:
            dtype = quant.storage_dtype(self.quant_mode)
        elif kv_dtype in ("fp32", "float32"):
            dtype = torch.float32
        elif kv_dtype in ("bf16", "bfloat16"):
            dtype = torch.bfloat16
        self.kv_dtype_name = self.quant_mode or str(dtype).split(".")[-1]
        self.seq_replica: Dict[int, int] = {}
        shape = (num_pages, page_size, n_kv_heads, head_dim)
        self.k: Optional[List[torch.Tensor]] = [
            torch.zeros(shape, dtype=dtype, device=self.device)
            for _ in range(n_layers)]
        self.v: Optional[List[torch.Tensor]] = [
            torch.zeros(shape, dtype=dtype, device=self.device)
            for _ in range(n_layers)]
        sshape = (num_pages, page_size, n_kv_heads)
        self.k_scale: Optional[List[torch.Tensor]] = None
        self.v_scale: Optional[List[torch.Tensor]] = None
        if self.quant_mode is not None:
            self.k_scale = [torch.zeros(sshape, device=self.device)
                            for _ in range(n_layers)]
            self.v_scale = [torch.zeros(sshape, device=self.device)
                            for _ in range(n_layers)]
        self.dtype = dtype
        self.tables: Dict[int, List[int]] = {}
        self.lengths: Dict[int, int] = {}
        self.reused_prefix: Dict[int, int] = {}
        self._prefix_index: Dict[bytes, Tuple[int, int]] = {}
        self._seq_version: Dict[int, int] = {}
        self._version_counter = 0
        self._mirror: Optional[torch.Tensor] = None     # (S, width) device
        self._mirror_rows: List[Optional[Tuple[int, int]]] = []
        self.mirror_width_hint = 0
        self.upload_rows_total = 0
        self.upload_full_rebuilds = 0
        self.last_upload_rows = 0
        self.external_refs: Dict[int, int] = {}

    # -- sequence lifecycle ----------------------------------------------
    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def can_admit(self, n_tokens: int, replica: int = 0) -> bool:
        return self.pool.free_in(replica) >= self.pages_needed(n_tokens)

    def create(self, seq_id: int, prompt_tokens: Sequence[int],
               replica: int = 0) -> bool:
        """Admit a sequence, reusing shared-prefix pages where the
        page-aligned prompt hash matches.  ``lengths[seq_id]`` is the
        reused (and already written) token count.  False when out of
        pages."""
        assert seq_id not in self.tables
        n = len(prompt_tokens)
        table: List[int] = []
        reused = 0
        h = hashlib.sha1()
        for start in range(0, n, self.page_size):
            chunk = tuple(prompt_tokens[start:start + self.page_size])
            full_page = len(chunk) == self.page_size
            h.update(repr(chunk).encode())
            key = h.digest()
            hit = self._prefix_index.get(key) if full_page else None
            if (hit is not None and hit[0] in self.pool.refs
                    and self.pool.gen[hit[0]] == hit[1]
                    and reused * self.page_size == start):
                self.pool.retain(hit[0])
                table.append(hit[0])
                reused += 1
                self.pool.stats.prefix_hits += 1
                continue
            page = self.pool.alloc(replica)
            if page is None:
                for p in table:
                    self.pool.release(p)
                return False
            self.pool.stats.prefix_misses += 1
            if full_page:
                self._prefix_index[key] = (page, self.pool.gen[page])
            table.append(page)
        self.tables[seq_id] = table
        self.seq_replica[seq_id] = replica
        self.lengths[seq_id] = min(reused * self.page_size,
                                   self._readable(table))
        self.reused_prefix[seq_id] = reused * self.page_size
        self._bump(seq_id)
        return True

    def _bump(self, seq_id: int) -> None:
        self._version_counter += 1
        self._seq_version[seq_id] = self._version_counter

    def _readable(self, table: List[int]) -> int:
        total = 0
        for p in table:
            f = self.pool.filled.get(p, 0)
            total += f
            if f < self.page_size:
                break
        return total

    def _alloc_for(self, seq_id: int) -> Optional[int]:
        return self.pool.alloc(self.seq_replica.get(seq_id, 0))

    def free_seq(self, seq_id: int) -> None:
        for p in self.tables.pop(seq_id):
            self.pool.release(p)
        del self.lengths[seq_id]
        self.reused_prefix.pop(seq_id, None)
        self._seq_version.pop(seq_id, None)
        self.seq_replica.pop(seq_id, None)

    # -- quarantine / recovery --------------------------------------------
    def quarantine_seq(self, seq_id: int) -> None:
        """Drop a suspect sequence's bookkeeping without walking its
        block table through ``pool.release``; :meth:`recover` reclaims
        its pages."""
        self.tables.pop(seq_id, None)
        self.lengths.pop(seq_id, None)
        self.reused_prefix.pop(seq_id, None)
        self._seq_version.pop(seq_id, None)
        self.seq_replica.pop(seq_id, None)

    def recover(self) -> int:
        """Rebuild refcounts and the free list from the surviving tables
        (plus ``external_refs``), scrub reclaimed pages to zero, realign
        the alloc/free counters and drop the device table mirror.
        Returns the number of repaired pages."""
        pool = self.pool
        expected: Dict[int, int] = dict(self.external_refs)
        for table in self.tables.values():
            for p in table:
                if 0 <= p < pool.num_pages:
                    expected[p] = expected.get(p, 0) + 1
        repaired, orphans = 0, []
        for page in range(pool.num_pages):
            want = expected.get(page, 0)
            have = pool.refs.get(page, 0)
            if want == have:
                continue
            repaired += 1
            if want == 0:
                orphans.append(page)
                del pool.refs[page]
                pool.filled.pop(page, None)
            else:
                pool.refs[page] = want
        pool.free = [p for p in range(pool.num_pages - 1, -1, -1)
                     if p not in pool.refs]
        pool.stats.freed_pages = (pool.stats.allocated_pages
                                  - len(pool.refs))
        if orphans:
            self.scrub_pages(orphans)
        self._mirror = None            # next device_tables: full rebuild
        return repaired

    def scrub_pages(self, pages: Sequence[int]) -> None:
        """Zero the K/V content (and scales) of ``pages`` in place.
        Requires the host to own the tensors (not taken)."""
        if not pages or self.k is None:
            return
        idx = torch.as_tensor(list(pages), dtype=torch.long,
                              device=self.device)
        for layer in range(self.n_layers):
            self.k[layer][idx] = 0
            self.v[layer][idx] = 0
            if self.k_scale is not None:
                self.k_scale[layer][idx] = 0
                self.v_scale[layer][idx] = 0

    def ensure_capacity(self, seq_id: int, n_tokens: int) -> bool:
        """Grow the block table so ``n_tokens`` positions have pages.
        False (table unchanged) when the pool runs dry."""
        table = self.tables[seq_id]
        need = self.pages_needed(n_tokens)
        grown = []
        while len(table) < need:
            page = self._alloc_for(seq_id)
            if page is None:
                for p in grown:
                    self.pool.release(p)
                    table.pop()
                return False
            table.append(page)
            grown.append(page)
        if grown:
            self._bump(seq_id)
        return True

    def make_writable(self, seq_id: int, start: int, end: int,
                      divergent: bool = True) -> bool:
        """Copy-on-write guard for token span [start, end): divergent
        writes copy shared pages first; prompt-content writes go
        through (every sharer pledges identical content)."""
        if not divergent:
            return True
        for page_pos in range(start // self.page_size,
                              -(-end // self.page_size)):
            if self._writable_page(seq_id, page_pos) is None:
                return False
        return True

    def truncate(self, seq_id: int, n_tokens: int) -> bool:
        """Shrink the table to cover exactly ``n_tokens`` positions (the
        speculative rewind).  True when pages were released or the
        length moved."""
        table = self.tables[seq_id]
        keep = self.pages_needed(n_tokens)
        changed = False
        while len(table) > keep:
            self.pool.release(table.pop())
            changed = True
        if self.lengths[seq_id] > n_tokens:
            self.lengths[seq_id] = n_tokens
            changed = True
        if changed:
            self._bump(seq_id)
        return changed

    def advance(self, seq_id: int, n_tokens: int) -> None:
        """Mark K/V valid (written) up to ``n_tokens``."""
        table = self.tables[seq_id]
        ps = self.page_size
        for i in range(self.lengths[seq_id] // ps, n_tokens // ps):
            self.pool.filled[table[i]] = ps
        if n_tokens % ps:
            p = table[n_tokens // ps]
            self.pool.filled[p] = max(self.pool.filled.get(p, 0),
                                      n_tokens % ps)
        self.lengths[seq_id] = max(self.lengths[seq_id], n_tokens)

    def _writable_page(self, seq_id: int, page_pos: int) -> Optional[int]:
        """Copy-on-write: if the page is shared, copy it (codes and
        scales, in place) before writing."""
        table = self.tables[seq_id]
        page = table[page_pos]
        if self.pool.refs.get(page, 1) > 1:
            new_page = self._alloc_for(seq_id)
            if new_page is None:
                return None
            for layer in range(self.n_layers):
                self.k[layer][new_page] = self.k[layer][page]
                self.v[layer][new_page] = self.v[layer][page]
                if self.k_scale is not None:
                    self.k_scale[layer][new_page] = self.k_scale[layer][page]
                    self.v_scale[layer][new_page] = self.v_scale[layer][page]
            self.pool.release(page)
            table[page_pos] = new_page
            self.pool.stats.cow_copies += 1
            self._bump(seq_id)
            return new_page
        return page

    def flat_slots(self, seq_id: int, start: int, end: int) -> np.ndarray:
        """Flat (page*page_size + offset) destination for each token
        position in [start, end)."""
        pos = np.arange(start, end)
        table = np.asarray(self.tables[seq_id], np.int64)
        return table[pos // self.page_size] * self.page_size \
            + pos % self.page_size

    # -- host write paths (the legacy engine, tests) -----------------------
    def _scatter(self, layer: int, idx: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> None:
        """Write (n, Hkv, hd) K/V rows at flat slots ``idx`` of one
        layer, in place; an int8/fp8 pool stores codes and, at the same
        flat slots, their scales."""
        npg, ps = self.pool.num_pages, self.page_size
        k, v = k.to(self.device), v.to(self.device)
        kf = self.k[layer].view(npg * ps, self.n_kv_heads, self.head_dim)
        vf = self.v[layer].view(npg * ps, self.n_kv_heads, self.head_dim)
        if self.quant_mode is None:
            kf[idx] = k.to(kf.dtype)
            vf[idx] = v.to(vf.dtype)
            return
        kq, k_sc = quant.quantize(k, self.quant_mode)
        vq, v_sc = quant.quantize(v, self.quant_mode)
        kf[idx] = kq
        vf[idx] = vq
        self.k_scale[layer].view(npg * ps, self.n_kv_heads)[idx] = k_sc
        self.v_scale[layer].view(npg * ps, self.n_kv_heads)[idx] = v_sc

    def append(self, seq_id: int,
               layer_kv: Sequence[Tuple[torch.Tensor, torch.Tensor]]
               ) -> bool:
        """Append ONE token's K/V for every layer: ``layer_kv[i]`` is a
        ((Hkv, hd), (Hkv, hd)) pair.  Grows the table and copies a shared
        page first.  False when out of pages."""
        pos = self.lengths[seq_id]
        page_pos, offset = divmod(pos, self.page_size)
        table = self.tables[seq_id]
        if page_pos >= len(table):
            page = self._alloc_for(seq_id)
            if page is None:
                return False
            table.append(page)
            self._bump(seq_id)
        page = self._writable_page(seq_id, page_pos)
        if page is None:
            return False
        idx = torch.tensor([page * self.page_size + offset],
                           dtype=torch.long, device=self.device)
        for layer, (k_t, v_t) in enumerate(layer_kv):
            self._scatter(layer, idx, k_t[None], v_t[None])
        self.pool.filled[page] = max(self.pool.filled.get(page, 0),
                                     offset + 1)
        self.lengths[seq_id] = pos + 1
        return True

    def write_batch(self, seq_id: int,
                    layer_kv: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    start: int, end: int) -> bool:
        """Write token span [start, end) with one in-place scatter per
        layer: ``layer_kv[i]`` = ((end-start, Hkv, hd), same for v).
        Allocates pages as needed.  False when out of pages."""
        if end <= start:
            return True
        if not self.ensure_capacity(seq_id, end):
            return False
        if not self.make_writable(seq_id, start, end, divergent=False):
            return False
        idx = torch.from_numpy(self.flat_slots(seq_id, start, end)).to(
            self.device)
        for layer, (k_s, v_s) in enumerate(layer_kv):
            self._scatter(layer, idx, k_s, v_s)
        self.advance(seq_id, end)
        return True

    def write_prompt(self, seq_id: int,
                     layer_kv: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                     n_tokens: int) -> bool:
        """Batched prefill write of every prompt token PAST the
        already-valid reused prefix: ``layer_kv[i]`` holds the full
        prompt's (n_tokens, Hkv, hd) K/V; the valid prefix is skipped."""
        skip = min(self.lengths[seq_id], n_tokens)
        span = [(k[skip:], v[skip:]) for k, v in layer_kv]
        return self.write_batch(seq_id, span, skip, n_tokens)

    def gather(self, seq_ids: Sequence[int], layer: int,
               pad_to: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Contiguous (B, Hkv, L, hd) K/V of a batch of sequences from
        their page tables (L = ``pad_to`` or the longest length; rows
        padded with page 0), and their (B,) int32 lengths, all on the
        pool's device.  A quantized pool is dequantized to fp32.  The
        executor attends the pages in place instead; this is the legacy
        engine's and the gathered-cache path's read."""
        max_len = max(self.lengths[s] for s in seq_ids)
        pad_to = pad_to or max_len
        max_pages = self.pages_needed(pad_to)
        tables = np.zeros((len(seq_ids), max_pages), np.int64)
        for i, s in enumerate(seq_ids):
            t = self.tables[s][:max_pages]
            tables[i, : len(t)] = t
        idx = torch.from_numpy(tables).to(self.device)         # (B, P)
        k = self.k[layer][idx]                          # (B, P, ps, Hkv, hd)
        v = self.v[layer][idx]
        if self.quant_mode is not None:
            k = quant.dequantize(k, self.k_scale[layer][idx])
            v = quant.dequantize(v, self.v_scale[layer][idx])
        b = len(seq_ids)
        shape = (b, max_pages * self.page_size, self.n_kv_heads,
                 self.head_dim)
        k = k.reshape(shape)[:, :pad_to].transpose(1, 2).contiguous()
        v = v.reshape(shape)[:, :pad_to].transpose(1, 2).contiguous()
        lens = torch.tensor([self.lengths[s] for s in seq_ids],
                            dtype=torch.int32, device=self.device)
        return k, v, lens

    # -- device mirror / single ownership ----------------------------------
    _EMPTY_ROW = (-1, -1)

    def device_tables(self, seq_ids: Sequence[int], max_pages: int
                      ) -> torch.Tensor:
        """(len(seq_ids), W) int32 device block-table mirror, W >=
        ``max_pages``, rows padded with page 0.  Slot i is dirty when its
        (seq id, table version) differs from what the device row holds;
        the dirty rows go up as one host-to-device copy and one in-place
        ``index_copy_``.  A steady decode step uploads zero rows.  A full
        rebuild happens only when the slot count or width outgrows the
        mirror."""
        s = len(seq_ids)
        targets = [(sid, self._seq_version[sid]) if sid >= 0
                   else self._EMPTY_ROW for sid in seq_ids]
        if (self._mirror is None or self._mirror.shape[0] != s
                or self._mirror.shape[1] < max_pages):
            width = max(max_pages, self.mirror_width_hint,
                        self._mirror.shape[1]
                        if self._mirror is not None else 0)
            out = np.zeros((s, width), np.int32)
            for i, sid in enumerate(seq_ids):
                if sid < 0:
                    continue
                t = self._device_row(sid, width)
                out[i, : len(t)] = t
            self._mirror = torch.from_numpy(out).to(self.device)
            self._mirror_rows = list(targets)
            uploaded = s
            self.upload_full_rebuilds += 1
        else:
            width = self._mirror.shape[1]
            dirty = [i for i, tgt in enumerate(targets)
                     if self._mirror_rows[i] != tgt]
            uploaded = len(dirty)
            if dirty:
                rows = np.zeros((len(dirty), width), np.int32)
                for j, i in enumerate(dirty):
                    sid = seq_ids[i]
                    if sid >= 0:
                        t = self._device_row(sid, width)
                        rows[j, : len(t)] = t
                    self._mirror_rows[i] = targets[i]
                idx = torch.as_tensor(dirty, dtype=torch.long)
                self._mirror.index_copy_(
                    0, idx.to(self.device),
                    torch.from_numpy(rows).to(self.device))
        self.last_upload_rows = uploaded
        self.upload_rows_total += uploaded
        return self._mirror

    def _device_row(self, sid: int, width: int) -> List[int]:
        """A sequence's block-table row as the device sees it: a page id
        outside the pool (a corrupted host table, which the watchdog
        catches after the step) goes up as page 0, so no kernel reads
        outside the page tensors.  The reference's gathers clamp or
        fill such ids instead."""
        n = self.pool.num_pages
        return [p if 0 <= p < n else 0 for p in self.tables[sid][:width]]

    def take_kv(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Hand the page tensors to the executor, which updates them in
        place.  The host must not touch them until ``put_kv``."""
        ks, vs = self.k, self.v
        assert ks is not None, "KV tensors already taken (ownership hazard)"
        self.k = self.v = None
        return ks, vs

    def put_kv(self, ks: List[torch.Tensor], vs: List[torch.Tensor]) -> None:
        self.k, self.v = list(ks), list(vs)

    def take_scales(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """The scales half of the ownership contract; ([], []) for an
        unquantized pool."""
        if self.quant_mode is None:
            return [], []
        ks, vs = self.k_scale, self.v_scale
        assert ks is not None, \
            "KV scale tensors already taken (ownership hazard)"
        self.k_scale = self.v_scale = None
        return ks, vs

    def put_scales(self, ks: List[torch.Tensor],
                   vs: List[torch.Tensor]) -> None:
        if self.quant_mode is None:
            return
        self.k_scale, self.v_scale = list(ks), list(vs)

    def memory_stats(self) -> Dict[str, float]:
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        page_bytes = (self.page_size * self.n_kv_heads * self.head_dim
                      * 2 * itemsize * self.n_layers)
        if self.quant_mode is not None:
            page_bytes += (self.page_size * self.n_kv_heads * 2 * 4
                           * self.n_layers)
        used = self.pool.num_pages - self.pool.num_free
        return {
            "pages_total": self.pool.num_pages,
            "pages_used": used,
            "pages_free": self.pool.num_free,
            "page_bytes": page_bytes,
            "kv_dtype": self.kv_dtype_name,
            "bytes_used": used * page_bytes,
            "kv_bytes": self.pool.num_pages * page_bytes,
            "page_hwm": self.pool.stats.page_hwm,
            "page_hwm_per_replica": list(self.pool.page_hwm_per_replica),
            "prefix_hit_rate": self.pool.stats.hit_rate,
            "cow_copies": self.pool.stats.cow_copies,
            "oom_rejections": self.pool.stats.oom_rejections,
        }
