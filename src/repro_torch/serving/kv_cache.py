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

Data replicas and meshes.  With ``n_replicas = R`` page ids stay
GLOBAL, replica r owning the contiguous range [r*ppr, (r+1)*ppr), as in
the reference; the host bookkeeping is the same on every rank of a mesh
(the control plane is mesh-oblivious).  Without a mesh one set of page
tensors holds every replica, and the device table rows hold global ids.
On a (data, model) mesh each rank allocates only its own part of the
pool, as ``distributed.sharding.serving_kv_spec`` places it
(:class:`PoolShard`): its replica's page range over ``data``; its KV
heads over ``model`` where they divide; otherwise its share of the
replica's pages over ``model`` (context-parallel KV).  The rank's table
mirror holds its replica's slot rows in ids of its own page tensors; a
context-parallel rank's rows list only the pages it holds, in table
order, and :meth:`PagedKVCache.local_positions` maps each token's
position onto that compacted row.  Copy-on-write between two model
ranks' pages is a broadcast over the model group; ``gather`` sums the
ranks' parts over the mesh.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..distributed import collectives as C
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
    """Refcounted free-list of physical page ids.  With ``n_replicas >
    1`` page ids stay global and replica r owns the contiguous range
    ``[r*pages_per_replica, (r+1)*pages_per_replica)``; ``free`` stays
    one flat list, and replica-targeted allocation scans it."""

    def __init__(self, num_pages: int, n_replicas: int = 1):
        if n_replicas < 1 or num_pages % n_replicas:
            raise MeshConfigError(
                f"num_pages={num_pages} must divide across "
                f"n_replicas={n_replicas}")
        self.num_pages = num_pages
        self.n_replicas = n_replicas
        self.pages_per_replica = num_pages // n_replicas
        self.free: List[int] = list(range(num_pages - 1, -1, -1))
        self.refs: Dict[int, int] = {}
        # content generation per page: bumped on every alloc, so prefix
        # index entries stamped with an older generation are stale
        self.gen: List[int] = [0] * num_pages
        # tokens actually WRITTEN into each live page
        self.filled: Dict[int, int] = {}
        self.stats = PageStats()
        self.page_hwm_per_replica: List[int] = [0] * n_replicas

    def replica_of(self, page: int) -> int:
        return page // self.pages_per_replica

    def free_in(self, replica: int) -> int:
        """Free pages owned by ``replica`` (O(free); host-side only)."""
        if self.n_replicas == 1:
            return len(self.free)
        return sum(1 for p in self.free
                   if p // self.pages_per_replica == replica)

    def _live_in(self, replica: int) -> int:
        return self.pages_per_replica - self.free_in(replica)

    def alloc(self, replica: Optional[int] = None) -> Optional[int]:
        """Pop a free page: from ``replica``'s range when given, from
        anywhere otherwise (the fault injector's page stealer)."""
        if replica is None or self.n_replicas == 1:
            if not self.free:
                self.stats.oom_rejections += 1
                return None
            page = self.free.pop()
        else:
            lo = replica * self.pages_per_replica
            hi = lo + self.pages_per_replica
            i = next((j for j in range(len(self.free) - 1, -1, -1)
                      if lo <= self.free[j] < hi), None)
            if i is None:
                self.stats.oom_rejections += 1
                return None
            page = self.free.pop(i)
        self.refs[page] = 1
        self.gen[page] += 1
        self.filled[page] = 0
        self.stats.allocated_pages += 1
        self.stats.page_hwm = max(self.stats.page_hwm, len(self.refs))
        r = self.replica_of(page)
        self.page_hwm_per_replica[r] = max(self.page_hwm_per_replica[r],
                                           self._live_in(r))
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


@dataclass(frozen=True)
class PoolShard:
    """The part of the page pool one rank holds: global pages [page_lo,
    page_hi) and KV heads [head_lo, head_hi).  ``mode`` is ``"heads"``
    (heads split over ``model``), ``"pages"`` (the replica's pages split
    over ``model``: context-parallel KV) or ``"full"`` (the replica's
    whole pool on every model rank, or no mesh at all)."""
    page_lo: int
    page_hi: int
    head_lo: int
    head_hi: int
    mode: str = "full"
    replica: int = 0
    model_rank: int = 0
    data_group: object = None
    model_group: object = None

    def holds(self, page: int) -> bool:
        return self.page_lo <= page < self.page_hi

    @property
    def n_pages(self) -> int:
        return self.page_hi - self.page_lo

    @property
    def n_heads(self) -> int:
        return self.head_hi - self.head_lo


def pool_shard(mesh, n_kv_heads: int, num_pages: int,
               n_replicas: int) -> PoolShard:
    """This rank's :class:`PoolShard` on ``mesh`` (None: the whole pool),
    as ``serving_kv_spec`` places a (num_pages, ps, Hkv, hd) pool."""
    if mesh is None:
        return PoolShard(0, num_pages, 0, n_kv_heads)
    from ..distributed.sharding import serving_kv_spec, shard_range
    from ..launch.mesh import axis_sizes, coords
    sizes, here = axis_sizes(mesh), coords(mesh)
    spec = serving_kv_spec(n_kv_heads, mesh,
                           pages_per_replica=num_pages // n_replicas)
    p_lo, p_hi = (0, num_pages) if spec[0] is None else \
        shard_range(num_pages, spec[0], sizes, here)
    h_lo, h_hi = (0, n_kv_heads) if spec[2] is None else \
        shard_range(n_kv_heads, spec[2], sizes, here)
    mode = "heads" if spec[2] is not None else (
        "pages" if isinstance(spec[0], tuple) or spec[0] == "model"
        else "full")
    names = mesh.mesh_dim_names
    return PoolShard(p_lo, p_hi, h_lo, h_hi, mode,
                     here.get("data", 0), here.get("model", 0),
                     mesh.get_group("data") if "data" in names else None,
                     mesh.get_group("model") if "model" in names else None)


class PagedKVCache:
    """Physical paged KV storage + per-sequence block tables."""

    def __init__(self, *, n_layers: int, n_kv_heads: int, head_dim: int,
                 page_size: int = 16, num_pages: int = 256,
                 dtype: torch.dtype = torch.bfloat16, n_replicas: int = 1,
                 kv_dtype: Optional[str] = None, device=None, mesh=None):
        self.device = resolve_device(device)
        self.n_layers = n_layers
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.page_size = page_size
        self.pool = PagePool(num_pages, n_replicas)
        self.n_replicas = n_replicas
        self.pages_per_replica = self.pool.pages_per_replica
        self.mesh = mesh
        self.shard = pool_shard(mesh, n_kv_heads, num_pages, n_replicas)
        self.quant_mode = quant.canonical(kv_dtype)
        if self.quant_mode is not None:
            dtype = quant.storage_dtype(self.quant_mode)
        elif kv_dtype in ("fp32", "float32"):
            dtype = torch.float32
        elif kv_dtype in ("bf16", "bfloat16"):
            dtype = torch.bfloat16
        self.kv_dtype_name = self.quant_mode or str(dtype).split(".")[-1]
        self.seq_replica: Dict[int, int] = {}
        npg, nh = self.shard.n_pages, self.shard.n_heads
        shape = (npg, page_size, nh, head_dim)
        self.k: Optional[List[torch.Tensor]] = [
            torch.zeros(shape, dtype=dtype, device=self.device)
            for _ in range(n_layers)]
        self.v: Optional[List[torch.Tensor]] = [
            torch.zeros(shape, dtype=dtype, device=self.device)
            for _ in range(n_layers)]
        sshape = (npg, page_size, nh)
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
                    and self.pool.replica_of(hit[0]) == replica
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
        pages = [p - self.shard.page_lo for p in pages
                 if self.shard.holds(p)]
        if not pages or self.k is None:
            return
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
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
            self._copy_page(page, new_page)
            self.pool.release(page)
            table[page_pos] = new_page
            self.pool.stats.cow_copies += 1
            self._bump(seq_id)
            return new_page
        return page

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy page ``src`` (codes and scales, every layer) to page
        ``dst`` of one replica, in place.  Only that replica's ranks act;
        on a context-parallel rank the two pages may lie with two model
        ranks, and the holder of ``src`` broadcasts it over the model
        group."""
        sh = self.shard
        if self.mesh is not None and \
                self.pool.replica_of(src) != sh.replica:
            return
        tensors = [self.k, self.v] + (
            [self.k_scale, self.v_scale] if self.k_scale is not None else [])
        if sh.holds(src) and sh.holds(dst):
            for layers in tensors:
                for t in layers:
                    t[dst - sh.page_lo] = t[src - sh.page_lo]
            return
        if sh.mode != "pages":
            raise AssertionError(f"pages {src}, {dst} of replica "
                                 f"{sh.replica} not held here")
        span = sh.n_pages
        base = sh.replica * self.pages_per_replica
        owner = C.global_rank(sh.model_group, (src - base) // span)
        for layers in tensors:
            for t in layers:
                buf = t[src - sh.page_lo].clone() if sh.holds(src) else \
                    torch.empty_like(t[0])
                C.broadcast(buf, owner, sh.model_group)
                if sh.holds(dst):
                    t[dst - sh.page_lo] = buf

    def flat_offset(self, replica: int) -> int:
        """What turns a flat (page*ps + offset) index local to
        ``replica``'s page range (the scheduler's ``write_idx``) into an
        index into this rank's page tensors."""
        return (replica * self.pages_per_replica
                - self.shard.page_lo) * self.page_size

    def local_positions(self, seq_ids: Sequence[int], seg_ids: np.ndarray,
                        positions: np.ndarray) -> np.ndarray:
        """Each token's position in its slot's row of :meth:
        `device_tables`: the position itself, except on a
        context-parallel rank, whose rows list only the pages it holds:
        there it is the count of held keys at positions <= the token's,
        minus one (-1: the rank holds none of them, and padding).  Keys
        keep their order, so a token's visible held keys are a prefix of
        the compacted row.  ``seq_ids`` are the slots' sequence ids (the
        rows' order), ``seg_ids`` each token's slot (< 0: padding)."""
        seg = np.asarray(seg_ids)
        pos = np.asarray(positions)
        if self.shard.mode != "pages":
            return pos.astype(np.int32)
        ps, sh = self.page_size, self.shard
        width = max((len(self.tables[s]) for s in seq_ids if s >= 0),
                    default=0) + 1
        held = np.zeros((len(seq_ids), width), bool)
        for i, sid in enumerate(seq_ids):
            if sid >= 0:
                t = np.asarray(self.tables[sid], np.int64)
                held[i, :len(t)] = (t >= sh.page_lo) & (t < sh.page_hi)
        before = np.concatenate([np.zeros((len(seq_ids), 1), np.int64),
                                 np.cumsum(held, axis=1)], axis=1)
        slot = np.clip(seg, 0, len(seq_ids) - 1)
        col = np.clip(pos // ps, 0, width - 1)
        out = before[slot, col] * ps + np.where(held[slot, col],
                                                pos % ps + 1, 0) - 1
        return np.where(seg >= 0, out, -1).astype(np.int32)

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
        """Write (n, Hkv, hd) K/V rows at global flat slots ``idx`` of one
        layer, in place (the rows, and heads, this rank holds); an
        int8/fp8 pool stores codes and, at the same flat slots, their
        scales."""
        sh, ps = self.shard, self.page_size
        npg, nh = sh.n_pages, sh.n_heads
        idx = idx.to(self.device) - sh.page_lo * ps
        keep = (idx >= 0) & (idx < npg * ps)
        idx = idx[keep]
        k = k.to(self.device)[keep][:, sh.head_lo:sh.head_hi]
        v = v.to(self.device)[keep][:, sh.head_lo:sh.head_hi]
        kf = self.k[layer].view(npg * ps, nh, self.head_dim)
        vf = self.v[layer].view(npg * ps, nh, self.head_dim)
        if self.quant_mode is None:
            kf[idx] = k.to(kf.dtype)
            vf[idx] = v.to(vf.dtype)
            return
        kq, k_sc = quant.quantize(k, self.quant_mode)
        vq, v_sc = quant.quantize(v, self.quant_mode)
        kf[idx] = kq
        vf[idx] = vq
        self.k_scale[layer].view(npg * ps, nh)[idx] = k_sc
        self.v_scale[layer].view(npg * ps, nh)[idx] = v_sc

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
        sh = self.shard
        held = torch.from_numpy((tables >= sh.page_lo)
                                & (tables < sh.page_hi)).to(self.device)
        idx = torch.from_numpy(tables - sh.page_lo).to(self.device)
        idx = torch.where(held, idx, torch.zeros_like(idx))   # (B, P)
        k = self.k[layer][idx]                          # (B, P, ps, Hkv, hd)
        v = self.v[layer][idx]
        if self.quant_mode is not None:
            k = quant.dequantize(k, self.k_scale[layer][idx])
            v = quant.dequantize(v, self.v_scale[layer][idx])
        if self.mesh is not None:
            k, v = (self._sum_parts(x, held) for x in (k, v))
        b = len(seq_ids)
        shape = (b, max_pages * self.page_size, self.n_kv_heads,
                 self.head_dim)
        k = k.reshape(shape)[:, :pad_to].transpose(1, 2).contiguous()
        v = v.reshape(shape)[:, :pad_to].transpose(1, 2).contiguous()
        lens = torch.tensor([self.lengths[s] for s in seq_ids],
                            dtype=torch.int32, device=self.device)
        return k, v, lens

    def _sum_parts(self, x: torch.Tensor, held: torch.Tensor
                   ) -> torch.Tensor:
        """The full (B, P, ps, Hkv, hd) gather from every rank's part:
        each rank contributes the pages and heads it holds (one model
        rank of a ``"full"`` replica), zeros elsewhere, summed in fp32
        over the model and then the data group (exact: one part is
        nonzero at each element)."""
        sh = self.shard
        full = torch.zeros(x.shape[:3] + (self.n_kv_heads,) + x.shape[4:],
                           dtype=torch.float32, device=x.device)
        if sh.mode != "full" or sh.model_rank == 0:
            full[:, :, :, sh.head_lo:sh.head_hi] = torch.where(
                held[:, :, None, None, None], x.float(),
                torch.zeros((), device=x.device))
        for group in (sh.model_group, sh.data_group):
            if group is not None:
                C.all_reduce_sum(full, group)
        return full.to(x.dtype)

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
        mirror.  On a mesh of R > 1 replicas the rank's mirror holds its
        own replica's S = len(seq_ids) / R rows (:meth:`_device_row`)."""
        if self.mesh is not None and self.n_replicas > 1:
            s_r = len(seq_ids) // self.n_replicas
            r = self.shard.replica
            seq_ids = list(seq_ids)[r * s_r:(r + 1) * s_r]
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
        """A sequence's block-table row as the device sees it: ids into
        this rank's page tensors (global ids without a mesh); a
        context-parallel rank lists only the pages it holds, in table
        order.  A page id outside them (a corrupted host table, which the
        watchdog catches after the step) goes up as page 0, so no kernel
        reads outside the page tensors.  The reference's gathers clamp
        or fill such ids instead."""
        sh = self.shard
        table = self.tables[sid]
        if sh.mode == "pages":
            table = [p for p in table if sh.holds(p)]
        return [p - sh.page_lo if sh.holds(p) else 0 for p in table[:width]]

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
        sh = self.shard
        # this rank's tensors: its pages, of its heads
        local_bytes = (page_bytes * sh.n_pages * sh.n_heads
                       // self.n_kv_heads)
        return {
            "pages_total": self.pool.num_pages,
            "pages_used": used,
            "pages_free": self.pool.num_free,
            "page_bytes": page_bytes,
            "kv_dtype": self.kv_dtype_name,
            "bytes_used": used * page_bytes,
            "kv_bytes": local_bytes,
            "page_hwm": self.pool.stats.page_hwm,
            "page_hwm_per_replica": list(self.pool.page_hwm_per_replica),
            "prefix_hit_rate": self.pool.stats.hit_rate,
            "cow_copies": self.pool.stats.cow_copies,
            "oom_rejections": self.pool.stats.oom_rejections,
        }
