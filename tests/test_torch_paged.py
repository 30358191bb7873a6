"""The paged-attention kernel's decomposition, which both its main
kernels run (bf16 q on the tensor cores, fp32 q on the CUDA cores): query
tiles of same-slot tokens, key splits, and the combine of the splits.

On the CPU the work list comes from ``paged_tiles_plain`` (the kernel's
pre-pass in plain PyTorch) and :func:`tiled_attention` computes attention
from it the kernel's way: tile by tile and split by split, each split's
(m, l, unnormalised O), then the merge in split order, with the
probabilities rounded to bf16 before the PV product at bf16 and the K / V
scales of a quantized pool applied to scores and probabilities.  That is
held against ``paged_attention_plain`` and, at fp32, the JAX reference
(``repro.kernels.ref.paged_attention``, and the Pallas kernel in
interpret mode) at the 1e-5 kernel tier (2e-3 over 1024 keys or more).
On the card (``requires_cuda``) the kernel itself is held against the
plain version, its device pre-pass against ``paged_tiles_plain``, two
calls against each other bit for bit, and an fp32 token's row alone
against the same token inside a mixed batch, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serving import quant as jquant
from repro_torch.kernels import decode_attention as DA
from repro_torch.serving import quant as tquant
from torch_port_helpers import cuda_device, requires_cuda, \
    strided_operands, to_numpy, \
    to_torch  # noqa: F401  (cuda_device is the fixture requires_cuda uses)

TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 q: the decomposition and the plain version round probabilities
# (unnormalised against normalised) and dequantized pages at different
# places: one bf16 step of O(1) outputs, as chip_smoke.py's PAGED_TOL
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
NEG_INF = -1e30


def tiled_attention(q, kp, vp, tables, seg, pos, *, scale, window,
                    tile_tokens, split_keys, k_scale=None, v_scale=None):
    """Paged attention from the kernel's work list, the kernel's way.
    q (T, Hkv, G, D) fp32 or bf16; a bf16 q rounds each split's
    unnormalised probabilities (times the V scales of a quantized pool)
    to bf16 before the PV product.  Returns (T, Hkv, G, D) in q's dtype."""
    t, hkv, g, d = q.shape
    n, ps = kp.shape[:2]
    tiles = DA.paged_tiles_plain(seg, pos, tables.shape, ps, tile_tokens,
                                 split_keys, window)
    kf = kp.float().reshape(n * ps, hkv, d)
    vf = vp.float().reshape(n * ps, hkv, d)
    out = torch.full((t, hkv, g, d), float("nan"))
    for first, count, slot, lo, hi, splits, _, _ in tiles.tolist():
        toks = torch.arange(first, first + count)
        qt = q[toks].float()
        p_t = pos[toks].long()
        parts = []
        for s in range(splits):
            keys = torch.arange(lo + s * split_keys,
                                min(hi, lo + (s + 1) * split_keys))
            rows = tables[slot, keys // ps].long() * ps + keys % ps
            sc = torch.einsum("chgd,khd->chgk", qt, kf[rows])
            if k_scale is not None:
                sc = sc * k_scale.reshape(n * ps, hkv)[rows].T[None, :,
                                                               None, :]
            sc = sc * scale
            ok = keys[None, :] <= p_t[:, None]
            if window:
                ok = ok & (keys[None, :] > p_t[:, None] - window)
            ok = ok[:, None, None, :]
            sc = torch.where(ok, sc, torch.tensor(NEG_INF))
            m = torch.full(sc.shape[:-1], NEG_INF)
            if keys.numel():
                m = torch.maximum(m, sc.amax(-1))
            p = torch.where(ok, torch.exp(sc - m[..., None]),
                            torch.tensor(0.0))
            pv = p
            if v_scale is not None:
                pv = pv * v_scale.reshape(n * ps, hkv)[rows].T[None, :,
                                                               None, :]
            if q.dtype == torch.bfloat16:
                pv = pv.to(torch.bfloat16).float()
            parts.append((m, p.sum(-1),
                          torch.einsum("chgk,khd->chgd", pv, vf[rows])))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        lsum = sum(l * torch.exp(m - mx) for m, l, _ in parts)
        acc = sum(o * torch.exp(m - mx)[..., None] for m, _, o in parts)
        out[toks] = acc / lsum.clamp(min=1e-30)[..., None]
    return out.to(q.dtype)


def pool_case(rng, n_pages, ps, hkv, d, pool):
    """K/V pages from a seed: fp32 (or bf16), or the reference's own int8
    / fp8 codes and scales."""
    kp = rng.standard_normal((n_pages, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, hkv, d)).astype(np.float32)
    ksc = vsc = None
    if pool in ("int8", "fp8_e4m3"):
        kp, ksc = (np.asarray(a) for a in jquant.quantize(jnp.asarray(kp),
                                                          pool))
        vp, vsc = (np.asarray(a) for a in jquant.quantize(jnp.asarray(vp),
                                                          pool))
    return kp, vp, ksc, vsc


# layouts: (name, seg, pos, tables (S, P), ps, window).  "reference" is
# tests/test_torch_kernels.py's mixed batch (a prefill chunk, a fresh
# prefill start, decode tokens, padding); "shared_prefix" the reference's
# ragged tables with two slots sharing pages (ps 8); the rest each hold
# one case of the decomposition.
def layouts(rng):
    ref_tables = rng.permutation(24)[:12].reshape(3, 4)
    shared = np.zeros((4, 4), np.int64)
    shared[0, :1] = [5]
    shared[1, :4] = [7, 9, 11, 13]
    shared[2, :3] = [7, 9, 2]
    shared[3, :1] = [17]
    wide = rng.permutation(40)[:32].reshape(4, 8)
    return {
        "reference": ([0, 0, 1, 2, 2, 2, -1], [3, 4, 0, 10, 14, 15, 0],
                      ref_tables, 4, None),
        "reference_window": ([0, 0, 1, 2, 2, 2, -1],
                             [3, 4, 0, 10, 14, 15, 0], ref_tables, 4, 6),
        "shared_prefix": ([0, 1, 2, 3], [2, 29, 20, 0], shared, 8, None),
        # a run of slot 0 then slot 1 inside what would be one M-token
        # tile: the tile is cut where the slot changes
        "straddle": ([0, 0, 0, 1, 1, 1, 1], [9, 10, 11, 4, 5, 6, 7], wide,
                     4, None),
        # same-slot tokens that are not neighbours: one tile each
        "not_adjacent": ([0, 1, 0, 1, 0], [12, 20, 13, 21, 14], wide, 4,
                         None),
        # one tile (positions 20 and 30, window 4) whose first split
        # (keys 17-24 at 8 keys a split) holds no key visible to the
        # token at 30
        "window_empties_split": ([2, 2], [20, 30], wide, 4, 4),
        # one slot with more tokens than a tile holds, then padding
        "long_run": ([3] * 11 + [-1, -1], list(range(5, 16)) + [0, 0],
                     wide, 4, None),
    }


def case(layout, pool, hkv=2, g=2, d=16, seed=7):
    rng = np.random.default_rng(seed)
    seg, pos, tables, ps, window = layouts(rng)[layout]
    kp, vp, ksc, vsc = pool_case(rng, 40, ps, hkv, d, pool)
    q = rng.standard_normal((len(seg), hkv * g, d)).astype(np.float32)
    return (q, kp, vp, ksc, vsc, np.asarray(tables, np.int32),
            np.asarray(seg, np.int32), np.asarray(pos, np.int32), window)


# (tile tokens, split keys): the kernel's own at G = 2 (64 rows / G, 128
# keys a split; ``DA.tiling`` reads them from the source on the card), and
# small ones that cut these short sequences into several tiles and splits
TILINGS = ((32, 128), (2, 8), (3, 4))


def _tiled(q, kp, vp, ksc, vsc, tables, seg, pos, window, tiling, hkv,
           dtype=torch.float32):
    t = lambda a: None if a is None else to_torch(a)  # noqa: E731
    qt = t(q).reshape(q.shape[0], hkv, -1, q.shape[-1]).to(dtype)
    kk, vv = t(kp), t(vp)
    if ksc is None:
        kk, vv = kk.to(dtype), vv.to(dtype)
    return tiled_attention(qt, kk, vv, t(tables), t(seg), t(pos),
                           scale=q.shape[-1] ** -0.5, window=window,
                           tile_tokens=tiling[0], split_keys=tiling[1],
                           k_scale=t(ksc), v_scale=t(vsc))


@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("layout", ["reference", "reference_window",
                                    "shared_prefix", "straddle",
                                    "not_adjacent", "window_empties_split",
                                    "long_run"])
def test_tiled_matches_plain_and_jax_ref_fp32(layout, tiling):
    q, kp, vp, ksc, vsc, tables, seg, pos, window = case(layout, "fp32")
    out = _tiled(q, kp, vp, ksc, vsc, tables, seg, pos, window, tiling, 2)
    t = to_torch
    plain = DA.paged_attention_plain(
        t(q).reshape(len(seg), 2, 2, 16), t(kp), t(vp), t(tables), t(seg),
        t(pos), scale=16 ** -0.5, window=window)
    live = seg >= 0
    np.testing.assert_allclose(to_numpy(out)[live], to_numpy(plain)[live],
                               **TOL)
    exp = np.asarray(jref.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(seg), jnp.asarray(pos),
        window=window)).reshape(out.shape)
    np.testing.assert_allclose(to_numpy(out)[live], exp[live], **TOL)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("pool", ["int8", "fp8_e4m3"])
def test_tiled_quantized_scales_match_jax_ref_and_pallas(pool, window):
    """K scales on the scores, V scales on the probabilities: the
    reference's dequantize-then-attend at fp32, within 1e-5."""
    q, kp, vp, ksc, vsc, tables, seg, pos, _ = case("reference", pool)
    out = _tiled(q, kp, vp, ksc, vsc, tables, seg, pos, window, (2, 8), 2)
    j = jnp.asarray
    args = (j(q), j(kp), j(vp), j(tables), j(seg), j(pos))
    kw = dict(window=window, k_scale=j(ksc), v_scale=j(vsc))
    live = seg >= 0
    exp = np.asarray(jref.paged_attention(*args, **kw)).reshape(out.shape)
    np.testing.assert_allclose(to_numpy(out)[live], exp[live], **TOL)
    exp = np.asarray(jops.paged_attention(*args, **kw)).reshape(out.shape)
    np.testing.assert_allclose(to_numpy(out)[live], exp[live], **TOL)


@pytest.mark.parametrize("pool", ["bf16", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("layout", ["reference_window", "shared_prefix",
                                    "window_empties_split", "long_run"])
def test_tiled_bf16_matches_plain(layout, pool):
    """bf16 q over each pool the bf16 kernel takes, with P rounded to
    bf16 as the kernel rounds it, against the plain version."""
    q, kp, vp, ksc, vsc, tables, seg, pos, window = case(
        layout, "fp32" if pool == "bf16" else pool)
    out = _tiled(q, kp, vp, ksc, vsc, tables, seg, pos, window, (3, 4), 2,
                 dtype=torch.bfloat16)
    t = lambda a: None if a is None else to_torch(a)  # noqa: E731
    qq = t(q).reshape(len(seg), 2, 2, 16).bfloat16()
    kk, vv = t(kp), t(vp)
    if ksc is None:
        kk, vv = kk.bfloat16(), vv.bfloat16()
    plain = DA.paged_attention_plain(qq, kk, vv, t(tables), t(seg), t(pos),
                                     scale=16 ** -0.5, window=window,
                                     k_scale=t(ksc), v_scale=t(vsc))
    live = torch.as_tensor(seg >= 0)
    torch.testing.assert_close(out[live].float(), plain[live].float(),
                               **BF16_TOL)


def _pallas(q, kp, vp, ksc, vsc, tables, seg, pos, window):
    """The reference's Pallas paged kernel (interpret mode on the CPU),
    (T, Hq, D) as numpy."""
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return np.asarray(jops.paged_attention(
        j(q), j(kp), j(vp), j(tables), j(seg), j(pos), window=window,
        k_scale=j(ksc), v_scale=j(vsc)))


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("pool", ["fp32", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("layout", ["reference", "long_run"])
def test_tiled_fp32_pools_match_plain_and_pallas(layout, pool, window):
    """fp32 q over each pool the fp32 ("simt") main kernel takes, at its
    tiling for G = 2 (32 tokens a tile, 128 keys a split) and at a small
    one: the plain version and the Pallas kernel, within 1e-5."""
    q, kp, vp, ksc, vsc, tables, seg, pos, _ = case(layout, pool)
    live = seg >= 0
    t = lambda a: None if a is None else to_torch(a)  # noqa: E731
    plain = DA.paged_attention_plain(
        t(q).reshape(len(seg), 2, 2, 16), t(kp), t(vp), t(tables), t(seg),
        t(pos), scale=16 ** -0.5, window=window, k_scale=t(ksc),
        v_scale=t(vsc))
    exp = _pallas(q, kp, vp, ksc, vsc, tables, seg, pos, window)
    for tiling in ((32, 128), (3, 4)):
        out = _tiled(q, kp, vp, ksc, vsc, tables, seg, pos, window, tiling,
                     2)
        np.testing.assert_allclose(to_numpy(out)[live],
                                   to_numpy(plain)[live], **TOL)
        np.testing.assert_allclose(to_numpy(out).reshape(exp.shape)[live],
                                   exp[live], **TOL)


def long_case(pool, seed=9):
    """A slot of 1152 keys (72 pages of 16) read by a decode token at
    1100, another slot's 4-token chunk at 1022-1025 (across the split
    boundary at key 1024) and padding: splits of 128 keys up to 9 deep."""
    rng = np.random.default_rng(seed)
    tables = rng.permutation(160)[:144].reshape(2, 72).astype(np.int32)
    seg = np.array([0, 1, 1, 1, 1, -1], np.int32)
    pos = np.array([1100, 1022, 1023, 1024, 1025, 0], np.int32)
    kp, vp, ksc, vsc = pool_case(rng, 160, 16, 1, 16, pool)
    q = rng.standard_normal((6, 2, 16)).astype(np.float32)
    return q, kp, vp, ksc, vsc, tables, seg, pos


@pytest.mark.parametrize("pool", ["fp32", "int8"])
def test_tiled_fp32_over_1024_keys_matches_plain_and_pallas(pool):
    """Over 1024 keys the reference's tier is 2e-3 (a long fp32
    reduction in another order)."""
    q, kp, vp, ksc, vsc, tables, seg, pos = long_case(pool)
    live = seg >= 0
    t = lambda a: None if a is None else to_torch(a)  # noqa: E731
    out = tiled_attention(
        t(q).reshape(6, 1, 2, 16), t(kp), t(vp), t(tables), t(seg), t(pos),
        scale=0.25, window=None, tile_tokens=32, split_keys=128,
        k_scale=t(ksc), v_scale=t(vsc))
    plain = DA.paged_attention_plain(
        t(q).reshape(6, 1, 2, 16), t(kp), t(vp), t(tables), t(seg), t(pos),
        scale=0.25, k_scale=t(ksc), v_scale=t(vsc))
    tol = dict(rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(to_numpy(out)[live], to_numpy(plain)[live],
                               **tol)
    exp = _pallas(q, kp, vp, ksc, vsc, tables, seg, pos, None)
    np.testing.assert_allclose(to_numpy(out).reshape(exp.shape)[live],
                               exp[live], **tol)


def test_a_tokens_splits_do_not_depend_on_its_tile_mates():
    """Without a window a tile's splits start at key 0 in multiples of
    the split size, whatever its other tokens: a token sees the same key
    ranges alone as inside a mixed batch (where its tile-mates reach
    further), and the batch's extra splits hold no key it can see.  So
    the merge adds exact zeros and its row is the same: bit for bit on
    the card (test_cuda_paged_simt_row_is_independent_of_its_batch);
    here, where the decomposition's products are batched einsums, to
    1e-6."""
    q, kp, vp, ksc, vsc, tables, seg, pos = long_case("fp32")
    t = lambda a: None if a is None else to_torch(a)  # noqa: E731
    kw = dict(scale=0.25, window=None, tile_tokens=32, split_keys=128)
    args = (t(kp), t(vp), t(tables))
    batch = tiled_attention(t(q).reshape(6, 1, 2, 16), *args, t(seg),
                            t(pos), **kw)
    tiles = DA.paged_tiles_plain(t(seg), t(pos), tables.shape, 16, 32, 128)
    for i in (1, 2):  # chunk tokens that share a tile with later ones
        alone_tiles = DA.paged_tiles_plain(t(seg[i:i + 1]), t(pos[i:i + 1]),
                                           tables.shape, 16, 32, 128)
        (_, _, _, lo, hi, n, _, _), = alone_tiles.tolist()
        (row,) = [r for r in tiles.tolist() if r[0] <= i < r[0] + r[1]]
        assert lo == row[3] == 0 and row[4] > hi and row[5] == n + 1
        # the batch's split past the token's own begins after its position
        assert n * 128 > pos[i]
        alone = tiled_attention(t(q[i:i + 1]).reshape(1, 1, 2, 16), *args,
                                t(seg[i:i + 1]), t(pos[i:i + 1]), **kw)
        np.testing.assert_allclose(to_numpy(alone)[0],
                                   to_numpy(batch)[i], rtol=0, atol=1e-6)


def _tiles(layout, m, ks):
    _, _, _, _, _, tables, seg, pos, window = case(layout, "fp32")
    ps = {"shared_prefix": 8}.get(layout, 4)
    return DA.paged_tiles_plain(torch.as_tensor(seg), torch.as_tensor(pos),
                                tables.shape, ps, m, ks, window).tolist()


def test_tiles_cut_where_the_slot_changes():
    assert _tiles("straddle", 4, 32) == [
        [0, 3, 0, 0, 12, 1, 9, 11], [3, 4, 1, 0, 8, 1, 4, 7]]


def test_tiles_of_same_slot_tokens_that_are_not_neighbours():
    rows = _tiles("not_adjacent", 4, 32)
    assert [r[:3] for r in rows] == [[0, 1, 0], [1, 1, 1], [2, 1, 0],
                                     [3, 1, 1], [4, 1, 0]]


def test_tiles_window_and_splits():
    # keys [17, 31) in splits of 8: [17, 25) and [25, 31)
    assert _tiles("window_empties_split", 4, 8) == [
        [0, 2, 2, 17, 31, 2, 20, 30]]


def test_tiles_cut_a_long_run_every_m_tokens():
    rows = _tiles("long_run", 4, 32)
    # 11 tokens of slot 3 in tiles of 4, 4 and 3; padding is slot 0 at
    # its own position
    assert [r[:3] for r in rows] == [[0, 4, 3], [4, 4, 3], [8, 3, 3],
                                     [11, 2, 0]]
    assert rows[-1][3:] == [0, 1, 1, 0, 0]


def test_tiles_clip_to_the_table_width_and_cover_every_token():
    seg = torch.tensor([0, 1, -1, 5], dtype=torch.int32)
    pos = torch.tensor([100, 3, 0, 7], dtype=torch.int32)
    rows = DA.paged_tiles_plain(seg, pos, (2, 4), 4, 8, 32).tolist()
    # slot 0 at position 100 sees the 16 keys of its 4 pages; seg 5 clips
    # to slot 1, and joins nothing since slot 0's padding sits between
    assert rows == [[0, 1, 0, 0, 16, 1, 100, 100],
                    [1, 1, 1, 0, 4, 1, 3, 3],
                    [2, 1, 0, 0, 1, 1, 0, 0],
                    [3, 1, 1, 0, 8, 1, 7, 7]]
    assert sum(r[1] for r in rows) == 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tiles_cover_every_token_with_its_key_range(seed):
    """Random runs of segment ids: the tiles cover the tokens in order,
    each holds one clipped slot and at most M tokens, and its key range
    and splits are those of its tokens' positions."""
    gen = torch.Generator().manual_seed(seed)
    t, m, ks, ps, window = 200, 5, 16, 4, 9 if seed else None
    ids = torch.randint(-1, 5, (t,), generator=gen)
    seg = ids.repeat_interleave(torch.randint(1, 9, (t,), generator=gen))
    seg = seg[:t].to(torch.int32)
    pos = torch.randint(0, 60, (t,), generator=gen).to(torch.int32)
    rows = DA.paged_tiles_plain(seg, pos, (4, 12), ps, m, ks,
                                window).tolist()
    slots = seg.long().clamp(0, 3)
    nxt = 0
    for first, count, slot, lo, hi, splits, lo_pos, hi_pos in rows:
        assert first == nxt and 1 <= count <= m
        nxt = first + count
        toks = slice(first, nxt)
        assert (slots[toks] == slot).all()
        assert (lo_pos, hi_pos) == (int(pos[toks].min()),
                                    int(pos[toks].max()))
        assert lo == (max(0, lo_pos - window + 1) if window else 0)
        assert hi == max(lo, min(hi_pos + 1, 12 * ps))
        assert splits == max(1, -(-(hi - lo) // ks))
    assert nxt == t


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

def serving_layout(gen, n_slots, chunk, n_pad, max_len, ps, p_pages):
    """The executor's layout: two slots run a prefill chunk of ``chunk``
    tokens at consecutive positions, the rest one decode token each, then
    padding.  Returns seg, pos (lists) and tables (S, P)."""
    lens = torch.randint(chunk + 1, max_len + 1, (n_slots,),
                         generator=gen).tolist()
    perm = torch.randperm(n_slots * p_pages + 8, generator=gen)
    tables = perm[:n_slots * p_pages].reshape(n_slots, p_pages)
    seg, pos = [], []
    for slot, n in enumerate(lens):
        first = n - chunk if slot < 2 else n - 1
        seg += [slot] * (n - first)
        pos += list(range(first, n))
    seg += [-1] * n_pad
    pos += [0] * n_pad
    return seg, pos, tables.to(torch.int32)


def card_case(dev, pool, ps, d=128, hkv=2, g=8, max_len=300, chunk=21,
              seed=3, q_dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(seed)
    p_pages = -(-max_len // ps)
    seg, pos, tables = serving_layout(gen, 6, chunk, 5, max_len, ps,
                                      p_pages)
    n_pages = 6 * p_pages + 8
    k32 = torch.randn((n_pages, ps, hkv, d), generator=gen)
    v32 = torch.randn((n_pages, ps, hkv, d), generator=gen)
    q = torch.randn((len(seg), hkv, g, d), generator=gen)
    if pool in ("bf16", "fp32"):
        kp, vp, ksc, vsc = (k32.to(q_dtype), v32.to(q_dtype), None, None)
    else:
        kp, ksc = tquant.quantize(k32, pool)
        vp, vsc = tquant.quantize(v32, pool)
    move = lambda a: None if a is None else a.to(dev)  # noqa: E731
    return dict(q=q.to(q_dtype).to(dev), kp=move(kp), vp=move(vp),
                ksc=move(ksc), vsc=move(vsc), tables=tables.to(dev),
                seg=torch.tensor(seg, dtype=torch.int32, device=dev),
                pos=torch.tensor(pos, dtype=torch.int32, device=dev))


def _run(x, fn, window=None):
    return fn(x["q"], x["kp"], x["vp"], x["tables"], x["seg"], x["pos"],
              scale=x["q"].shape[-1] ** -0.5, window=window,
              k_scale=x["ksc"], v_scale=x["vsc"])


@requires_cuda
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("ps", [4, 8, 16])
@pytest.mark.parametrize("pool", ["bf16", "int8", "fp8_e4m3"])
def test_cuda_paged_mma_matches_plain(cuda_device, pool, ps, window):
    """bf16 q over each pool and page size, in the serving layout, with
    sequences of up to 300 keys: up to 3 splits of 128 keys."""
    x = card_case(cuda_device, pool, ps)
    before = DA.counter.launches
    out = _run(x, DA.paged_attention_fwd, window)
    torch.cuda.synchronize()
    assert DA.counter.launches == before + 1
    assert DA.last_launch()["device_launches"] == 3
    if window is None:  # some sequence is cut into several splits
        tiles = DA.paged_tiles(x["seg"], x["pos"], x["tables"].shape, ps, 8)
        assert int(tiles[:, 5].max()) > 1
    ref = _run(x, DA.paged_attention_plain, window)
    live = x["seg"] >= 0
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               **BF16_TOL)


@requires_cuda
@pytest.mark.parametrize("q_dtype,pool", [(torch.bfloat16, "int8"),
                                          (torch.float32, "fp32")])
def test_cuda_paged_kernel_copies_a_strided_query(cuda_device, q_dtype,
                                                  pool):
    """q at an odd element offset or transposed: the wrapper copies it and
    gives the contiguous call's bits; a page pool that is not contiguous
    is still refused (the pools are single-owner and never copied)."""
    x = card_case(cuda_device, pool, 16, q_dtype=q_dtype)
    want = _run(x, DA.paged_attention_fwd)
    for view in strided_operands(x["q"]):
        before = DA.counter.launches
        got = _run({**x, "q": view}, DA.paged_attention_fwd)
        assert DA.counter.launches == before + 1
        assert got.is_contiguous() and torch.equal(got, want)
    with pytest.raises(ValueError, match="contiguous"):
        _run({**x, "kp": strided_operands(x["kp"])[1]},
             DA.paged_attention_fwd)


@requires_cuda
@pytest.mark.parametrize("d", [16, 32, 64, 256])
def test_cuda_paged_mma_head_dims(cuda_device, d):
    x = card_case(cuda_device, "bf16", 16, d=d, hkv=1, g=4)
    out = _run(x, DA.paged_attention_fwd)
    ref = _run(x, DA.paged_attention_plain)
    live = x["seg"] >= 0
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               **BF16_TOL)


@requires_cuda
@pytest.mark.parametrize("g", [1, 3, 128])
def test_cuda_paged_mma_group_sizes(cuda_device, g):
    """Tiles of 64 tokens (G = 1), of rows that do not fill a warp (G =
    3), and one token's heads cut into two 64-row blocks (G = 128)."""
    x = card_case(cuda_device, "int8", 8, d=64, hkv=1, g=g, chunk=70,
                  max_len=200)
    out = _run(x, DA.paged_attention_fwd)
    ref = _run(x, DA.paged_attention_plain)
    live = x["seg"] >= 0
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               **BF16_TOL)


@requires_cuda
def test_cuda_paged_mma_serving_shape_and_determinism(cuda_device):
    """gemma-2b's attention (G = 8, D = 256, ps 16) at serving's 1024-key
    cap: tiles of 8 tokens, several splits, every call the same bits."""
    x = card_case(cuda_device, "bf16", 16, d=256, hkv=1, g=8,
                  max_len=1024, chunk=100)
    tiles = DA.paged_tiles(x["seg"], x["pos"], x["tables"].shape, 16, 8)
    assert int(tiles[:, 1].max()) == 8 and int(tiles[:, 5].max()) > 1
    a = _run(x, DA.paged_attention_fwd)
    b = _run(x, DA.paged_attention_fwd)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    ref = _run(x, DA.paged_attention_plain)
    live = x["seg"] >= 0
    torch.testing.assert_close(a[live].float(), ref[live].float(),
                               **BF16_TOL)


@requires_cuda
@pytest.mark.parametrize("window", [None, 37])
@pytest.mark.parametrize("t", [7, 1024, 2600])
def test_cuda_prepass_matches_plain(cuda_device, t, window):
    """The device pre-pass's work list equals paged_tiles_plain's at the
    kernel's tiling, for T of one chunk of its block and of several (the
    scans' carries), at G = 8 (8-token tiles) and G = 3 (21)."""
    gen = torch.Generator().manual_seed(t)
    # runs of 1-20 tokens of one segment id (-1: padding), ids clipped
    # to the 4 slots of the table
    ids = torch.randint(-1, 6, (t,), generator=gen)
    lens = torch.randint(1, 21, (t,), generator=gen)
    seg = ids.repeat_interleave(lens)[:t].to(torch.int32)
    pos = torch.randint(0, 500, (t,), generator=gen).to(torch.int32)
    for g in (8, 3):
        tiling = DA.tiling(g, 20, 16)
        assert tiling["tile_tokens"] == 64 // g
        want = DA.paged_tiles_plain(seg, pos, (4, 20), 16,
                                    tiling["tile_tokens"],
                                    tiling["split_keys"], window)
        got = DA.paged_tiles(seg.to(cuda_device), pos.to(cuda_device),
                             (4, 20), 16, g, window)
        assert torch.equal(got.cpu(), want)


def first_design_smem(g, d, ps):
    """Shared bytes of the first fp32 kernel's block (a (ps, D) K and V
    page and the group's rows), which refused a page size past 232448."""
    return 4 * (2 * ps * d + 2 * g * d + g * ps + 3 * g)


def refused_page_size(g, d):
    """The smallest power-of-two page size the first fp32 kernel
    refused."""
    ps = 16
    while first_design_smem(g, d, ps) <= 232448:
        ps *= 2
    return ps


@requires_cuda
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("pool", ["fp32", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_cuda_paged_simt_matches_plain(cuda_device, d, g, pool, window):
    """fp32 q over each pool the CUDA-core main kernel takes, in the
    serving layout with sequences of up to 300 keys (up to 3 splits), at
    a page size the first fp32 kernel refused: within 1e-5, the three
    launches recorded."""
    ps = refused_page_size(g, d)
    x = card_case(cuda_device, pool, ps, d=d, g=g, q_dtype=torch.float32)
    before = DA.counter.launches
    out = _run(x, DA.paged_attention_fwd, window)
    torch.cuda.synchronize()
    assert DA.counter.launches == before + 1
    rec = DA.last_launch()
    assert rec["device_launches"] == 3 and rec["prepass_blocks"] == 1
    ref = _run(x, DA.paged_attention_plain, window)
    live = x["seg"] >= 0
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out[live], ref[live], **TOL)


@requires_cuda
@pytest.mark.parametrize("pool", ["fp32", "int8"])
def test_cuda_paged_simt_row_is_independent_of_its_batch(cuda_device,
                                                         pool):
    """gemma-2b's attention (G = 8, D = 256, ps 16) in the serving layout
    at its 1024-key cap: a token's row run alone is bit for bit its row
    inside the mixed batch, where its tile-mates reach further and its
    tile has more splits (what lets speculation at fp32 equal spec_k=0)."""
    x = card_case(cuda_device, pool, 16, d=256, hkv=1, g=8, max_len=1024,
                  chunk=100, q_dtype=torch.float32)
    full = _run(x, DA.paged_attention_fwd)
    n_live = int((x["seg"] >= 0).sum())
    for i in (0, 3, 57, 99, 100, n_live - 1):
        one = {**x, "q": x["q"][i:i + 1].contiguous(),
               "seg": x["seg"][i:i + 1].contiguous(),
               "pos": x["pos"][i:i + 1].contiguous()}
        alone = _run(one, DA.paged_attention_fwd)
        torch.cuda.synchronize()
        assert torch.equal(alone[0], full[i]), i


@requires_cuda
@pytest.mark.parametrize("d", [16, 256])
@pytest.mark.parametrize("pool", [torch.float32, torch.int8,
                                  torch.float8_e4m3fn])
def test_cuda_paged_simt_attributes(cuda_device, pool, d):
    """The CUDA-core main kernel: 256 threads, 32-key tiles, no spill
    (at D = 256 its O is 64 registers a lane), and its shared memory
    within a block's."""
    a = DA.kernel_attributes(torch.float32, pool, d)
    assert a["variant"] == "simt" and a["threads"] == 256
    assert a["spill_bytes"] == 0 and a["blocks_per_sm"] >= 1
    assert a["key_tile"] == 32 and 0 < a["smem_bytes"] <= 232448


@requires_cuda
@pytest.mark.parametrize("pool", [torch.bfloat16, torch.int8])
def test_cuda_paged_kernel_attributes(cuda_device, pool):
    """The D = 256 budget the source note rests on: no spill, two blocks
    an SM, 32-key tiles."""
    a = DA.kernel_attributes(torch.bfloat16, pool, 256)
    assert a["variant"] == "mma" and a["threads"] == 128
    assert a["spill_bytes"] == 0 and a["blocks_per_sm"] >= 2
    assert a["key_tile"] == 32 and a["smem_bytes"] > 0
    assert DA.kernel_attributes(torch.float32, torch.float32,
                                256)["variant"] == "simt"


# ----------------------------------------------------------------------
# the log-sum-exp output (the context-parallel merge's input)
# ----------------------------------------------------------------------

LSE_RTOL = 1e-5


def _run_lse(x, fn, window=None):
    return fn(x["q"], x["kp"], x["vp"], x["tables"], x["seg"], x["pos"],
              scale=x["q"].shape[-1] ** -0.5, window=window,
              k_scale=x["ksc"], v_scale=x["vsc"], return_lse=True)


@requires_cuda
@pytest.mark.parametrize("q_dtype,pool", [(torch.bfloat16, "bf16"),
                                          (torch.float32, "fp32")])
@pytest.mark.parametrize("max_len", [100, 300])
def test_cuda_paged_lse_matches_plain(cuda_device, q_dtype, pool, max_len):
    """The kernel's lse (written at the one-split end, or by the combine
    when a row has several splits) within 1e-5 relative of the plain
    version's ``logsumexp``; its output the bits of a call without lse;
    a token that sees no key (position -1) gets -inf."""
    x = card_case(cuda_device, pool, 16, d=256, hkv=1, g=8,
                  max_len=max_len, chunk=40, q_dtype=q_dtype)
    x["pos"][-6] = -1                      # a live token with no key
    before = DA.counter.launches
    out, lse = _run_lse(x, DA.paged_attention_fwd)
    plain = _run(x, DA.paged_attention_fwd)
    torch.cuda.synchronize()
    assert DA.counter.launches == before + 2
    assert lse.shape == out.shape[:3] and lse.dtype == torch.float32
    assert torch.equal(out, plain)
    _, ref = _run_lse(x, DA.paged_attention_plain)
    live = (x["seg"] >= 0) & (x["pos"] >= 0)
    torch.testing.assert_close(lse[live], ref[live], rtol=LSE_RTOL, atol=0)
    assert bool(torch.isneginf(lse[-6]).all())
    if max_len > 128:
        tiles = DA.paged_tiles(x["seg"], x["pos"], x["tables"].shape, 16, 8)
        assert int(tiles[:, 5].max()) > 1


@requires_cuda
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_cuda_paged_call_without_lse_keeps_its_bits(cuda_device, pool):
    """Asking for the lse changes no bit of the output, at the serving
    layout with splits, for both main kernels."""
    for q_dtype in (torch.bfloat16, torch.float32):
        if pool == "bf16" and q_dtype == torch.float32:
            continue
        x = card_case(cuda_device, pool, 8, q_dtype=q_dtype)
        out, _ = _run_lse(x, DA.paged_attention_fwd)
        assert torch.equal(out, _run(x, DA.paged_attention_fwd))
