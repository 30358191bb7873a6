"""The port's mixed attention (a flat token batch against per-slot
contiguous caches, kernel B2) against the JAX package.

On the CPU the port's wrappers run the plain version; it is held against
``repro.models.attention.mixed_attention(backend="ref")`` (the jnp
oracle) and ``repro.kernels.ops.mixed_attention`` (the Pallas kernel in
interpret mode, as tests/test_serving.py runs it) on the same numpy
inputs: 2e-5 at these small serving shapes in fp32 (docs/kernels.md),
3e-2 (the bf16 tier) in bf16.  Every case holds padding tokens.  The
positions stay below the cache length: a token with no visible key (only
possible when its position is past the cache under a window) gives zeros
from the Pallas and CUDA kernels and a uniform average of V from the jnp
oracle and the plain version, so the two references disagree there.
Cases that hold the CUDA kernel against its plain version need the card
and skip elsewhere.

The bf16 kernel's decomposition (variant "mma": query tiles of same-slot
tokens, key splits, the combine of the splits) is held on the CPU too:
:func:`tiled_mixed_attention` computes attention from the plain work list
(``paged_tiles_plain`` over a table of one page of L keys a slot) tile by
tile and split by split and merges in split order (the paged
decomposition over that table), against
``mixed_attention_plain``, the jnp oracle and the interpret-mode Pallas
kernel (1e-5 at fp32; 1e-2 + 1e-2 |ref| at bf16, where it rounds the
unnormalised probabilities to bf16 as the kernel does).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as JA
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as TA
from test_torch_paged import tiled_attention
from torch_port_helpers import cuda_device, requires_cuda, to_numpy, \
    to_torch  # noqa: F401  (cuda_device is the fixture requires_cuda uses)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# the decomposition against the plain version and the JAX references
TILED_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
             torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


def mixed_case(seed, g, hd, hkv=2, s=3, l=32):
    """A mixed batch over 3 slots: a prefill chunk (slot 0), a fresh
    prefill start (slot 1), decode tokens (slot 2) and two padding tokens
    (seg -1), as tests/test_serving.py's case."""
    rng = np.random.default_rng(seed)
    kc = rng.standard_normal((s, hkv, l, hd)).astype(np.float32)
    vc = rng.standard_normal((s, hkv, l, hd)).astype(np.float32)
    q = rng.standard_normal((9, hkv * g, hd)).astype(np.float32)
    seg = np.array([0, 0, 0, 1, 2, 2, 2, -1, -1], np.int32)
    pos = np.array([3, 4, 5, 0, 10, 11, 31, 0, 0], np.int32)
    return q, kc, vc, seg, pos


def mixed_tiles_plain(seg, pos, n_slots, seq_len, tile_tokens, split_keys,
                      window=None):
    """The bf16 kernel's work list: the paged pre-pass's over a table of
    one page of ``seq_len`` keys a slot."""
    return DA.paged_tiles_plain(seg, pos, (n_slots, 1), seq_len,
                                tile_tokens, split_keys, window)


def tiled_mixed_attention(q, kc, vc, seg, pos, *, scale, window,
                          tile_tokens, split_keys):
    """Mixed attention from the bf16 kernel's work list, the kernel's way:
    the paged decomposition (``test_torch_paged.tiled_attention``: each
    split's (m, l, unnormalised O), probabilities rounded to bf16 before
    the PV product when q is bf16, the merge in split order) over a table
    of one page a slot, slot s's whole cache being page s of L keys.  q
    (T, Hkv, G, D); caches (S, Hkv, L, D).  A token with no visible key
    gets zeros, as the kernel gives.  Returns (T, Hkv, G, D) in q's
    dtype."""
    tables = torch.arange(kc.shape[0], dtype=torch.int32)[:, None]
    return tiled_attention(q, kc.transpose(1, 2), vc.transpose(1, 2), tables,
                           seg, pos, scale=scale, window=window,
                           tile_tokens=tile_tokens, split_keys=split_keys)


# layouts of the decomposition tests: (seg, pos, S, L, window).  Positions
# stay below L (see the module note).
MIXED_LAYOUTS = {
    # tests/test_serving.py's batch: a prefill chunk, a fresh prefill
    # start, decode tokens, padding
    "reference": ([0, 0, 0, 1, 2, 2, 2, -1, -1],
                  [3, 4, 5, 0, 10, 11, 31, 0, 0], 3, 32, None),
    "reference_window": ([0, 0, 0, 1, 2, 2, 2, -1, -1],
                         [3, 4, 5, 0, 10, 11, 31, 0, 0], 3, 32, 4),
    # a run of slot 0 then slot 1 inside what would be one M-token tile
    "straddle": ([0, 0, 0, 1, 1, 1, 1], [9, 10, 11, 4, 5, 6, 7], 2, 16,
                 None),
    # same-slot tokens that are not neighbours: one tile each
    "not_adjacent": ([0, 1, 0, 1, 0], [12, 20, 13, 21, 14], 2, 24, None),
    # one tile (positions 20 and 30, window 4) whose first split (keys
    # 17-24 at 8 keys a split) holds no key the token at 30 sees
    "window_empties_split": ([2, 2], [20, 30], 3, 32, 4),
    # one slot with more tokens than a tile holds, then padding; L = 37
    # is no multiple of a split
    "long_run": ([1] * 11 + [-1, -1], list(range(25, 36)) + [0, 0], 2, 37,
                 None),
}


def layout_case(layout, dtype, hkv=2, g=2, d=16, seed=5):
    seg, pos, s, l, window = MIXED_LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    kc = rng.standard_normal((s, hkv, l, d)).astype(np.float32)
    vc = rng.standard_normal((s, hkv, l, d)).astype(np.float32)
    q = rng.standard_normal((len(seg), hkv, g, d)).astype(np.float32)
    cast = lambda a: to_torch(a).to(dtype)  # noqa: E731
    return (cast(q), cast(kc), cast(vc), torch.tensor(seg, dtype=torch.int32),
            torch.tensor(pos, dtype=torch.int32), window)


# (tile tokens, split keys): the kernel's own at G = 2 (64 rows / G, 128
# keys a split), and small ones that cut these short sequences into
# several tiles and splits
MIXED_TILINGS = ((32, 128), (2, 8), (3, 4))


@pytest.mark.parametrize("tiling", MIXED_TILINGS)
@pytest.mark.parametrize("layout", sorted(MIXED_LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_mixed_matches_plain(dtype, layout, tiling):
    q, kc, vc, seg, pos, window = layout_case(layout, dtype)
    out = tiled_mixed_attention(q, kc, vc, seg, pos, scale=16 ** -0.5,
                                window=window, tile_tokens=tiling[0],
                                split_keys=tiling[1])
    plain = DA.mixed_attention_plain(q, kc, vc, seg, pos, scale=16 ** -0.5,
                                     window=window)
    live = seg >= 0
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out[live].float(), plain[live].float(),
                               **TILED_TOL[dtype])


@pytest.mark.parametrize("tiling", MIXED_TILINGS)
@pytest.mark.parametrize("layout", ["reference", "reference_window",
                                    "long_run", "window_empties_split"])
def test_tiled_mixed_matches_jax_oracle_and_pallas_fp32(layout, tiling):
    """The decomposition against the jnp oracle and the Pallas kernel in
    interpret mode (tests/test_serving.py's way), fp32, 1e-5."""
    q, kc, vc, seg, pos, window = layout_case(layout, torch.float32)
    out = tiled_mixed_attention(q, kc, vc, seg, pos, scale=16 ** -0.5,
                                window=window, tile_tokens=tiling[0],
                                split_keys=tiling[1])
    t, hkv, g, d = q.shape
    args = [jnp.asarray(to_numpy(x)) for x in
            (q.reshape(t, hkv * g, d), kc, vc)]
    args += [jnp.asarray(seg.numpy()), jnp.asarray(pos.numpy())]
    live = (seg >= 0).numpy()
    got = to_numpy(out).reshape(t, hkv * g, d)[live]
    oracle = np.asarray(JA.mixed_attention(*args, window=window,
                                           backend="ref"))
    np.testing.assert_allclose(got, oracle[live], rtol=1e-5, atol=1e-5)
    pallas = np.asarray(jops.mixed_attention(*args, window=window))
    np.testing.assert_allclose(got, pallas[live], rtol=1e-5, atol=1e-5)


def _mixed_tiles(layout, m, ks):
    seg, pos, s, l, window = MIXED_LAYOUTS[layout]
    return mixed_tiles_plain(torch.tensor(seg), torch.tensor(pos), s, l, m,
                             ks, window).tolist()


def test_mixed_tiles_cut_where_the_slot_changes():
    assert _mixed_tiles("straddle", 4, 32) == [
        [0, 3, 0, 0, 12, 1, 9, 11], [3, 4, 1, 0, 8, 1, 4, 7]]


def test_mixed_tiles_cut_a_long_run_every_m_tokens():
    rows = _mixed_tiles("long_run", 4, 8)
    # 11 tokens of slot 1 in tiles of 4, 4 and 3, their keys clipped to
    # L = 37; padding is slot 0 at its own position
    assert [r[:3] for r in rows] == [[0, 4, 1], [4, 4, 1], [8, 3, 1],
                                     [11, 2, 0]]
    assert [r[3:6] for r in rows] == [[0, 29, 4], [0, 33, 5], [0, 36, 5],
                                      [0, 1, 1]]


def test_mixed_tiles_window_narrows_the_key_range():
    # keys [17, 31) in splits of 8: [17, 25) and [25, 31)
    assert _mixed_tiles("window_empties_split", 4, 8) == [
        [0, 2, 2, 17, 31, 2, 20, 30]]


def test_mixed_tiles_clip_to_the_cache_and_cover_every_token():
    seg = torch.tensor([0, 1, -1, 5, 1], dtype=torch.int32)
    pos = torch.tensor([100, 3, 0, 7, 50], dtype=torch.int32)
    rows = mixed_tiles_plain(seg, pos, 2, 20, 8, 8).tolist()
    # slot 0 at position 100 sees the 20 keys of its cache; seg 5 clips to
    # slot 1 and joins the next slot-1 token; padding is slot 0
    assert rows == [[0, 1, 0, 0, 20, 3, 100, 100],
                    [1, 1, 1, 0, 4, 1, 3, 3],
                    [2, 1, 0, 0, 1, 1, 0, 0],
                    [3, 2, 1, 0, 20, 3, 7, 50]]
    assert sum(r[1] for r in rows) == len(seg)
    # under a window, a token past the cache sees no key: an empty range
    rows = mixed_tiles_plain(seg[:1], pos[:1], 2, 20, 8, 8, 6).tolist()
    assert rows == [[0, 1, 0, 95, 95, 1, 100, 100]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixed_tiles_cover_every_token_with_its_key_range(seed):
    """Random runs of segment ids: the tiles cover the tokens in order,
    each holds one clipped slot and at most M tokens, and its key range
    and splits are those of its tokens' positions over L keys."""
    gen = torch.Generator().manual_seed(seed)
    t, m, ks, l, window = 200, 5, 16, 45, 9 if seed else None
    ids = torch.randint(-1, 5, (t,), generator=gen)
    seg = ids.repeat_interleave(torch.randint(1, 9, (t,), generator=gen))
    seg = seg[:t].to(torch.int32)
    pos = torch.randint(0, 60, (t,), generator=gen).to(torch.int32)
    rows = mixed_tiles_plain(seg, pos, 4, l, m, ks, window).tolist()
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
        assert hi == max(lo, min(hi_pos + 1, l))
        assert splits == max(1, -(-(hi - lo) // ks))
    assert nxt == t


@pytest.mark.parametrize("g,hd", [(1, 16), (2, 32), (4, 64), (4, 16),
                                  (1, 64), (2, 16)])
@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixed_plain_matches_jax_oracle_and_pallas(dtype, window, g, hd):
    q, kc, vc, seg, pos = mixed_case(g * 100 + hd, g, hd)
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype))
                  for a in (q, kc, vc))
    tq, tk, tv = (to_torch(np.asarray(a)) for a in (jq, jk, jv))
    live = seg >= 0
    port = to_numpy(TA.mixed_attention(tq, tk, tv, to_torch(seg),
                                       to_torch(pos), window=window))
    assert port.shape == q.shape
    tol = TOL[dtype]
    oracle = np.asarray(JA.mixed_attention(
        jq, jk, jv, jnp.asarray(seg), jnp.asarray(pos), window=window,
        backend="ref").astype(jnp.float32))
    np.testing.assert_allclose(port[live], oracle[live], rtol=tol, atol=tol)
    pallas = np.asarray(jops.mixed_attention(
        jq, jk, jv, jnp.asarray(seg), jnp.asarray(pos),
        window=window).astype(jnp.float32))
    np.testing.assert_allclose(port[live], pallas[live], rtol=tol, atol=tol)


def test_padding_rows_read_slot_zero():
    """A padding token (seg < 0) reads slot 0, as the reference's clip
    does, so its (discarded) output equals the oracle's too."""
    q, kc, vc, seg, pos = mixed_case(7, 2, 16)
    out = to_numpy(tops.mixed_attention(to_torch(q), to_torch(kc),
                                        to_torch(vc), to_torch(seg),
                                        to_torch(pos)))
    exp = np.asarray(JA.mixed_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(seg),
        jnp.asarray(pos), backend="ref"))
    np.testing.assert_allclose(out, exp, rtol=2e-5, atol=2e-5)


def test_paged_equals_gathered_mixed_attention():
    """The port's paged attention over pages == its mixed attention over
    the explicitly gathered per-slot caches (the reference's
    tests/test_kernels.py:209-227), and the paged plain version is the
    mixed one after its gather (bitwise)."""
    rng = np.random.default_rng(80)
    n_pages, ps, hkv, d, hq, s, p = 20, 4, 2, 16, 4, 3, 3
    kp = rng.standard_normal((n_pages, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, hkv, d)).astype(np.float32)
    q = rng.standard_normal((5, hq, d)).astype(np.float32)
    tables = rng.permutation(n_pages)[:s * p].reshape(s, p).astype(np.int32)
    seg = np.array([0, 1, 1, 2, -1], np.int32)
    pos = np.array([4, 7, 8, 11, 0], np.int32)
    gidx = (tables[:, :, None] * ps + np.arange(ps)).reshape(s, p * ps)
    kc = kp.reshape(-1, hkv, d)[gidx].transpose(0, 2, 1, 3)
    vc = vp.reshape(-1, hkv, d)[gidx].transpose(0, 2, 1, 3)
    t = to_torch
    paged = TA.paged_attention(t(q), t(kp), t(vp), t(tables), t(seg),
                               t(pos))
    mixed = TA.mixed_attention(t(q), t(kc), t(vc), t(seg), t(pos))
    torch.testing.assert_close(paged, mixed, rtol=1e-5, atol=1e-5)
    direct = DA.mixed_attention_plain(
        t(q).reshape(5, hkv, 2, d), t(kc), t(vc), t(seg), t(pos),
        scale=d ** -0.5).reshape(5, hq, d)
    torch.testing.assert_close(paged, direct, rtol=0, atol=0)


def test_bf16_queries_over_fp32_caches():
    """bf16 q over fp32 caches (what ``gather`` gives from an int8/fp8
    pool): the logits are fp32 of the bf16 queries, the output is bf16,
    and it agrees with the fp32 oracle at the bf16 tier."""
    q, kc, vc, seg, pos = mixed_case(9, 4, 32)
    qb = to_torch(q).to(torch.bfloat16)
    out = tops.mixed_attention(qb, to_torch(kc), to_torch(vc),
                               to_torch(seg), to_torch(pos))
    assert out.dtype == torch.bfloat16
    exp = np.asarray(JA.mixed_attention(
        jnp.asarray(to_numpy(qb)), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(seg), jnp.asarray(pos), backend="ref"))
    live = seg >= 0
    np.testing.assert_allclose(to_numpy(out)[live], exp[live], rtol=3e-2,
                               atol=3e-2)


def test_every_backend_goes_through_the_wrapper(monkeypatch):
    calls = []
    real = DA.mixed_attention_plain

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(DA, "mixed_attention_plain", spy)
    q, kc, vc, seg, pos = mixed_case(3, 2, 16)
    t = to_torch
    for backend in ("auto", "pallas", "ref"):
        TA.mixed_attention(t(q), t(kc), t(vc), t(seg), t(pos),
                           backend=backend)
    assert len(calls) == 3
    with pytest.raises(ValueError):
        TA.mixed_attention(t(q), t(kc), t(vc), t(seg), t(pos),
                           backend="jnp")


def test_wrapper_refuses_other_devices():
    meta = torch.zeros((2, 1, 2, 16), device="meta")
    seg = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        DA.mixed_attention_fwd(meta, meta, meta, seg, seg, scale=1.0)


# ----------------------------------------------------------------------
# on the card: the kernel against its plain version
# ----------------------------------------------------------------------

@requires_cuda
@pytest.mark.parametrize("hd", [16, 32, 128, 256])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("pair", ["fp32", "bf16", "bf16_over_fp32"])
def test_cuda_mixed_kernel_matches_plain(cuda_device, pair, window, hd):
    g, hkv, s, l = 8 if hd == 256 else 2, 1 if hd == 256 else 4, 3, 700
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(hd)
    q = torch.randn((9, hkv, g, hd), generator=gen, device=dev)
    kc = torch.randn((s, hkv, l, hd), generator=gen, device=dev)
    vc = torch.randn((s, hkv, l, hd), generator=gen, device=dev)
    if pair != "fp32":
        q = q.to(torch.bfloat16)
    if pair == "bf16":
        kc, vc = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
    seg = torch.tensor([0, 0, 0, 1, 2, 2, 2, -1, -1], dtype=torch.int32,
                       device=dev)
    pos = torch.tensor([3, 4, 5, 0, 10, 511, 699, 0, 0], dtype=torch.int32,
                       device=dev)
    before = DA.mixed_counter.launches
    out = DA.mixed_attention_fwd(q, kc, vc, seg, pos, scale=hd ** -0.5,
                                 window=window)
    torch.cuda.synchronize()
    assert DA.mixed_counter.launches == before + 1
    exp = DA.mixed_attention_plain(q, kc, vc, seg, pos, scale=hd ** -0.5,
                                   window=window)
    tol = 1e-2 if pair != "fp32" else 1e-5
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)


@requires_cuda
def test_cuda_mixed_kernel_refuses_unsupported_pairs(cuda_device):
    x = torch.zeros((2, 1, 2, 16), device=cuda_device)
    seg = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        DA.mixed_attention_fwd(x, x.to(torch.bfloat16),
                               x.to(torch.bfloat16), seg, seg, scale=1.0)
    with pytest.raises(ValueError):
        DA.mixed_attention_fwd(torch.zeros((2, 1, 2, 24), device=cuda_device),
                               torch.zeros((2, 1, 4, 24), device=cuda_device),
                               torch.zeros((2, 1, 4, 24), device=cuda_device),
                               seg, seg, scale=1.0)


def card_layout(gen, n_slots, chunk, n_pad, seq_len):
    """The gathered path's layout: two slots run a prefill chunk of
    ``chunk`` tokens at consecutive positions, the rest one decode token
    each, then padding; lengths up to ``seq_len``."""
    lens = torch.randint(chunk + 1, seq_len + 1, (n_slots,),
                         generator=gen).tolist()
    seg, pos = [], []
    for slot, n in enumerate(lens):
        first = n - chunk if slot < 2 else n - 1
        seg += [slot] * (n - first)
        pos += list(range(first, n))
    return seg + [-1] * n_pad, pos + [0] * n_pad


def mma_case(dev, d, g, hkv=2, seq_len=300, chunk=21, seed=3):
    """bf16 q and caches of 6 slots of ``seq_len`` keys (300: no multiple
    of a 128-key split), a chunk longer than a tile (M = 64 / G tokens
    for G <= 8), decode tokens and padding."""
    gen = torch.Generator().manual_seed(seed)
    seg, pos = card_layout(gen, 6, chunk, 5, seq_len)
    kc = torch.randn((6, hkv, seq_len, d), generator=gen)
    vc = torch.randn((6, hkv, seq_len, d), generator=gen)
    q = torch.randn((len(seg), hkv, g, d), generator=gen)
    return (q.bfloat16().to(dev), kc.bfloat16().to(dev),
            vc.bfloat16().to(dev),
            torch.tensor(seg, dtype=torch.int32, device=dev),
            torch.tensor(pos, dtype=torch.int32, device=dev))


@requires_cuda
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("g", [1, 2, 8, 16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_cuda_mixed_mma_matches_plain(cuda_device, hd, g, window):
    q, kc, vc, seg, pos = mma_case(cuda_device, hd, g,
                                   chunk=70 if g == 1 else 21)
    assert DA.mixed_variant(q.dtype, kc.dtype) == "mma"
    before = DA.mixed_counter.launches
    out = DA.mixed_attention_fwd(q, kc, vc, seg, pos, scale=hd ** -0.5,
                                 window=window)
    torch.cuda.synchronize()
    assert DA.mixed_counter.launches == before + 1
    assert DA.mixed_last_launch()["device_launches"] == 3
    ref = DA.mixed_attention_plain(q, kc, vc, seg, pos, scale=hd ** -0.5,
                                   window=window)
    live = seg >= 0
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               rtol=1e-2, atol=1e-2)


@requires_cuda
@pytest.mark.parametrize("g", [3, 128])
def test_cuda_mixed_mma_row_blocks(cuda_device, g):
    """Rows that do not fill a warp (G = 3) and one token's heads cut
    into two 64-row blocks (G = 128)."""
    q, kc, vc, seg, pos = mma_case(cuda_device, 64, g, hkv=1, seq_len=200)
    out = DA.mixed_attention_fwd(q, kc, vc, seg, pos, scale=0.125)
    ref = DA.mixed_attention_plain(q, kc, vc, seg, pos, scale=0.125)
    live = seg >= 0
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               rtol=1e-2, atol=1e-2)


@requires_cuda
def test_cuda_mixed_mma_no_visible_key_gives_zeros(cuda_device):
    """A token past the cache under a window sees no key: zeros, as the
    Pallas kernel gives, beside tokens that see keys in one tile."""
    q, kc, vc, _, _ = mma_case(cuda_device, 32, 2, seq_len=40)
    q = q[:3]
    seg = torch.tensor([0, 0, 0], dtype=torch.int32, device=cuda_device)
    pos = torch.tensor([38, 39, 60], dtype=torch.int32, device=cuda_device)
    out = DA.mixed_attention_fwd(q, kc, vc, seg, pos, scale=32 ** -0.5,
                                 window=8)
    ref = DA.mixed_attention_plain(q, kc, vc, seg, pos, scale=32 ** -0.5,
                                   window=8)
    assert bool((out[2] == 0).all())
    torch.testing.assert_close(out[:2].float(), ref[:2].float(), rtol=1e-2,
                               atol=1e-2)


@requires_cuda
def test_cuda_mixed_mma_gemma_shape_and_determinism(cuda_device):
    """gemma-2b's attention (Hkv = 1, G = 8, D = 256) over 1024-key
    caches: tiles of 8 tokens, several splits, every call the same
    bits."""
    q, kc, vc, seg, pos = mma_case(cuda_device, 256, 8, hkv=1,
                                   seq_len=1024, chunk=100)
    tiles = DA.mixed_tiles(seg, pos, 6, 1024, 8)
    assert int(tiles[:, 1].max()) == 8 and int(tiles[:, 5].max()) > 1
    a = DA.mixed_attention_fwd(q, kc, vc, seg, pos, scale=0.0625)
    b = DA.mixed_attention_fwd(q, kc, vc, seg, pos, scale=0.0625)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    ref = DA.mixed_attention_plain(q, kc, vc, seg, pos, scale=0.0625)
    live = seg >= 0
    torch.testing.assert_close(a[live].float(), ref[live].float(),
                               rtol=1e-2, atol=1e-2)


@requires_cuda
@pytest.mark.parametrize("window", [None, 37])
@pytest.mark.parametrize("t", [7, 1024, 2600])
def test_cuda_mixed_prepass_matches_plain(cuda_device, t, window):
    """The device pre-pass's work list equals the plain one at the
    kernel's tiling, for T of one chunk of its block and of several, at
    G = 8 (8-token tiles) and G = 3 (21), over L = 300 keys."""
    gen = torch.Generator().manual_seed(t)
    ids = torch.randint(-1, 6, (t,), generator=gen)
    lens = torch.randint(1, 21, (t,), generator=gen)
    seg = ids.repeat_interleave(lens)[:t].to(torch.int32)
    pos = torch.randint(0, 500, (t,), generator=gen).to(torch.int32)
    for g in (8, 3):
        tiling = DA.mixed_tiling(g, 300)
        assert tiling == {"tile_tokens": 64 // g, "split_keys": 128,
                          "max_splits": 3}
        want = mixed_tiles_plain(seg, pos, 4, 300, tiling["tile_tokens"],
                                 tiling["split_keys"], window)
        got = DA.mixed_tiles(seg.to(cuda_device), pos.to(cuda_device), 4,
                             300, g, window)
        assert torch.equal(got.cpu(), want)


@requires_cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_cuda_mixed_kernel_attributes(cuda_device, hd):
    """No spill at any head_dim; at D = 256 two blocks an SM (the source
    note's budget) and 32-key tiles."""
    a = DA.mixed_kernel_attributes(torch.bfloat16, torch.bfloat16, hd)
    assert a["variant"] == "mma" and a["threads"] == 128
    assert a["spill_bytes"] == 0 and a["key_tile"] == 32
    if hd == 256:
        assert a["blocks_per_sm"] >= 2


@requires_cuda
@pytest.mark.parametrize("pair", [(torch.float32, torch.float32),
                                  (torch.bfloat16, torch.float32)])
def test_cuda_mixed_fp32_caches_run_simt(cuda_device, pair):
    """The two fp32-cache pairs stay on the CUDA cores: one launch."""
    qdt, cdt = pair
    assert DA.mixed_variant(qdt, cdt) == "simt"
    assert DA.mixed_kernel_attributes(qdt, cdt, 64)["variant"] == "simt"
    q, kc, vc, seg, pos = mma_case(cuda_device, 64, 2)
    DA.mixed_attention_fwd(q.to(qdt), kc.to(cdt), vc.to(cdt), seg, pos,
                           scale=0.125)
    torch.cuda.synchronize()
    launched = DA.mixed_last_launch()
    assert launched["device_launches"] == 1
    assert launched["prepass_blocks"] == 0 and launched["main_blocks"] > 0
