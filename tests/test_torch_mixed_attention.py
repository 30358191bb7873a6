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
unnormalised probabilities to bf16 as the kernel does).  The fp32-cache
kernel (variant "tf32x3") runs the same work list in 3xTF32 on the
tensor cores: :func:`tf32x3_mixed` computes attention in its order and
arithmetic (stages of the split's keys, products in ``matmul_tf32``, the
online softmax in log2 units), held against the same references at 1e-5
for fp32 q and for bf16 q values, and shows that a token's row alone
equals its row in a batch, bit for bit, with no window.
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
from repro_torch.serving import quant
from test_torch_paged import tiled_attention
from torch_port_helpers import cuda_device, matmul_tf32, requires_cuda, \
    strided_operands, to_numpy, \
    to_torch  # noqa: F401  (cuda_device: requires_cuda's fixture)

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
                          tile_tokens, split_keys, stage_keys=None):
    """Mixed attention from the kernel's work list, the kernel's way.
    Without ``stage_keys`` (the "mma" kernel's decomposition): the paged
    decomposition (``test_torch_paged.tiled_attention``: each split's (m,
    l, unnormalised O), probabilities rounded to bf16 before the PV
    product when q is bf16, the merge in split order) over a table of one
    page a slot, slot s's whole cache being page s of L keys.  With
    ``stage_keys`` (fp32 caches, the "tf32x3" kernel): :func:`tf32x3_mixed`
    in 3xTF32 arithmetic.  q (T, Hkv, G, D); caches (S, Hkv, L, D).  A
    token with no visible key gets zeros, as the kernel gives.  Returns
    (T, Hkv, G, D) in q's dtype."""
    if stage_keys is not None:
        return tf32x3_mixed(q, kc, vc, seg, pos, scale=scale, window=window,
                            tile_tokens=tile_tokens, split_keys=split_keys,
                            stage_keys=stage_keys)
    tables = torch.arange(kc.shape[0], dtype=torch.int32)[:, None]
    return tiled_attention(q, kc.transpose(1, 2), vc.transpose(1, 2), tables,
                           seg, pos, scale=scale, window=window,
                           tile_tokens=tile_tokens, split_keys=split_keys)


LOG2E = 1.4426950408889634


def ordered_sum(p):
    """The last dim summed left to right (keepdim): elementwise adds, so a
    row's sum does not depend on how many rows the tensor holds."""
    acc = p[..., :1]
    for j in range(1, p.shape[-1]):
        acc = acc + p[..., j:j + 1]
    return acc


def token_exp2(x):
    """exp2 one token (first index) at a time: torch's vectorized exp2 and
    its scalar tail differ in the last bit, so the elements of a call must
    not depend on how many tokens the tensor holds."""
    return torch.stack([torch.exp2(xi) for xi in x])


def tf32x3_mixed(q, kc, vc, seg, pos, *, scale, window, tile_tokens,
                 split_keys, stage_keys):
    """Mixed attention over fp32 caches as the "tf32x3" kernel orders it:
    the work list's tiles and splits (every split from key lo in steps of
    ``split_keys``), each split's keys in stages of ``stage_keys`` (rows
    past the split zero-filled), S = Q K^T and O += P V in 3xTF32
    (``matmul_tf32``, one token's G x D rows at a time, so a row's
    products do not depend on its tile-mates), the online softmax in log2
    units with P kept in fp32, and the splits merged in split order (O_s
    exp2(m_s - m) summed split by split, times 1 / max(l, 1e-30); a tile of
    one split the same).  q (T, Hkv, G, D) fp32 or bf16 (exact in TF32);
    caches (S, Hkv, L, D) fp32.  Returns (T, Hkv, G, D) in q's dtype."""
    t, hkv, g, d = q.shape
    n_slots, _, l, _ = kc.shape
    tiles = mixed_tiles_plain(seg, pos, n_slots, l, tile_tokens, split_keys,
                              window)
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    neg = torch.tensor(DA.NEG_INF)
    out = torch.full((t, hkv, g, d), float("nan"))
    for first, count, slot, lo, hi, splits, _, _ in tiles.tolist():
        toks = range(first, first + count)
        p_t = pos[first:first + count].long()[:, None, None, None]
        parts = []
        for sp in range(splits):
            k_lo = lo + sp * split_keys
            k_hi = min(hi, k_lo + split_keys)
            m = torch.full((count, hkv, g, 1), DA.NEG_INF)
            lsum = torch.zeros((count, hkv, g, 1))
            o = torch.zeros((count, hkv, g, d))
            for k0 in range(k_lo, k_hi, stage_keys):
                keys = torch.arange(k0, k0 + stage_keys)
                live = keys < k_hi
                rows = keys.clamp(max=l - 1)
                kst = kc[slot][:, rows].float() * live[None, :, None]
                vst = vc[slot][:, rows].float() * live[None, :, None]
                sc = torch.stack([matmul_tf32(q[i].float(),
                                              kst.transpose(-1, -2))
                                  for i in toks])
                ok = live & (keys <= p_t)
                if window:
                    ok = ok & (keys > p_t - window)
                x = torch.where(ok, sc * sl2, neg)
                m_new = torch.maximum(m, x.amax(-1, keepdim=True))
                alpha = token_exp2(m - m_new)
                p = torch.where(ok, token_exp2(x - m_new), 0.0)
                lsum = alpha * lsum + ordered_sum(p)
                o = o * alpha + torch.stack(
                    [matmul_tf32(p[i], vst) for i in range(count)])
                m = m_new
            parts.append((m, lsum, o))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        lw = torch.zeros_like(mx)
        acc = torch.zeros((count, hkv, g, d))
        for m, lsum, o in parts:
            w = token_exp2(m - mx)
            lw = lw + lsum * w
            acc = acc + o * w
        out[first:first + count] = acc * (1.0 / lw.clamp(min=1e-30))
    return out.to(q.dtype)


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


# the "tf32x3" kernel's decomposition: (tile tokens, split keys, stage
# keys): the kernel's own at G = 2 (32 tokens, 128 keys a split, 32 a
# stage), and small ones that cut these sequences into several tiles,
# splits and stages
TF32_TILINGS = ((32, 128, 32), (2, 8, 4), (3, 4, 4))


def jax_mixed_references(q, kc, vc, seg, pos, window):
    """The jnp oracle's and the interpret-mode Pallas kernel's outputs, as
    (T, Hkv, G, D) fp32 numpy arrays, on the same inputs."""
    t, hkv, g, d = q.shape
    args = [jnp.asarray(to_numpy(x)) for x in
            (q.reshape(t, hkv * g, d), kc, vc)]
    args += [jnp.asarray(seg.numpy()), jnp.asarray(pos.numpy())]
    return [np.asarray(f(*args, window=window).astype(jnp.float32)).reshape(
        t, hkv, g, d) for f in (
            lambda *a, **k: JA.mixed_attention(*a, **k, backend="ref"),
            jops.mixed_attention)]


@pytest.mark.parametrize("tiling", TF32_TILINGS)
@pytest.mark.parametrize("pair", ["fp32", "bf16_q_fp32_cache"])
@pytest.mark.parametrize("layout", ["reference", "reference_window",
                                    "long_run", "window_empties_split",
                                    "gemma"])
def test_tf32x3_mixed_matches_jax_oracle_and_pallas(layout, pair, tiling):
    """The fp32-cache kernel's decomposition in its 3xTF32 arithmetic
    against the jnp oracle and the Pallas kernel in interpret mode, fp32,
    1e-5.  ``bf16_q_fp32_cache`` holds the queries at bf16 values in fp32
    (the bf16-q kernel's arithmetic before its output is rounded to bf16);
    ``gemma`` is gemma-2b's attention width (G = 8, D = 256) on the
    reference layout."""
    name, g, d = ((layout, 2, 16) if layout != "gemma"
                  else ("reference", 8, 256))
    q, kc, vc, seg, pos, window = layout_case(name, torch.float32, g=g, d=d)
    if pair != "fp32":
        q = q.to(torch.bfloat16).float()
    tokens, split_keys, stage_keys = tiling
    out = tiled_mixed_attention(q, kc, vc, seg, pos, scale=d ** -0.5,
                                window=window, tile_tokens=min(tokens,
                                                               64 // g),
                                split_keys=split_keys,
                                stage_keys=stage_keys)
    live = (seg >= 0).numpy()
    got = to_numpy(out)[live]
    for ref in jax_mixed_references(q, kc, vc, seg, pos, window):
        np.testing.assert_allclose(got, ref[live], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tiling", TF32_TILINGS)
@pytest.mark.parametrize("layout", ["reference", "long_run", "straddle"])
def test_tf32x3_mixed_row_is_independent_of_its_batch(layout, tiling):
    """With no window, a token's row alone equals the same row in its
    batch, bit for bit: the splits start at key 0 in steps of the split
    size, every row masks by its own position, and the splits merge in
    split order, so the stages a token's tile-mates add are masked for it
    and change nothing."""
    q, kc, vc, seg, pos, window = layout_case(layout, torch.float32)
    assert window is None
    kw = dict(scale=0.25, window=None, tile_tokens=tiling[0],
              split_keys=tiling[1], stage_keys=tiling[2])
    batch = tiled_mixed_attention(q, kc, vc, seg, pos, **kw)
    for i in range(len(seg)):
        alone = tiled_mixed_attention(q[i:i + 1], kc, vc, seg[i:i + 1],
                                      pos[i:i + 1], **kw)
        assert torch.equal(alone[0], batch[i]), i


def test_tf32x3_mixed_bf16_q_is_the_fp32_result_rounded():
    """bf16 q over fp32 caches: the decomposition's output is its result
    for the same query values in fp32, rounded to bf16 (P stays fp32, as
    ``p.astype(v.dtype)`` keeps it over fp32 caches)."""
    q, kc, vc, seg, pos, window = layout_case("reference", torch.float32)
    qb = q.to(torch.bfloat16)
    kw = dict(scale=0.25, window=window, tile_tokens=2, split_keys=8,
              stage_keys=4)
    out = tiled_mixed_attention(qb, kc, vc, seg, pos, **kw)
    wide = tiled_mixed_attention(qb.float(), kc, vc, seg, pos, **kw)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, wide.to(torch.bfloat16))


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
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
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


FP32_CACHE_PAIRS = [(torch.float32, torch.float32),
                    (torch.bfloat16, torch.float32)]


@requires_cuda
@pytest.mark.parametrize("seq_len", [128, 300])
@pytest.mark.parametrize("pair", FP32_CACHE_PAIRS)
def test_cuda_mixed_fp32_caches_run_tf32x3(cuda_device, pair, seq_len):
    """The two fp32-cache pairs run the 3xTF32 main kernel over the shared
    work list: the pre-pass (one block), the main kernel and the combine,
    3 device launches, or 2 when L fits one 128-key split."""
    qdt, cdt = pair
    assert DA.mixed_variant(qdt, cdt) == "tf32x3"
    assert DA.mixed_kernel_attributes(qdt, cdt, 64)["variant"] == "tf32x3"
    q, kc, vc, seg, pos = mma_case(cuda_device, 64, 2, seq_len=seq_len)
    DA.mixed_attention_fwd(q.to(qdt), kc.to(cdt), vc.to(cdt), seg, pos,
                           scale=0.125)
    torch.cuda.synchronize()
    launched = DA.mixed_last_launch()
    one_split = seq_len <= DA.mixed_tiling(2, seq_len)["split_keys"]
    assert launched["device_launches"] == (2 if one_split else 3)
    assert launched["prepass_blocks"] == 1 and launched["main_blocks"] > 0
    assert (launched["combine_blocks"] == 0) == one_split


@requires_cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("pair", FP32_CACHE_PAIRS)
def test_cuda_mixed_tf32x3_kernel_attributes(cuda_device, pair, hd):
    """No spill at any head_dim, 8 warps, 32-key stages, and at least one
    block an SM at D = 256 (the Q tile, two fp32 (K, V) stages and the
    exchange in shared memory)."""
    a = DA.mixed_kernel_attributes(*pair, hd)
    assert a["variant"] == "tf32x3" and a["threads"] == 256
    assert a["spill_bytes"] == 0 and a["key_tile"] == 32
    assert a["blocks_per_sm"] >= 1 and a["smem_bytes"] <= 232448


@requires_cuda
@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("pair", FP32_CACHE_PAIRS)
def test_cuda_mixed_tf32x3_row_is_independent_of_its_batch(cuda_device,
                                                            pair, hd):
    """With no window, every token's row alone equals its row in the
    batch, bit for bit (the rule the fp32 greedy runs at spec_k 2 and 0
    rest on): prefill chunks longer than a tile, decode tokens, padding,
    caches of several splits."""
    qdt, cdt = pair
    g = 8 if hd == 256 else 2
    q, kc, vc, seg, pos = mma_case(cuda_device, hd, g, hkv=1, seq_len=300,
                                   chunk=21)
    q, kc, vc = q.to(qdt), kc.to(cdt), vc.to(cdt)
    batch = DA.mixed_attention_fwd(q, kc, vc, seg, pos, scale=hd ** -0.5)
    for i in range(q.shape[0]):
        alone = DA.mixed_attention_fwd(q[i:i + 1], kc, vc, seg[i:i + 1],
                                       pos[i:i + 1], scale=hd ** -0.5)
        assert torch.equal(alone[0], batch[i]), i


@requires_cuda
def test_cuda_gathered_int8_pool_matches_paged(cuda_device):
    """bf16 q over an int8 pool: the gathered path (the pool dequantized
    into fp32 per-slot caches of code x scale, then the mixed kernel's
    bf16-over-fp32 pair) agrees with the paged kernel over the same pool
    within the bf16 tier, 1e-2 + 1e-2 |paged| (the paged kernel rounds the
    probabilities to bf16 before its PV product, the mixed one keeps them
    fp32 over fp32 caches: one bf16 step of an output of magnitude 2-4
    apart)."""
    dev = cuda_device
    gen = torch.Generator().manual_seed(31)
    n_pages, ps, hkv, g, d, s, p = 40, 16, 1, 8, 256, 4, 8
    k, v = (torch.randn((n_pages, ps, hkv, d), generator=gen)
            for _ in range(2))
    (kp, ksc), (vp, vsc) = (quant.quantize(x, "int8") for x in (k, v))
    tables = torch.randperm(n_pages, generator=gen)[:s * p].reshape(s, p)
    seg, pos = card_layout(gen, s, 10, 3, p * ps)
    q = torch.randn((len(seg), hkv, g, d), generator=gen).bfloat16()
    gidx = (tables[:, :, None] * ps + torch.arange(ps)).reshape(s, p * ps)
    kc, vc = (quant.dequantize(c.reshape(n_pages * ps, hkv, d)[gidx],
                               sc.reshape(n_pages * ps, hkv)[gidx])
              .transpose(1, 2).contiguous() for c, sc in ((kp, ksc),
                                                          (vp, vsc)))
    to = dict(device=dev)
    seg = torch.tensor(seg, dtype=torch.int32, **to)
    pos = torch.tensor(pos, dtype=torch.int32, **to)
    mixed = DA.mixed_attention_fwd(q.to(dev), kc.to(dev), vc.to(dev), seg,
                                   pos, scale=d ** -0.5)
    paged = DA.paged_attention_fwd(
        q.to(dev), kp.to(dev), vp.to(dev), tables.to(torch.int32).to(dev),
        seg, pos, scale=d ** -0.5, k_scale=ksc.to(dev), v_scale=vsc.to(dev))
    assert DA.mixed_variant(q.dtype, kc.dtype) == "tf32x3"
    live = seg >= 0
    torch.testing.assert_close(mixed[live].float(), paged[live].float(),
                               rtol=1e-2, atol=1e-2)


@requires_cuda
@pytest.mark.parametrize("pair", ["fp32", "bf16", "bf16_over_fp32"])
def test_cuda_mixed_kernel_copies_strided_operands(cuda_device, pair):
    """q and both caches at an odd element offset or transposed: the
    wrapper copies them and gives the contiguous call's bits."""
    q, kc, vc, seg, pos = mma_case(cuda_device, 64, 2, seq_len=200)
    if pair != "bf16":
        kc, vc = kc.float(), vc.float()
    if pair == "fp32":
        q = q.float()
    want = DA.mixed_attention_fwd(q, kc, vc, seg, pos, scale=0.125)
    for view in range(2):
        args = [strided_operands(x)[view] for x in (q, kc, vc)]
        before = DA.mixed_counter.launches
        got = DA.mixed_attention_fwd(*args, seg, pos, scale=0.125)
        assert DA.mixed_counter.launches == before + 1
        assert got.is_contiguous() and torch.equal(got, want)


