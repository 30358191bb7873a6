"""The decode kernel's optional log-sum-exp output (``return_lse``),
which the meshed decode step merges across the model ranks that hold a
cache's slots.  No JAX here: the card cases run in this file.

  * the plain version with ``return_lse`` gives the same output and the
    ``logsumexp`` of the visible scaled logits (-inf for an empty row);
  * two halves of a cache, each attended alone and merged by their lse
    (``merge_attention_partials``), equal the whole within 1e-5: the
    meshed decode step's decomposition;
  * on the card, the kernel's lse (the main kernel's at one split, the
    combine's otherwise) within 1e-5 relative of the plain version's, an
    empty row -inf, and the output the bits of a call without lse.
"""

import pytest
import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.models.attention import merge_attention_partials
from torch_port_helpers import cuda_device, requires_cuda  # noqa: F401


def _decode_case(dtype, b=4, hkv=1, g=8, smax=200, d=64, seed=0,
                 device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, hkv, g, d, generator=gen).to(dtype)
    k = torch.randn(b, hkv, smax, d, generator=gen).to(dtype)
    v = torch.randn(b, hkv, smax, d, generator=gen).to(dtype)
    lens = torch.tensor([smax, 1, 0, 77][:b], dtype=torch.int32)
    return tuple(x.to(device) for x in (q, k, v, lens))


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_decode_lse(dtype, window):
    q, k, v, lens = _decode_case(dtype)
    scale = q.shape[-1] ** -0.5
    out = DA.decode_attention_plain(q, k, v, lens, scale=scale,
                                    window=window)
    out2, lse = DA.decode_attention_plain(q, k, v, lens, scale=scale,
                                          window=window, return_lse=True)
    assert torch.equal(out, out2) and lse.dtype == torch.float32
    logits = torch.einsum("bhgd,bhkd->bhgk", q.float(), k.float()) * scale
    for i, n in enumerate(lens.tolist()):
        lo = max(0, n - window) if window else 0
        if n == 0:
            assert bool(torch.isneginf(lse[i]).all())
        else:
            torch.testing.assert_close(
                lse[i], torch.logsumexp(logits[i, ..., lo:n], -1))


def test_decode_halves_merged_by_lse_equal_the_whole():
    """The meshed decode step's split of the cache's slots: each half
    attended alone (a half with no live slot gives an lse of -inf), the
    halves merged, equal the whole cache's attention within 1e-5."""
    q, k, v, lens = _decode_case(torch.float32)
    scale = q.shape[-1] ** -0.5
    whole = DA.decode_attention_plain(q, k, v, lens, scale=scale)
    half = k.shape[2] // 2
    parts = []
    for r in range(2):
        live = (lens - r * half).clamp(0, half).to(torch.int32)
        sl = slice(r * half, (r + 1) * half)
        parts.append(DA.decode_attention_plain(
            q, k[:, :, sl], v[:, :, sl], live, scale=scale,
            return_lse=True))
    merged = merge_attention_partials([o for o, _ in parts],
                                      [s for _, s in parts])
    rows = lens > 0
    torch.testing.assert_close(merged[rows], whole[rows], rtol=1e-5,
                               atol=1e-5)


@requires_cuda
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("smax", [100, 600])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_decode_lse_matches_plain(cuda_device, dtype, smax, window):
    """The kernel's lse (the main kernel's at one split, the combine's
    otherwise) within 1e-5 relative of the plain version's; an empty row
    -inf; the output the bits of a call without lse."""
    q, k, v, lens = _decode_case(dtype, d=256, smax=smax, device=cuda_device)
    scale = 256 ** -0.5
    before = DA.decode_counter.launches
    out, lse = DA.decode_attention_fwd(q, k, v, lens, scale=scale,
                                       window=window, return_lse=True)
    plain = DA.decode_attention_fwd(q, k, v, lens, scale=scale,
                                    window=window)
    torch.cuda.synchronize()
    assert DA.decode_counter.launches == before + 2
    assert torch.equal(out, plain)
    _, ref = DA.decode_attention_plain(q, k, v, lens, scale=scale,
                                       window=window, return_lse=True)
    live = lens > 0
    torch.testing.assert_close(lse[live], ref[live], rtol=1e-5, atol=0)
    assert bool(torch.isneginf(lse[~live]).all())
