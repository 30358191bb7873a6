"""Every kernel launch of the port is one ``torch.library.custom_op`` with
a shape function, so ``repro_torch.compile`` traces a function that
reaches it as one graph node where ``jax.jit`` computes: the paged,
decode and mixed attention kernels, both Gumbel kernels, the fused
elementwise chain, WKV6 and the Mamba scan (flash already was one).

On the CPU the graph is traced with ``make_fx`` over fake CUDA tensors
(no card needed): each launch is exactly one operator node whose fake
outputs have the eager wrapper's shapes and dtypes.  On the card each
launch runs inside ``repro_torch.compile`` with no graph break, is
counted once a compiled call by ``launch_counts()``, and gives the eager
call's result (bits).  Eagerly a launch skips the dispatcher and runs
the operator's body (``kernels._build.LaunchOp``).
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx

import repro_torch as rt
from repro_torch.core import fuse
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import fused_elementwise as FE
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import ops as kops
from torch_port_helpers import cuda_device, requires_cuda  # noqa: F401


def _paged(dev, lse=False):
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(6, 2, 2, 32, generator=gen)
    pool = torch.randn(8, 4, 2, 32, generator=gen)
    tables = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32)
    seg = torch.tensor([0, 0, 0, 1, 1, -1], dtype=torch.int32)
    pos = torch.tensor([3, 4, 5, 9, 10, 0], dtype=torch.int32)
    args = [x.to(dev) for x in (q, pool, pool.flip(0).contiguous(), tables,
                                seg, pos)]

    def fn(q, kp, vp, tables, seg, pos):
        return DA.paged_attention_fwd(q, kp, vp, tables, seg, pos,
                                      scale=0.2, return_lse=lse)
    return fn, args


def _mixed(dev):
    gen = torch.Generator().manual_seed(6)
    q = torch.randn(5, 2, 2, 32, generator=gen)
    cache = torch.randn(2, 2, 16, 32, generator=gen)
    seg = torch.tensor([0, 0, 1, 1, -1], dtype=torch.int32)
    pos = torch.tensor([3, 4, 7, 8, 0], dtype=torch.int32)
    args = [x.to(dev) for x in (q, cache, cache.flip(2).contiguous(), seg,
                                pos)]

    def fn(q, k, v, seg, pos):
        return DA.mixed_attention_fwd(q, k, v, seg, pos, scale=0.2)
    return fn, args


def _decode(dev):
    gen = torch.Generator().manual_seed(7)
    q = torch.randn(2, 2, 4, 32, generator=gen)
    cache = torch.randn(2, 2, 24, 32, generator=gen)
    lens = torch.tensor([5, 24], dtype=torch.int32)
    args = [x.to(dev) for x in (q, cache, cache.flip(2).contiguous(), lens)]

    def fn(q, k, v, lens):
        return DA.decode_attention_fwd(q, k, v, lens, scale=0.2)
    return fn, args


def _gumbel(dev):
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(4, 300, generator=gen)
    u = torch.rand(4, 300, generator=gen).clamp(1e-6, 1 - 1e-6)
    return (lambda x, u: kops.gumbel_perturb(x, u)), [x.to(dev), u.to(dev)]


def _gumbel_keyed(dev):
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(4, 300, generator=gen)
    seeds = torch.tensor([1, 2, 3, 4])
    pos = torch.tensor([10, 11, 12, 13])
    return ((lambda x, s, p: kops.gumbel_perturb_keyed(x, s, p)),
            [x.to(dev), seeds.to(dev), pos.to(dev)])


def _rwkv6(dev):
    gen = torch.Generator().manual_seed(10)
    r, k, v = (torch.randn(1, 2, 8, 64, generator=gen) for _ in range(3))
    w = torch.rand(1, 2, 8, 64, generator=gen) * 0.5 + 0.4
    u = torch.randn(2, 64, generator=gen)
    return ((lambda r, k, v, w, u: kops.rwkv6_scan(r, k, v, w, u)),
            [x.to(dev) for x in (r, k, v, w, u)])


def _mamba(dev):
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(1, 8, 32, generator=gen)
    dt = torch.rand(1, 8, 32, generator=gen) * 0.1
    B, C = (torch.randn(1, 8, 16, generator=gen) for _ in range(2))
    A = -torch.rand(32, 16, generator=gen) - 0.5
    D = torch.randn(32, generator=gen)
    return ((lambda x, dt, B, C, A, D: kops.mamba_scan(x, dt, B, C, A, D)),
            [t.to(dev) for t in (x, dt, B, C, A, D)])


def _fused(dev):
    gen = torch.Generator().manual_seed(12)
    x = torch.randn(64, 33, generator=gen).to(dev)
    with rt.default_device(dev.type if isinstance(dev, torch.device)
                           else dev):
        chain, ext = fuse.capture_chain(
            lambda t: (t * 2.0 + 1.0).tanh() * t, rt.Tensor(x))
    kernel = FE.make_fused_elementwise(chain)
    return (lambda *xs: kernel(*xs)), list(ext)


# case -> (builder, operator, kernel counter)
CASES = {
    "paged": (_paged, "paged_attention", "paged_attention"),
    "paged_lse": (lambda d: _paged(d, lse=True), "paged_attention",
                  "paged_attention"),
    "mixed": (_mixed, "mixed_attention", "mixed_attention"),
    "decode": (_decode, "decode_attention", "decode_attention"),
    "gumbel": (_gumbel, "gumbel_perturb", "gumbel_perturb"),
    "gumbel_keyed": (_gumbel_keyed, "gumbel_perturb_keyed",
                     "gumbel_perturb"),
    "fused": (_fused, "fused_elementwise", "fused_elementwise"),
    "rwkv6": (_rwkv6, "rwkv6_scan", "rwkv6_scan"),
    "mamba": (_mamba, "mamba_scan", "mamba_scan"),
}


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("case", sorted(CASES))
def test_launch_traces_as_one_operator(case):
    """With fake CUDA tensors the wrapper traces to exactly one
    ``repro_torch::<op>`` node (no ``data_ptr`` of a fake tensor is
    read), whose outputs have the eager CPU call's shapes and dtypes."""
    build, op, _ = CASES[case]
    fn, cpu_args = build(torch.device("cpu"))
    eager = _flat(fn(*cpu_args))
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        fake = [torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                                    device="cuda") for a in cpu_args]
    with rt.autograd.tracing():
        graph = make_fx(fn, tracing_mode="fake")(*fake)
    targets = [str(n.target) for n in graph.graph.nodes
               if n.op == "call_function" and "repro_torch" in str(n.target)]
    assert targets == [f"repro_torch.{op}.default"]
    outs = [n for n in graph.graph.nodes if n.op == "output"][0].args[0]
    vals = [o.meta["val"] for o in _flat(outs)]
    assert [tuple(v.shape) for v in vals] == [tuple(e.shape) for e in eager]
    assert [v.dtype for v in vals] == [e.dtype for e in eager]


@requires_cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_compiled_launch_matches_eager(cuda_device, case):
    """On the card: the compiled function launches its kernel once a call
    (counted inside the compiled call), with no graph break, and gives
    the eager call's bits (the Triton and CUDA kernels are deterministic
    at one shape)."""
    from torch._dynamo.utils import counters
    build, _, counter = CASES[case]
    fn, args = build(cuda_device)
    with rt.default_device("cuda"):
        eager = _flat(fn(*args))
        cf = rt.compile(fn)
        breaks = sum(counters["graph_break"].values())
        cf(*args)
        torch.cuda.synchronize()
        assert sum(counters["graph_break"].values()) == breaks
        reset_launch_counts()
        out = _flat(cf(*args))
        torch.cuda.synchronize()
    counts = launch_counts()
    assert counts[counter] == 1
    assert sum(counts.values()) == 1
    for a, b in zip(out, eager):
        assert torch.equal(a, b), case


def test_eager_calls_skip_the_dispatcher():
    """Eagerly a launch runs its operator's body directly (no dispatcher
    round trip on host-bound steps); under fake tensors, a dispatch mode
    or Dynamo it goes through the operator."""
    from repro_torch.kernels._build import _tracing
    real = torch.zeros(2)
    assert not _tracing((real, [real], 1.0, None))
    assert not _tracing((torch.nn.Parameter(real),))
    with FakeTensorMode() as mode:
        fake = mode.from_tensor(real)
        assert _tracing((fake,))
        assert _tracing((real,))          # the mode itself is on
    assert _tracing(([fake],))
