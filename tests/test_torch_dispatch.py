"""The reference's dispatch-cache, fusion-queue, foreach-optimizer
(``tests/test_dispatch_cache.py``) and allocator/stream
(``tests/test_allocator_streams.py``) gates, re-run on the port on the
CPU, plus the dispatch-cache counts of one program held equal to the
reference's.

``test_compile_unhashable_static_falls_back`` and
``test_fusion_inside_jit_is_bypassed`` are in ``test_torch_compile.py``
with the rest of the jit bridge.  ``test_pallas_interpret_matches_composite`` becomes the
plain version of the port's kernel on the same composite (the Pallas
kernel itself is held against it in ``test_torch_fuse.py``).
"""

import gc

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro
import repro_torch as rt
import repro_torch.optim as optim
from repro_torch.core import dispatch as D
from repro_torch.core import fuse as F
from repro_torch.core.allocator import (ROUND_BYTES, CachingAllocator,
                                        round_size)
from repro_torch.core.autograd import no_grad
from repro_torch.core.stream import Event, Stream, current_stream, stream
from repro_torch.kernels import fused_elementwise as FE
from torch_port_helpers import port_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_cpu")


class TestDispatchCache:
    def test_hit_miss_stats(self):
        x = rt.randn(16, 16)
        _ = x.exp()
        s = rt.dispatch_cache_stats()
        assert s["num_misses"] >= 1 and s["num_hits"] == 0
        _ = x.exp()
        s = rt.dispatch_cache_stats()
        assert s["num_hits"] == 1
        _ = rt.randn(8, 8).exp()
        s2 = rt.dispatch_cache_stats()
        assert s2["num_misses"] == s["num_misses"] + 1
        assert s2["num_entries"] == s2["num_misses"]

    def test_grad_flag_and_statics_key(self):
        x = rt.randn(4, 4, requires_grad=True)
        y = rt.randn(4, 4)
        _ = x.exp()
        _ = y.exp()
        assert rt.dispatch_cache_stats()["num_misses"] == 2
        _ = x.sum(dim=0)
        _ = x.sum(dim=1)
        assert rt.dispatch_cache_stats()["num_misses"] == 4

    def test_device_keys_entries(self):
        """CPU and CUDA entries never collide: the device type is part
        of the signature."""
        key = D.make_key("exp", (), [torch.zeros(2)], False)
        meta = D.make_key("exp", (), [torch.zeros(2, device="meta")], False)
        assert key != meta and key[2] == (((2,), "torch.float32", "cpu"),)

    def test_cached_vjp_matches_fresh_torch_vjp(self):
        xd = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (32, 32), dtype=np.float32))
        f = lambda a: torch.tanh(a * 2.0 + 1.0) * a  # noqa: E731
        out_ref, vjp_ref = torch.func.vjp(f, xd)
        cot = torch.ones_like(out_ref)
        (g_ref,) = vjp_ref(cot)

        def run():
            x = rt.Tensor(xd, requires_grad=True)
            y = (x * 2.0 + 1.0).tanh() * x
            y.backward(rt.Tensor(cot))
            return y.numpy(), x.grad.numpy()

        y1, g1 = run()
        y2, g2 = run()
        assert rt.dispatch_cache_stats()["num_hits"] > 0
        for y, g in ((y1, g1), (y2, g2)):
            np.testing.assert_allclose(y, out_ref.numpy(), rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(g, g_ref.numpy(), rtol=1e-6,
                                       atol=1e-6)

    def test_unhashable_static_falls_back(self):
        x = rt.randn(4, 4)
        before = rt.dispatch_cache_stats()["num_fallback_unhashable"]
        idx = rt.tensor(np.array([0, 2]))
        _ = x[idx]
        s = rt.dispatch_cache_stats()
        assert (s["num_uncached"] >= 1
                or s["num_fallback_unhashable"] > before)

    def test_tensor_valued_static_never_cached(self):
        from repro_torch.core.tensor_mod import _static_ok
        t = rt.randn(())
        assert not _static_ok((t,))
        assert not _static_ok(t)
        assert _static_ok((1, 2.0, None, "s", (3, torch.float32)))
        x = rt.randn(4, 4)
        before = D.dispatch_cache_stats()["num_fallback_unhashable"]
        with pytest.raises(TypeError):
            _ = x.clamp(min=t)
        s = D.dispatch_cache_stats()
        assert s["num_fallback_unhashable"] == before + 1
        assert s["num_entries"] == 0

    def test_bool_index_key_distinct_from_int(self):
        x = rt.tensor(np.arange(12).reshape(3, 4))
        assert x[1].shape == (4,)
        assert x[True].shape == (1, 3, 4)

    def test_statics_keyed_by_type(self):
        t = rt.tensor(np.arange(6, dtype=np.int32))
        assert t.clamp(0, 1).dtype == torch.int32
        assert t.clamp(0.0, 1.0).dtype == torch.float32

    def test_cache_disabled_context(self):
        x = rt.randn(4, 4)
        with D.cache_disabled():
            _ = x.exp()
            _ = x.exp()
        assert rt.dispatch_cache_stats()["num_entries"] == 0

    def test_stats_of_one_program_equal_the_reference(self):
        """The same program, without a shape change in a chain, counts
        the same hits and misses, per op too, in both packages."""
        def program(P):
            P.reset_dispatch_cache()
            P.manual_seed(0)
            x = P.randn(8, 8, requires_grad=True)
            w = P.randn(8, 8, requires_grad=True)
            for _ in range(3):
                with P.fuse.fusion():
                    h = ((x @ w) * 2.0 + 1.0).tanh()
                    loss = (h * h).sum() + x.exp().mean()
                loss.backward()
            s = P.dispatch_cache_stats()
            return ({k: v for k, v in s.items() if k != "per_op"},
                    s["per_op"])

        (js, jper), (ts, tper) = program(repro), program(rt)
        assert ts == js
        assert tper == jper


class TestFusionQueue:
    def test_chain_defers_and_flushes_once(self):
        x = rt.randn(16, 16, requires_grad=True)
        with F.fusion():
            y = ((x * 2.0 + 1.0).tanh() * x).sigmoid()
            assert y._pending is not None
            got = y.numpy()
        assert y._pending is None
        xd = x.numpy()
        ref = 1 / (1 + np.exp(-(np.tanh(xd * 2 + 1) * xd)))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        per_op = rt.dispatch_cache_stats()["per_op"]["__fused__"]
        assert per_op["misses"] == 1 and per_op["hits"] == 0

    def test_fused_backward_matches_eager(self):
        xd = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (16, 16), dtype=np.float32))
        x1 = rt.Tensor(xd, requires_grad=True)
        with F.fusion():
            ((x1 * 3.0).exp() + x1).sum().backward()
        x2 = rt.Tensor(xd, requires_grad=True)
        ((x2 * 3.0).exp() + x2).sum().backward()
        np.testing.assert_allclose(x1.grad.numpy(), x2.grad.numpy(),
                                   rtol=1e-6, atol=1e-6)

    def test_intermediates_materialized_from_same_kernel(self):
        x = rt.randn(8, requires_grad=True)
        with F.fusion():
            m = x * 3.0
            z = m.exp()
            (z.sum() + m.sum()).backward()
        ref = np.exp(x.numpy() * 3) * 3 + 3
        np.testing.assert_allclose(x.grad.numpy(), ref, rtol=1e-5,
                                   atol=1e-6)
        assert m.grad_fn is z.grad_fn and m.grad_fn.name == "fused[mul+exp]"

    def test_inplace_mutation_flushes_with_premutation_value(self):
        a = rt.randn(8)
        with F.fusion():
            b = a * 3.0
            expect = a.numpy() * 3.0
            a.add_(1.0)
            np.testing.assert_allclose(b.numpy(), expect, rtol=1e-6)

    def test_version_counter_detects_mutation_before_backward(self):
        w = rt.randn(8, requires_grad=True)
        y = w * 2.0
        with F.fusion():
            z = y.exp()
            z.numpy()
        y._version.bump()
        with pytest.raises(RuntimeError, match="inplace"):
            z.sum().backward()

    def test_no_grad_boundary_not_fused_through(self):
        w = rt.randn(8, requires_grad=True)
        with F.fusion():
            with no_grad():
                c = w * 2.0
            y = c * w
            y.sum().backward()
        np.testing.assert_allclose(w.grad.numpy(), c.numpy(), rtol=1e-6)

    def test_depth_cap_flushes(self):
        x = rt.randn(4)
        with F.fusion():
            y = x
            for _ in range(F.MAX_CHAIN_DEPTH + 2):
                y = y + 1.0
            np.testing.assert_allclose(
                y.numpy(), x.numpy() + (F.MAX_CHAIN_DEPTH + 2), rtol=1e-6)

    def test_retain_graph_through_a_fused_node(self):
        x = rt.randn(6, requires_grad=True)
        with F.fusion():
            q = (x * x).exp().sum()
        q.backward(retain_graph=True)
        g1 = x.grad.numpy().copy()
        q.backward()
        np.testing.assert_allclose(x.grad.numpy(), 2 * g1, rtol=1e-6)
        with pytest.raises(RuntimeError, match="second time"):
            q.backward()


class TestFusedElementwiseKernel:
    def test_plain_version_matches_composite(self):
        rng = np.random.default_rng(2)
        a = torch.from_numpy(rng.standard_normal((20, 15), dtype=np.float32))
        b = torch.full((20, 15), 0.5)
        chain, ext = F.capture_chain(
            lambda p, q: (p * q).tanh() + q, rt.Tensor(a), rt.Tensor(b))
        assert [st[0] for st in chain.steps] == ["mul", "tanh", "add"]
        o1, _, o2 = FE.fused_elementwise(chain, *ext)
        np.testing.assert_allclose(o1.numpy(), a.numpy() * 0.5, rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(o2.numpy(), np.tanh(a.numpy() * 0.5)
                                   + 0.5, rtol=1e-5, atol=1e-6)


class TestForeachOptimizers:
    def _params(self, n2d=12, n1d=12):
        rt.manual_seed(3)
        return ([rt.randn(16, 8, requires_grad=True) for _ in range(n2d)]
                + [rt.randn(8, requires_grad=True) for _ in range(n1d)])

    def _run(self, opt_cls, foreach, steps=3, **kw):
        ps = self._params()
        opt = getattr(optim, opt_cls)(ps, foreach=foreach, **kw)
        for s in range(steps):
            rng = np.random.default_rng(s)
            for p in ps:
                p.grad = rt.tensor(rng.standard_normal(p.shape,
                                                       dtype=np.float32))
            opt.step()
        return [p.numpy() for p in ps]

    @pytest.mark.parametrize("opt_cls,kw", [
        ("SGD", dict(lr=1e-2, momentum=0.9, nesterov=True,
                     weight_decay=1e-4)),
        ("Adam", dict(lr=1e-3)),
        ("AdamW", dict(lr=1e-3, weight_decay=0.01)),
        ("Adafactor", dict(lr=1e-2)),
    ])
    def test_foreach_equivalent_to_perleaf(self, opt_cls, kw):
        fe = self._run(opt_cls, True, **kw)
        pl = self._run(opt_cls, False, **kw)
        for a, b in zip(fe, pl):
            np.testing.assert_allclose(a, b, rtol=2e-6, atol=2e-7)

    def test_foreach_matches_reference(self):
        """SGD with momentum (the eager_train optimizer) and AdamW on the
        same params and grads as the reference's foreach step."""
        import repro.optim as joptim
        for cls, kw in (("SGD", dict(lr=0.1, momentum=0.9)),
                        ("AdamW", dict(lr=1e-3))):
            res = []
            for P, O in ((repro, joptim), (rt, optim)):
                P.manual_seed(3)
                ps = [P.randn(16, 8, requires_grad=True),
                      P.randn(8, requires_grad=True)]
                opt = getattr(O, cls)(ps, **kw)
                for s in range(3):
                    rng = np.random.default_rng(s)
                    for p in ps:
                        p.grad = P.tensor(rng.standard_normal(
                            p.shape, dtype=np.float32))
                    opt.step()
                res.append([np.asarray(p.numpy()) for p in ps])
            for a, b in zip(*res):
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)

    def test_staggered_grads_keep_perleaf_bias_correction(self):
        def run(foreach):
            rt.manual_seed(11)
            p1 = rt.randn(8, requires_grad=True)
            p2 = rt.randn(8, requires_grad=True)
            opt = optim.Adam([p1, p2], lr=1e-2, foreach=foreach)
            for s in range(6):
                rng = np.random.default_rng(s)
                p1.grad = rt.tensor(rng.standard_normal(8).astype(np.float32))
                p2.grad = (rt.tensor(rng.standard_normal(8).astype(
                    np.float32)) if s >= 5 else None)
                opt.step()
            return p1.numpy(), p2.numpy(), int(opt.state[id(p2)]["step"])

        a1, a2, st_f = run(True)
        b1, b2, st_l = run(False)
        np.testing.assert_allclose(a1, b1, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(a2, b2, rtol=1e-6, atol=1e-7)
        assert st_f == st_l == 1

    def test_state_dict_roundtrip_preserves_perleaf_state(self):
        ps = self._params(4, 0)
        opt = optim.AdamW(ps, lr=1e-3, foreach=True)
        for p in ps:
            p.grad = rt.Tensor(p.data * 0.1)
        opt.step()
        sd = opt.state_dict()
        assert len(sd["state"]) == 4
        assert all("m" in s and "v" in s and "step" in s
                   for s in sd["state"])
        opt2 = optim.AdamW(ps, lr=1e-3, foreach=True)
        opt2.load_state_dict(sd)
        assert int(opt2.state[id(ps[0])]["step"]) == 1

    def test_functional_foreach_make_optimizer(self):
        from repro_torch.optim.functional import make_optimizer
        rng = np.random.default_rng(0)
        params = [torch.from_numpy(rng.standard_normal((8, 4),
                                                       dtype=np.float32)),
                  torch.from_numpy(rng.standard_normal(4, dtype=np.float32))]
        grads = [p * 0.1 for p in params]
        for name in ("sgd", "adamw"):
            init_r, upd_r = make_optimizer(name, lr=1e-2)
            init_f, upd_f = make_optimizer(name, foreach=True, lr=1e-2)
            p_r, _ = upd_r(grads, init_r(params), params)
            p_f, _ = upd_f(grads, init_f(params), params)
            for a, b in zip(p_r, p_f):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-6,
                                           atol=2e-7)


# ----------------------------------------------------------------------
# allocator and streams (tests/test_allocator_streams.py)
# ----------------------------------------------------------------------

class TestRounding:
    def test_rounds_to_512(self):
        assert round_size(1) == ROUND_BYTES
        assert round_size(512) == 512
        assert round_size(513) == 1024

    @given(n=st.integers(0, 1 << 24))
    @settings(max_examples=100, deadline=None)
    def test_round_properties(self, n):
        r = round_size(n)
        assert r >= max(n, ROUND_BYTES)
        assert r % ROUND_BYTES == 0
        assert r - n < ROUND_BYTES or n == 0


class TestCachePolicy:
    def test_same_size_reuses_block(self):
        alloc = CachingAllocator()
        b1 = alloc.allocate(1000, stream=0)
        alloc.free(b1)
        b2 = alloc.allocate(900, stream=0)
        assert b2 is b1
        assert alloc.stats.num_cache_hits == 1
        assert alloc.stats.num_system_allocs == 1

    def test_per_stream_pools(self):
        alloc = CachingAllocator()
        b1 = alloc.allocate(1024, stream=0)
        alloc.free(b1)
        b2 = alloc.allocate(1024, stream=1)
        assert b2 is not b1
        assert alloc.stats.num_cache_misses == 2

    def test_cross_stream_free_defers_reuse(self):
        alloc = CachingAllocator()
        b = alloc.allocate(2048, stream=0)
        alloc.free(b, stream=1)
        b2 = alloc.allocate(2048, stream=0)
        assert b2 is not b
        alloc.synchronize()
        b3 = alloc.allocate(2048, stream=0)
        assert b3 is b

    def test_empty_cache(self):
        alloc = CachingAllocator()
        blocks = [alloc.allocate(4096) for _ in range(4)]
        for b in blocks:
            alloc.free(b)
        assert alloc.empty_cache() == 4 * 4096
        assert alloc.stats.bytes_reserved == 0

    @given(sizes=st.lists(st.integers(1, 1 << 16), min_size=1,
                          max_size=64))
    @settings(max_examples=50, deadline=None)
    def test_accounting_invariants(self, sizes):
        alloc = CachingAllocator()
        blocks = []
        for s in sizes:
            blocks.append(alloc.allocate(s))
            st_ = alloc.stats
            assert st_.bytes_active <= st_.bytes_reserved
            assert st_.peak_bytes_active >= st_.bytes_active
        for b in blocks:
            alloc.free(b)
        assert alloc.stats.bytes_active == 0
        assert alloc.stats.bytes_reserved == sum(round_size(s)
                                                 for s in sizes)
        before = alloc.stats.num_system_allocs
        for s in sizes:
            alloc.allocate(s)
        assert alloc.stats.num_system_allocs == before


class TestRefcounting:
    def test_tensor_del_returns_block(self):
        alloc = rt.allocator.device_allocator()
        base_active = alloc.stats.bytes_active
        t = rt.zeros(1024, 1024)
        assert alloc.stats.bytes_active >= base_active + 4 * 1024 * 1024
        del t
        gc.collect()
        assert alloc.stats.bytes_active <= base_active + ROUND_BYTES

    def test_graph_release_frees_saved(self):
        alloc = rt.allocator.device_allocator()
        a = rt.randn(256, 256, requires_grad=True)
        loss = (a.exp() * 2.0).sum()
        mid = alloc.stats.bytes_active
        loss.backward()
        del loss
        gc.collect()
        assert alloc.stats.bytes_active < mid

    def test_views_share_storage(self):
        t = rt.zeros(64, 64)
        assert t[0]._storage is t._storage


class TestStreams:
    def test_current_stream_context(self):
        s = Stream()
        assert current_stream() is not s
        with stream(s):
            assert current_stream() is s
            rt.randn(8)
        assert current_stream() is not s

    def test_stream_synchronize_and_query(self):
        s = Stream()
        with stream(s):
            x = rt.randn(64, 64)
            _ = x @ x
        s.synchronize()
        assert s.query()

    def test_event_ordering(self):
        s1, s2 = Stream(), Stream()
        with stream(s1):
            _ = rt.randn(32, 32) @ rt.randn(32, 32)
        ev = s1.record_event()
        s2.wait_event(ev)
        assert ev.query()

    def test_event_timing(self):
        e1 = Event(enable_timing=True)
        e2 = Event(enable_timing=True)
        e1.record()
        _ = rt.randn(64, 64) @ rt.randn(64, 64)
        e2.record()
        assert e1.elapsed_time(e2) >= 0.0

    def test_tensor_tracks_stream(self):
        s = Stream()
        with stream(s):
            t = rt.randn(4)
        assert t._storage.stream_id == s.stream_id
