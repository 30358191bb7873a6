"""The port's front door (``repro_torch.serving.frontend`` and
``launch/server.py``): the cases of tests/test_frontend.py run on the
port's engine on the CPU over ``clockutil.FakeClock`` — async streaming,
mid-stream cancellation, watermark backpressure, SLO-aware admission,
randomized churn with zero drops, and the real-socket SSE smoke — with
the reference's params carried across, so the streamed tokens equal the
reference frontend's and the dense oracle's."""

import asyncio
import json
import random

import pytest

from repro.serving.engine import ServingEngine as JEngine
from repro.serving.frontend import AsyncFrontend as JFrontend
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.errors import (AdmissionRejected,
                                        BackpressureRejected)
from repro_torch.serving.frontend import AsyncFrontend
from repro_torch.serving.scheduler import RequestState

from clockutil import FakeClock
from test_serving import dense_rollout
from torch_port_helpers import tiny_models


def run(coro):
    """Run an async test body on a fresh event loop."""
    return asyncio.run(coro)


async def spin(n: int = 4):
    """Yield the loop ``n`` times so queue consumers drain."""
    for _ in range(n):
        await asyncio.sleep(0)


def make_engine(engine=ServingEngine, **kw):
    cfg, params, tcfg, tparams = tiny_models()
    kw.setdefault("page_size", 4)
    kw.setdefault("num_pages", 64)
    kw.setdefault("max_batch", 4)
    clk = kw.pop("clock", None) or FakeClock()
    if engine is ServingEngine:
        return ServingEngine(tcfg, tparams, clock=clk, device="cpu",
                             **kw), clk
    return engine(cfg, params, clock=clk, **kw), clk


async def consume(fe, prompt, mnt, events, **kw):
    """Standard consumer: append every StreamEvent; record a typed
    admission rejection as the string 'rejected'."""
    try:
        async for ev in fe.stream(prompt, mnt, **kw):
            events.append(ev)
    except AdmissionRejected:
        events.append("rejected")


def pool_conserved(eng):
    """KV refcount conservation: allocated == freed + held, and held
    pages + free pages == the pool."""
    pool = eng.kv.pool
    held = len(pool.refs)
    st = pool.stats
    return (st.allocated_pages == st.freed_pages + held
            and held + pool.num_free == pool.num_pages)


def stream_tokens(engine, frontend, prompt, n_new):
    """Stream one request through ``frontend`` over ``engine``; return
    its token events, its terminal events and the frontend."""
    async def main():
        eng, _ = make_engine(engine)
        fe = frontend(eng)
        events = []
        task = asyncio.ensure_future(consume(fe, prompt, n_new, events))
        await spin()
        while fe.busy and not task.done():
            fe.pump()
            await spin()
        await task
        assert eng.kv.pool.num_free == eng.kv.pool.num_pages
        return events, fe

    events, fe = run(main())
    return ([e for e in events if e.kind == "token"],
            [e for e in events if e.terminal], fe)


class TestStreaming:
    def test_stream_matches_reference_frontend_and_dense_oracle(self):
        prompt, n_new = [1, 2, 3, 4, 5], 6
        toks, terminals, fe = stream_tokens(ServingEngine, AsyncFrontend,
                                            prompt, n_new)
        assert len(terminals) == 1
        assert terminals[0].kind == "finished"
        assert [e.index for e in toks] == list(range(len(toks)))
        assert fe.metrics["tokens_dropped"] == 0
        ref_toks, ref_terms, _ = stream_tokens(JEngine, JFrontend, prompt,
                                               n_new)
        assert [e.token for e in toks] == [e.token for e in ref_toks]
        assert [e.kind for e in terminals] == [e.kind for e in ref_terms]
        cfg, params, _, _ = tiny_models()
        assert [e.token for e in toks] == dense_rollout(cfg, params,
                                                        prompt, n_new)

    def test_cancel_mid_stream_frees_pages_immediately(self):
        async def main():
            eng, _ = make_engine()
            fe = AsyncFrontend(eng)
            got = []
            agen = fe.stream([1, 2, 3, 4, 5, 6, 7, 8], 64)
            # pull two tokens, then walk away mid-decode
            while len(got) < 2:
                t = asyncio.ensure_future(agen.__anext__())
                await spin()                   # let the body submit
                while not t.done():
                    fe.pump()
                    await spin()
                ev = await t
                assert ev.kind == "token"      # budget 64: no terminal yet
                got.append(ev.token)
            assert eng.running                 # mid-decode, holding pages
            await agen.aclose()                # disconnect
            # cancellation is synchronous: pages free NOW, same tick
            assert eng.kv.pool.num_free == eng.kv.pool.num_pages
            rid = next(iter(eng.scheduler.done))
            assert eng.scheduler.done[rid].state is RequestState.CANCELLED
            assert fe.metrics["client_cancelled"] == 1
            assert fe.metrics["tokens_dropped"] == 0
            assert not fe._streams             # nothing stuck

        run(main())

    def test_disconnect_before_first_token_cancels_queued(self):
        async def main():
            eng, _ = make_engine()
            fe = AsyncFrontend(eng)
            # aclose before the first __anext__ never starts the
            # generator body: nothing submitted, nothing to clean
            agen = fe.stream([1, 2, 3], 8)
            await agen.aclose()
            assert not eng.scheduler.waiting
            assert not fe._streams

            # the submitted-but-unserved variant: body ran (request
            # queued), consumer walks away before any pump
            agen2 = fe.stream([4, 5, 6], 8)
            task = asyncio.ensure_future(agen2.__anext__())
            await spin()                       # body runs -> submitted
            assert len(eng.scheduler.waiting) == 1
            task.cancel()
            await spin()
            await agen2.aclose()
            assert not eng.scheduler.waiting   # cancelled out of queue
            assert eng.kv.pool.num_free == eng.kv.pool.num_pages
            assert not fe._streams

        run(main())

    def test_max_stream_tokens_caps_budget(self):
        async def main():
            eng, _ = make_engine()
            fe = AsyncFrontend(eng, max_stream_tokens=3)
            events = []
            task = asyncio.ensure_future(
                consume(fe, [1, 2, 3, 4], 100, events))
            await spin()
            while not task.done():
                fe.pump()
                await spin()
            await task
            toks = [e for e in events if e.kind == "token"]
            assert len(toks) == 3              # budget clamped
            assert events[-1].terminal

        run(main())


class TestBackpressure:
    def saturate(self, eng, n_tokens):
        """Hold pages via a raw KV sequence (no scheduler involvement)
        so live-page fraction is exact and deterministic."""
        assert eng.kv.create(999, list(range(n_tokens)))

    def test_low_priority_shed_high_priority_meets_deadline(self):
        async def main():
            clk = FakeClock()
            eng, _ = make_engine(num_pages=16, clock=clk)
            fe = AsyncFrontend(eng, hwm_frac=0.95,
                               low_priority_hwm_frac=0.5,
                               retry_after_s=2.5)
            self.saturate(eng, 32)             # 8/16 pages live = 0.5
            # low priority: at the 0.5 watermark -> typed shed
            with pytest.raises(BackpressureRejected) as ei:
                await fe.stream([1, 2, 3], 4, priority=0).__anext__()
            assert isinstance(ei.value, AdmissionRejected)  # satellite
            assert ei.value.retry_after_s == 2.5
            assert fe.metrics["backpressure_rejections"] == 1
            # high priority: below the 0.95 watermark -> serves, and
            # its TTFT deadline is met (no misses) under the fake clock
            events = []
            task = asyncio.ensure_future(consume(
                fe, [1, 2, 3], 4, events, priority=1,
                ttft_deadline_ms=1e4))
            await spin()
            while not task.done():
                fe.pump()
                clk.advance(0.001)
                await spin()
            await task
            assert events[-1].kind == "finished"
            assert eng.metrics["ttft_deadline_misses"] == 0
            eng.kv.free_seq(999)

        run(main())

    def test_queue_depth_gate_carries_retry_after(self):
        async def main():
            eng, _ = make_engine()
            fe = AsyncFrontend(eng, max_queue_depth=1,
                               retry_after_s=0.25)
            agen = fe.stream([1, 2, 3], 4)
            t = asyncio.ensure_future(agen.__anext__())
            await spin()                       # first request queued
            with pytest.raises(BackpressureRejected) as ei:
                await fe.stream([4, 5, 6], 4).__anext__()
            assert ei.value.retry_after_s == 0.25
            t.cancel()
            await spin()
            await agen.aclose()

        run(main())


class TestSLOAdmission:
    def test_edf_orders_queued_admission(self):
        eng, _ = make_engine(max_batch=1)
        rid_a = eng.submit([1, 2, 3], max_new_tokens=2)
        rid_b = eng.submit([4, 5, 6], max_new_tokens=2,
                           ttft_deadline_ms=50.0)
        eng.step()
        # one slot: the deadline-bearing request wins it (EDF), even
        # though it arrived second
        assert rid_b in eng.running
        assert rid_a not in eng.running

    def test_priority_beats_fifo(self):
        eng, _ = make_engine(max_batch=1)
        rid_a = eng.submit([1, 2, 3], max_new_tokens=2)
        rid_b = eng.submit([4, 5, 6], max_new_tokens=2, priority=5)
        eng.step()
        assert rid_b in eng.running
        assert rid_a not in eng.running

    def test_tenant_fair_share_prefers_lighter_tenant(self):
        eng, _ = make_engine(max_batch=1)
        rid = eng.submit([1, 2, 3, 4], max_new_tokens=2, tenant="heavy")
        assert [r.req_id for r in eng.run()] == [rid]
        assert eng.scheduler.tenant_tokens["heavy"] > 0
        rid_h = eng.submit([5, 6, 7], max_new_tokens=2, tenant="heavy")
        rid_l = eng.submit([8, 9, 10], max_new_tokens=2, tenant="light")
        eng.step()
        # same priority, no deadlines: the tenant with fewer scheduled
        # tokens is admitted first despite the later req_id
        assert rid_l in eng.running
        assert rid_h not in eng.running

    def test_defaults_degenerate_to_fifo(self):
        eng, _ = make_engine(max_batch=1)
        rid_a = eng.submit([1, 2, 3], max_new_tokens=2)
        eng.submit([4, 5, 6], max_new_tokens=2)
        eng.step()
        assert rid_a in eng.running

    def test_ttft_deadline_miss_counted(self):
        clk = FakeClock()
        eng, _ = make_engine(max_batch=1, clock=clk)
        eng.submit([1, 2, 3, 4], max_new_tokens=30)
        eng.step()                             # hog takes the slot
        rid = eng.submit([9, 8, 7], max_new_tokens=4,
                         ttft_deadline_ms=50.0)
        clk.advance(0.1)
        eng.step()
        assert eng.scheduler.done[rid].state is RequestState.TIMED_OUT
        assert eng.metrics["ttft_deadline_misses"] == 1

    def test_aging_prevents_priority_starvation(self):
        # one slot + a stream of priority-9 arrivals would starve the
        # priority-0 request forever; aging ranks it to the very front
        # after ``aging_steps`` bypasses
        eng, _ = make_engine(max_batch=1, aging_steps=3)
        rid_low = eng.submit([1, 2, 3], max_new_tokens=2, priority=0)
        hi = [eng.submit([10 + i, 11, 12], max_new_tokens=1, priority=9)
              for i in range(2)]
        for _ in range(40):
            if rid_low in eng.scheduler.done:
                break
            # keep high-priority pressure up: top the queue back up
            if len(eng.scheduler.waiting) < 2 \
                    and eng.metrics["aged_admissions"] == 0:
                hi.append(eng.submit([20, 21, 22], max_new_tokens=1,
                                     priority=9))
            eng.step()
        assert rid_low in eng.scheduler.done
        assert eng.scheduler.done[rid_low].state is RequestState.FINISHED
        assert eng.metrics["aged_admissions"] >= 1


class TestChurnProperty:
    """Satellite: randomized client churn against the frontend.
    Invariants: KV refcount conservation at every pump, exactly one
    terminal event per completed stream, zero dropped tokens, zero
    stuck streams."""

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_randomized_churn_conserves_and_terminates(self, seed):
        async def main():
            rng = random.Random(seed)
            clk = FakeClock()
            eng, _ = make_engine(num_pages=32, max_batch=3, clock=clk)
            fe = AsyncFrontend(eng, hwm_frac=1.0)
            streams = []                       # (events, task)
            for round_no in range(30):
                act = rng.random()
                if act < 0.45 and len(streams) < 8:
                    events = []
                    prompt = [rng.randrange(1, 96)
                              for _ in range(rng.choice([3, 5, 9]))]
                    t = asyncio.ensure_future(consume(
                        fe, prompt, rng.choice([2, 4, 8]), events,
                        priority=rng.choice([0, 1]),
                        tenant=rng.choice(["a", "b"])))
                    streams.append((events, t))
                elif act < 0.60 and eng.running:
                    # cancel-mid-decode from the server side
                    eng.cancel(rng.choice(list(eng.running)))
                elif act < 0.75 and streams:
                    # client disconnect: kill a random consumer task
                    _, t = rng.choice(streams)
                    if not t.done():
                        t.cancel()
                fe.pump()
                clk.advance(0.01)
                await spin()
                assert pool_conserved(eng), f"round {round_no}"
            # drain: pump until every consumer task resolves
            for _ in range(200):
                if all(t.done() for _, t in streams) and not fe.busy:
                    break
                fe.pump()
                await spin()
            for _, t in streams:
                if not t.done():
                    t.cancel()
                try:
                    await t
                except asyncio.CancelledError:
                    pass
            await spin()
            # exactly one terminal event per stream that got events
            for events, t in streams:
                terms = [e for e in events
                         if e != "rejected" and e.terminal]
                assert len(terms) <= 1
                if events and not t.cancelled() \
                        and "rejected" not in events:
                    assert len(terms) == 1
            assert fe.metrics["tokens_dropped"] == 0
            assert not fe._streams             # zero stuck streams
            assert pool_conserved(eng)
            # frontend held nothing: cancel the raw engine leftovers
            eng.drain()
            assert eng.kv.pool.num_free == eng.kv.pool.num_pages

        run(main())


class TestHttpServer:
    """Real-socket smoke over the raw-asyncio SSE server."""

    def test_sse_roundtrip_metrics_and_503(self):
        from repro_torch.launch.server import HttpFrontendServer, \
            sse_client

        async def main():
            eng, _ = make_engine(num_pages=32)
            fe = AsyncFrontend(eng, hwm_frac=0.95,
                               low_priority_hwm_frac=0.4,
                               idle_sleep_s=0.001)
            server = HttpFrontendServer(fe, "127.0.0.1", 0)
            await server.start()
            try:
                # full stream
                toks, terminal = [], None
                async for ev, data in sse_client(
                        "127.0.0.1", server.port,
                        {"prompt": [1, 2, 3, 4], "max_new_tokens": 3}):
                    if ev == "token":
                        toks.append(data["token"])
                    else:
                        terminal = ev
                assert terminal == "finished"
                assert len(toks) == 3
                # walk away after 1 event: server must cancel + free
                async for ev, data in sse_client(
                        "127.0.0.1", server.port,
                        {"prompt": [5, 6, 7, 8], "max_new_tokens": 64},
                        max_events=1):
                    pass
                for _ in range(500):           # bounded, event-driven
                    if not eng.scheduler.running \
                            and not eng.scheduler.waiting:
                        break
                    await asyncio.sleep(0.01)
                assert not eng.scheduler.running
                assert eng.kv.pool.num_free == eng.kv.pool.num_pages
                # saturated pool -> low-priority 503 + Retry-After
                assert eng.kv.create(999, list(range(64)))  # 16/32 live
                got = []
                async for ev, data in sse_client(
                        "127.0.0.1", server.port,
                        {"prompt": [1, 2], "max_new_tokens": 2}):
                    got.append((ev, data))
                assert got == [("http_error", got[0][1])]
                assert got[0][1]["status"] == 503
                assert got[0][1]["retry_after"] is not None
                eng.kv.free_seq(999)
                # metrics endpoint
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", server.port)
                writer.write(b"GET /metrics HTTP/1.1\r\n"
                             b"Host: x\r\n\r\n")
                await writer.drain()
                raw = await reader.read()
                writer.close()
                body = raw.split(b"\r\n\r\n", 1)[1]
                stats = json.loads(body)
                assert stats["streams_finished"] >= 1
                assert stats["tokens_dropped"] == 0
            finally:
                await server.stop()

        run(main())
