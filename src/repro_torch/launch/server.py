"""Streaming HTTP/SSE serving entry point.

    PYTHONPATH=src python -m repro_torch.launch.server [--preset tiny|small]
        [--host 127.0.0.1] [--port 8008] [--num-pages N]
        [--hwm-frac F] [--max-stream-tokens N] [--selftest N]
        [--device cuda|cpu]

Counterpart of ``repro/launch/server.py``, with the same flags plus
``--device``: the engine runs on CUDA unless ``--device cpu`` is given
(without a GPU and without it, it raises).  A dependency-free asyncio
HTTP server (``asyncio.start_server``) over
:class:`~repro_torch.serving.AsyncFrontend`.  One event-loop task drives
the engine (``frontend.run``); each client connection is a coroutine
consuming an async token stream.

Routes::

    POST /generate   JSON {"prompt": [ints], "max_new_tokens": 16,
                           "priority": 0, "tenant": "default",
                           "ttft_deadline_ms": null, "timeout_ms": null}
                     -> text/event-stream, one SSE event per token:
                          event: token
                          data: {"token": 17, "index": 0}
                        ending with exactly one terminal event
                        (event: finished | cancelled | timed_out |
                         failed).  Backpressure shed -> 503 with a
                        Retry-After header; other admission rejections
                        -> 429; bad JSON -> 400.
    GET  /metrics    engine + frontend counters as JSON
    GET  /healthz    200 "ok"

Disconnect semantics: if the client drops mid-stream the write fails,
the handler abandons the async generator, and its ``finally`` cancels
the request — KV pages free on the same scheduler tick.  ``--selftest
N`` starts the server on an ephemeral loopback port, streams N requests
through a real socket with :func:`sse_client`, prints the metrics, and
exits nonzero on any failure.
"""

from __future__ import annotations

import argparse
import asyncio
import json
from typing import AsyncIterator, Dict, List, Optional, Sequence, Tuple

from ..models.lm import init_params
from ..serving.engine import ServingEngine
from ..serving.errors import AdmissionRejected, BackpressureRejected
from ..serving.frontend import AsyncFrontend
from .serve import PRESETS, preset_config

__all__ = ["HttpFrontendServer", "sse_client", "main"]


def _response(status: str, headers: Dict[str, str], body: bytes) -> bytes:
    head = [f"HTTP/1.1 {status}"]
    head += [f"{k}: {v}" for k, v in headers.items()]
    head += [f"Content-Length: {len(body)}", "Connection: close", "", ""]
    return "\r\n".join(head).encode() + body


def _sse(event: str, data: dict) -> bytes:
    return (f"event: {event}\ndata: {json.dumps(data)}\n\n").encode()


class HttpFrontendServer:
    """Raw-asyncio HTTP/SSE wrapper around an :class:`AsyncFrontend`.

    ``start`` binds the socket and spawns the engine-pump task;
    ``stop`` drains both.  The server object exposes ``port`` after
    ``start`` so tests can bind port 0."""

    def __init__(self, frontend: AsyncFrontend, host: str = "127.0.0.1",
                 port: int = 8008):
        self.frontend = frontend
        self.host, self.port = host, port
        self._server: Optional[asyncio.AbstractServer] = None
        self._pump_task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        """Bind the listening socket and start the engine-pump task."""
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._pump_task = asyncio.ensure_future(self.frontend.run())

    async def stop(self) -> None:
        """Close the socket, stop the pump, cancel open streams."""
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self.frontend.close()
        if self._pump_task is not None:
            await self._pump_task

    # -- request handling ---------------------------------------------------
    async def _read_request(self, reader: asyncio.StreamReader
                            ) -> Tuple[str, str, bytes]:
        line = await reader.readline()
        if not line:
            return "", "", b""
        method, path, _ = line.decode().split(" ", 2)
        clen = 0
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, val = h.decode().partition(":")
            if name.strip().lower() == "content-length":
                clen = int(val.strip())
        body = await reader.readexactly(clen) if clen else b""
        return method, path, body

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            method, path, body = await self._read_request(reader)
            if not method:
                return
            if method == "GET" and path == "/healthz":
                writer.write(_response(
                    "200 OK", {"Content-Type": "text/plain"}, b"ok"))
            elif method == "GET" and path == "/metrics":
                payload = json.dumps(self.frontend.stats(),
                                     default=str).encode()
                writer.write(_response(
                    "200 OK", {"Content-Type": "application/json"},
                    payload))
            elif method == "POST" and path == "/generate":
                await self._generate(writer, body)
            else:
                writer.write(_response(
                    "404 Not Found", {"Content-Type": "text/plain"},
                    b"not found"))
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError):
            pass                      # client went away; nothing to do
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _generate(self, writer: asyncio.StreamWriter,
                        body: bytes) -> None:
        try:
            spec = json.loads(body.decode() or "{}")
            prompt = [int(t) for t in spec["prompt"]]
        except (ValueError, KeyError, TypeError) as e:
            writer.write(_response(
                "400 Bad Request", {"Content-Type": "text/plain"},
                f"bad request body: {e}".encode()))
            return
        try:
            stream = self.frontend.stream(
                prompt,
                int(spec.get("max_new_tokens", 16)),
                priority=int(spec.get("priority", 0)),
                tenant=str(spec.get("tenant", "default")),
                ttft_deadline_ms=spec.get("ttft_deadline_ms"),
                timeout_ms=spec.get("timeout_ms"))
            first = await stream.__anext__()   # admission errors surface here
        except BackpressureRejected as e:
            writer.write(_response(
                "503 Service Unavailable",
                {"Content-Type": "text/plain",
                 "Retry-After": f"{e.retry_after_s:g}"},
                str(e).encode()))
            return
        except AdmissionRejected as e:
            writer.write(_response(
                "429 Too Many Requests", {"Content-Type": "text/plain"},
                str(e).encode()))
            return
        writer.write(("HTTP/1.1 200 OK\r\n"
                      "Content-Type: text/event-stream\r\n"
                      "Cache-Control: no-cache\r\n"
                      "Connection: close\r\n\r\n").encode())
        try:
            ev = first
            while True:
                if ev.terminal:
                    writer.write(_sse(ev.kind, {
                        "req_id": ev.req_id, "error": ev.error}))
                    await writer.drain()
                    return
                writer.write(_sse("token", {
                    "token": ev.token, "index": ev.index}))
                await writer.drain()   # raises when the client is gone
                ev = await stream.__anext__()
        finally:
            # disconnect or server shutdown: abandoning the generator
            # runs its finally -> engine.cancel -> pages free now
            await stream.aclose()


async def sse_client(host: str, port: int, spec: dict,
                     max_events: Optional[int] = None
                     ) -> AsyncIterator[Tuple[str, dict]]:
    """Minimal SSE client: POST ``spec`` to ``/generate`` and yield
    ``(event, data)`` pairs.  Stops after the terminal event, after
    ``max_events`` events (simulating a client that walks away
    mid-stream), or on a non-200 status (yielding one synthetic
    ``("http_error", {"status": ..., "retry_after": ...})`` pair)."""
    reader, writer = await asyncio.open_connection(host, port)
    body = json.dumps(spec).encode()
    writer.write((f"POST /generate HTTP/1.1\r\n"
                  f"Host: {host}\r\nContent-Type: application/json\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    try:
        status_line = (await reader.readline()).decode()
        status = int(status_line.split(" ", 2)[1])
        headers: Dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        if status != 200:
            yield "http_error", {
                "status": status,
                "retry_after": headers.get("retry-after")}
            return
        seen = 0
        event, data = "message", {}
        while True:
            line = await reader.readline()
            if not line:
                return
            text = line.decode().rstrip("\n").rstrip("\r")
            if text.startswith("event:"):
                event = text[6:].strip()
            elif text.startswith("data:"):
                data = json.loads(text[5:].strip())
            elif text == "":
                yield event, data
                seen += 1
                if event != "token":
                    return
                if max_events is not None and seen >= max_events:
                    return            # walk away mid-stream
                event, data = "message", {}
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass


def build_engine(preset: str, *, num_pages: int, page_size: int,
                 max_batch: int, chunk: int, device=None) -> ServingEngine:
    """Construct the preset engine the server fronts (same presets as
    ``launch.serve`` so the two entry points stay comparable), on CUDA
    unless ``device`` says otherwise."""
    cfg = preset_config(preset, "server")
    params = init_params(cfg, seed=0, device="cpu")
    return ServingEngine(cfg, params, page_size=page_size,
                         num_pages=num_pages, max_batch=max_batch,
                         chunk_size=chunk, device=device)


async def _selftest(server: HttpFrontendServer, n: int,
                    vocab: int) -> int:
    """Drive ``n`` streams through a real socket; return the number
    that reached a terminal ``finished`` event with >= 1 token."""
    ok = 0
    for i in range(n):
        prompt = [(3 + 5 * i + j) % (vocab - 1) + 1 for j in range(6)]
        toks: List[int] = []
        terminal = None
        async for ev, data in sse_client(
                server.host, server.port,
                {"prompt": prompt, "max_new_tokens": 4}):
            if ev == "token":
                toks.append(data["token"])
            else:
                terminal = ev
        if terminal == "finished" and toks:
            ok += 1
    return ok


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default="tiny")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--num-pages", type=int, default=256)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--hwm-frac", type=float, default=0.95,
                    help="page watermark for high-priority admission")
    ap.add_argument("--max-stream-tokens", type=int, default=256,
                    help="hard cap on any one request's token budget")
    ap.add_argument("--max-queue-depth", type=int, default=64)
    ap.add_argument("--selftest", type=int, default=None, metavar="N",
                    help="serve N requests through a real socket on an "
                         "ephemeral port, print metrics, and exit")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    eng = build_engine(args.preset, num_pages=args.num_pages,
                       page_size=args.page_size,
                       max_batch=args.max_batch, chunk=args.chunk,
                       device=args.device)
    fe = AsyncFrontend(eng, hwm_frac=args.hwm_frac,
                       max_queue_depth=args.max_queue_depth,
                       max_stream_tokens=args.max_stream_tokens)
    port = 0 if args.selftest else args.port
    server = HttpFrontendServer(fe, args.host, port)

    async def serve() -> int:
        await server.start()
        print(f"[server] listening on http://{server.host}:{server.port}"
              f"  (preset={args.preset}, device={eng.device})")
        if args.selftest is not None:
            vocab = PRESETS[args.preset]["vocab_size"]
            ok = await _selftest(server, args.selftest, vocab)
            await server.stop()
            print(json.dumps(server.frontend.stats(), default=str,
                             indent=2))
            print(f"[selftest] {ok}/{args.selftest} streams finished")
            return 0 if ok == args.selftest else 1
        try:
            await asyncio.Event().wait()      # serve until Ctrl-C
        except (KeyboardInterrupt, asyncio.CancelledError):
            pass
        await server.stop()
        return 0

    raise SystemExit(asyncio.run(serve()))


if __name__ == "__main__":
    main()
