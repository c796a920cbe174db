"""Async HTTP front-end for the serving engine — stdlib asyncio only (port
of ``repro/serve/frontend.py``).

Endpoints:
  POST /generate  {"prompt": [ints], "max_new": n, "deadline_s": s}
                  → ``text/event-stream``: one ``data: {"token": t}`` event
                  per decoded token, then ``data: {"done": true, ...}``.
                  → 503 + ``Retry-After`` when the bounded queue is full
                  (load shedding: new work is rejected before resident
                  work is evicted) or the server is draining.
  GET  /healthz   → {"ok": ..., "queued": q, "active": a, ...}; when a
                  supervisor wraps the engine this reflects its health
                  state machine ("healthy"/"degraded"/"recovering").
  GET  /stats     → engine.stats (+ supervisor stats) as JSON

Threading model: the engine is single-threaded compute, so every engine
touch (submit / cancel / pump) happens under one lock.  ``pump()`` runs in
the default executor (it blocks on device steps); the asyncio loop stays
free to accept connections and stream tokens.  Tokens flow engine → client
through a bounded per-request ``asyncio.Queue`` fed by the ``Request.
on_token`` hook via ``call_soon_threadsafe``:

  * backpressure — a client that stops reading fills its queue; the next
    token overflows and the front-end cancels the request in the engine
    (error="backpressure") instead of buffering unboundedly.  TCP-level
    pushback is handled separately by awaiting ``writer.drain()``.
  * deadlines — ``deadline_s`` rides on the Request; the engine's pump
    expires it (error="deadline") whether the request is queued or
    mid-decode, and the stream ends with the partial output.
  * disconnects — a watcher on the request socket notices EOF (client
    gone) even **before the first token** and cancels the request
    (error="disconnected"), so abandoned requests stop burning decode
    steps instead of staying resident until completion.

Graceful shutdown: ``stop(drain_timeout_s=...)`` enters drain mode — new
requests get 503, in-flight requests finish (until the timeout) — then
closes the server.

The module doubles as the client: ``sse_generate`` speaks the protocol and
``drive_http_trace`` replays a Poisson arrival trace against a live server
(``launch/serve.py --http`` and the socket tests use it).
"""
from __future__ import annotations

import asyncio
import json
import threading
from typing import Any

import numpy as np

from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.faults import FaultPlan, QueueFull


class HttpFrontend:
    def __init__(self, engine: ServingEngine, *, supervisor=None,
                 host: str = "127.0.0.1", port: int = 0,
                 queue_tokens: int = 256, poll_s: float = 0.002,
                 drain_delay_s: float = 0.0,
                 faults: FaultPlan | None = None):
        if engine.cfg.scheduler != "continuous":
            raise ValueError("HTTP streaming needs the continuous scheduler "
                             "(wave batches whole requests)")
        if supervisor is not None and supervisor.engine is not engine:
            raise ValueError("supervisor wraps a different engine")
        self.engine = engine
        self.supervisor = supervisor
        self.host, self.port = host, port
        self.queue_tokens = queue_tokens
        self.poll_s = poll_s
        # test hook: sleep after each streamed event, emulating a saturated
        # egress link (kernel socket buffers hide TCP pushback at the tiny
        # payload sizes the test models use)
        self.drain_delay_s = drain_delay_s
        # fault injection (sse_stall site); defaults to the supervisor's
        # plan so one --fault-plan arms the whole stack
        self.faults = faults if faults is not None else (
            supervisor.faults if supervisor is not None else None)
        self._lock = threading.Lock()     # serializes every engine touch
        self._uid = 0
        self._overflow: set[int] = set()  # uids whose client fell behind
        self._server: asyncio.AbstractServer | None = None
        self._pump_task: asyncio.Task | None = None
        self._stopping = False
        self._draining = False

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._pump_task = asyncio.ensure_future(self._pump_loop())

    async def stop(self, *, drain_timeout_s: float = 0.0) -> bool:
        """Shut down; with ``drain_timeout_s`` > 0, first enter drain mode:
        reject new requests with 503 and keep pumping until every resident
        request finishes or the timeout passes.  Returns True when the
        engine drained fully."""
        drained = True
        if drain_timeout_s > 0:
            self._draining = True
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            while loop.time() - t0 < drain_timeout_s:
                with self._lock:
                    if self.engine.idle():
                        break
                await asyncio.sleep(self.poll_s)
            with self._lock:
                drained = self.engine.idle()
        self._stopping = True
        if self._pump_task is not None:
            await self._pump_task
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        return drained

    def _pump_once(self) -> bool:
        with self._lock:
            if self.supervisor is not None:
                return self.supervisor.pump()
            return self.engine.pump()

    async def _pump_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._stopping:
            busy = await loop.run_in_executor(None, self._pump_once)
            if not busy:
                await asyncio.sleep(self.poll_s)

    # ------------------------------------------------------------- handlers
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request = await reader.readline()
            parts = request.decode("ascii", "replace").split()
            if len(parts) < 2:
                return
            method, path = parts[0], parts[1]
            clen = 0
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                key, _, val = line.decode("ascii", "replace").partition(":")
                if key.strip().lower() == "content-length":
                    clen = int(val)
            body = (json.loads(await reader.readexactly(clen))
                    if clen else {})
            if method == "POST" and path == "/generate":
                await self._generate(body, reader, writer)
            elif method == "GET" and path == "/healthz":
                self._json(writer, self._health())
            elif method == "GET" and path == "/stats":
                with self._lock:
                    stats = dict(self.engine.stats)
                    if self.supervisor is not None:
                        stats["supervisor"] = {
                            **{k: v for k, v in
                               self.supervisor.stats.items()},
                            "state": self.supervisor.state}
                self._json(writer, stats)
            else:
                self._json(writer, {"error": "not found"}, status=404)
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    def _health(self) -> dict:
        with self._lock:
            if self.supervisor is not None:
                health = self.supervisor.health()
            else:
                health = {
                    "ok": True,
                    "queued": len(self.engine.queue),
                    "active": sum(r is not None
                                  for r in self.engine._slots)}
        health["draining"] = self._draining
        return health

    @staticmethod
    def _json(writer, obj: dict, status: int = 200,
              headers: dict | None = None) -> None:
        payload = json.dumps(obj).encode()
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        writer.write(
            f"HTTP/1.1 {status} {'OK' if status == 200 else 'ERR'}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(payload)}\r\n{extra}"
            f"Connection: close\r\n\r\n".encode() + payload)

    def _submit(self, req: Request) -> None:
        with self._lock:
            if self.supervisor is not None:
                self.supervisor.submit(req)
            else:
                self.engine.submit(req)

    async def _generate(self, body: dict, reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter) -> None:
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue(maxsize=self.queue_tokens)
        if self._draining:
            self._json(writer, {"error": "draining"}, status=503,
                       headers={"Retry-After": "1"})
            return
        with self._lock:
            uid = self._uid
            self._uid += 1

        def on_token(req: Request, tok: int) -> None:
            # executor thread (inside pump, engine lock held) → loop thread
            def push():
                try:
                    queue.put_nowait(tok)
                except asyncio.QueueFull:
                    self._overflow.add(req.uid)
            loop.call_soon_threadsafe(push)

        req = Request(uid, np.asarray(body["prompt"], np.int32),
                      max_new=int(body.get("max_new", 16)),
                      deadline_s=float(body.get("deadline_s", 0.0)),
                      on_token=on_token)
        try:
            self._submit(req)
        except QueueFull as exc:        # load shedding: reject-new, never
            self._json(writer, {"error": "overloaded"}, status=503,
                       headers={"Retry-After":        # evict resident work
                                str(max(1, round(exc.retry_after_s)))})
            return

        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-store\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        # disconnect watcher: the client sends nothing after its request
        # body, so a completed read means EOF (socket closed).  Checked
        # every loop tick — a disconnect between admission and first token
        # previously left the request resident until completion.
        eof_task: asyncio.Task = asyncio.ensure_future(reader.read(1))
        sent = 0
        try:
            while True:
                if eof_task.done() and not eof_task.result():
                    with self._lock:
                        self.engine.cancel(uid, error="disconnected")
                    if not req.error:
                        req.error = "disconnected"
                    break
                if uid in self._overflow:
                    self._overflow.discard(uid)
                    with self._lock:
                        self.engine.cancel(uid, error="backpressure")
                    if not req.error:      # finished before the cancel
                        req.error = "backpressure"   # tokens were dropped
                    break
                try:
                    tok = await asyncio.wait_for(queue.get(), timeout=0.05)
                except asyncio.TimeoutError:
                    if req.done and queue.empty():
                        break
                    if self.supervisor is not None and \
                            self.supervisor._results.get(uid, req).done:
                        break              # finished on a post-rollback clone
                    continue
                if self.faults is not None:
                    stall = self.faults.fire("sse_stall")
                    if stall is not None:
                        await asyncio.sleep(stall.payload)
                writer.write(f"data: {json.dumps({'token': int(tok)})}\n\n"
                             .encode())
                await writer.drain()        # TCP backpressure
                if self.drain_delay_s:
                    await asyncio.sleep(self.drain_delay_s)
                sent += 1
            if self.supervisor is not None:
                req = self.supervisor._results.get(uid, req)
            final = {"done": True, "n": len(req.out), "sent": sent,
                     "error": req.error}
            writer.write(f"data: {json.dumps(final)}\n\n".encode())
        except (ConnectionError, asyncio.CancelledError):
            with self._lock:
                self.engine.cancel(uid, error="cancelled")
            raise
        finally:
            eof_task.cancel()


# ------------------------------------------------------------------ client
async def sse_generate(host: str, port: int, prompt, *, max_new: int = 16,
                       deadline_s: float = 0.0,
                       read_delay_s: float = 0.0) -> tuple[list[int], dict]:
    """POST /generate and consume the SSE stream → (tokens, final-event).

    ``read_delay_s`` sleeps between event reads — test hook to provoke the
    server-side backpressure cancel.  A 503 rejection returns
    ``([], {"status": 503, "retry_after_s": ...})``."""
    reader, writer = await asyncio.open_connection(host, port)
    body = json.dumps({"prompt": [int(t) for t in prompt],
                       "max_new": max_new,
                       "deadline_s": deadline_s}).encode()
    writer.write(f"POST /generate HTTP/1.1\r\nHost: {host}\r\n"
                 f"Content-Type: application/json\r\n"
                 f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    await writer.drain()
    status_line = await reader.readline()
    status = int(status_line.split()[1]) if status_line.split()[1:] else 0
    retry_after = 0.0
    while True:                                   # response headers
        line = await reader.readline()
        if line in (b"\r\n", b""):
            break
        key, _, val = line.decode().partition(":")
        if key.strip().lower() == "retry-after":
            retry_after = float(val)
    if status != 200:
        writer.close()
        return [], {"status": status, "retry_after_s": retry_after}
    tokens: list[int] = []
    final: dict = {}
    while True:
        line = await reader.readline()
        if not line:
            break
        line = line.strip()
        if not line.startswith(b"data:"):
            continue
        event = json.loads(line[5:])
        if "token" in event:
            tokens.append(int(event["token"]))
            if read_delay_s:
                await asyncio.sleep(read_delay_s)
        if event.get("done"):
            final = event
            break
    writer.close()
    return tokens, final


async def fetch_json(host: str, port: int, path: str) -> dict:
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: {host}\r\n\r\n".encode())
    await writer.drain()
    clen = 0
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b""):
            break
        key, _, val = line.decode().partition(":")
        if key.strip().lower() == "content-length":
            clen = int(val)
    payload = await reader.readexactly(clen)
    writer.close()
    return json.loads(payload)


async def drive_http_trace(host: str, port: int,
                           trace: list[dict]) -> list[dict[str, Any]]:
    """Replay a Poisson arrival trace against a live server.

    Each trace entry: {"t": arrival-offset-seconds, "prompt": array,
    "max_new": n, [...]} — returns per-request dicts with the streamed
    tokens in submission order."""

    async def one(spec: dict) -> dict:
        await asyncio.sleep(float(spec.get("t", 0.0)))
        tokens, final = await sse_generate(
            host, port, spec["prompt"], max_new=int(spec["max_new"]),
            deadline_s=float(spec.get("deadline_s", 0.0)))
        return {"uid": spec.get("uid"), "tokens": tokens, "final": final}

    return list(await asyncio.gather(*(one(s) for s in trace)))
