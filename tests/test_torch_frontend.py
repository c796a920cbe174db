"""The port's HTTP/SSE front end (``repro_torch/serve/frontend.py``) on the
CPU: the constructor guards, the admission bound, and the request handler
driven in process — ``HttpFrontend._handle`` fed an ``asyncio.StreamReader``
and a writer that records bytes, with the pump loop running, no socket —
for /healthz, /stats, a 404, a streamed /generate whose tokens equal the
offline engine's and JAX's engine's, and a 503 from the bounded queue.

Two tests open a real socket on 127.0.0.1 (one SSE round trip with
/healthz, and load shedding) and are marked ``slow``, as the JAX package's
socket tests are (tests/test_frontend_robustness.py): they start a server
and its executor thread and poll wall-clock conditions.
"""
from __future__ import annotations

import asyncio
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.models.model_builder import build_model as j_build  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model_builder import build_model  # noqa: E402
from repro_torch.serve.engine import (Request, ServeConfig,  # noqa: E402
                                      ServingEngine)
from repro_torch.serve.faults import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.serve.frontend import (HttpFrontend,  # noqa: E402
                                        drive_http_trace, fetch_json,
                                        sse_generate)
from repro_torch.serve.supervisor import (Supervisor,  # noqa: E402
                                          SupervisorConfig)
from test_torch_fixtures import jax_tree_to_numpy  # noqa: E402

TINY = dict(name="fe-tiny", family="dense", num_layers=1, d_model=16,
            num_heads=2, num_kv_heads=2, head_dim=8, d_ff=32,
            vocab_size=48, dtype="float32")
MAX_LEN = 48


@pytest.fixture(scope="module")
def setup():
    jm = j_build(JModelConfig(**TINY))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(ModelConfig(**TINY), device="cpu")
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    return jm, jp, tm, tp


def _engine(setup, **over):
    cfg = dict(batch_slots=2, max_len=MAX_LEN)
    cfg.update(over)
    return ServingEngine(setup[2], setup[3], ServeConfig(**cfg))


def _prompt(n=4, seed=0):
    return np.random.default_rng(seed).integers(0, 48, size=n).astype(
        np.int32)


def _offline(setup, prompts, max_new):
    """Tokens of the port's and JAX's offline engines, by uid."""
    jm, jp, _, _ = setup
    jeng = JEngine(jm, jp, JServeConfig(batch_slots=2, max_len=MAX_LEN))
    teng = _engine(setup)
    for uid, p in enumerate(prompts):
        jeng.submit(JRequest(uid, p, max_new=max_new))
        teng.submit(Request(uid, p, max_new=max_new))
    jout = {r.uid: r.out for r in jeng.run()}
    tout = {r.uid: r.out for r in teng.run()}
    assert tout == jout
    return tout


class _Writer:
    """Records what the handler writes (stands in for a StreamWriter)."""

    def __init__(self):
        self.buf = bytearray()
        self.closed = False

    def write(self, data: bytes) -> None:
        self.buf += data

    async def drain(self) -> None:
        await asyncio.sleep(0)

    def close(self) -> None:
        self.closed = True

    def status(self) -> int:
        return int(bytes(self.buf).split(b"\r\n", 1)[0].split()[1])

    def events(self) -> list[dict]:
        body = bytes(self.buf).split(b"\r\n\r\n", 1)[1]
        return [json.loads(line[5:]) for line in body.split(b"\n")
                if line.startswith(b"data:")]

    def json(self) -> dict:
        return json.loads(bytes(self.buf).split(b"\r\n\r\n", 1)[1])


def _request(method: str, path: str, body: dict | None = None,
             eof: bool = True) -> asyncio.StreamReader:
    payload = json.dumps(body).encode() if body is not None else b""
    reader = asyncio.StreamReader()
    reader.feed_data(f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                     f"Content-Length: {len(payload)}\r\n\r\n".encode()
                     + payload)
    if eof:                      # a streaming client keeps its socket open
        reader.feed_eof()
    return reader


async def _handled(fe, method, path, body=None, eof=True) -> _Writer:
    w = _Writer()
    await fe._handle(_request(method, path, body, eof), w)
    assert w.closed
    return w


# --------------------------------------------------------------------------
# fast: guards and the handler in process
# --------------------------------------------------------------------------
def test_frontend_requires_continuous_scheduler(setup):
    with pytest.raises(ValueError, match="continuous"):
        HttpFrontend(_engine(setup, scheduler="wave"))


def test_frontend_rejects_foreign_supervisor(setup):
    sup = Supervisor(_engine(setup))
    with pytest.raises(ValueError, match="different engine"):
        HttpFrontend(_engine(setup), supervisor=sup)


def test_frontend_takes_the_supervisors_fault_plan(setup):
    eng = _engine(setup)
    plan = FaultPlan([FaultSpec(site="sse_stall", at=(0,), payload=0.0)])
    fe = HttpFrontend(eng, supervisor=Supervisor(eng, faults=plan))
    assert fe.faults is plan


def test_pump_once_drives_engine_and_supervisor(setup):
    eng = _engine(setup)
    fe = HttpFrontend(eng)
    assert fe._pump_once() is False              # nothing queued
    eng.submit(Request(0, _prompt(), max_new=3))
    steps = 0                   # the admission samples token 1 of 3
    while fe._pump_once():
        steps += 1
    assert steps == 2 and eng.finished[0].out == _offline(
        setup, [_prompt()], 3)[0]
    sup = Supervisor(_engine(setup))
    fe = HttpFrontend(sup.engine, supervisor=sup)
    sup.submit(Request(1, _prompt(), max_new=2))
    while fe._pump_once():
        pass
    assert [r.uid for r in sup.results()] == [1]


def test_health_stats_and_404_in_process(setup):
    eng = _engine(setup)
    sup = Supervisor(eng)

    async def main():
        fe = HttpFrontend(eng, supervisor=sup)
        h = await _handled(fe, "GET", "/healthz")
        s = await _handled(fe, "GET", "/stats")
        x = await _handled(fe, "GET", "/nope")
        return h, s, x

    h, s, x = asyncio.run(main())
    assert h.status() == 200 and h.json()["state"] == "healthy"
    assert h.json()["ok"] and h.json()["draining"] is False
    assert s.status() == 200 and s.json()["supervisor"]["state"] == "healthy"
    assert "decode_steps" in s.json()
    assert x.status() == 404


def test_generate_streams_the_engines_tokens_in_process(setup):
    """Two /generate streams through the handler with the pump loop
    running: their tokens equal the offline engine's (and so JAX's)."""
    prompts = [_prompt(4, 0), _prompt(5, 1)]
    want = _offline(setup, prompts, 6)

    async def main():
        fe = HttpFrontend(_engine(setup))
        fe._pump_task = asyncio.ensure_future(fe._pump_loop())
        try:
            ws = await asyncio.gather(*(
                _handled(fe, "POST", "/generate",
                         {"prompt": p.tolist(), "max_new": 6}, eof=False)
                for p in prompts))
        finally:
            fe._stopping = True
            await fe._pump_task
        return ws

    for uid, w in enumerate(asyncio.run(main())):
        assert w.status() == 200
        ev = w.events()
        assert [e["token"] for e in ev[:-1]] == want[uid]
        assert ev[-1] == {"done": True, "n": 6, "sent": 6, "error": ""}


def test_generate_sheds_load_with_503_in_process(setup):
    """A full bounded queue answers 503 + Retry-After; a draining server
    answers 503 too."""
    async def main():
        eng = _engine(setup, max_queued=1)
        eng.submit(Request(0, _prompt(), max_new=2))
        fe = HttpFrontend(eng)
        shed = await _handled(fe, "POST", "/generate",
                              {"prompt": _prompt().tolist()}, eof=False)
        fe._draining = True
        drain = await _handled(fe, "POST", "/generate",
                               {"prompt": _prompt().tolist()}, eof=False)
        return shed, drain, len(eng.queue)

    shed, drain, queued = asyncio.run(main())
    for w in (shed, drain):
        assert w.status() == 503 and b"Retry-After: " in bytes(w.buf)
    assert shed.json() == {"error": "overloaded"} and queued == 1
    assert drain.json() == {"error": "draining"}


# --------------------------------------------------------------------------
# slow: real sockets
# --------------------------------------------------------------------------
@pytest.mark.slow
def test_sse_round_trip_over_a_socket(setup):
    prompts = [_prompt(4, 2), _prompt(3, 3)]
    want = _offline(setup, prompts, 5)

    async def main():
        eng = _engine(setup)
        sup = Supervisor(eng, SupervisorConfig(snapshot_every=2),
                         faults=FaultPlan([FaultSpec(site="decode_logits",
                                                     at=(2,))]))
        fe = HttpFrontend(eng, supervisor=sup)
        await fe.start()
        try:
            res = await drive_http_trace(
                "127.0.0.1", fe.port,
                [{"uid": i, "t": 0.01 * i, "prompt": p, "max_new": 5}
                 for i, p in enumerate(prompts)])
            health = await fetch_json("127.0.0.1", fe.port, "/healthz")
        finally:
            drained = await fe.stop(drain_timeout_s=2.0)
        return res, health, drained, sup.stats["recoveries"]

    res, health, drained, recoveries = asyncio.run(main())
    assert [r["tokens"] for r in res] == [want[0], want[1]]
    assert health["ok"] and drained and recoveries == 1


@pytest.mark.slow
def test_load_shedding_over_a_socket(setup):
    async def main():
        fe = HttpFrontend(_engine(setup, batch_slots=1, max_queued=1))
        await fe.start()
        try:
            a = asyncio.ensure_future(sse_generate(
                "127.0.0.1", fe.port, _prompt(), max_new=24))
            while sum(r is not None for r in fe.engine._slots) < 1:
                await asyncio.sleep(0.01)
            b = asyncio.ensure_future(sse_generate(
                "127.0.0.1", fe.port, _prompt(seed=1), max_new=4))
            while len(fe.engine.queue) < 1:
                await asyncio.sleep(0.01)
            shed = await sse_generate("127.0.0.1", fe.port,
                                      _prompt(seed=2), max_new=4)
            done = await asyncio.gather(a, b)
        finally:
            await fe.stop()
        return shed, done

    (shed_tokens, shed), ((a_tok, a_fin), (b_tok, b_fin)) = \
        asyncio.run(main())
    assert shed_tokens == [] and shed["status"] == 503
    assert shed["retry_after_s"] >= 1.0
    assert len(a_tok) == 24 and not a_fin["error"]
    assert len(b_tok) == 4 and not b_fin["error"]
