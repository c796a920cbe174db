"""The serving engine's CUDA graphs on a card (marked ``cuda``: they skip
without one; this file imports no JAX, so it runs where JAX is absent):

    python -m pytest -q --noconftest -m cuda tests/test_torch_capture_cuda.py

REDUCED configs in bf16, 2:4-compressed (K2, and K3 for the expert
stacks), serve 4 equal requests on 4 slots; the reference is the eager
``model.decode_step`` loop the engine's steps amount to — each prompt
prefilled alone at B = 1 from a fresh cache, then the 4 rows decoded side
by side at B = 4.  A replay runs the kernels the eager step runs, on the
same shapes, so tokens and every selected logit are bitwise equal, and the
K2 / K3 launches counted under replay equal the eager ones.
"""
from __future__ import annotations

import dataclasses
import gc
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.masks import nm_mask  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models.model_builder import build_model  # noqa: E402
from repro_torch.serve.compressed import compress_params  # noqa: E402
from repro_torch.serve.engine import (Request, ServeConfig,  # noqa: E402
                                      ServingEngine)
from repro_torch.serve.faults import FaultPlan  # noqa: E402
from repro_torch.serve.supervisor import (Supervisor,  # noqa: E402
                                          SupervisorConfig)

MAX_LEN, NEW = 32, 6
CASES = {
    "dense": ("tinyllama-1.1b", {}, {}),
    "int8": ("tinyllama-1.1b", {"kv_cache_dtype": "int8"}, {}),
    "paged": ("tinyllama-1.1b", {}, {"paged": True, "page_size": 8}),
    "moe": ("qwen3-moe-30b-a3b", {}, {}),
    "mla": ("deepseek-v3-671b", {}, {}),
    "rings": ("gemma3-1b", {}, {}),
    "hybrid": ("zamba2-7b", {}, {}),
    "xlstm": ("xlstm-1.3b", {}, {}),
}
_TREES: dict = {}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _masks(model, params) -> dict:
    """A 2:4 mask (1.0 = pruned, (in, out)) of every prunable linear."""
    masks = {}
    for i in range(model.num_blocks()):
        for path in model.block_linear_paths(params, i):
            expert = path[-1] if isinstance(path[-1], int) else None
            node = params
            for k in (path[:-1] if expert is not None else path):
                node = node[k]
            w = (node if expert is None else node[expert]).float()
            ones = torch.ones(w.shape[0], device=w.device)
            masks[path] = nm_mask(w.T, ones, 2, 4).T
    return masks


def _tree(arch: str, cfg_kw: dict, dev):
    key = (arch, tuple(sorted(cfg_kw.items())))
    if key not in _TREES:
        cfg = get_config(arch, reduced=True).replace(dtype="bfloat16",
                                                     **cfg_kw)
        model = build_model(cfg, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        _TREES[key] = (model, compress_params(params, _masks(model, params),
                                              2, 4))
    return _TREES[key]


def _prompts(vocab: int, n: int = 4, S: int = 8) -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=S) for _ in range(n)]


def _recording(engine) -> list:
    """Record every logits tensor the engine samples from (a copy)."""
    seen, select = [], engine._select

    def record(logits):
        seen.append(logits.float().clone())
        return select(logits)

    engine._select = record
    return seen


def _serve(model, comp, prompts, **serve_kw):
    eng = ServingEngine(model, comp, ServeConfig(
        batch_slots=len(prompts), max_len=MAX_LEN, **serve_kw))
    seen = _recording(eng)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, max_new=NEW))
    done = eng.run()
    torch.cuda.synchronize()
    return [r.out for r in done], seen, eng


def _eager(model, comp, prompts):
    """B = 1 prefills from fresh caches, then a B = 4 lockstep decode, as
    the engine's steps go → (tokens per row, the logits sampled from)."""
    dev = model.device
    seen, rows, first = [], [], []
    with torch.no_grad():
        for p in prompts:
            row = model.init_cache(1, MAX_LEN)
            toks = torch.tensor(np.asarray(p)[None], device=dev)
            for s in range(toks.shape[1]):
                lg, row = model.decode_step(comp, row, toks[:, s:s + 1], s)
            seen.append(lg[:, -1].float().clone())
            first.append(int(lg[0, -1].argmax()))
            rows.append(row)
        cache = _stack(rows)
        tok = torch.tensor(first, device=dev)[:, None]
        pos = torch.full((len(prompts),), len(prompts[0]), device=dev)
        got = [tok[:, 0]]
        for _ in range(NEW - 1):
            lg, cache = model.decode_step(comp, cache, tok, pos)
            seen.append(lg[:, -1].float().clone())
            tok = lg[:, -1].argmax(-1, keepdim=True)
            got.append(tok[:, 0])
            pos = pos + 1
    torch.cuda.synchronize()
    return torch.stack(got, 1).tolist(), seen


def _stack(rows):
    """B = 1 cache trees → one tree of B = len(rows), leaf by leaf."""
    if isinstance(rows[0], dict):
        return {k: _stack([r[k] for r in rows]) for k in rows[0]}
    return dataclasses.replace(rows[0], **{
        f.name: torch.cat([getattr(r, f.name) for r in rows])
        for f in dataclasses.fields(rows[0])
        if isinstance(getattr(rows[0], f.name), torch.Tensor)})


def _counts() -> list:
    return [(fn.__name__, n, dict(s)) for fn, n, s in kops.launch_counts()]


def _delta(a: list, b: list) -> dict:
    return {name: nb - na for (name, na, _), (_, nb, _) in zip(a, b)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_engine_replays_bitwise_the_eager_step(cuda, case):
    arch, cfg_kw, serve_kw = CASES[case]
    model, comp = _tree(arch, cfg_kw, cuda)
    prompts = _prompts(model.cfg.vocab_size)
    c0 = _counts()
    got, seen, eng = _serve(model, comp, prompts, **serve_kw)
    c1 = _counts()
    want, ref = _eager(model, comp, prompts)
    c2 = _counts()
    assert got == want
    assert len(seen) == len(ref) == len(prompts) + NEW - 1
    diff = max(float((a - b).abs().max()) for a, b in zip(seen, ref))
    assert diff == 0.0, f"{case}: logits max |Δ| {diff}"
    served, eager = _delta(c0, c1), _delta(c1, c2)
    assert served == eager and served["nm_matmul_cuda"] > 0
    if case == "moe":
        assert served["nm_matmul_stacked_cuda"] > 0
    gs = eng.graph_stats()
    steps = len(prompts) * len(prompts[0]) + NEW - 1
    assert gs["graphs"] == 2 and gs["steps"] == steps
    assert gs["replays"] == steps - 2 and gs["pool_bytes"] >= 0


@pytest.mark.cuda
def test_wave_engine_one_graph(cuda):
    model, comp = _tree("tinyllama-1.1b", {}, cuda)
    prompts = _prompts(model.cfg.vocab_size)
    got, _, eng = _serve(model, comp, prompts, scheduler="wave")
    again, _, _ = _serve(model, comp, prompts, scheduler="wave")
    assert got == again and all(len(t) == NEW for t in got)
    gs = eng.graph_stats()
    assert gs["graphs"] == 1 and set(eng._steps) == {"wave"}
    assert gs["steps"] == len(prompts[0]) + NEW - 1


@pytest.mark.cuda
def test_restore_into_the_live_engine_replays(cuda):
    """Snapshot after 3 pumps, run on, restore into the same engine and run
    on again: the same tokens, the same buffers, no second capture."""
    model, comp = _tree("zamba2-7b", {}, cuda)
    prompts = _prompts(model.cfg.vocab_size)
    eng = ServingEngine(model, comp, ServeConfig(batch_slots=4,
                                                 max_len=MAX_LEN))
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, max_new=NEW))
    for _ in range(3):
        eng.pump()
    snap = eng.snapshot()
    want = [r.out for r in eng.run()]
    ptrs = [t.data_ptr() for layer in eng._cache["mamba"].values()
            for t in (layer.ssm, layer.conv)]
    graphs = {k: s.graph for k, s in eng._steps.items()}
    eng.restore(snap)
    assert [r.out for r in eng.run()] == want
    assert [t.data_ptr() for layer in eng._cache["mamba"].values()
            for t in (layer.ssm, layer.conv)] == ptrs
    assert {k: s.graph for k, s in eng._steps.items()} == graphs


@pytest.mark.cuda
def test_capture_holds_the_collector_off(cuda):
    """A dead engine left in a reference cycle frees its graphs' pool (a
    cudaFree) when the collector finds it, and a capture refuses that: the
    collector is off while each step is captured, on for its eager
    warm-up, and on again after."""
    model, comp = _tree("tinyllama-1.1b", {}, cuda)
    inner, seen = model.decode_step, []

    def watching(*a, **kw):
        seen.append(gc.isenabled())
        return inner(*a, **kw)

    model.decode_step = watching
    try:
        _, _, eng = _serve(model, comp, _prompts(model.cfg.vocab_size))
    finally:
        del model.decode_step
    # the row step's warm-up and capture, then the decode step's
    assert seen == [True, False, True, False]
    assert gc.isenabled() and eng.graph_stats()["graphs"] == 2


@pytest.mark.cuda
def test_capture_on_another_thread(cuda):
    """The SSE front end pumps from its own thread: a thread-local capture
    there gives the main thread's tokens."""
    model, comp = _tree("tinyllama-1.1b", {}, cuda)
    prompts = _prompts(model.cfg.vocab_size)
    want, _, _ = _serve(model, comp, prompts)
    out: dict = {}

    def body():
        try:
            out["got"] = _serve(model, comp, prompts)[0]
        except BaseException as exc:        # surfaced below
            out["exc"] = exc

    th = threading.Thread(target=body)
    th.start()
    th.join(300)
    assert "exc" not in out, out.get("exc")
    assert out["got"] == want


@pytest.mark.cuda
def test_supervised_rollback_replays_the_restored_buffers(cuda):
    model, comp = _tree("xlstm-1.3b", {}, cuda)
    prompts = _prompts(model.cfg.vocab_size)
    want, _, _ = _serve(model, comp, prompts)
    eng = ServingEngine(model, comp, ServeConfig(batch_slots=4,
                                                 max_len=MAX_LEN))
    sup = Supervisor(eng, SupervisorConfig(snapshot_every=2, retry_budget=8),
                     faults=FaultPlan.parse("decode_logits@3"))
    for uid, p in enumerate(prompts):
        sup.submit(Request(uid, p, max_new=NEW))
    got = [r.out for r in sup.run()]
    assert sup.stats["recoveries"] == 1 and got == want
    assert eng.graph_stats()["graphs"] == 2


def _failing_capture(model, comp) -> ServingEngine:
    """Serve one request with a decode step that syncs the host: it passes
    its eager warm-up and fails its capture, and the engine raises."""
    inner = model.decode_step

    def syncing(params, cache, tokens, pos):
        if bool((tokens < 0).any()):
            raise AssertionError("negative token")
        return inner(params, cache, tokens, pos)

    eng = ServingEngine(model, comp, ServeConfig(batch_slots=2,
                                                 max_len=MAX_LEN))
    model.decode_step = syncing
    try:
        eng.submit(Request(0, _prompts(model.cfg.vocab_size)[0], max_new=2))
        with pytest.raises(RuntimeError):
            eng.run()
    finally:
        del model.decode_step
    return eng


@pytest.mark.cuda
def test_a_failing_capture_raises(cuda):
    """A step that syncs the host passes its eager warm-up and fails its
    capture: the engine raises, it does not fall back to eager."""
    model, comp = _tree("tinyllama-1.1b", {}, cuda)
    eng = _failing_capture(model, comp)
    assert all(s.graph is None for s in eng._steps.values())


@pytest.mark.cuda
def test_the_default_generator_draws_after_a_failing_capture(cuda):
    """After the failing capture above, a draw from the default CUDA
    generator succeeds and equals the draw that the generator's state from
    before the serve gives (greedy serving draws nothing): the capture's
    failure path hands the generator back its state, since PyTorch ends a
    generator's capture mode only after a capture that succeeds."""
    model, comp = _tree("tinyllama-1.1b", {}, cuda)
    state = torch.cuda.get_rng_state()
    _failing_capture(model, comp)
    got = torch.randn((64,), device=cuda)
    torch.cuda.set_rng_state(state)
    want = torch.randn((64,), device=cuda)
    assert torch.equal(got, want)
