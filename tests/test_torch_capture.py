"""The serving engine's compiled step on the CPU, and the capture-safety
lint rules.

On a card the engine captures each model step as a CUDA graph and replays
it; a graph keeps reading and writing the buffers it saw at capture.  These
tests hold, for every family the engine serves (REDUCED configs, fp32, on
the CPU, where the engine runs the same step eagerly), what a replay
depends on: each decode writes its cache in place (every tensor's
``data_ptr`` unchanged) with bitwise the values a decode over a copy of
the cache gives; tensor positions give bitwise the int-position logits; a
static cache reset from the template equals a fresh ``init_cache``;
``restore`` into a live engine keeps its buffers and continues bitwise;
the paged layers share one table tensor.  Then ``jit-purity`` and
``recompile-hazards`` — JAX's ``TestJitPurity`` / ``TestRecompileHazards``
case for case in their torch forms, plus the ``with torch.cuda.graph``,
``capture_begin`` and ``make_graphed_callables`` roots — and the kernel
wrappers' launch tally that a replay adds.
"""
from __future__ import annotations

import copy
import dataclasses
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.engine import RepoIndex, run_rules  # noqa: E402
from repro_torch.analysis.rules import RULES  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models.model_builder import build_model  # noqa: E402
from repro_torch.serve.engine import (Request, ServeConfig,  # noqa: E402
                                      ServingEngine)
import test_torch_fixtures  # noqa: E402,F401  (caps torch's threads)

FAMILIES = ["tinyllama-1.1b", "qwen3-moe-30b-a3b", "deepseek-v3-671b",
            "gemma3-1b", "zamba2-7b", "xlstm-1.3b"]
MAX_LEN = 16
_MODELS: dict = {}


def _model(arch: str):
    if arch not in _MODELS:
        cfg = get_config(arch, reduced=True)
        model = build_model(cfg, device="cpu")
        _MODELS[arch] = (model, model.init(torch.Generator().manual_seed(0)))
    return _MODELS[arch]


def _leaves(tree) -> list:
    """(name, tensor) of every tensor of a cache tree, in order."""
    if isinstance(tree, dict):
        return [(f"{k}/{n}", t) for k in tree for n, t in _leaves(tree[k])]
    return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)]


def _objects(tree) -> list:
    if isinstance(tree, dict):
        return [o for k in tree for o in _objects(tree[k])]
    return [tree]


def _assert_tree_equal(a, b) -> None:
    la, lb = _leaves(a), _leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def _tokens(step: int) -> torch.Tensor:
    return torch.tensor([[3 + step], [7 + 2 * step]], dtype=torch.int64)


def _requests(seed: int = 5):
    rng = np.random.default_rng(seed)
    return [Request(uid, rng.integers(0, 512, size=S), max_new=mn)
            for uid, (S, mn) in enumerate([(5, 6), (3, 4), (6, 5), (4, 6)])]


# ============================================== the step a graph captures
@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_writes_cache_in_place(arch):
    """Four decode steps at per-slot positions: the cache dict, its layer
    objects and every tensor's storage are the same after each step, and
    logits and state are bitwise those of the same steps over a deep copy
    whose tensors the steps do not share."""
    model, params = _model(arch)
    cache = model.init_cache(2, MAX_LEN)
    ref = copy.deepcopy(cache)
    objs = [id(o) for o in _objects(cache)]
    ptrs = [t.data_ptr() for _, t in _leaves(cache)]
    with torch.no_grad():
        for s in range(4):
            pos = torch.tensor([s + 2, s], dtype=torch.int64)
            lg, out = model.decode_step(params, cache, _tokens(s), pos)
            assert out is cache
            assert [id(o) for o in _objects(cache)] == objs
            assert [t.data_ptr() for _, t in _leaves(cache)] == ptrs
            lr, ref = model.decode_step(params, copy.deepcopy(ref),
                                        _tokens(s), pos.clone())
            assert torch.equal(lg, lr)
            _assert_tree_equal(cache, ref)


@pytest.mark.parametrize("arch", FAMILIES)
def test_tensor_positions_bitwise_int(arch):
    """The engine's (B,) position buffer, every slot at one depth, gives
    bitwise the logits and caches of the python-int position."""
    model, params = _model(arch)
    c_int, c_vec = model.init_cache(2, MAX_LEN), model.init_cache(2, MAX_LEN)
    buf = torch.zeros((2,), dtype=torch.int64)
    with torch.no_grad():
        for s in range(5):
            li, c_int = model.decode_step(params, c_int, _tokens(s), s)
            buf.fill_(s)
            lv, c_vec = model.decode_step(params, c_vec, _tokens(s), buf)
            assert torch.equal(li, lv)
    _assert_tree_equal(c_int, c_vec)


@pytest.mark.parametrize("arch", FAMILIES)
def test_static_row_cache_reset_equals_fresh(arch):
    """After serving, the engine's static B = 1 row cache (admissions
    prefill into it) and the wave engine's B = slots cache, reset from the
    template, equal a fresh ``init_cache`` leaf for leaf — also where
    the initial state is not zero (positions −1, sLSTM's m at −1e30)."""
    model, params = _model(arch)
    eng = ServingEngine(model, params, ServeConfig(batch_slots=2,
                                                   max_len=MAX_LEN))
    wave = ServingEngine(model, params, ServeConfig(
        batch_slots=2, max_len=MAX_LEN, scheduler="wave"))
    for e in (eng, wave):
        for r in _requests():
            e.submit(r)
        e.run()
    row, wcache = eng._steps["row"].cache, wave._steps["wave"].cache
    assert any(not torch.equal(t, f) for (_, t), (_, f) in zip(
        _leaves(row), _leaves(model.init_cache(1, MAX_LEN))))
    ptrs = [t.data_ptr() for _, t in _leaves(row)]
    assert eng._static_cache("row", 1).cache is row
    assert wave._static_cache("wave", 2).cache is wcache
    assert [t.data_ptr() for _, t in _leaves(row)] == ptrs
    _assert_tree_equal(row, model.init_cache(1, MAX_LEN))
    _assert_tree_equal(wcache, model.init_cache(2, MAX_LEN))


@pytest.mark.parametrize("arch", FAMILIES)
def test_restore_into_live_engine_keeps_buffers(arch):
    """A snapshot after 3 pumps restored into the same, live engine: the
    resident cache keeps every tensor (the decode step holds them), and
    the run continues bitwise to the tokens of running on undisturbed; a
    genesis snapshot (no cache yet) restored into the live engine resets
    the cache in place and serves the whole trace again, bitwise."""
    model, params = _model(arch)
    eng = ServingEngine(model, params, ServeConfig(batch_slots=2,
                                                   max_len=MAX_LEN))
    genesis = eng.snapshot()
    for r in _requests():
        eng.submit(r)
    for _ in range(3):
        eng.pump()
    snap = eng.snapshot()
    want = {r.uid: r.out for r in eng.run()}
    step = eng._steps["decode"]
    ptrs = [t.data_ptr() for _, t in _leaves(eng._cache)]
    eng.restore(snap)
    assert step.cache is eng._cache
    assert [t.data_ptr() for _, t in _leaves(eng._cache)] == ptrs
    assert {r.uid: r.out for r in eng.run()} == want
    eng.restore(genesis)
    assert [t.data_ptr() for _, t in _leaves(eng._cache)] == ptrs
    _assert_tree_equal(eng._cache, model.init_cache(2, MAX_LEN))
    for r in _requests():
        eng.submit(r)
    assert {r.uid: r.out for r in eng.run()} == want


def test_engine_on_the_cpu_runs_the_step_eagerly():
    """On the CPU nothing is captured: each model step (one a prefill token
    and one a decode step) runs eagerly through the engine's two steps."""
    model, params = _model("tinyllama-1.1b")
    eng = ServingEngine(model, params, ServeConfig(batch_slots=2,
                                                   max_len=MAX_LEN))
    for r in _requests():
        eng.submit(r)
    eng.run()
    gs = eng.graph_stats()
    assert set(eng._steps) == {"row", "decode"}
    assert gs["graphs"] == gs["replays"] == 0 and gs["pool_bytes"] == 0
    assert gs["steps"] == (eng.stats["prefill_tokens"]
                           + eng.stats["decode_steps"])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v3-671b",
                                  "gemma3-1b"])
def test_sync_tables_keeps_one_table_tensor(arch):
    """Every paged layer reads one table tensor, written in place by each
    dirty step (never rebound), equal to the pager's table; tokens equal
    the contiguous engine's."""
    model, params = _model(arch)
    eng = ServingEngine(model, params, ServeConfig(
        batch_slots=2, max_len=MAX_LEN, paged=True, page_size=4))
    cont = ServingEngine(model, params, ServeConfig(batch_slots=2,
                                                    max_len=MAX_LEN))
    for e in (eng, cont):
        for r in _requests():
            e.submit(r)
    eng.pump()
    table = eng._table
    assert table is not None
    ptr = table.data_ptr()
    synced = 0
    while eng.pump():
        if not eng.pager.dirty:         # synced before this pump's step
            assert table.tolist() == eng.pager.table.tolist()
            synced += 1
    paged = [c for c in eng._cache.values() if hasattr(c, "table")]
    assert paged and all(c.table is table for c in paged)
    assert table.data_ptr() == ptr and synced > 0
    got = {r.uid: r.out for r in eng.run()}
    assert got == {r.uid: r.out for r in cont.run()}


# ============================================ the wrappers' launch tally
def test_launch_tally_take_and_add(monkeypatch):
    """A capture's launches are taken out of the counts and become the
    tally that each replay adds back — launches and launches by shape."""
    fakes = []
    for name in ("nm_matmul_cuda", "nm_matmul_stacked_cuda"):
        def fake():
            pass
        fake.launches = 3
        fake.by_shape = __import__("collections").Counter({("a",): 3})
        monkeypatch.setattr(kops.nm_spmm, name, fake)
        fakes.append(fake)
    before = kops.launch_counts()
    fakes[0].launches += 2
    fakes[0].by_shape[("a",)] += 1
    fakes[0].by_shape[("b",)] += 1
    tally = kops.take_launches(before)
    assert [(f.launches, dict(f.by_shape)) for f in fakes] == \
        [(3, {("a",): 3})] * 2
    for _ in range(3):
        kops.add_launches(tally)
    assert fakes[0].launches == 9 and dict(fakes[0].by_shape) == \
        {("a",): 6, ("b",): 3}
    assert fakes[1].launches == 3 and dict(fakes[1].by_shape) == \
        {("a",): 3}


# ============================================== the capture-safety rules
def make_repo(tmp_path, files: dict[str, str]) -> RepoIndex:
    src = tmp_path / "src"
    for rel, text in files.items():
        p = src / "repro_torch" / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return RepoIndex.build(src)


def rule_findings(idx: RepoIndex, rule_name: str):
    return run_rules(idx, [RULES[rule_name]])


class TestJitPurity:
    def test_flags_host_rng_and_clock_in_captured_fn(self, tmp_path):
        idx = make_repo(tmp_path, {"mod.py": """\
            import time
            import numpy as np
            import torch

            def step(x):
                noise = np.random.rand()
                t = time.time()
                return x * noise * t

            class Runner:
                def capture(self, x):
                    self.graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(self.graph):
                        self.out = step(x)
        """})
        found = rule_findings(idx, "jit-purity")
        msgs = [f.message for f in found]
        assert len(found) == 2
        assert any("numpy.random.rand" in m for m in msgs)
        assert any("time.time" in m for m in msgs)

    def test_flags_impurity_reached_through_call_graph(self, tmp_path):
        idx = make_repo(tmp_path, {"mod.py": """\
            import numpy as np
            import torch

            def helper(x):
                return x + np.random.rand()

            def step(x):
                return helper(x)

            GRAPHED = torch.cuda.make_graphed_callables(step, (None,))
        """})
        found = rule_findings(idx, "jit-purity")
        assert len(found) == 1
        assert found[0].symbol == "helper"
        assert "captured via step -> helper" in found[0].message

    def test_flags_host_syncs(self, tmp_path):
        idx = make_repo(tmp_path, {"mod.py": """\
            import torch

            def step(x, pos):
                if bool(torch.sum(x) > 0):
                    x = -x
                n = int(x.amax())
                k = x.max().item()
                return x + torch.as_tensor(pos, device=x.device) + n + k

            def capture(g, x, pos):
                g.capture_begin()
                out = step(x, pos)
                g.capture_end()
                return g, out
        """})
        msgs = [f.message for f in rule_findings(idx, "jit-purity")]
        assert len(msgs) == 4
        assert sum("syncs the host" in m for m in msgs) == 2
        assert any(".item() copies a tensor" in m for m in msgs)
        assert any("torch.as_tensor(..., device=)" in m for m in msgs)

    def test_host_code_not_flagged(self, tmp_path):
        idx = make_repo(tmp_path, {"mod.py": """\
            import time
            import numpy as np
            import torch

            def host_loop(x):
                t0 = time.time()
                return np.random.rand() + x.sum().item()

            def step(x):
                return x * int(x.shape[0])

            class Runner:
                def capture(self, x):
                    self.graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(self.graph):
                        self.out = step(x)
                    return host_loop(self.out)
        """})
        assert rule_findings(idx, "jit-purity") == []

    def test_device_rng_and_fills_are_fine(self, tmp_path):
        idx = make_repo(tmp_path, {"mod.py": """\
            import torch

            def step(gen, x, pos):
                noise = torch.rand(x.shape, generator=gen, device=x.device)
                p = torch.full((x.shape[0],), 3, device=x.device)
                return x + noise + p + torch.tensor(1.0, device="cpu")

            class Runner:
                def capture(self, gen, x, pos):
                    self.graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(self.graph):
                        self.out = step(gen, x, pos)
        """})
        assert rule_findings(idx, "jit-purity") == []

    def test_the_engines_captured_step_is_reachable(self):
        """The port's own capture root: the engine's ``_decode_fn`` and
        the decode steps of every served family below it."""
        from pathlib import Path
        idx = RepoIndex.build(Path(__file__).resolve().parents[1] / "src")
        graph = idx.graph
        reach = graph.jit_reachable()
        for key in ("repro_torch.serve.engine::_decode_fn",
                    "repro_torch.models.transformer::TransformerLM."
                    "decode_step",
                    "repro_torch.models.attention::gqa_decode",
                    "repro_torch.models.attention::mla_decode",
                    "repro_torch.models.moe::moe_ffn",
                    "repro_torch.models.ssm::mamba2_decode",
                    "repro_torch.models.xlstm::slstm_decode",
                    "repro_torch.kernels.nm_spmm::nm_matmul_cuda",
                    "repro_torch.kernels.nm_spmm::nm_matmul_stacked_cuda"):
            assert key in reach, key
        assert not any(k.endswith("::ServingEngine._select") for k in reach)
        # the one capture (a ``capture_begin``, no ``with torch.cuda.
        # graph``) is the shared helper's; the engine captures its step
        # through ``util.graphs.Graph``
        sites = [(m, w) for m, _, _, w in graph.jit_sites]
        assert [m for m, w in sites if w in (
            "torch.cuda.graph", "torch.cuda.CUDAGraph.capture_begin")] == \
            ["repro_torch.util.graphs"]
        assert [m for m, w in sites
                if w == "repro_torch.util.graphs.Graph"] == \
            ["repro_torch.serve.engine"]


class TestRecompileHazards:
    def test_flags_scalar_param_of_captured_fn(self, tmp_path):
        idx = make_repo(tmp_path, {"mod.py": """\
            import torch

            def step(x, block_size: int):
                return x[:block_size]

            class Runner:
                def capture(self, x):
                    self.graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(self.graph):
                        self.out = step(x, 4)
        """})
        found = rule_findings(idx, "recompile-hazards")
        assert len(found) == 1
        assert "block_size" in found[0].message

    def test_tensor_param_is_fine(self, tmp_path):
        idx = make_repo(tmp_path, {"mod.py": """\
            import torch

            def step(x, pos: torch.Tensor):
                return x + pos

            class Runner:
                def capture(self, x, pos):
                    self.graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(self.graph):
                        self.out = step(x, pos)
        """})
        assert rule_findings(idx, "recompile-hazards") == []

    def test_partial_binding_at_capture_is_fine(self, tmp_path):
        idx = make_repo(tmp_path, {"mod.py": """\
            import functools
            import torch

            def step(model, n: int, x):
                return x[:n]

            def make(model, x):
                return torch.cuda.make_graphed_callables(
                    functools.partial(step, model, 4), (x,))
        """})
        assert rule_findings(idx, "recompile-hazards") == []

    def test_flags_graph_captured_per_call(self, tmp_path):
        idx = make_repo(tmp_path, {"mod.py": """\
            import torch

            def run(x):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    y = x * 2
                g.replay()
                return y
        """})
        found = rule_findings(idx, "recompile-hazards")
        assert len(found) == 1
        assert "captures afresh" in found[0].message

    def test_flags_capture_in_a_loop_body(self, tmp_path):
        idx = make_repo(tmp_path, {"mod.py": """\
            import torch

            class Runner:
                def run(self, xs):
                    for x in xs:
                        self.graph = torch.cuda.CUDAGraph()
                        self.graph.capture_begin()
                        self.out = x * 2
                        self.graph.capture_end()
        """})
        found = rule_findings(idx, "recompile-hazards")
        assert len(found) == 1
        assert "loop body" in found[0].message

    def test_module_level_and_kept_graphs_are_fine(self, tmp_path):
        idx = make_repo(tmp_path, {"mod.py": """\
            import torch

            def double(x):
                return x * 2

            DOUBLE = torch.cuda.make_graphed_callables(double, (None,))

            class Runner:
                def capture(self, x):
                    g = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(g):
                        out = double(x)
                    self.graph, self.out = g, out
        """})
        assert rule_findings(idx, "recompile-hazards") == []

    def test_suppression(self, tmp_path):
        idx = make_repo(tmp_path, {"mod.py": """\
            import torch

            def probe(x):
                g = torch.cuda.CUDAGraph()
                # lint: disable=recompile-hazards
                with torch.cuda.graph(g):
                    y = x * 2
                g.replay()
                return y
        """})
        assert rule_findings(idx, "recompile-hazards") == []
