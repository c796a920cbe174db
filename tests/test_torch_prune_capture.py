"""The prune job's compiled steps on the CPU: ``util.graphs.graphed`` (the
port's ``jax.jit``) over the twelve method × pattern solves and the
schedule's block passes, and the capture-safety lint over them.

On a card a graphed call's second use copies its tensors into static
buffers, captures the function over them and replays; later calls copy
and replay, and every output is cloned out of the graphs' shared pool.
Here every call runs inline; a fake card (``fake_card``) runs the same
bookkeeping with a stand-in graph whose "capture" poisons its outputs and
whose replay recomputes them in place from the static buffers — so a key
that let a stale buffer through, a copy that was missed, or an output
returned without its clone shows as a wrong bit.  The solves run at
tinyllama REDUCED's widths (W (128, 64) and (64, 128)) in fp32 and bf16
against their direct calls (``__wrapped__``), bitwise.
"""
from __future__ import annotations

import collections
import functools
import gc
import textwrap
import weakref
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch.analysis.engine import RepoIndex, run_rules  # noqa: E402
from repro_torch.analysis.rules import RULES  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import (api, hessian, magnitude, sparsegpt,  # noqa: E402
                              thanos, wanda)
from repro_torch.core.schedule import (collect_hessian_stats,  # noqa: E402
                                       get_path, prune_model)
from repro_torch.data.pipeline import calibration_batches  # noqa: E402
from repro_torch.models.model_builder import (ModelAdapter,  # noqa: E402
                                              build_model)
from repro_torch.util import graphs  # noqa: E402
import test_torch_fixtures  # noqa: E402,F401  (caps torch's threads)

REPO_ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(128, 64), (64, 128)]          # tinyllama REDUCED gate / down
DTYPES = [torch.float32, torch.bfloat16]
SOLVES = {
    "thanos/unstructured": (thanos.prune_unstructured,
                            {"p": 0.5, "block_size": 32}),
    "thanos/nm": (thanos.prune_nm, {"n": 2, "m": 4, "block_size": 32}),
    "thanos/structured": (thanos.prune_structured, {"p": 0.3,
                                                    "alpha": 0.1}),
    "sparsegpt/unstructured": (sparsegpt.prune_unstructured,
                               {"p": 0.5, "mask_blocksize": 32}),
    "sparsegpt/nm": (sparsegpt.prune_nm, {"n": 2, "m": 4, "blocksize": 32}),
    "sparsegpt/structured": (sparsegpt.prune_structured,
                             {"p": 0.3, "blocksize": 32}),
    "wanda/unstructured": (wanda.prune_unstructured, {"p": 0.5}),
    "wanda/nm": (wanda.prune_nm, {"n": 2, "m": 4}),
    "wanda/structured": (wanda.prune_structured, {"p": 0.3}),
    "magnitude/unstructured": (magnitude.prune_unstructured, {"p": 0.5}),
    "magnitude/nm": (magnitude.prune_nm, {"n": 2, "m": 4}),
    "magnitude/structured": (magnitude.prune_structured, {"p": 0.3}),
}


def _problem(seed: int, c: int, b: int, dtype) -> tuple:
    """(W (c, b) in ``dtype``, H = 2XᵀX/n (b, b) fp32) from numpy."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((c, b)).astype(np.float32))
    x = rng.standard_normal((4 * b, b)).astype(np.float32)
    x[:, 3] = 0.0                                  # one dead feature
    h = torch.from_numpy(2.0 * x.T @ x / x.shape[0])
    return w.to(dtype), h


def _equal(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


class FakeGraph:
    """A stand-in for ``graphs.Graph`` on the CPU.  Its "capture" runs the
    function once for the output buffers and poisons them (a real capture
    computes nothing); a replay recomputes from the static buffers the
    function closes over and writes the result into those buffers."""

    made: list = []

    def __init__(self, fn, device, pool):
        self.fn, self.pool, self.replays = fn, pool, 0
        self.tally, self.capture_s = [], 0.0
        self.out = pytree.tree_map(self._poison, fn())
        FakeGraph.made.append(weakref.ref(self))

    @staticmethod
    def _poison(t):
        if not isinstance(t, torch.Tensor):
            return t
        t = t.clone()
        return t.fill_(float("nan")) if t.is_floating_point() else t.zero_()

    def replay(self):
        # a replay runs no Python: a graphed callee must not key itself
        graphs._local().depth += 1
        try:
            new = self.fn()
        finally:
            graphs._local().depth -= 1
        for o, v in zip(pytree.tree_leaves(self.out),
                        pytree.tree_leaves(new)):
            if isinstance(o, torch.Tensor):
                o.copy_(v)
        self.replays += 1
        return self.out


def _fake(monkeypatch) -> None:
    """Every graphed call inside a scope takes the card's path."""
    FakeGraph.made = []

    def device(leaves):
        return (torch.device("cpu") if any(isinstance(x, torch.Tensor)
                                           for x in leaves) else None)

    monkeypatch.setattr(graphs, "_graph_device", device)
    monkeypatch.setattr(graphs, "Graph", FakeGraph)
    monkeypatch.setattr(graphs, "run_on_side", lambda fn, dev, keep=(): fn())
    monkeypatch.setattr(graphs, "_check_linalg", lambda: None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    monkeypatch.setattr(graphs, "settled_reserve", lambda device: 0)


@pytest.fixture
def fake_card(monkeypatch):
    _fake(monkeypatch)
    yield
    assert graphs._local().scope is None


# ----------------------------------------------------------------- solves
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(SOLVES))
def test_solve_leaves_its_inputs_unchanged(name, dtype):
    fn, kw = SOLVES[name]
    w, h = _problem(0, 128, 64, dtype)
    w0, h0 = w.clone(), h.clone()
    ptrs = (w.data_ptr(), h.data_ptr())
    fn(w, h, **kw)
    assert (w.data_ptr(), h.data_ptr()) == ptrs
    assert torch.equal(w, w0) and torch.equal(h, h0)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(SOLVES))
def test_replays_on_static_buffers_are_bitwise_the_direct_call(
        fake_card, name, dtype):
    """Two inputs in turn (A, B, A, B): the first call is eager, the second
    captures, every later one replays on buffers filled by ``copy_`` —
    each result bitwise the direct call's, none clobbered by a later
    replay."""
    fn, kw = SOLVES[name]
    a, b = _problem(1, 128, 64, dtype), _problem(2, 128, 64, dtype)
    want = {k: fn.__wrapped__(*p, **kw) for k, p in (("a", a), ("b", b))}
    with graphs.scope() as sc:
        got = [(k, fn(*p, **kw)) for k, p in
               (("a", a), ("b", b), ("a", a), ("b", b))]
        for k, res in got:
            assert _equal(res, want[k]), k
        stats = sc.stats()
    assert stats["eager"] == 1 and stats["graphs"] == 1
    assert stats["replays"] == 3 and stats["calls"] == 4


def test_the_key_separates_shape_dtype_and_static_arguments(fake_card):
    """The same shape in another layer replays the same graph; another
    shape, dtype, block size or a percdamp escalation (×10, as
    ``prune_layer_guarded`` retries) is a key of its own."""
    kw = {"n": 2, "m": 4, "block_size": 32}
    with graphs.scope() as sc:
        for seed in range(3):                      # three layers, one key
            thanos.prune_nm(*_problem(seed, 128, 64, torch.float32), **kw)
        assert len(sc.entries) == 1 and sc.stats()["graphs"] == 1
        thanos.prune_nm(*_problem(0, 64, 128, torch.float32), **kw)
        thanos.prune_nm(*_problem(0, 128, 64, torch.bfloat16), **kw)
        thanos.prune_nm(*_problem(0, 128, 64, torch.float32), **kw,
                        percdamp=0.1)
        thanos.prune_nm(*_problem(0, 128, 64, torch.float32),
                        **dict(kw, block_size=64))
        assert len(sc.entries) == 5
        statics = sorted(dict(k[1])["percdamp"] for k in sc.entries)
        assert statics == [0.01, 0.01, 0.01, 0.01, 0.1]


def test_an_expanded_view_keys_like_its_dense_copy(fake_card):
    """A pass-2 output handed on as the next carry: the eager call returns
    an expanded positions view, a replay its dense clone — one key, as
    both copy into the same dense static buffer."""
    fn = graphs.graphed(lambda c: {"h": c["h"] * 2.0,
                                   "positions": c["positions"] + 1})
    pos = torch.arange(8).expand(2, 8)
    with graphs.scope() as sc:
        for p in (pos, pos.contiguous(), pos):
            out = fn({"h": torch.ones((2, 8)), "positions": p})
            assert torch.equal(out["positions"], pos + 1)
        assert len(sc.entries) == 1 and sc.stats()["replays"] == 2


def test_static_arguments_must_be_parameters():
    with pytest.raises(TypeError):
        graphs.graphed(lambda w: w, static=("p",))


def test_cpu_calls_run_inline():
    """Without a card every call runs as written, in a scope or not: no
    key, no graph, the direct call's result."""
    w, h = _problem(0, 128, 64, torch.float32)
    kw = {"n": 2, "m": 4, "block_size": 32}
    with graphs.scope() as sc:
        got = [thanos.prune_nm(w, h, **kw) for _ in range(3)]
        assert sc.entries == {} and sc.stats()["calls"] == 0
    want = thanos.prune_nm.__wrapped__(w, h, **kw)
    assert all(_equal(g, want) for g in got)


def test_outside_a_scope_and_nested_calls_run_inline(fake_card):
    """A call outside any scope runs inline; inside a graphed solve (its
    warm-up and its capture) ``inv_cholesky_upper`` runs inline, as JAX
    traces a jitted callee into its caller."""
    w, h = _problem(0, 128, 64, torch.float32)
    thanos.prune_structured(w, h, p=0.3, alpha=0.1)
    assert FakeGraph.made == []
    with graphs.scope() as sc:
        for _ in range(3):
            thanos.prune_structured(w, h, p=0.3, alpha=0.1)
        assert [k[0] for k in sc.entries] == [thanos.prune_structured]
        hessian.inv_cholesky_upper(h)                # a call of its own
        assert len(sc.entries) == 2


def test_a_nested_scope_is_the_open_one(fake_card):
    """``scope()`` inside an open scope is that scope: a run's graphs
    share one pool, and only the outer exit releases them."""
    w, h = _problem(0, 128, 64, torch.float32)
    with graphs.scope() as outer:
        for _ in range(2):
            with graphs.scope() as inner:
                thanos.prune_structured(w, h, p=0.3, alpha=0.1)
            assert inner is outer and len(outer.entries) == 1
        assert outer.stats()["graphs"] == 1
        assert outer.stats()["replays"] == 1
    assert outer.entries == {} and outer.pool is None


def test_guard_escalation_replays_like_the_inline_guard(fake_card):
    """A singular H: every attempt is non-finite until the magnitude
    fallback; the graphed attempts (each percdamp a key) give the inline
    guard's GuardInfo and result."""
    w, _ = _problem(0, 128, 64, torch.float32)
    h = torch.eye(64)
    h[0, 1] = h[1, 0] = 1e3          # indefinite past every damping (≤ 100)
    cfg = api.PruneConfig("thanos", "nm", block_size=32)
    want = api.prune_layer_guarded(w, h, cfg,
                                   on_singular="fallback:magnitude")
    with graphs.scope() as sc:
        for _ in range(2):
            got = api.prune_layer_guarded(w, h, cfg,
                                          on_singular="fallback:magnitude")
            assert got[1] == want[1] and _equal(got[0], want[0])
        # five percdamp keys and the fallback's, each used twice
        assert sc.stats()["graphs"] == 6
    assert want[1].fallback == "magnitude" and want[1].damp_attempts == 5


# ----------------------------------------------------------- block passes
BLOCK_ARCHS = ["tinyllama-1.1b", "qwen3-moe-30b-a3b", "zamba2-7b",
               "xlstm-1.3b"]
_MODELS: dict = {}


def _model(arch: str):
    if arch not in _MODELS:
        cfg = get_config(arch, reduced=True)
        model = build_model(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        batches = calibration_batches(cfg, num_samples=6, seq_len=16,
                                      batch=2, device="cpu")
        _MODELS[arch] = (model, params, batches)
    return _MODELS[arch]


@pytest.mark.parametrize("arch", BLOCK_ARCHS)
def test_block_pass_over_a_static_carry_is_bitwise_block_apply(fake_card,
                                                               arch):
    """Pass 1 (the tape: every linear's input, MoE's (x, valid) pairs) and
    pass 2 of the first and last block over three carries: eager, capture,
    replay — each bitwise ``block_apply``."""
    model, params, batches = _model(arch)
    adapter = ModelAdapter(model)
    carries = [adapter.prepare(params, b) for b in batches]
    with torch.no_grad(), graphs.scope() as sc:
        for i in (0, adapter.num_blocks(params) - 1):
            for capture in (True, False):
                block = graphs.graphed(functools.partial(
                    adapter.block_apply, params, i, capture=capture))
                for c in carries:
                    want = adapter.block_apply(params, i, c, capture=capture)
                    assert _equal(block(c), want), (i, capture)
                graphs.release(block)
        assert sc.entries == {} and sc.stats()["graphs"] == 4


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-moe-30b-a3b"])
def test_prune_model_from_graphs_is_bitwise_the_inline_run(monkeypatch,
                                                            arch):
    """Thanos 2:4 over the whole model: the run from (fake) graphs — every
    solve keyed, each block's passes captured before and after its prune —
    gives the inline run's masks, weights and losses; its graphs go with
    the run."""
    model, params, batches = _model(arch)
    cfg = api.PruneConfig("thanos", "nm", block_size=32)
    want_p, want = prune_model(params, ModelAdapter(model), batches, cfg)
    assert want.graphs["graphs"] == 0
    _fake(monkeypatch)
    got_p, got = prune_model(params, ModelAdapter(model), batches, cfg)
    assert _equal(got_p, want_p)
    assert _equal(got.masks, want.masks)
    assert [r.obs_loss for r in got.layers] == \
        [r.obs_loss for r in want.layers]
    # every block pass (two calibration batches: eager, then captured) and
    # every solve shape used twice or more gets its graph
    shapes = collections.Counter(tuple(get_path(params, p).shape)
                                 for p in want.masks)
    nb = ModelAdapter(model).num_blocks(params)
    g = got.graphs
    assert g["graphs"] == 2 * nb + sum(n > 1 for n in shapes.values())
    assert g["eager"] == 2 * nb + len(shapes)
    assert g["calls"] == len(batches) * 2 * nb + len(want.masks)
    gc.collect()
    assert all(r() is None for r in FakeGraph.made)
    assert graphs._local().scope is None


def test_the_allocation_pass_counts_in_the_open_scope(monkeypatch):
    """``collect_hessian_stats`` (block passes only) from (fake) graphs
    inside a caller's scope: the inline pass's statistics, each block's
    passes captured at their second batch and counted in that scope,
    dropped once the block is done."""
    model, params, batches = _model("tinyllama-1.1b")
    adapter = ModelAdapter(model)
    want = collect_hessian_stats(params, adapter, batches)
    _fake(monkeypatch)
    with graphs.scope() as sc:
        got = collect_hessian_stats(params, adapter, batches)
        assert sc.entries == {}
    assert got == want
    nb = adapter.num_blocks(params)
    st = sc.stats()
    assert st["graphs"] == st["eager"] == 2 * nb
    assert st["replays"] == 2 * nb * (len(batches) - 1)
    assert graphs._local().scope is None


# -------------------------------------------------------------- the lint
def _make_repo(tmp_path, files: dict) -> RepoIndex:
    src = tmp_path / "src"
    for rel, text in files.items():
        p = src / "repro_torch" / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return RepoIndex.build(src)


def _findings(idx: RepoIndex, rule: str) -> list:
    return run_rules(idx, [RULES[rule]])


_HELPER = """\
    class graphed:
        def __init__(self, fn=None, *, static=()):
            self.fn = fn
"""


def test_the_prune_jobs_captured_code_is_reachable():
    """The new capture sites reach every solver (with what they call) and
    every family's block pass; the engine's step stays reachable."""
    idx = RepoIndex.build(REPO_ROOT / "src")
    reach = idx.graph.jit_reachable()
    for mod in ("thanos", "sparsegpt", "wanda", "magnitude"):
        for pat in ("unstructured", "nm", "structured"):
            assert f"repro_torch.core.{mod}::prune_{pat}" in reach
    for key in ("repro_torch.core.hessian::inv_cholesky_upper",
                "repro_torch.core.solver::batched_multipliers",
                "repro_torch.core.masks::rank_threshold_mask",
                "repro_torch.core.sparsegpt::_block_sweep.block",
                "repro_torch.models.model_builder::ModelAdapter.block_apply",
                "repro_torch.models.transformer::TransformerLM.block",
                "repro_torch.models.moe::moe_ffn",
                "repro_torch.models.hybrid::HybridLM.block",
                "repro_torch.models.ssm::mamba2_forward",
                "repro_torch.models.xlstm::slstm_forward",
                "repro_torch.models.encdec::EncDecLM.block",
                "repro_torch.serve.engine::_decode_fn"):
        assert key in reach, key
    for key in ("repro_torch.core.api::prune_layer_guarded",
                "repro_torch.core.solver::solution_finite",
                "repro_torch.core.hessian::HessianAccumulator.update"):
        assert key not in reach, key


def test_the_port_lints_clean_with_an_empty_baseline():
    import json
    idx = RepoIndex.build(REPO_ROOT / "src")
    findings = run_rules(idx, list(RULES.values()))
    assert findings == [], "\n".join(f.render() for f in findings)
    base = json.loads((REPO_ROOT / "src/repro_torch/analysis/"
                       "baseline.json").read_text())
    assert base == {"version": 1, "findings": []}


def test_recompile_flags_a_scalar_left_out_of_static(tmp_path):
    idx = _make_repo(tmp_path, {"util/graphs.py": _HELPER, "mod.py": """\
        from repro_torch.util.graphs import graphed

        @graphed(static=("p",))
        def solve(w, h, *, p: float, block_size: int = 128):
            return w[:block_size] * p
    """})
    found = _findings(idx, "recompile-hazards")
    assert len(found) == 1 and "block_size" in found[0].message


def test_recompile_static_and_partial_bound_arguments_are_fine(tmp_path):
    idx = _make_repo(tmp_path, {"util/graphs.py": _HELPER, "mod.py": """\
        import functools

        from repro_torch.util import graphs

        @graphs.graphed(static=("p", "block_size"))
        def solve(w, h, *, p: float, block_size: int = 128):
            return w[:block_size] * p

        def apply(params, i: int, carry, *, capture: bool):
            return carry

        def run(params, carries):
            fwd = graphs.graphed(functools.partial(apply, params, 0,
                                                   capture=True))
            return [fwd(c) for c in carries]
    """})
    assert _findings(idx, "recompile-hazards") == []
    assert "repro_torch.mod::apply" in idx.graph.jit_reachable()


def test_recompile_catches_a_solver_whose_static_names_lose_one(tmp_path):
    """The real Thanos solvers with ``percdamp`` dropped from one
    ``static=``: that solver is flagged."""
    src = (REPO_ROOT / "src/repro_torch/core/thanos.py").read_text()
    broken = src.replace('@graphed(static=("p", "alpha", "percdamp"))',
                         '@graphed(static=("p", "alpha"))')
    assert broken != src
    idx = _make_repo(tmp_path, {"util/graphs.py": _HELPER,
                                "core/thanos.py": broken})
    found = _findings(idx, "recompile-hazards")
    assert [(f.symbol, "percdamp" in f.message) for f in found] == \
        [("prune_structured", True)]


def test_jit_purity_flags_a_host_copy_under_graphed(tmp_path):
    """``torch.tensor(..., device=)`` in a graphed solve and in a block pass
    wrapped as ``graphed(partial(...))``: both refused."""
    idx = _make_repo(tmp_path, {"util/graphs.py": _HELPER, "mod.py": """\
        import functools

        import torch

        from repro_torch.util.graphs import graphed

        @graphed(static=("p",))
        def solve(w, *, p: float):
            r = torch.tensor(int(p * w.numel()), device=w.device)
            return w * r

        class Adapter:
            def block_apply(self, params, i, carry, *, capture):
                return carry * float(carry.sum())

        def run(adapter, params, carries):
            fwd = graphed(functools.partial(adapter.block_apply, params, 0,
                                            capture=False))
            return [fwd(c) for c in carries]
    """})
    found = _findings(idx, "jit-purity")
    assert sorted(f.symbol for f in found) == ["Adapter.block_apply",
                                                "solve"]


def test_a_non_tensor_leaf_is_part_of_the_key(fake_card):
    """A call's non-tensor leaves (``h=None`` of a data-free method)
    key like static arguments: ``magnitude`` with and without H."""
    w, h = _problem(0, 128, 64, torch.float32)
    with graphs.scope() as sc:
        for _ in range(2):
            magnitude.prune_nm(w, None, n=2, m=4)
            magnitude.prune_nm(w, h, n=2, m=4)
        assert len(sc.entries) == 2 and sc.stats()["replays"] == 2


def test_jit_purity_flags_a_scalar_stored_at_a_tensor_index(tmp_path):
    """``t[argsort(...)[:k]] = 1.0`` is an ``index_put_`` of a host scalar,
    copied to the card — refused in a capture (the card refused the
    solvers' first captures so); ``index_fill_`` and a basic slice are
    fine."""
    idx = _make_repo(tmp_path, {"util/graphs.py": _HELPER, "mod.py": """\
        import torch

        from repro_torch.util.graphs import graphed

        @graphed(static=("k",))
        def select(x, *, k: int):
            col = torch.zeros_like(x)
            col[torch.argsort(x, stable=True)[:k]] = 1.0
            keep = torch.zeros_like(x)
            keep.index_fill_(0, torch.argsort(-x)[:k], 1.0)
            keep[:k] = 0.0
            return col + keep
    """})
    found = _findings(idx, "jit-purity")
    assert len(found) == 1 and "index_fill_" in found[0].message
    assert found[0].line == 8
