"""The prune job's CUDA graphs on a card (marked ``cuda``: they skip
without one; this file imports no JAX, so it runs where JAX is absent):

    python -m pytest -q --noconftest -m cuda tests/test_torch_prune_capture_cuda.py

Inside a ``util.graphs.scope()`` a graphed solve's first call with a key
runs eagerly, its second captures and replays, later ones replay.  The
reference is the direct call (``fn.__wrapped__``) on the current stream:
a replay runs the kernels the direct call runs, on the same shapes and
the same cuSOLVER routines, so weights, mask and loss are bitwise equal —
on two different (W, H) pairs per key in turn, which a graph reading a
stale buffer would fail.  The block passes, a whole ``prune_model`` against
an eager loop over the same public pieces, the guard on a singular H, the
pool's release and a refused capture complete it.
"""
from __future__ import annotations

import functools
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import (api, magnitude, sparsegpt, thanos,  # noqa: E402
                              wanda)
from repro_torch.core.hessian import HessianAccumulator  # noqa: E402
from repro_torch.core.schedule import (get_path, prune_model,  # noqa: E402
                                       set_path)
from repro_torch.data.pipeline import calibration_batches  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.model_builder import (ModelAdapter,  # noqa: E402
                                              build_model)
from repro_torch.util import graphs  # noqa: E402

SOLVES = {
    "thanos/unstructured": (thanos.prune_unstructured,
                            {"p": 0.5, "block_size": 128}),
    "thanos/nm": (thanos.prune_nm, {"n": 2, "m": 4, "block_size": 64}),
    "thanos/structured": (thanos.prune_structured, {"p": 0.3,
                                                    "alpha": 0.1}),
    "sparsegpt/unstructured": (sparsegpt.prune_unstructured,
                               {"p": 0.5, "mask_blocksize": 64}),
    "sparsegpt/nm": (sparsegpt.prune_nm, {"n": 2, "m": 4, "blocksize": 64}),
    "sparsegpt/structured": (sparsegpt.prune_structured,
                             {"p": 0.3, "blocksize": 64}),
    "wanda/unstructured": (wanda.prune_unstructured, {"p": 0.5}),
    "wanda/nm": (wanda.prune_nm, {"n": 2, "m": 4}),
    "wanda/structured": (wanda.prune_structured, {"p": 0.3}),
    "magnitude/unstructured": (magnitude.prune_unstructured, {"p": 0.5}),
    "magnitude/nm": (magnitude.prune_nm, {"n": 2, "m": 4}),
    "magnitude/structured": (magnitude.prune_structured, {"p": 0.3}),
}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return resolve_device("cuda")          # cuSOLVER, TF32 off


def _problem(seed: int, c: int, b: int, dtype, dev) -> tuple:
    """(W (c, b) in ``dtype``, H = 2XᵀX/n (b, b) fp32) from numpy."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((c, b)).astype(np.float32)
    x = rng.standard_normal((2 * b, b)).astype(np.float32)
    x[:, 5] = 0.0                                  # one dead feature
    h = 2.0 * x.T @ x / x.shape[0]
    return (torch.from_numpy(w).to(dev, dtype),
            torch.from_numpy(h).to(dev))


def _equal(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(SOLVES))
def test_solve_replays_bitwise_the_direct_call(cuda, name, dtype):
    fn, kw = SOLVES[name]
    for c, b in ((512, 256), (256, 512)):
        pairs = {s: _problem(s, c, b, DTYPES[dtype], cuda) for s in (1, 2)}
        want = {s: fn.__wrapped__(*p, **kw) for s, p in pairs.items()}
        with graphs.scope() as sc:
            for s in (1, 2, 1, 2, 2):
                got = fn(*pairs[s], **kw)
                torch.cuda.synchronize()
                assert _equal(got, want[s]), (c, b, s)
            st = sc.stats()
        assert (st["eager"], st["graphs"], st["replays"]) == (1, 1, 4)


@pytest.mark.cuda
def test_a_singular_h_gives_nan_attempts_and_the_eager_guard(cuda):
    w, _ = _problem(0, 256, 128, torch.bfloat16, cuda)
    h = torch.eye(128, device=cuda)
    h[0, 1] = h[1, 0] = 1e3          # indefinite past every damping (≤ 100)
    cfg = api.PruneConfig("thanos", "nm", block_size=64)
    want = api.prune_layer_guarded(w, h, cfg,
                                   on_singular="fallback:magnitude")
    with graphs.scope() as sc:
        for _ in range(2):
            res = api.prune_layer(w, h, cfg)
            assert not bool(torch.isfinite(res.weights.float()).all())
            got = api.prune_layer_guarded(w, h, cfg,
                                          on_singular="fallback:magnitude")
            assert got[1] == want[1] and _equal(got[0], want[0])
        assert sc.stats()["graphs"] == 6      # 5 percdamps + magnitude
    assert want[1].fallback == "magnitude" and want[1].damp_attempts == 5


_MODELS: dict = {}


def _model(arch: str, dev):
    if arch not in _MODELS:
        cfg = get_config(arch, reduced=True).replace(dtype="bfloat16")
        model = build_model(cfg, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        batches = calibration_batches(cfg, num_samples=6, seq_len=32,
                                      batch=2, device=dev)
        _MODELS[arch] = (model, params, batches)
    return _MODELS[arch]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-moe-30b-a3b",
                                  "zamba2-7b", "xlstm-1.3b"])
def test_block_passes_replay_bitwise(cuda, arch):
    model, params, batches = _model(arch, cuda)
    adapter = ModelAdapter(model)
    carries = [adapter.prepare(params, b) for b in batches]
    with torch.no_grad(), graphs.scope() as sc:
        for i in (0, adapter.num_blocks(params) - 1):
            for capture in (True, False):
                block = graphs.graphed(functools.partial(
                    adapter.block_apply, params, i, capture=capture))
                for c in carries:
                    want = adapter.block_apply(params, i, c, capture=capture)
                    got = block(c)
                    torch.cuda.synchronize()
                    assert _equal(got, want), (i, capture)
                graphs.release(block)
        assert sc.stats()["graphs"] == 4 and sc.entries == {}


def _eager_prune(params, adapter, batches, cfg):
    """Alg. 3 as a loop of eager public pieces outside any scope:
    ``block_apply``, ``HessianAccumulator``, ``prune_layer``."""
    carries = [adapter.prepare(params, b) for b in batches]
    accs, masks = {}, {}
    for i in range(adapter.num_blocks(params)):
        for c in carries:
            for path, x in adapter.block_apply(params, i, c,
                                               capture=True)[1].items():
                x, valid = x if isinstance(x, tuple) else (x, None)
                if path not in accs:
                    accs[path] = HessianAccumulator.init(x.shape[-1],
                                                         x.device)
                accs[path].update(x, valid)
        for path in adapter.block_linear_paths(params, i):
            kernel = get_path(params, path)
            res = api.prune_layer(kernel.T, accs.pop(path).finalize(), cfg)
            params = set_path(params, path,
                              res.weights.T.contiguous().to(kernel.dtype))
            masks[path] = res.mask.T.contiguous()
        carries = [adapter.block_apply(params, i, c, capture=False)[0]
                   for c in carries]
    return params, masks


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-moe-30b-a3b",
                                  "zamba2-7b"])
def test_prune_model_equals_the_eager_loop_and_frees_its_pool(cuda, arch):
    model, params, batches = _model(arch, cuda)
    adapter = ModelAdapter(model)
    cfg = api.PruneConfig("thanos", "nm", block_size=32)
    with torch.no_grad():
        want_p, want_m = _eager_prune(params, adapter, batches, cfg)
    made = []
    real = graphs.Graph

    class Tracked(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(weakref.ref(self))

    graphs.Graph = Tracked
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(cuda)
        got_p, rep = prune_model(params, adapter, batches, cfg)
        torch.cuda.synchronize()
        after = torch.cuda.memory_reserved(cuda)
    finally:
        graphs.Graph = real
    assert _equal(got_p, want_p) and _equal(rep.masks, want_m)
    g = rep.graphs
    # and the scope's anchor (``Scope.open_pool``)
    assert g["graphs"] > 0 and g["replays"] > 0 and \
        g["graphs"] + 1 == len(made)
    gc.collect()
    assert all(r() is None for r in made)
    kept = sum(t.numel() * t.element_size() for t in
               pytree.tree_leaves((got_p, rep.masks)))
    assert after - before <= kept + (64 << 20), (before, after, kept)


@pytest.mark.cuda
def test_a_scope_captures_again_after_dropping_every_graph(cuda):
    """A block's passes drop their graphs once the block is done, and the
    next block captures into the scope's pool with no graph left in it
    (the allocation pass: no solve keeps one)."""
    def shift(x, i):
        return x + i

    x = torch.arange(8.0, device=cuda)
    with graphs.scope() as sc:
        for i in range(3):
            fn = graphs.graphed(functools.partial(shift, i=i))
            for _ in range(3):
                assert torch.equal(fn(x), x + i)
            graphs.release(fn)
            assert sc.entries == {}
    st = sc.stats()
    assert st["graphs"] == 3 and st["replays"] == 6


@pytest.mark.cuda
def test_a_capture_that_syncs_raises(cuda):
    """The eager first call syncs freely; the capture refuses the sync and
    raises — there is no eager fallback."""
    @graphs.graphed
    def syncing(x):
        return x * float(x.sum())

    x = torch.ones(8, device=cuda)
    with graphs.scope():
        syncing(x)
        with pytest.raises(RuntimeError):
            syncing(x)


@pytest.mark.cuda
def test_a_capture_on_magma_is_refused(cuda):
    w, h = _problem(0, 256, 128, torch.float32, cuda)
    torch.backends.cuda.preferred_linalg_library("magma")
    try:
        with graphs.scope():
            thanos.prune_nm(w, h, n=2, m=4, block_size=64)
            with pytest.raises(RuntimeError, match="cuSOLVER"):
                thanos.prune_nm(w, h, n=2, m=4, block_size=64)
    finally:
        torch.backends.cuda.preferred_linalg_library("cusolver")
