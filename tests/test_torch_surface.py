"""The public surface of the port against the JAX package's, on the CPU.

Each name below is held exactly against its JAX counterpart: ``psi_x`` and
``mask_sparsity`` (``core/masks.py``) on inputs with ties, the shape cells
and the long-context registry (``configs``), ``CalibrationStream`` (its
fields, defaults and batch layout; the tokens are numpy's, as the port's
calibration batches are), ``prune_model(keep_masks=, progress=)`` and the
package re-exports of ``serve``, ``data``, ``util`` and ``kernels``.  Then a
symbol diff of every reference module against its port counterpart: what
the port lacks must be exactly the names and modules the ROADMAP says are
not to be ported (the numpy oracle, the jit-only lint rules, the dry run's
HLO readers, the Pallas entry points and tile knobs).
"""
from __future__ import annotations

import ast
import dataclasses
import importlib
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as j_base  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.core import masks as j_masks  # noqa: E402
from repro.data import pipeline as j_pipeline  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402
from repro_torch.core import masks  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from test_torch_fixtures import n, t  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_psi_x_and_mask_sparsity_equal_jax(dtype):
    rng = np.random.default_rng(3)
    # small integers: many exact ties, broken by flat index
    w = rng.integers(-3, 4, size=(12, 20)).astype(np.float32)
    xn = rng.integers(1, 3, size=(20,)).astype(np.float32)
    jw = jnp.asarray(w).astype(dtype)
    tw = t(np.asarray(jw))
    for r in (0, 1, 37, 120, 239, 240):
        jm = j_masks.psi_x(jw, jnp.asarray(xn), jnp.asarray(r))
        m = masks.psi_x(tw, t(xn), r)
        assert m.dtype == tw.dtype and m.shape == tw.shape
        np.testing.assert_array_equal(n(m), np.asarray(jm, np.float32))
        assert float(m.sum()) == r
        assert n(masks.mask_sparsity(m.float())).tobytes() == np.asarray(
            j_masks.mask_sparsity(jm.astype(jnp.float32))).tobytes()


def test_shape_cells_and_long_context_registry_equal_jax():
    assert [dataclasses.astuple(c) for c in base.SHAPES.values()] == \
        [dataclasses.astuple(c) for c in j_base.SHAPES.values()]
    assert list(base.SHAPES) == list(j_base.SHAPES)
    assert [f.name for f in dataclasses.fields(base.ShapeCell)] == \
        [f.name for f in dataclasses.fields(j_base.ShapeCell)]
    assert registry.LONG_CONTEXT_OK == j_registry.LONG_CONTEXT_OK
    for arch in registry.ARCHS:
        cfg, jcfg = registry.get_config(arch), j_registry.get_config(arch)
        for name in base.SHAPES:
            assert registry.cell_supported(cfg, base.SHAPES[name]) == \
                j_registry.cell_supported(jcfg, j_base.SHAPES[name])
    for skipped in (False, True):
        got = [(a, c.name) for a, c in registry.all_cells(skipped)]
        want = [(a, c.name) for a, c in j_registry.all_cells(skipped)]
        assert got == want
    assert len(list(registry.all_cells(True))) == 40
    assert len(list(registry.all_cells())) == 40 - 6


def test_calibration_stream():
    jf = {f.name: f.default for f in dataclasses.fields(
        j_pipeline.CalibrationStream)}
    pf = {f.name: f.default for f in dataclasses.fields(
        pipeline.CalibrationStream)}
    assert {k: v for k, v in pf.items() if k != "device"} == jf
    corpus = pipeline.SyntheticCorpus(vocab_size=97, seed=3)
    stream = pipeline.CalibrationStream(corpus, num_samples=6, seq_len=10,
                                        batch=2, seed=5, device="cpu")
    got = stream.batches()
    jgot = j_pipeline.CalibrationStream(
        j_pipeline.SyntheticCorpus(vocab_size=97, seed=3), num_samples=6,
        seq_len=10, batch=2, seed=5).batches()
    assert len(got) == len(jgot) == 3
    for b, jb in zip(got, jgot):
        assert set(b) == set(jb) == {"tokens"}
        assert tuple(b["tokens"].shape) == tuple(jb["tokens"].shape)
        assert 0 <= int(b["tokens"].min()) and int(b["tokens"].max()) < 97
    for i, b in enumerate(got):     # batch i is numpy's stream [seed, i]
        want = corpus.sample(np.random.default_rng([5, i]), 2, 10)
        np.testing.assert_array_equal(n(b["tokens"]), want)
    cfg = registry.get_config("tinyllama-1.1b", reduced=True)
    cal = pipeline.calibration_batches(cfg, num_samples=4, seq_len=8,
                                       batch=2, seed=7, device="cpu")
    same = pipeline.CalibrationStream(
        pipeline.SyntheticCorpus(vocab_size=cfg.vocab_size), num_samples=4,
        seq_len=8, batch=2, seed=7, device="cpu").batches()
    assert all(torch.equal(a["tokens"], b["tokens"])
               for a, b in zip(cal, same))
    with pytest.raises(ValueError, match="multiple of batch"):
        pipeline.CalibrationStream(corpus, num_samples=5, batch=2,
                                   device="cpu").batches()


def test_prune_model_keep_masks_and_progress_equal_jax():
    """``keep_masks=False`` leaves the masks out of both reports;
    ``progress`` gets JAX's lines (the loss digits aside: two solvers)."""
    from repro.configs.registry import get_config as j_get_config
    from repro.core import PruneConfig as JCfg
    from repro.core import prune_model as j_prune_model
    from repro.core.plan import PrunePlan as JPlan
    from repro.core.plan import PruneRule as JRule
    from repro.models.model_builder import ModelAdapter as JAdapter
    from repro.models.model_builder import build_model as j_build
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import PruneConfig, PrunePlan, PruneRule
    from repro_torch.core import prune_model
    from repro_torch.models.model_builder import ModelAdapter, build_model

    jcfg = j_get_config("tinyllama-1.1b", reduced=True).replace(
        num_layers=1)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
            for _ in range(2)]
    cell = dict(method="thanos", pattern="nm", n=2, m=4, block_size=32)
    jplan = JPlan(rules=(JRule(match="*/attn/wq/*", cfg=None, name="keep"),
                         JRule(match="blocks/*", cfg=JCfg(**cell))))
    plan = PrunePlan(rules=(PruneRule(match="*/attn/wq/*", cfg=None,
                                      name="keep"),
                            PruneRule(match="blocks/*",
                                      cfg=PruneConfig(**cell))))
    jlines, lines = [], []
    _, jrep = j_prune_model(jparams, JAdapter(jmodel),
                            [{"tokens": jnp.asarray(x)} for x in toks],
                            jplan, keep_masks=False, progress=jlines.append)
    model = build_model(registry.get_config(
        "tinyllama-1.1b", reduced=True).replace(num_layers=1), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    _, rep = prune_model(params, ModelAdapter(model),
                         [{"tokens": torch.from_numpy(x).long()}
                          for x in toks],
                         plan, keep_masks=False, progress=lines.append)
    assert rep.masks == {} and dict(jrep.masks) == {}
    assert len(lines) == len(jlines) == 7
    assert [s.split(" loss=")[0] for s in lines] == \
        [s.split(" loss=")[0] for s in jlines]
    assert any("skipped (rule 0)" in s for s in lines)


@pytest.mark.parametrize("pkg", ["serve", "data", "util", "kernels"])
def test_package_reexports_equal_jax(pkg):
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    assert port.__all__ == ref.__all__
    assert all(hasattr(port, name) for name in port.__all__)


# names in a reference module that the port does not carry, and why
NOT_PORTED = {
    # the dry run's readers of compiled XLA: HLO text parsing (collective
    # bytes, shape bytes and their regexes), memory_analysis() and the
    # TPU's ICI rate for the collective term — the port has no HLO
    "launch/dryrun.py": {"shape_bytes", "collective_bytes", "mem_dict",
                         "COLLECTIVE_RE", "SHAPE_RE", "DTYPE_BYTES",
                         "COMP_HEADER_RE", "WHILE_RE", "CONST_RE",
                         "ICI_BW"},
    # the Pallas tile knobs and their switch: K2 plans its own tiles
    "kernels/ops.py": {"choose_tiles"},
    "models/layers.py": {"set_nm_kernel", "get_nm_kernel"},
    # the Pallas entry points: the port's kernels are hessian_update_cuda
    # and nm_matmul_cuda behind the same ops dispatch
    "kernels/hessian_accum.py": {"hessian_xtx"},
    "kernels/nm_spmm.py": {"nm_matmul"},
}
# whole modules: the numpy oracle the port's tests already use
MODULES_NOT_PORTED = ("core/reference.py",)


def _public_names(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {tg.id for tg in node.targets if isinstance(tg, ast.Name)}
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            out |= {a.asname or a.name for a in node.names}
    return {x for x in out if not x.startswith("_") and x != "Array"}


def test_symbol_diff_is_only_the_queued_tooling():
    missing = {}
    for ref in sorted((SRC / "repro").rglob("*.py")):
        rel = ref.relative_to(SRC / "repro").as_posix()
        port = SRC / "repro_torch" / rel
        if rel.startswith(MODULES_NOT_PORTED):
            continue
        assert port.exists(), f"no port of src/repro/{rel}"
        lack = _public_names(ref) - _public_names(port)
        if lack != NOT_PORTED.get(rel, set()):
            missing[rel] = sorted(lack)
    assert not missing, missing
