"""The port's cost model, abstract trees and dry run against the JAX
package's, on the CPU and without allocating (``launch/costmodel.py``,
``launch/steps.py``, ``launch/dryrun.py``).

The port's trees are built on the ``meta`` device, JAX's by ``eval_shape``,
both at the FULL configs.  ``linear_macs_per_token``, ``attn_macs``,
``model_flops`` and ``step_cost``'s flops are equal (``==``) on all 10
archs × 4 cells; bytes are equal too, except a decode step's cache: the
port's positions, lengths and page tables are int64 (JAX's int32), so its
``cache_bytes`` and ``hbm_bytes`` exceed JAX's by exactly 4 bytes an index
element.  ``abstract_nm_params`` leaf shapes equal JAX's under 2:4 and the
mixed recipe, deepseek's ``wkv_b`` kept dense; ``plan_segments`` equal on
every arch.  Then the dry run's records: one cell per family against
JAX's analytic terms, and ``--measure`` on a REDUCED decode cell.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.core.plan import PrunePlan as JPlan  # noqa: E402
from repro.core.sparsity import NmCompressed as JNm  # noqa: E402
from repro.core.sparsity import NmStackedCompressed as JNmS  # noqa: E402
from repro.launch import costmodel as JCM  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models.model_builder import build_model as j_build  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeCell  # noqa: E402
from repro_torch.core.plan import PrunePlan  # noqa: E402
from repro_torch.core.sparsity import (NmCompressed,  # noqa: E402
                                       NmStackedCompressed)
from repro_torch.dist.sharding import MeshShape  # noqa: E402
from repro_torch.launch import costmodel as CM  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models.model_builder import build_model  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "examples", "recipes", "mixed_2to4_serve.json")


@functools.lru_cache(maxsize=None)
def pair(arch: str):
    """(port model, port meta params, JAX model, JAX abstract params)."""
    model = build_model(registry.get_config(arch), device="cpu")
    jmodel = j_build(j_registry.get_config(arch))
    return model, S.abstract_params(model), jmodel, JS.abstract_params(jmodel)


def j_dryrun():
    """JAX's dryrun module, imported without letting its 512-device
    XLA_FLAGS reach this process's backend (already up) or children."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jd
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jd


def index_bytes(cache) -> int:
    """4 bytes for each int64 element of a port cache (int32 in JAX)."""
    return 4 * sum(x.numel() for x in CM.tree_tensors(cache)
                   if x.dtype == torch.int64)


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_macs_and_model_flops_equal_jax(arch):
    cfg, jcfg = registry.get_config(arch), j_registry.get_config(arch)
    _, a, _, ja = pair(arch)
    assert CM.linear_macs_per_token(cfg) == JCM.linear_macs_per_token(jcfg)
    jd = j_dryrun()
    for cell in SHAPES.values():
        for kind in ("train", "prefill", "decode"):
            assert CM.attn_macs(cfg, cell.global_batch, cell.seq_len, kind,
                                cache_len=cell.seq_len) == \
                JCM.attn_macs(jcfg, cell.global_batch, cell.seq_len, kind,
                              cache_len=cell.seq_len)
        assert dryrun.model_flops(cfg, a, cell) == \
            jd.model_flops(jcfg, ja, cell)
    assert CM.param_bytes(cfg, a) == JCM.param_bytes(jcfg, ja)


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_step_cost_equal_jax_on_every_cell(arch):
    """All 4 cells (skipped ones too), n_micro as the dry run sets it;
    whisper's decode also with the cached cross k/v."""
    cfg, jcfg = registry.get_config(arch), j_registry.get_config(arch)
    model, a, jmodel, ja = pair(arch)
    for cell in SHAPES.values():
        B, L = cell.global_batch, cell.seq_len
        cache = jcache = None
        if cell.kind == "decode":
            cache = S.abstract_cache(model, B, L)
            jcache = jax.eval_shape(functools.partial(jmodel.init_cache, B,
                                                      L))
        n_micro = max(1, B // 256) if cell.kind == "train" else 1
        for cross in ((False, True) if cfg.family == "encdec" else
                      (False,)):
            c = CM.step_cost(cfg, cell, a, n_micro=n_micro, a_cache=cache,
                             cross_cached=cross)
            jc = JCM.step_cost(jcfg, cell, ja, n_micro=n_micro,
                               a_cache=jcache, cross_cached=cross)
            extra = index_bytes(cache) if cache is not None else 0
            assert c.flops == jc.flops, (cell.name, cross)
            assert c.weight_bytes == jc.weight_bytes
            assert c.hbm_bytes - jc.hbm_bytes == extra, (cell.name, cross)
            want = dict(jc.detail)
            if "cache_bytes" in want:
                want["cache_bytes"] += extra
            assert c.detail == want
    if cfg.family in ("dense", "moe", "vlm"):      # the paged tables too
        pc = S.meta_model(model).init_paged_cache(
            4, num_pages=8, page_size=16, pages_per_slot=4)
        jpc = jax.eval_shape(functools.partial(
            jmodel.init_paged_cache, 4, num_pages=8, page_size=16,
            pages_per_slot=4))
        assert CM.cache_bytes(pc) - JCM.cache_bytes(jpc) == index_bytes(pc)


def _leaf_shapes(tree, is_port: bool) -> dict:
    """{path: (kind, shape, dtype)} with compressed leaves expanded; the
    index bytes compare as one byte type (uint8 in the port, int8 in
    JAX)."""
    out: dict = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, (NmCompressed, NmStackedCompressed, JNm,
                               JNmS)):
            kind = "stacked" if isinstance(node, (NmStackedCompressed,
                                                  JNmS)) else "nm"
            out[path] = (kind, tuple(node.values.shape),
                         str(node.values.dtype).replace("torch.", ""),
                         tuple(node.indices.shape), node.indices.dtype.itemsize
                         if is_port else np.dtype(node.indices.dtype).itemsize,
                         node.n, node.m, node.b)
        else:
            out[path] = ("dense", tuple(node.shape),
                         str(node.dtype).replace("torch.", ""))

    walk(tree, ())
    return out


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_abstract_nm_params_equal_jax(arch):
    model, _, jmodel, _ = pair(arch)
    got = _leaf_shapes(S.abstract_nm_params(model, 2, 4), True)
    want = _leaf_shapes(JS.abstract_nm_params(jmodel, 2, 4), False)
    assert got == want
    assert any(v[0] != "dense" for v in got.values())
    if arch == "deepseek-v3-671b":        # absorbed-decode raw weight
        wkv_b = [v for p, v in got.items() if "wkv_b" in p]
        assert wkv_b and all(v[0] == "dense" for v in wkv_b)
    if arch == "qwen3-moe-30b-a3b":
        assert any(v[0] == "stacked" for v in got.values())


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-moe-30b-a3b"])
def test_abstract_nm_params_mixed_recipe_equal_jax(arch):
    model, _, jmodel, _ = pair(arch)
    got = _leaf_shapes(S.abstract_nm_params(
        model, plan=PrunePlan.load(RECIPE)), True)
    want = _leaf_shapes(JS.abstract_nm_params(
        jmodel, plan=JPlan.load(RECIPE)), False)
    assert got == want
    kinds = {v[0] for v in got.values()}
    if arch == "tinyllama-1.1b":     # MLP 2:4, attention dense
        assert "nm" in kinds
        assert all(v[0] == "dense" for p, v in got.items() if "attn" in p)


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_plan_segments_equal_jax(arch):
    model, a, jmodel, ja = pair(arch)
    sigs = [S._block_signature(model, a, i)
            for i in range(model.num_blocks())]
    jsigs = [JS._block_signature(jmodel, ja, i)
             for i in range(jmodel.num_blocks())]
    assert S.plan_segments(sigs) == JS.plan_segments(jsigs)
    run = S.make_block_runner(model, block_fn=lambda p, c, i: c + [i])
    assert run(None, []) == list(range(model.num_blocks()))   # every block


# ---------------------------------------------------------------- dry run
FAMILY_CELLS = [("tinyllama-1.1b", "train_4k"),
                ("qwen3-moe-30b-a3b", "prefill_32k"),
                ("internvl2-76b", "prefill_32k"),
                ("whisper-medium", "decode_32k"),
                ("zamba2-7b", "long_500k"),
                ("xlstm-1.3b", "decode_32k")]


@pytest.mark.parametrize("arch,cell_name", FAMILY_CELLS)
def test_dryrun_record_one_cell_per_family(arch, cell_name):
    """JAX's run_cell keys that do not come from XLA; the analytic terms
    as ``step_cost`` gives them (JAX's, plus the index bytes on decode);
    the H100's peaks; the left-out HLO keys absent, not zeroed."""
    cell = SHAPES[cell_name]
    mesh = MeshShape(("data", "model"), (16, 16))
    rec = dryrun.run_cell(arch, cell, mesh, "pod16x16", 256)
    assert rec["device"] == "NVIDIA H100 80GB HBM3"
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW) == (989e12, 3.35e12)
    assert all(k not in rec for k in dryrun.LEFT_OUT)
    assert set(rec["roofline"]) == {"compute_s", "memory_s"}
    _, _, jmodel, ja = pair(arch)
    jcfg = j_registry.get_config(arch)
    jcache = None
    if cell.kind == "decode":
        jcache = jax.eval_shape(functools.partial(
            jmodel.init_cache, cell.global_batch, cell.seq_len))
    n_micro = cell.global_batch // 16 if cell.kind == "train" else 1
    jc = JCM.step_cost(jcfg, cell, ja, n_micro=n_micro, a_cache=jcache)
    assert rec["analytic"]["flops"] == jc.flops
    extra = rec["analytic"]["hbm_bytes"] - jc.hbm_bytes
    assert extra == (0 if jcache is None else index_bytes(
        S.abstract_cache(build_model(registry.get_config(arch),
                                     device="cpu"),
                         cell.global_batch, cell.seq_len)))
    assert rec["model_flops"] == j_dryrun().model_flops(jcfg, ja, cell)
    t = rec["roofline"]
    assert t["compute_s"] == jc.flops / (256 * 989e12)
    assert rec["bottleneck"] == max(t, key=t.get)
    assert rec["roofline_step_s"] == max(t.values())
    per, whole = rec["argument_bytes"]["per_device"], \
        rec["argument_bytes"]["whole"]
    assert 0 < per["total"] < whole["total"]
    assert rec["fits"] == (per["total"] <= 80e9)
    assert rec["fits_one_card"] == (whole["total"] <= 80e9)
    if cell.kind == "train":                 # fp32 grads, bf16 moments
        assert whole["grads"] == 2 * whole["params"]
        assert whole["moments"] == 2 * whole["params"]


def test_dryrun_cli_writes_records_and_skips(tmp_path, capsys):
    out = tmp_path / "dr"
    rc = dryrun.main(["--arch", "tinyllama-1.1b", "--cell",
                      "decode_32k,long_500k", "--mesh", "single", "--out",
                      str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "SKIP tinyllama-1.1b long_500k" in text
    assert (out / "tinyllama-1.1b_decode_32k_pod16x16.json").exists()
    rc = dryrun.main(["--arch", "tinyllama-1.1b", "--cell", "decode_32k",
                      "--mesh", "single", "--out", str(out)])
    assert rc == 0 and "HAVE" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["gemma3-1b", "xlstm-1.3b",
                                  "whisper-medium"])
def test_measure_cell_on_cpu_reduced(arch):
    """``--measure``'s run on the CPU: finite logits of (B, 1, V), the
    median of the runs, measured over the one-card bound."""
    cell = ShapeCell("decode_32k", 32, 4, "decode")
    rec = dryrun.measure_cell(arch, cell, device="cpu", reduced=True,
                              runs=3)
    cfg = registry.get_config(arch, reduced=True)
    assert rec["finite"] and rec["logits_shape"] == [4, 1, cfg.vocab_size]
    assert len(rec["step_ms_all"]) == 3 and rec["step_ms"] > 0
    assert rec["measured_over_bound"] == pytest.approx(
        rec["step_ms"] / 1e3 / rec["roofline_step_s"])
