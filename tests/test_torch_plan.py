"""The port's PrunePlan layer against the JAX package: every recipe of
examples/recipes/ round-trips to the same JSON bytes, rules resolve alike
on tinyllama's and qwen3-moe's paths, the sparsity allocation and the
Hessian stats it reads agree, a mixed recipe prunes tinyllama (REDUCED,
fp32) to the same masks and rollup, ``compress_params(plan=)`` packs
qwen3-moe's expert stacks into the same bytes (and refuses mixed stacks
alike), and mixed-residency serving gives JAX's greedy tokens; then the
``--plan`` flags of both CLIs.

Tolerances: JSON, masks, packed bytes and tokens exactly; Hessian traces
rtol 1e-5; weights rtol 5e-3 / atol 5e-4 and OBS losses rtol 1e-2, as
tests/test_torch_slice.py."""
from __future__ import annotations

import argparse
import json
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.core import LayerStat as JLayerStat  # noqa: E402
from repro.core import PrunePlan as JPrunePlan  # noqa: E402
from repro.core import collect_hessian_stats as j_stats  # noqa: E402
from repro.core import path_str as j_path_str  # noqa: E402
from repro.core import prune_model as j_prune_model  # noqa: E402
from repro.data.pipeline import calibration_batches  # noqa: E402
from repro.launch.prune import build_plan as j_build_plan  # noqa: E402
from repro.models.model_builder import ModelAdapter as JAdapter  # noqa
from repro.models.model_builder import build_model as j_build  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServingEngine as JEngine  # noqa: E402
from repro.serve.compressed import CompressionDowngrade as JDowngrade  # noqa
from repro.serve.compressed import compress_params as j_compress  # noqa
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import (AllocationSpec, LayerStat, PruneConfig,  # noqa
                              PrunePlan, PruneRule, as_plan,
                              collect_hessian_stats, get_path, prune_model)
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core.masks import check_nm  # noqa: E402
from repro_torch.core.sparsity import (NmCompressed,  # noqa: E402
                                       NmStackedCompressed)
from repro_torch.models.model_builder import ModelAdapter, build_model  # noqa
from repro_torch.serve.compressed import (CompressionDowngrade,  # noqa: E402
                                          compress_params, compressed_bytes,
                                          decompress_params)
from repro_torch.serve.engine import (Request, ServeConfig,  # noqa: E402
                                      ServingEngine)
from test_torch_fixtures import jax_tree_to_numpy, n  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RECIPES = sorted((ROOT / "examples" / "recipes").glob("*.json"))
MIXED = ROOT / "examples" / "recipes" / "mixed_2to4_serve.json"
MOE = ROOT / "examples" / "recipes" / "moe_expert_2to4.json"
BESA = ROOT / "examples" / "recipes" / "besa_trace_budget.json"
W_TOL = {"rtol": 5e-3, "atol": 5e-4}


def _carry(tree):
    return params_from_numpy(jax_tree_to_numpy(tree), device="cpu")


def _tbatches(jbatches):
    return [{"tokens": torch.from_numpy(np.array(b["tokens"]))}
            for b in jbatches]


def _masks(jmasks):
    return {k: torch.from_numpy(np.array(v)) for k, v in jmasks.items()}


# ------------------------------------------------------------- recipes
def test_recipes_present():
    assert {p.name for p in RECIPES} >= {MIXED.name, MOE.name, BESA.name,
                                         "headline_unstructured.json"}


@pytest.mark.parametrize("recipe", RECIPES, ids=lambda p: p.name)
def test_recipe_json_byte_equal_to_jax(recipe, tmp_path):
    """load → to_json → from_json is exact, and the JSON (and a saved file)
    is byte-equal to the JAX package's for the same recipe."""
    plan, jplan = PrunePlan.load(str(recipe)), JPrunePlan.load(str(recipe))
    assert plan.to_json() == jplan.to_json()
    assert plan.to_json(indent=None) == jplan.to_json(indent=None)
    assert PrunePlan.from_json(plan.to_json()) == plan
    assert PrunePlan.from_dict(jplan.to_dict()) == plan
    plan.save(str(tmp_path / "t.json"))
    jplan.save(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert not list(tmp_path.glob("*.tmp.*"))


def test_plan_json_round_trip_every_field():
    plan = PrunePlan(rules=(
        PruneRule(match="embed*", cfg=None, name="dense"),
        PruneRule(match="*/mlp/*", cfg=PruneConfig(
            method="thanos", pattern="nm", n=3, m=8, block_size=512,
            alpha=0.1), on_singular="fallback:magnitude"),
        PruneRule(match=r"blocks/\d+/attn/.*", regex=True,
                  cfg=PruneConfig(method="sparsegpt", p=0.625,
                                  percdamp=0.02, row_chunk=4)),
        PruneRule(match="*", cfg=PruneConfig(method="wanda", p=0.5)),
    ), allocation=AllocationSpec(policy="hessian_trace", budget=0.4,
                                 p_min=0.1, p_max=0.8))
    text = plan.to_json()
    assert PrunePlan.from_json(text) == plan
    assert JPrunePlan.from_json(text).to_json() == text


def test_plan_rejections_match_jax():
    bad = [({"rules": [], "extra": 1}, "unknown plan keys"),
           ({"version": 99, "rules": []}, "schema version"),
           ({"rules": [{"match": "*"}]}, "needs 'cfg' or 'action'"),
           ({"rules": [{"match": "*", "action": "skip", "cfg": {}}]},
            "excludes 'cfg'"),
           ({"rules": [{"match": "*", "cfgg": {}}]}, "unknown rule keys"),
           ({"rules": [{"match": "*", "cfg": {"sparsity": 1}}]},
            "unknown PruneConfig fields"),
           ({"rules": [{"match": "*", "cfg": {}, "on_singular": "pray"}]},
            "on_singular"),
           ({"rules": [{"match": "(", "regex": True, "cfg": {}}]},
            "bad regex"),
           ({"rules": [], "allocation": {"policy": "learned"}},
            "allocation policy"),
           ({"rules": [], "allocation": {"budget": 0.8, "p_max": 0.5}},
            "unattainable")]
    for d, msg in bad:
        with pytest.raises(ValueError, match=msg):
            PrunePlan.from_dict(d)
        with pytest.raises(ValueError, match=msg):
            JPrunePlan.from_dict(d)
    assert as_plan(PruneConfig()) == PrunePlan.uniform(PruneConfig())
    with pytest.raises(TypeError):
        as_plan({"rules": []})


def _paths(arch: str) -> list:
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    out = ["embed/table", "lm_head/w", "final_norm/scale"]
    for i in range(model.num_blocks()):
        out += list(model.block_linear_paths(params, i))
    return out


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-moe-30b-a3b"])
def test_resolve_and_cfg_for_match_jax(arch):
    paths = _paths(arch)
    assert any(isinstance(p, tuple) and isinstance(p[-1], int)
               for p in paths) == (arch != "tinyllama-1.1b")
    for recipe in RECIPES:
        plan, jplan = PrunePlan.load(str(recipe)), JPrunePlan.load(
            str(recipe))
        for path in paths:
            (i, cfg), (ij, cfgj) = plan.resolve(path), jplan.resolve(path)
            assert i == ij, (recipe.name, path)
            assert (cfg is None) == (cfgj is None)
            if cfg is not None:
                assert cfg.to_dict() == cfgj.to_dict()
                assert plan.cfg_for(path) == cfg
                assert tplan.path_str(path) == j_path_str(path)


def test_allocate_sparsity_matches_jax():
    """The same stats give the same expanded plan, byte for byte, for both
    policies and for an n:m plan (never reallocated)."""
    stats = {f"blocks/{i}/{nm}/w": (1024 * (i + 1), 10.0 ** (i - 2))
             for i in range(5) for nm in ("fc1", "fc2")}
    t_stats = {k: LayerStat(*v) for k, v in stats.items()}
    j_stats_ = {k: JLayerStat(*v) for k, v in stats.items()}
    for recipe in RECIPES:
        plan, jplan = PrunePlan.load(str(recipe)), JPrunePlan.load(
            str(recipe))
        for kw in ({}, {"policy": "uniform", "budget": 0.3},
                   {"policy": "hessian_trace", "budget": 0.6,
                    "p_min": 0.2, "p_max": 0.95}):
            got = plan.allocate_sparsity(t_stats, **kw)
            assert got.to_json() == jplan.allocate_sparsity(j_stats_,
                                                            **kw).to_json()
            assert got.allocation is None
    tr = PrunePlan.load(str(BESA)).allocate_sparsity(t_stats)
    ps = [tr.cfg_for(k).p for k in stats]
    sizes = [v[0] for v in stats.values()]
    assert abs(np.dot(ps, sizes) / sum(sizes) - 0.5) < 1e-6
    assert all(0.1 <= p <= 0.9 for p in ps)


# ------------------------------------------- tinyllama under a mixed recipe
@pytest.fixture(scope="module")
def tiny():
    jcfg = j_get_config("tinyllama-1.1b", reduced=True)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jbatches = calibration_batches(jcfg, num_samples=16, seq_len=32, batch=8)
    jplan = JPrunePlan.load(str(MIXED))
    jpruned, jrep = j_prune_model(jparams, JAdapter(jmodel), jbatches, jplan)
    tmodel = build_model(get_config("tinyllama-1.1b", reduced=True),
                         device="cpu")
    tparams = _carry(jparams)
    tpruned, trep = prune_model(tparams, ModelAdapter(tmodel),
                                _tbatches(jbatches), PrunePlan.load(
                                    str(MIXED)))
    return (jmodel, jparams, jbatches, jpruned, jrep), \
        (tmodel, tparams, tpruned, trep)


def test_collect_hessian_stats_match_jax(tiny):
    (jmodel, jparams, jbatches, _, _), (tmodel, tparams, _, _) = tiny
    sj = j_stats(jparams, JAdapter(jmodel), jbatches)
    st = collect_hessian_stats(tparams, ModelAdapter(tmodel),
                               _tbatches(jbatches))
    assert list(st) == list(sj) and len(st) == 14
    for k in sj:
        assert st[k].size == sj[k].size
        np.testing.assert_allclose(st[k].trace, sj[k].trace, rtol=1e-5)
    # the allocation over these stats: budget held, every p in its clip
    alloc = PrunePlan.load(str(BESA)).allocate_sparsity(st)
    ps = np.array([alloc.cfg_for(k).p for k in st])
    sizes = np.array([st[k].size for k in st])
    assert abs(ps @ sizes / sizes.sum() - 0.5) < 1e-6
    assert ps.min() >= 0.1 and ps.max() <= 0.9 and ps.std() > 0


def test_mixed_recipe_masks_and_rollup_match_jax(tiny):
    (_, jparams, _, jpruned, jrep), (_, tparams, tpruned, trep) = tiny
    assert list(trep.masks) == list(jrep.masks) and len(trep.masks) == 14
    for path, mk in jrep.masks.items():
        np.testing.assert_array_equal(n(trep.masks[path]), np.asarray(mk))
        np.testing.assert_allclose(n(get_path(tpruned, path)),
                                   np.asarray(get_path(jpruned, path)),
                                   **W_TOL)
        if "mlp" in path:
            assert check_nm(trep.masks[path].T, 2, 4)
    for rt, rj in zip(trep.layers, jrep.layers):
        assert (rt.path, rt.rule, rt.tag, rt.params, rt.skipped) == \
            (rj.path, rj.rule, rj.tag, rj.params, rj.skipped)
        assert rt.sparsity == pytest.approx(rj.sparsity, abs=1e-7)
        np.testing.assert_allclose(rt.obs_loss, rj.obs_loss, rtol=1e-2)
    roll_t, roll_j = trep.rule_rollup(), jrep.rule_rollup()
    assert [r["rule"] for r in roll_t] == [2, 4]
    for a, b in zip(roll_t, roll_j):
        for key in ("rule", "match", "action", "tag", "layers", "params"):
            assert a[key] == b[key], key
        assert a["mean_sparsity"] == pytest.approx(b["mean_sparsity"],
                                                   abs=1e-7)
        np.testing.assert_allclose(a["obs_loss"], b["obs_loss"], rtol=1e-2)
    art = json.loads(trep.to_json())
    assert PrunePlan.from_dict(art["plan"]) == trep.plan
    assert art["plan"] == json.loads(jrep.to_json())["plan"]
    assert [layer["path"] for layer in art["layers"]] == \
        [layer["path"] for layer in json.loads(jrep.to_json())["layers"]]
    assert art["mean_sparsity"] == pytest.approx(jrep.mean_sparsity())
    # the input tree is untouched
    w0 = ("blocks", 0, "mlp", "up", "w")
    assert float((get_path(tparams, w0) == 0).float().mean()) == 0.0


def test_skip_rules_leave_layers_dense(tiny):
    """A skip rule (and an unmatched path) keeps the kernel, reports the
    layer as skipped, and accumulates no Hessian for it."""
    (_, _, jbatches, _, _), (tmodel, tparams, _, _) = tiny
    plan = PrunePlan(rules=(
        PruneRule(match="blocks/0/mlp/*", cfg=None, name="dense"),
        PruneRule(match="*/mlp/*", cfg=PruneConfig(method="wanda", p=0.5)),
    ))
    pruned, rep = prune_model(tparams, ModelAdapter(tmodel),
                              _tbatches(jbatches), plan)
    by = {r.path: r for r in rep.layers}
    skipped = [r for r in rep.layers if r.skipped]
    assert len(skipped) == 3 + 8                    # rule 0 + unmatched attn
    assert {r.rule for r in skipped} == {0, -1}
    assert all(r.tag == "skip" and r.path not in rep.masks for r in skipped)
    assert by[("blocks", 1, "mlp", "up", "w")].rule == 1
    for r in skipped:
        assert get_path(pruned, r.path) is get_path(tparams, r.path)
    roll = {r["rule"]: r for r in rep.rule_rollup()}
    assert roll[-1]["match"] is None and roll[-1]["action"] == "skip"
    assert roll[0]["layers"] == 3 and roll[1]["layers"] == 3


def test_allocation_recipe_expands_inside_prune_model(tiny):
    (_, _, jbatches, _, _), (tmodel, tparams, _, _) = tiny
    adapter = ModelAdapter(tmodel)
    plan = PrunePlan.load(str(BESA))
    plan = PrunePlan(rules=(PruneRule(match="*", cfg=PruneConfig(
        method="wanda", p=0.5)),), allocation=plan.allocation)
    _, rep = prune_model(tparams, adapter, _tbatches(jbatches), plan)
    assert rep.plan.allocation is None and len(rep.plan.rules) == 15
    want = plan.allocate_sparsity(collect_hessian_stats(
        tparams, adapter, _tbatches(jbatches)))
    assert rep.plan.to_json() == want.to_json()
    for r in rep.layers:
        assert r.rule < 14 and r.tag.startswith("wanda_p")


def _serve(engine_cls, req_cls, cfg_cls, model, params):
    eng = engine_cls(model, params, cfg_cls(batch_slots=2, max_len=16))
    rng = np.random.default_rng(3)
    for uid, (plen, new) in enumerate([(5, 4), (3, 6), (7, 2), (4, 5)]):
        eng.submit(req_cls(uid, rng.integers(0, 512, size=plen).astype(
            np.int32), max_new=new))
    return [r.out for r in eng.run()]


def test_mixed_residency_engine_tokens_match_jax(tiny):
    """The JAX-pruned tree under the recipe, compressed per plan cell by
    each package: the same leaves (MLP packed with the same bytes,
    attention dense), and the engine's greedy tokens equal JAX's and the
    decompressed dense oracle's."""
    (jmodel, _, _, jpruned, jrep), (tmodel, _, _, trep) = tiny
    jcomp = j_compress(jpruned, jrep.masks, plan=jrep.plan)
    tcomp = compress_params(_carry(jpruned), _masks(jrep.masks),
                            plan=trep.plan)
    jcomp_t = _carry(jcomp)
    for path in jrep.masks:
        a, b = get_path(tcomp, path), get_path(jcomp_t, path)
        if "mlp" in path:
            assert isinstance(a, NmCompressed) and isinstance(b, NmCompressed)
            assert torch.equal(a.values, b.values)
            assert torch.equal(a.indices, b.indices)
        else:
            assert torch.is_tensor(a) and torch.equal(a, b)
    cb, db = compressed_bytes(tcomp)
    assert (cb, db) == compressed_bytes(jcomp_t) and cb / db == 0.5625
    out_j = _serve(JEngine, JRequest, JServeConfig, jmodel, jcomp)
    out_t = _serve(ServingEngine, Request, ServeConfig, tmodel, tcomp)
    out_d = _serve(ServingEngine, Request, ServeConfig, tmodel,
                   decompress_params(tcomp))
    assert out_t == out_j == out_d


# ----------------------------------- qwen3-moe: stacked packs under a plan
@pytest.fixture(scope="module")
def moe():
    jcfg = j_get_config("qwen3-moe-30b-a3b", reduced=True)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jbatches = calibration_batches(jcfg, num_samples=8, seq_len=32, batch=8)
    jpruned, jrep = j_prune_model(jparams, JAdapter(jmodel), jbatches,
                                  JPrunePlan.load(str(MOE)))
    return jpruned, jrep


def test_moe_recipe_compress_byte_identical_to_jax(moe):
    jpruned, jrep = moe
    plan = PrunePlan.load(str(MOE))
    tcomp = compress_params(_carry(jpruned), _masks(jrep.masks), plan=plan,
                            strict=True)
    jcomp = _carry(j_compress(jpruned, jrep.masks, plan=jrep.plan,
                              strict=True))
    for i in range(2):
        blk_t, blk_j = tcomp["blocks"][i], jcomp["blocks"][i]
        for name in ("gate", "up", "down"):
            a, b = blk_t["moe"][name]["w"], blk_j["moe"][name]["w"]
            assert isinstance(a, NmStackedCompressed) and a.E == 8
            assert (a.n, a.m, a.b, a.idx_bits) == (b.n, b.m, b.b, b.idx_bits)
            assert torch.equal(a.values, b.values)
            assert torch.equal(a.indices, b.indices)
        for name in ("wq", "wk", "wv", "wo"):
            a, b = blk_t["attn"][name]["w"], blk_j["attn"][name]["w"]
            assert torch.is_tensor(a) and torch.equal(a, b)  # dense
    assert compressed_bytes(tcomp) == compressed_bytes(jcomp)


@pytest.mark.parametrize("case", ["mixed", "partial", "unstructured"])
def test_moe_stack_downgrades_match_jax(moe, case):
    """A stack whose slices resolve to two n:m cells, or only partly to
    n:m, serves dense: a CompressionDowngrade, a ValueError under
    ``strict=True`` — as in JAX.  A stack all unstructured stays dense
    without a warning."""
    jpruned, jrep = moe
    nm = {"method": "thanos", "pattern": "nm", "n": 2, "m": 4}
    first = {"mixed": dict(nm, n=4, m=8),
             "partial": {"method": "thanos", "pattern": "unstructured"},
             "unstructured": {"method": "thanos",
                              "pattern": "unstructured"}}[case]
    rest = dict(first) if case == "unstructured" else nm
    d = {"version": 1, "rules": [
        {"match": "blocks/0/moe/gate/w/0", "cfg": first},
        {"match": "*/moe/*", "cfg": rest}]}
    plan, jplan = PrunePlan.from_dict(d), JPrunePlan.from_dict(d)
    tparams, tmasks = _carry(jpruned), _masks(jrep.masks)
    if case == "unstructured":
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            comp = compress_params(tparams, tmasks, plan=plan, strict=True)
        assert torch.is_tensor(comp["blocks"][0]["moe"]["gate"]["w"])
        return
    msg = ("mixed n:m cells" if case == "mixed"
           else r"experts \[0\] not n:m-masked")
    with pytest.raises(ValueError, match=msg):
        compress_params(tparams, tmasks, plan=plan, strict=True)
    with pytest.raises(ValueError, match=msg):
        j_compress(jpruned, jrep.masks, plan=jplan, strict=True)
    with pytest.warns(CompressionDowngrade, match=msg) as rec:
        comp = compress_params(tparams, tmasks, plan=plan)
    with pytest.warns(JDowngrade) as jrec:
        j_compress(jpruned, jrep.masks, plan=jplan)
    assert [str(w.message) for w in rec] == [str(w.message) for w in jrec]
    blk = comp["blocks"][0]["moe"]
    assert torch.is_tensor(blk["gate"]["w"])                  # dense
    assert isinstance(blk["up"]["w"], NmStackedCompressed)
    assert isinstance(comp["blocks"][1]["moe"]["gate"]["w"],
                      NmStackedCompressed)


def test_compress_params_needs_a_cell():
    with pytest.raises(ValueError, match=r"needs \(n, m\) or plan="):
        compress_params({}, {})


# --------------------------------------------------------------- the CLIs
def test_build_plan_matches_jax():
    ns = argparse.Namespace(
        plan="", method="sparsegpt", pattern="unstructured", p=0.5, n=2,
        m=4, alpha=0.0, block_size=64, skip=["embed*", "*/wo/*"],
        mlp_pattern="nm", attn_pattern="structured")
    from repro_torch.launch.prune import build_plan

    assert build_plan(ns).to_json() == j_build_plan(ns).to_json()
    ns.plan = str(MIXED)
    assert build_plan(ns).to_json() == j_build_plan(ns).to_json()
    bare = argparse.Namespace(
        plan="", method="wanda", pattern="structured", p=0.3, n=2, m=4,
        alpha=0.0, block_size=64, skip=[], mlp_pattern="", attn_pattern="")
    assert build_plan(bare) == PruneConfig(
        method="wanda", pattern="structured", p=0.3, block_size=64)
    assert build_plan(bare).to_dict() == j_build_plan(bare).to_dict()


def test_prune_cli_plan_flags(monkeypatch, capsys, tmp_path):
    from repro_torch.launch import prune as lprune

    report = tmp_path / "report.json"
    monkeypatch.setattr("sys.argv", [
        "prune", "--plan", str(MIXED), "--device", "cpu", "--report",
        str(report)])
    lprune.main()
    out = json.loads(capsys.readouterr().out)
    assert out["config"] == "plan[5 rules]" and out["layers_pruned"] == 14
    assert [r["match"] for r in out["rules"]] == ["*/mlp/*", "*/attn/*"]
    art = json.loads(report.read_text())
    assert PrunePlan.from_dict(art["plan"]) == PrunePlan.load(str(MIXED))
    monkeypatch.setattr("sys.argv", [
        "prune", "--method", "wanda", "--skip", "*/attn/*", "--mlp-pattern",
        "nm", "--device", "cpu"])
    lprune.main()
    out = json.loads(capsys.readouterr().out)
    assert (out["layers_pruned"], out["layers_skipped"]) == (6, 8)
    assert out["rules"][1]["tag"] == "wanda_2:4"
    for flag, bad in (("--method", "obs"), ("--pattern", "blocky")):
        monkeypatch.setattr("sys.argv", ["prune", flag, bad])
        with pytest.raises(SystemExit):
            lprune.main()
    capsys.readouterr()


def test_serve_cli_plan_flag(monkeypatch, capsys):
    from repro_torch.launch import serve as lserve

    monkeypatch.setattr("sys.argv", [
        "serve", "--plan", str(MIXED), "--device", "cpu", "--requests", "2",
        "--prompt-len", "4", "--max-new", "3", "--slots", "2"])
    lserve.main()
    out = capsys.readouterr().out
    assert "compressed weight bytes: 0.562 of their dense bytes" in out
    assert "*/mlp/*" in out and "thanos_p0.5" in out
    assert "2 requests, 6 tokens" in out


def test_plan_check_entry_point(tmp_path, capsys):
    assert tplan._main(["--check", str(RECIPES[0].parent)]) == 0
    assert f"all {len(RECIPES)} recipe(s) valid" in capsys.readouterr().out
    bad = tmp_path / "bad.json"
    bad.write_text('{"rules": [{"match": "*"}]}')
    assert tplan._main([str(bad)]) == 1
    assert "1 invalid recipe(s)" in capsys.readouterr().out
    assert tplan._main([]) == 1
