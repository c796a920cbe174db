"""The port's MoE slice on the CPU against the JAX package, on
qwen3-moe-30b-a3b REDUCED (fp32): ``moe_ffn`` with and without capacity
overflow, the per-expert routed-row counts, the dead-expert guard,
``forward``/``decode_step`` with qk-norm, Thanos 2:4 ``prune_model`` from the
same params and the JAX calibration tokens, stacked compression, and the
continuous-batching engine serving expert stacks compressed-resident.

Tolerances: ``moe_ffn`` rtol/atol 1e-5; logits rtol/atol 1e-4 (as
tests/test_torch_model.py); masks, counts, index bytes and greedy tokens
exactly; weights rtol 5e-3 / atol 5e-4 (as tests/test_torch_slice.py);
compressed vs decompressed serving bitwise on the plain path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.core import PruneConfig as JPruneConfig  # noqa: E402
from repro.core import prune_model as j_prune_model  # noqa: E402
from repro.data.pipeline import calibration_batches  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models.model_builder import ModelAdapter as JAdapter  # noqa
from repro.models.model_builder import build_model as j_build  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServingEngine as JEngine  # noqa: E402
from repro.serve.compressed import compress_params as j_compress  # noqa
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.api import PruneConfig  # noqa: E402
from repro_torch.core.masks import check_nm  # noqa: E402
from repro_torch.core.schedule import get_path, prune_model  # noqa: E402
from repro_torch.core.sparsity import NmStackedCompressed  # noqa: E402
from repro_torch.faults import InsufficientCalibration  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.model_builder import ModelAdapter, build_model  # noqa
from repro_torch.serve.compressed import (compress_params,  # noqa: E402
                                          compressed_bytes,
                                          decompress_params)
from repro_torch.serve.engine import (Request, ServeConfig,  # noqa: E402
                                      ServingEngine)
from test_torch_fixtures import jax_tree_to_numpy, n, t  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
TOL = {"rtol": 1e-4, "atol": 1e-4}
W_TOL = {"rtol": 5e-3, "atol": 5e-4}


def _models():
    jmodel = j_build(j_get_config(ARCH, reduced=True))
    tmodel = build_model(get_config(ARCH, reduced=True), device="cpu")
    return jmodel, tmodel


def _carry(tree):
    return params_from_numpy(jax_tree_to_numpy(tree), device="cpu")


def test_configs_match():
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(ARCH, reduced=reduced)) == \
            dataclasses.asdict(j_get_config(ARCH, reduced=reduced))


@pytest.mark.parametrize("cf", [4.0, 0.25])
def test_moe_ffn_matches_jax(cf):
    """Sort-based dispatch, capacity drop and gate renorm over survivors:
    cf 4.0 drops nothing, cf 0.25 (C = 8 for 64 assignments of top-2 over
    8 experts, as tests/test_stacked_compressed.py:307) drops some."""
    cfg = j_get_config(ARCH, reduced=True).replace(capacity_factor=cf)
    jp = JM.moe_params(jax.random.PRNGKey(9), cfg, jnp.float32)
    x = np.random.default_rng(10).normal(size=(2, 32, cfg.d_model))
    y_j = JM.moe_ffn(jp, jnp.asarray(x, jnp.float32), cfg)
    y_t = M.moe_ffn(_carry(jp), torch.from_numpy(x.astype(np.float32)),
                    get_config(ARCH, reduced=True).replace(
                        capacity_factor=cf))
    np.testing.assert_allclose(n(y_t), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)
    assert M.capacity(64, 2, 8, cf) == JM.capacity(64, 2, 8, cf)
    if cf < 1:
        assert M.capacity(64, 2, 8, cf) < 64 * 2 // 8


@pytest.fixture(scope="module")
def pair():
    jmodel, tmodel = _models()
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams, tmodel, _carry(jparams)


def test_tape_counts_routed_rows_like_jax(pair):
    """Block 0's tape: the same paths, expert inputs and (E, C) routed-row
    masks, so every expert's Hessian count equals JAX's."""
    jmodel, jparams, tmodel, tparams = pair
    cfg = jmodel.cfg
    tokens = np.array(calibration_batches(cfg, num_samples=4, seq_len=16,
                                          batch=4)[0]["tokens"])
    ja, ta = JAdapter(jmodel), ModelAdapter(tmodel)
    _, capj = ja.block_apply(jparams, 0, ja.prepare(
        jparams, {"tokens": jnp.asarray(tokens)}), capture=True)
    _, capt = ta.block_apply(tparams, 0, ta.prepare(
        tparams, {"tokens": torch.from_numpy(tokens)}), capture=True)
    assert list(capt) == list(capj) == ta.block_linear_paths(tparams, 0)
    counts = []
    for path, vj in capj.items():
        vt = capt[path]
        if isinstance(vj, tuple):
            np.testing.assert_array_equal(n(vt[1]), np.asarray(vj[1]))
            np.testing.assert_allclose(n(vt[0]), np.asarray(vj[0]), **TOL)
            counts.append(int(vt[1].sum()))
        else:
            np.testing.assert_allclose(n(vt), np.asarray(vj), **TOL)
    assert len(counts) == 3 * cfg.num_experts and min(counts) > 0


@pytest.mark.parametrize("T", [1, 4])
def test_unrouted_capacity_rows_are_zero(pair, T):
    """The premise of K3's skip: at serving sizes (T = 1 prefill token,
    T = 4 decode slots) every capacity row that ``valid`` marks unrouted is
    exactly zero in the gate/up input (the dispatch buffer) and in h, the
    down leaf's input; only T·k rows are routed."""
    _, _, tmodel, tparams = pair
    cfg = tmodel.cfg
    p = tparams["blocks"][0]["moe"]
    x = torch.from_numpy(np.random.default_rng(T).normal(
        size=(T, 1, cfg.d_model)).astype(np.float32))
    tape: dict = {}
    M.moe_ffn(p, x, cfg, tape=tape)
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    assert M.capacity(T, k, E, cfg.capacity_factor) == 8
    routed = 0
    for name in ("gate", "up", "down"):
        for e in range(E):
            xe, valid = tape[(name, "w", e)]
            assert xe.shape == (8, cfg.d_model if name != "down"
                                else cfg.moe_d_ff)
            assert bool((xe[~valid] == 0).all()), (name, e)
            assert bool((xe[valid] != 0).any(dim=-1).all()), (name, e)
            routed += int(valid.sum()) if name == "gate" else 0
    assert routed == T * k


def test_dead_expert_raises_insufficient_calibration(pair):
    """4 tokens × top-2 over 8 experts leaves experts unrouted (the JAX
    test at tests/test_stacked_compressed.py:231): the guard raises."""
    jmodel, jparams, tmodel, tparams = pair
    tokens = np.array(calibration_batches(jmodel.cfg, num_samples=2,
                                          seq_len=2, batch=2)[0]["tokens"])
    batches = [{"tokens": torch.from_numpy(tokens)}]
    ta = ModelAdapter(tmodel)
    _, caps = ta.block_apply(tparams, 0, ta.prepare(tparams, batches[0]),
                             capture=True)
    routed = [int(caps[("blocks", 0, "moe", "gate", "w", e)][1].sum())
              for e in range(jmodel.cfg.num_experts)]
    assert min(routed) == 0, "fixture must contain a dead expert"
    with pytest.raises(InsufficientCalibration):
        prune_model(tparams, ta, batches,
                    PruneConfig(method="thanos", p=0.5, block_size=16),
                    min_calib_samples=1)


def test_forward_and_decode_with_qk_norm_match_jax(pair):
    """qk-norm, head_dim·heads ≠ d_model and rope θ = 1e6 through the
    forward, the loss and token-by-token decode with (B,) positions."""
    jmodel, jparams, tmodel, tparams = pair
    assert jmodel.cfg.qk_norm and "qnorm" in tparams["blocks"][0]["attn"]
    tokens = np.random.default_rng(0).integers(0, 512, size=(2, 8))
    lj = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    lt = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(n(lt), np.asarray(lj), **TOL)
    np.testing.assert_allclose(
        float(tmodel.loss(tparams, {"tokens": torch.from_numpy(tokens)})),
        float(jmodel.loss(jparams, {"tokens": jnp.asarray(tokens,
                                                          jnp.int32)})),
        rtol=1e-5)
    jc, tc = jmodel.init_cache(2, 16), tmodel.init_cache(2, 16)
    for step in range(3):
        pos = np.array([step + 2, step], np.int32)
        tok = tokens[np.arange(2), pos][:, None]
        lj, jc = jmodel.decode_step(jparams, jc, jnp.asarray(tok, jnp.int32),
                                    jnp.asarray(pos))
        lt, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(n(lt), np.asarray(lj), **TOL)


@pytest.fixture(scope="module")
def pruned_pair(pair):
    jmodel, jparams, tmodel, tparams = pair
    jbatches = calibration_batches(jmodel.cfg, num_samples=8, seq_len=32,
                                   batch=8)
    jpruned, jrep = j_prune_model(
        jparams, JAdapter(jmodel), jbatches,
        JPruneConfig(method="thanos", pattern="nm", n=2, m=4, block_size=16))
    tbatches = [{"tokens": torch.from_numpy(np.array(b["tokens"]))}
                for b in jbatches]
    tpruned, trep = prune_model(
        tparams, ModelAdapter(tmodel), tbatches,
        PruneConfig(method="thanos", pattern="nm", n=2, m=4, block_size=16))
    return (jmodel, jpruned, jrep), (tmodel, tparams, tpruned, trep)


def test_prune_model_matches_jax(pruned_pair):
    """Every expert slice pruned with its own routed-token Hessian: masks
    equal, weights within 5e-3 / 5e-4, reports equal; the input tree is
    left as it was (the stacks are copied once, then written)."""
    (_, jpruned, jrep), (tmodel, tparams, tpruned, trep) = pruned_pair
    cfg = tmodel.cfg
    assert list(trep.masks) == list(jrep.masks)
    assert len(trep.layers) == cfg.num_layers * (4 + 3 * cfg.num_experts)
    for path, mk in jrep.masks.items():
        np.testing.assert_array_equal(n(trep.masks[path]), np.asarray(mk))
        assert check_nm(trep.masks[path].T, 2, 4)
        np.testing.assert_allclose(n(get_path(tpruned, path)),
                                   np.asarray(get_path(jpruned, path)),
                                   **W_TOL)
    for rt, rj in zip(trep.layers, jrep.layers):
        assert (rt.path, rt.tag, rt.params, rt.fallback, rt.damp_attempts) \
            == (rj.path, rj.tag, rj.params, rj.fallback, rj.damp_attempts)
        assert rt.sparsity == rj.sparsity == 0.5
    stack = ("blocks", 0, "moe", "gate", "w")
    assert get_path(tpruned, stack) is not get_path(tparams, stack)
    assert float((get_path(tparams, stack) == 0).float().mean()) == 0.0


def test_compressed_bytes_and_leaves_match_jax(pruned_pair):
    """The port packs the JAX-pruned tree into the JAX package's bytes:
    one NmStackedCompressed per stack with E = 8, attention 2-D leaves."""
    (_, jpruned, jrep), _ = pruned_pair
    jcomp = _carry(j_compress(jpruned, jrep.masks, 2, 4))
    tcomp = compress_params(_carry(jpruned), {
        k: torch.from_numpy(np.array(v)) for k, v in jrep.masks.items()},
        2, 4)
    for i in range(2):
        for name in ("gate", "up", "down"):
            a = tcomp["blocks"][i]["moe"][name]["w"]
            b = jcomp["blocks"][i]["moe"][name]["w"]
            assert isinstance(a, NmStackedCompressed) and a.E == 8
            assert torch.equal(a.values, b.values)
            assert torch.equal(a.indices, b.indices)
    assert compressed_bytes(tcomp) == compressed_bytes(jcomp)
    cb, db = compressed_bytes(tcomp)
    assert cb / db == 0.5625                      # fp32 values, 4-bit idx


def _serve(engine_cls, req_cls, cfg_cls, model, params):
    eng = engine_cls(model, params, cfg_cls(batch_slots=2, max_len=16))
    rng = np.random.default_rng(3)
    for uid, (plen, new) in enumerate([(5, 4), (3, 6), (7, 2)]):
        eng.submit(req_cls(uid, rng.integers(0, 512, size=plen).astype(
            np.int32), max_new=new))
    return eng, [r.out for r in eng.run()]


def test_engine_tokens_match_jax_and_dense_oracle(pruned_pair):
    """Compressed-resident MoE serving: the port's tokens equal the JAX
    engine's on the same compressed tree, and equal serving it
    decompressed; one decode step's logits are bitwise equal."""
    (jmodel, jpruned, jrep), (tmodel, _, _, _) = pruned_pair
    jcomp = j_compress(jpruned, jrep.masks, 2, 4)
    tcomp = _carry(jcomp)
    _, out_j = _serve(JEngine, JRequest, JServeConfig, jmodel, jcomp)
    _, out_c = _serve(ServingEngine, Request, ServeConfig, tmodel, tcomp)
    _, out_d = _serve(ServingEngine, Request, ServeConfig, tmodel,
                      decompress_params(tcomp))
    assert out_c == out_d == out_j
    tok = torch.tensor([[1], [7]])
    lc, _ = tmodel.decode_step(tcomp, tmodel.init_cache(2, 8), tok, 0)
    ld, _ = tmodel.decode_step(decompress_params(tcomp),
                               tmodel.init_cache(2, 8), tok, 0)
    torch.testing.assert_close(lc, ld, rtol=0, atol=0)


def test_engine_never_decompresses(pruned_pair, monkeypatch):
    (_, jpruned, jrep), (tmodel, _, _, _) = pruned_pair
    tcomp = _carry(j_compress(jpruned, jrep.masks, 2, 4))

    def boom(*a, **k):
        raise AssertionError("dense materialization on the serve path")

    import repro_torch.core.sparsity as sparsity
    import repro_torch.serve.compressed as compressed

    monkeypatch.setattr(compressed, "decompress_params", boom)
    monkeypatch.setattr(sparsity, "unpack_nm_stacked", boom)
    monkeypatch.setattr(sparsity, "unpack_nm", boom)
    eng, outs = _serve(ServingEngine, Request, ServeConfig, tmodel, tcomp)
    assert isinstance(eng.params["blocks"][1]["moe"]["down"]["w"],
                      NmStackedCompressed)
    assert [len(o) for o in outs] == [4, 6, 2]


def test_serve_cli_on_cpu(monkeypatch, capsys):
    """The serve CLI prunes, stack-compresses and serves qwen3-moe at
    REDUCED size on the CPU."""
    from repro_torch.launch import serve as lserve

    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", ARCH, "--nm", "--device", "cpu", "--requests",
        "2", "--prompt-len", "4", "--max-new", "3", "--slots", "2"])
    lserve.main()
    out = capsys.readouterr().out
    assert "compressed weight bytes: 0.562 of dense" in out
    assert "2 requests, 6 tokens" in out


def test_bf16_router_ties_route_like_jax_top_k():
    """bf16 routing with forced boundary ties: router columns repeated in
    groups of three make many tokens' k-th and (k+1)-th probabilities
    exactly equal.  ``jax.lax.top_k`` keeps the lower expert; so must the
    port (a stable descending sort cut to k, not ``torch.topk``).  Every
    expert's routed rows (the tape's (E, C) masks and the dispatched
    activations) equal JAX's exactly, and so do the per-token expert ids
    that ``jax.lax.top_k`` gives on the same probabilities; the outputs
    agree at bf16 rounding."""
    cfg = j_get_config(ARCH, reduced=True).replace(dtype="bfloat16")
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    jp = JM.moe_params(jax.random.PRNGKey(3), cfg, jnp.bfloat16)
    router = np.asarray(jp["router"]["w"].astype(jnp.float32))
    router = router[:, [0, 0, 0, 3, 3, 3, 6, 6][:E]]     # tied columns
    jp = dict(jp, router={"w": jnp.asarray(router, jnp.bfloat16)})
    x = np.random.default_rng(4).normal(size=(2, 32, cfg.d_model))
    xj = jnp.asarray(x, jnp.bfloat16)
    jtape: dict = {}
    y_j = JM.moe_ffn(jp, xj, cfg, tape=jtape)
    ttape: dict = {}
    tcfg = get_config(ARCH, reduced=True).replace(dtype="bfloat16")
    y_t = M.moe_ffn(_carry(jp), t(xj), tcfg, tape=ttape)

    probs = jax.nn.softmax((xj.reshape(-1, cfg.d_model)
                            @ jp["router"]["w"]).astype(jnp.float32))
    p_sorted = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
    assert (p_sorted[:, k - 1] == p_sorted[:, k]).mean() > 0.5  # ties forced
    gates_j, ids_j = jax.lax.top_k(probs, k)
    counts = np.zeros(E, np.int64)
    for e in range(E):
        xe, valid = ttape[("gate", "w", e)]
        xej, validj = jtape[("gate", "w", e)]
        np.testing.assert_array_equal(n(valid), np.asarray(validj))
        np.testing.assert_array_equal(n(xe), np.asarray(xej, np.float32))
        counts[e] = int(valid.sum())
    np.testing.assert_array_equal(
        counts, np.bincount(np.asarray(ids_j).ravel(), minlength=E))
    np.testing.assert_allclose(n(y_t), np.asarray(y_j, np.float32),
                               rtol=2e-2, atol=2e-2)
