"""The port's slice end to end on the CPU against the JAX package: Thanos
2:4 prunes tinyllama (REDUCED, fp32) block by block from the same params
and the JAX calibration tokens, the pruned linears pack into the same bytes,
and the continuous-batching engine serves the same greedy tokens.

Tolerances: masks and index bytes exactly; weights rtol 5e-3 / atol 5e-4
(as tests/test_thanos_algorithms.py); OBS losses rtol 1e-2; tokens exactly
(greedy argmax over fp32 logits that agree to ~1e-6)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.core import PruneConfig as JPruneConfig  # noqa: E402
from repro.core import prune_model as j_prune_model  # noqa: E402
from repro.data.pipeline import calibration_batches  # noqa: E402
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
from repro_torch.core.sparsity import NmCompressed  # noqa: E402
from repro_torch.models.model_builder import ModelAdapter, build_model  # noqa
from repro_torch.serve.compressed import (compress_params,  # noqa: E402
                                          compressed_bytes,
                                          decompress_params)
from repro_torch.serve.engine import (Request, ServeConfig,  # noqa: E402
                                      ServingEngine)
from test_torch_fixtures import jax_tree_to_numpy, n  # noqa: E402

W_TOL = {"rtol": 5e-3, "atol": 5e-4}


@pytest.fixture(scope="module")
def pruned_pair():
    jcfg = j_get_config("tinyllama-1.1b", reduced=True)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jbatches = calibration_batches(jcfg, num_samples=16, seq_len=32, batch=8)
    jcell = JPruneConfig(method="thanos", pattern="nm", n=2, m=4,
                         block_size=64)
    jpruned, jrep = j_prune_model(jparams, JAdapter(jmodel), jbatches, jcell)

    tmodel = build_model(get_config("tinyllama-1.1b", reduced=True),
                         device="cpu")
    tparams = params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")
    tbatches = [{"tokens": torch.from_numpy(np.array(b["tokens"]))}
                for b in jbatches]
    tcell = PruneConfig(method="thanos", pattern="nm", n=2, m=4,
                        block_size=64)
    tpruned, trep = prune_model(tparams, ModelAdapter(tmodel), tbatches,
                                tcell)
    return (jmodel, jpruned, jrep), (tmodel, tpruned, trep)


def test_prune_model_masks_and_reports_match_jax(pruned_pair):
    (_, jpruned, jrep), (_, tpruned, trep) = pruned_pair
    assert list(trep.masks) == list(jrep.masks)
    assert len(trep.layers) == 14
    for path, mk in jrep.masks.items():
        np.testing.assert_array_equal(n(trep.masks[path]), np.asarray(mk))
        assert check_nm(trep.masks[path].T, 2, 4)
        np.testing.assert_allclose(n(get_path(tpruned, path)),
                                   np.asarray(get_path(jpruned, path)),
                                   **W_TOL)
    for rt, rj in zip(trep.layers, jrep.layers):
        assert rt.path == rj.path and rt.tag == rj.tag
        assert rt.sparsity == rj.sparsity == 0.5
        assert (rt.damp_attempts, rt.fallback, rt.calib_skipped) == \
            (rj.damp_attempts, rj.fallback, rj.calib_skipped)
        assert rt.params == rj.params
        np.testing.assert_allclose(rt.obs_loss, rj.obs_loss, rtol=1e-2)
    assert trep.mean_sparsity() == jrep.mean_sparsity() == 0.5


def test_compress_matches_jax_bytes(pruned_pair):
    """JAX-pruned params and masks carried across pack into the bytes the
    JAX package packs; decompression restores the pruned kernels."""
    (_, jpruned, jrep), _ = pruned_pair
    jcomp = params_from_numpy(jax_tree_to_numpy(
        j_compress(jpruned, jrep.masks, 2, 4)), device="cpu")
    tpruned = params_from_numpy(jax_tree_to_numpy(jpruned), device="cpu")
    tmasks = {k: torch.from_numpy(np.array(v))
              for k, v in jrep.masks.items()}
    tcomp = compress_params(tpruned, tmasks, 2, 4)
    for path in jrep.masks:
        a, b = get_path(tcomp, path), get_path(jcomp, path)
        assert isinstance(a, NmCompressed) and isinstance(b, NmCompressed)
        assert (a.n, a.m, a.b, a.idx_bits) == (b.n, b.m, b.b, b.idx_bits)
        np.testing.assert_array_equal(n(a.values), n(b.values))
        np.testing.assert_array_equal(n(a.indices), n(b.indices))
        np.testing.assert_array_equal(n(get_path(decompress_params(tcomp),
                                                 path)),
                                      n(get_path(tpruned, path)))
    cb, db = compressed_bytes(tcomp)
    assert cb / db == pytest.approx(0.5625)       # fp32 values, 4-bit idx


def _serve(engine_cls, req_cls, model, params, cfg):
    eng = engine_cls(model, params, cfg)
    rng = np.random.default_rng(3)
    for uid, (plen, new) in enumerate([(5, 4), (3, 6), (7, 2), (4, 5)]):
        eng.submit(req_cls(uid, rng.integers(0, 512, size=plen).astype(
            np.int32), max_new=new))
    done = eng.run()
    return [r.out for r in done], eng.stats


def test_engine_tokens_match_jax_and_dense_oracle(pruned_pair):
    """Compressed-resident serving: the port's tokens equal the JAX
    engine's for the same params and prompts, and equal serving the same
    params decompressed (bitwise on the plain path)."""
    (jmodel, jpruned, jrep), (tmodel, _, _) = pruned_pair
    jcomp = j_compress(jpruned, jrep.masks, 2, 4)
    tcomp = params_from_numpy(jax_tree_to_numpy(jcomp), device="cpu")
    out_j, st_j = _serve(JEngine, JRequest, jmodel, jcomp,
                         JServeConfig(batch_slots=2, max_len=16))
    out_c, st_c = _serve(ServingEngine, Request, tmodel, tcomp,
                         ServeConfig(batch_slots=2, max_len=16))
    out_d, _ = _serve(ServingEngine, Request, tmodel,
                      decompress_params(tcomp),
                      ServeConfig(batch_slots=2, max_len=16))
    assert out_c == out_d
    assert out_c == out_j
    for k in ("decode_steps", "busy_slot_steps", "prefills",
              "prefill_tokens"):
        assert st_c[k] == st_j[k], k


def test_engine_logits_compressed_equal_decompressed(pruned_pair):
    """One decode step: compressed plain path == dense matmul, bitwise."""
    _, (tmodel, tpruned, trep) = pruned_pair
    comp = compress_params(tpruned, trep.masks, 2, 4)
    tok = torch.tensor([[1], [7]])
    lc, _ = tmodel.decode_step(comp, tmodel.init_cache(2, 8), tok, 0)
    ld, _ = tmodel.decode_step(decompress_params(comp),
                               tmodel.init_cache(2, 8), tok, 0)
    torch.testing.assert_close(lc, ld, rtol=0, atol=0)


def test_serve_config_validation_and_prompt_fit():
    with pytest.raises(ValueError, match="batch_slots"):
        ServeConfig(batch_slots=0)
    with pytest.raises(ValueError, match="max_len"):
        ServeConfig(max_len=1)
    model = build_model(get_config("tinyllama-1.1b", reduced=True),
                        device="cpu")
    eng = ServingEngine(model, {}, ServeConfig(batch_slots=1, max_len=4))
    with pytest.raises(ValueError, match="does not fit"):
        eng.submit(Request(0, np.zeros(4, np.int64)))


def test_launch_clis_on_cpu(monkeypatch, capsys):
    """Both CLIs run the slice on the CPU when asked (reduced config)."""
    from repro_torch.launch import prune as lprune
    from repro_torch.launch import serve as lserve

    monkeypatch.setattr("sys.argv", [
        "prune", "--pattern", "nm", "--device", "cpu"])
    lprune.main()
    assert '"mean_sparsity": 0.5' in capsys.readouterr().out
    monkeypatch.setattr("sys.argv", [
        "serve", "--nm", "--device", "cpu", "--requests", "2",
        "--prompt-len", "4", "--max-new", "3", "--slots", "2"])
    lserve.main()
    out = capsys.readouterr().out
    assert "compressed weight bytes: 0.562 of dense" in out
    assert "2 requests, 6 tokens" in out
