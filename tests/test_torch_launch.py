"""The port's launch tooling against the JAX package's, on the CPU
(``configs/registry`` specs, ``launch/mesh.py``, ``launch/steps.py``,
``launch/perf.py``, ``dryrun --prune-parity``).

Specs: ``input_specs`` / ``decode_specs`` keys and shapes equal JAX's for
all 10 archs × 4 cells; float dtypes equal, token and position dtypes
int64 (JAX's int32).  Step builders on ``make_debug_mesh()`` (1 × 1 on
the CPU) against JAX's on its own debug mesh, REDUCED configs (fp32),
inputs from a numpy seed (JAX's 1 × 1 mesh has Auto axes: under this
jax its ``make_debug_mesh`` gives Explicit ones): prefill's last-token logits at rtol/atol 1e-5
(as the forward parity tests), three decode steps at 1e-4 (dense, int8
cache, 2:4 weights packed from magnitude masks — the packing bitwise
JAX's ``compress_params`` — a 448-slot cache, whisper's cached cross
k/v, xLSTM; its bf16 matrix memory at test_torch_xlstm.py's bf16-state
bound), and ``make_train_step(microbatches=2)``: loss at rel 1e-5,
bf16 moments within one bf16 rounding of JAX's, params as the train
parity tests hold them.  The perf ladders run on REDUCED configs on the
CPU; the prune parity runs over 4 spawned gloo ranks.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.configs.base import ShapeCell as JCell  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models.model_builder import build_model as j_build  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.serve.compressed import compress_params as j_compress  # noqa
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeCell  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.masks import nm_mask  # noqa: E402
from repro_torch.core.schedule import get_path  # noqa: E402
from repro_torch.core.sparsity import NON_STREAMABLE_KERNELS  # noqa: E402
from repro_torch.launch import dryrun, perf  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch.costmodel import tree_tensors  # noqa: E402
from repro_torch.launch.mesh import (make_debug_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models.model_builder import build_model  # noqa: E402
from repro_torch.util.tree import sorted_leaves  # noqa: E402
from test_torch_fixtures import jax_tree_to_numpy, n, t  # noqa: E402


# ------------------------------------------------------------------ specs
def _spec(x, is_port: bool) -> tuple:
    dt = str(x.dtype).replace("torch.", "")
    if dt in ("int64", "int32"):
        assert dt == ("int64" if is_port else "int32")
        dt = "int"
    return tuple(x.shape), dt


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_input_and_decode_specs_equal_jax(arch):
    cfg, jcfg = registry.get_config(arch), j_registry.get_config(arch)
    for cell in SHAPES.values():
        for fn, jfn in ((registry.input_specs, j_registry.input_specs),
                        (registry.decode_specs, j_registry.decode_specs)):
            got, want = fn(cfg, cell), jfn(jcfg, cell)
            assert list(got) == list(want)
            assert all(v.device.type == "meta" for v in got.values())
            assert {k: _spec(v, True) for k, v in got.items()} == \
                {k: _spec(v, False) for k, v in want.items()}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-medium",
                                  "internvl2-76b"])
def test_concrete_batch_shapes_and_law(arch):
    cfg = registry.get_config(arch, reduced=True)
    cell = ShapeCell("t", 64, 3, "train")
    gen = torch.Generator().manual_seed(5)
    batch = registry.concrete_batch(cfg, cell, gen, device="cpu")
    specs = registry.input_specs(cfg, cell)
    assert list(batch) == list(specs)
    for k, v in batch.items():
        assert v.shape == specs[k].shape and v.dtype == specs[k].dtype
        assert v.device.type == "cpu"
        if v.dtype == registry.TOKEN_DTYPE:
            assert 0 <= int(v.min()) and int(v.max()) < cfg.vocab_size
            assert len(torch.unique(v)) > 10
        else:
            assert torch.isfinite(v).all() and abs(float(v.mean())) < 0.2
    again = registry.concrete_batch(cfg, cell, torch.Generator()
                                    .manual_seed(5), device="cpu")
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    if not torch.cuda.is_available():     # the card unless asked for cpu
        with pytest.raises(RuntimeError, match="CUDA"):
            registry.concrete_batch(cfg, cell)


# ------------------------------------------------------------------- mesh
def test_production_mesh_shapes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert (single.axis_names, single.shape) == (("data", "model"), (16, 16))
    assert (multi.axis_names, multi.shape) == (("pod", "data", "model"),
                                               (2, 16, 16))


@pytest.fixture(scope="module")
def mesh1():
    """``make_debug_mesh`` on the CPU: without a group it starts a one-rank
    gloo group, which this fixture then ends."""
    import torch.distributed as dist

    started = not dist.is_initialized()
    try:
        yield make_debug_mesh(device_type="cpu")
    finally:
        if started:
            dist.destroy_process_group()


def test_debug_mesh_is_one_by_one(mesh1):
    assert mesh1.mesh_dim_names == ("data", "model")
    assert tuple(mesh1.shape) == (1, 1)
    assert S._dp_size(mesh1) == 1


# -------------------------------------------------------- step builders
def j_debug_mesh():
    """JAX's 1 × 1 debug mesh with Auto axes: ``launch/mesh.make_debug_mesh``
    builds Explicit axes under jax ≥ 0.9, which the builders' sharding
    constraints refuse; ``Mesh`` lays the same device out as JAX's tests
    do."""
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def j_setup(arch, **replace):
    """(JAX model, params, port model, params) of ``arch`` REDUCED."""
    jcfg = j_registry.get_config(arch, reduced=True).replace(**replace)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(registry.get_config(arch, reduced=True)
                        .replace(**replace), device="cpu")
    return jmodel, jparams, model, params_from_numpy(
        jax_tree_to_numpy(jparams), device="cpu")


def batch_pair(cfg, cell, seed=0):
    rng = np.random.default_rng(seed)
    jb, tb = {}, {}
    for k, spec in registry.input_specs(cfg, cell).items():
        if spec.dtype == registry.TOKEN_DTYPE:
            x = rng.integers(0, cfg.vocab_size, size=spec.shape)
            jb[k], tb[k] = jnp.asarray(x, jnp.int32), torch.from_numpy(x)
        else:
            x = rng.normal(size=spec.shape).astype(np.float32)
            jb[k], tb[k] = jnp.asarray(x), t(x)
    return jb, tb


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-medium",
                                  "internvl2-76b"])
def test_prefill_step_matches_jax(arch, mesh1):
    jmodel, jparams, model, params = j_setup(arch)
    cell = ShapeCell("p", 16, 2, "prefill")
    jstep, jargs = JS.make_prefill_step(jmodel, j_debug_mesh(), JCell(
        "p", 16, 2, "prefill"))
    step, args = S.make_prefill_step(model, mesh1, cell)
    assert step.kind == "prefill" and args[0] is not None
    jb, tb = batch_pair(model.cfg, cell)
    want = jstep(jparams, jb)
    got = step(params, tb)
    assert tuple(got.shape) == tuple(want.shape) == (2, 1,
                                                     model.cfg.vocab_size)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def magnitude_masks(model, params) -> dict:
    """The magnitude 2:4 masks ``magnitude_nm_params`` packs, by path."""
    masks = {}
    for i in range(model.num_blocks()):
        for path in model.block_linear_paths(params, i):
            if any(p in NON_STREAMABLE_KERNELS for p in path
                   if isinstance(p, str)):
                continue
            w = get_path(params, path)
            masks[path] = nm_mask(w.T.float(), torch.ones(w.shape[0]), 2,
                                  4).T.to(w.dtype)
    return masks


def decode_pair(arch, opts: S.DecodeOptions, mesh, *, B=2, L=16, steps=3,
                **replace):
    """Three decode steps of the port's step and JAX's on the same
    params, tokens and positions; → (port logits, JAX logits) each step."""
    jmodel, jparams, model, params = j_setup(arch, **replace)
    cell = ShapeCell("decode_t", L, B, "decode")
    jstep, jargs = JS.make_decode_step(jmodel, j_debug_mesh(),
                                       JCell("decode_t", L, B, "decode"),
                                       JS.DecodeOptions(**vars(opts)))
    step, args = S.make_decode_step(model, mesh, cell, opts)
    if opts.nm:
        masks = magnitude_masks(model, params)
        jparams = j_compress(jparams, {p: jnp.asarray(n(m)) for p, m in
                                       masks.items()}, 2, 4)
        params = S.magnitude_nm_params(model, params, 2, 4)
        packed = params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")
        for got, want in zip(tree_tensors(params), tree_tensors(packed)):
            assert torch.equal(got, want)
    jcfg = jmodel.cfg.replace(kv_cache_dtype=opts.kv_dtype) \
        if opts.kv_dtype else jmodel.cfg
    max_len = opts.cache_len or L
    # un-aliased: JAX's sLSTM zero state shares one buffer, which the
    # step's donation refuses
    jcache = jax.tree.map(lambda x: jnp.array(x, copy=True),
                          type(jmodel)(jcfg).init_cache(B, max_len))
    cache = step.model.init_cache(B, max_len)
    extra, jextra = (), ()
    rng = np.random.default_rng(1)
    if model.cfg.family == "encdec":
        e = rng.normal(size=(B, opts.enc_len or 1500, model.cfg.d_model)
                       ).astype(np.float32)
        jextra, extra = (jnp.asarray(e),), (t(e),)
        if opts.cross_cache:
            jextra = (jmodel.precompute_cross_kv(jparams, jextra[0]),)
            extra = (step.model.precompute_cross_kv(params, extra[0]),)
    out = []
    for s in range(steps):
        tok = rng.integers(0, model.cfg.vocab_size, size=(B, 1))
        pos = np.array([s, s + 1])[:B]
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok, jnp.int32),
                           jnp.asarray(pos, jnp.int32), *jextra)
        tl, cache = step(params, cache, torch.from_numpy(tok),
                         torch.from_numpy(pos), *extra)
        out.append((n(tl), np.asarray(jl)))
    return out, step, args


@pytest.mark.parametrize("label,opts", [
    ("dense", S.DecodeOptions()),
    ("int8", S.DecodeOptions(kv_dtype="int8")),
    ("nm24", S.DecodeOptions(nm=(2, 4), weight_sharding="tp")),
    ("cache_len", S.DecodeOptions(cache_len=24)),
])
def test_decode_step_matches_jax_tinyllama(label, opts, mesh1):
    out, step, args = decode_pair("tinyllama-1.1b", opts, mesh1)
    for got, want in out:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert [a.device.type for a in args[2:]] == ["meta", "meta"]
    assert step.in_specs[0] is not None and len(step.in_specs) == 4


@pytest.mark.parametrize("arch,opts", [
    ("whisper-medium", S.DecodeOptions(cache_len=24, enc_len=24)),
    ("whisper-medium", S.DecodeOptions(cache_len=24, cross_cache=True,
                                       enc_len=24)),
    ("xlstm-1.3b", S.DecodeOptions()),
    ("xlstm-1.3b", S.DecodeOptions(kv_dtype="bf16")),
])
def test_decode_step_matches_jax_families(arch, opts, mesh1):
    out, step, args = decode_pair(arch, opts, mesh1)
    for got, want in out:
        if opts.kv_dtype == "bf16":   # test_torch_xlstm.py's bf16-state bound
            np.testing.assert_allclose(got, want, rtol=2e-2,
                                       atol=1e-2 * np.abs(want).max())
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if opts.cross_cache:
        assert isinstance(args[4], dict) and \
            args[4][0]["k"].device.type == "meta"


def test_train_step_microbatches_match_jax(mesh1):
    """``make_train_step(microbatches=2)`` — fp32 accumulation over two
    row blocks, one AdamW update with bf16 moments — against JAX's."""
    jmodel, jparams, model, params = j_setup("tinyllama-1.1b")
    cell = ShapeCell("t", 16, 4, "train")
    jstep, (ja, jopt_a, jb_a) = JS.make_train_step(
        jmodel, j_debug_mesh(), JCell("t", 16, 4, "train"), microbatches=2)
    step, (a, opt_a, b_a) = S.make_train_step(model, mesh1, cell,
                                              microbatches=2)
    assert opt_a.mu["embed"]["table"].dtype == torch.bfloat16
    jb, tb = batch_pair(model.cfg, cell, seed=3)
    jopt = JAdamW(weight_decay=0.1, clip_norm=1.0,
                  moment_dtype="bfloat16").init(jparams)
    jnew, jstate, jm = jstep(jparams, jopt, jb)
    new, state, m = step(params, step.optimizer.init(params), tb)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    assert int(state.step) == int(jstate.step) == 1
    for got, want in ((state.mu, jstate.mu), (state.nu, jstate.nu)):
        for g, w in zip(sorted_leaves(got), jax.tree.leaves(
                jax_tree_to_numpy(want))):
            w = np.asarray(w, np.float32)
            # one bf16 rounding of a float32 moment: 2⁻⁸ relative
            np.testing.assert_allclose(n(g), w, rtol=2 ** -7,
                                       atol=1e-12 + 1e-3 * np.abs(w).max())
    for g, w in zip(sorted_leaves(new), jax.tree.leaves(
            jax_tree_to_numpy(jnew))):
        np.testing.assert_allclose(n(g), np.asarray(w, np.float32),
                                   rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------ perf, parity
def test_perf_ladders_on_cpu_reduced():
    """Every ladder's rungs on REDUCED configs at a small decode cell:
    JAX's record keys (less the compiler's), the measurement beside them,
    speedups within a depth, the hypotheses and predictions verbatim."""
    cell = ShapeCell("decode_32k", 32, 4, "decode")
    for key, rungs in perf.LADDERS.items():
        seen = []
        recs = perf.run_ladder(key, device="cpu", reduced=True, cell=cell,
                               runs=2, on_rung=lambda tag, o, e, k:
                               seen.append((tag, sorted(k))))
        assert [r["tag"] for r in recs] == [r[0] for r in rungs]
        assert [s[1] for s in seen] == [["args", "logits", "step"]] * len(
            rungs)
        for r, (tag, opts, hyp, pred) in zip(recs, rungs):
            assert (r["hypothesis"], r["prediction"]) == (hyp, pred)
            assert set(r["terms"]) == {"compute_s", "memory_s"}
            assert r["chips"] == 1 and r["finite"] and r["cuts"] == []
            assert r["step_s"] == max(r["terms"].values())
            assert r["measured_ms"] > 0
            for k in ("collectives", "memory", "compile_s"):
                assert k not in r
        assert all("speedup_vs_prev" in r for r in recs[1:])
    xl = perf.run_ladder("xlstm-1.3b/decode_32k", device="cpu",
                         reduced=True, cell=cell, runs=1, depth=2)
    assert all(r["depth"] == 2 and r["cuts"] == ["layers 4 → 2"]
               for r in xl)
    assert xl[-1]["analytic"]["hbm_bytes"] < xl[-2]["analytic"]["hbm_bytes"]


@pytest.mark.parametrize("arch,opts", [
    ("mistral-large-123b", S.DecodeOptions(kv_dtype="int8")),
    ("whisper-medium", S.DecodeOptions(cache_len=48, cross_cache=True,
                                       kv_dtype="int8")),
])
def test_int8_cache_check_reads_the_filled_cache(arch, opts, mesh1,
                                                 monkeypatch):
    """The int8 rungs' gate: over a cache filled at log-spaced depths the
    int8 logits sit within a tenth of what the cache's content moves the
    bf16 logits; a dequant that drops the scale, takes a neighbouring
    lane's scale or reads back zeros lands beyond that bound."""
    from repro_torch.models import attention as A

    model = build_model(registry.get_config(arch, reduced=True),
                        device="cpu")
    step, _ = S.make_decode_step(model, mesh1,
                                 ShapeCell("decode_32k", 64, 8, "decode"),
                                 opts)
    args = step.concrete_args(torch.Generator().manual_seed(0))
    r = perf.int8_cache_check(step, args)
    assert r["max_abs"] < min(1.0, 0.1 * r["content"])
    good = A._dequantize
    for bad in (lambda q, s, dt: q.to(dt),
                lambda q, s, dt: good(q, s.roll(1, dims=1), dt),
                lambda q, s, dt: torch.zeros(q.shape, dtype=dt)):
        monkeypatch.setattr(A, "_dequantize", bad)
        assert perf.int8_cache_check(step, args)["max_abs"] >= \
            0.1 * r["content"]


def test_dryrun_prune_parity_over_four_gloo_ranks(capfd):
    assert dryrun.main(["--prune-parity"]) == 0
    out = capfd.readouterr().out
    assert "PRUNE-PARITY OK shards=4 c=512 b=64" in out
