"""The tooling's compiled prefill and decode steps on the CPU (JAX's
jitted ``make_prefill_step`` and donated ``make_decode_step``), REDUCED
configs in fp32.

``launch/steps.make_decode_step`` and ``make_prefill_step`` return steps
that own their CUDA graphs: on a card the first call with a key runs
eagerly, the second captures over the caller's params (and, for decode,
its cache: donated, bound in place) and static copies of everything else,
and later calls replay.  Here the calls run inline unless the fake card of
``test_torch_train_capture`` is installed (``CardGraph``: a capture
computes nothing, rolls its writes to existing storage back, poisons its
fresh outputs and refuses host reads; a replay recomputes).  Under it:
three decode steps of tinyllama (dense, int8 cache, 2:4 weights), xLSTM
and whisper (cross k/v cached and not) against JAX's jitted step at
``test_torch_launch``'s tolerances, the cache's leaves at their storage,
``Step.__wrapped__`` bitwise the step, the prefill step against JAX's, a
rebound cache leaf refused, ``Step.reset_cache`` bitwise a fresh cache,
and ``dryrun.timed_runs`` / ``perf.measure`` / ``dryrun.measure_cell``
with their direct, capture and replayed fields.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ShapeCell as JCell  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.serve.compressed import compress_params as j_compress  # noqa
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.dist.sharding import MeshShape  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import dryrun, perf  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.util import graphs  # noqa: E402
from repro_torch.util.tree import (data_ptrs, fill_, flatten,  # noqa: E402
                                   rebuild)
from test_torch_fixtures import n, t  # noqa: E402
from test_torch_launch import (batch_pair, j_debug_mesh,  # noqa: E402
                               j_setup, magnitude_masks)
from test_torch_train_capture import CardGraph  # noqa: E402
from test_torch_prune_capture import _fake  # noqa: E402

MESH = MeshShape(("data", "model"), (1, 1))
STEPS = 3


@pytest.fixture
def card(monkeypatch):
    _fake(monkeypatch)
    monkeypatch.setattr(graphs, "Graph", CardGraph)
    yield
    assert graphs._local().scope is None


def _ptrs(cache) -> list:
    return data_ptrs(cache)


def _decode_setup(arch, opts, *, B=2, L=16):
    """(JAX step, params, cache, extra; port step, params, cache, extra)
    on the same numpy-seeded params and encoder source."""
    jmodel, jparams, model, params = j_setup(arch)
    jstep, _ = JS.make_decode_step(jmodel, j_debug_mesh(),
                                   JCell("decode_t", L, B, "decode"),
                                   JS.DecodeOptions(**vars(opts)))
    step, _ = S.make_decode_step(model, MESH,
                                 ShapeCell("decode_t", L, B, "decode"), opts)
    if opts.nm:
        masks = magnitude_masks(model, params)
        jparams = j_compress(jparams, {p: jnp.asarray(n(m)) for p, m in
                                       masks.items()}, 2, 4)
        params = S.magnitude_nm_params(model, params, 2, 4)
    jcfg = jmodel.cfg.replace(kv_cache_dtype=opts.kv_dtype) \
        if opts.kv_dtype else jmodel.cfg
    max_len = opts.cache_len or L
    # un-aliased: JAX's sLSTM zero state shares one buffer, which the
    # step's donation refuses
    jcache = jax.tree.map(lambda x: jnp.array(x, copy=True),
                          type(jmodel)(jcfg).init_cache(B, max_len))
    cache = step.model.init_cache(B, max_len)
    extra, jextra = (), ()
    if model.cfg.family == "encdec":
        e = np.random.default_rng(1).normal(
            size=(B, opts.enc_len or 1500, model.cfg.d_model)).astype(
                np.float32)
        jextra, extra = (jnp.asarray(e),), (t(e),)
        if opts.cross_cache:
            jextra = (jmodel.precompute_cross_kv(jparams, jextra[0]),)
            extra = (step.model.precompute_cross_kv(params, extra[0]),)
    return (jstep, jparams, jcache, jextra), (step, params, cache, extra)


DECODES = [
    ("tinyllama-1.1b", S.DecodeOptions()),
    ("tinyllama-1.1b", S.DecodeOptions(kv_dtype="int8")),
    ("tinyllama-1.1b", S.DecodeOptions(nm=(2, 4))),
    ("xlstm-1.3b", S.DecodeOptions()),
    ("whisper-medium", S.DecodeOptions(cache_len=24, enc_len=24)),
    ("whisper-medium", S.DecodeOptions(cache_len=24, cross_cache=True,
                                       enc_len=24)),
]
IDS = ["tinyllama", "tinyllama-int8", "tinyllama-nm24", "xlstm",
       "whisper", "whisper-crosskv"]


@pytest.mark.parametrize("arch,opts", DECODES, ids=IDS)
def test_decode_step_replays_match_jax(card, arch, opts):
    """Three steps (eager, capture, replay) on the fake card against JAX's
    jitted step: the logits at test_torch_launch's tolerances, the cache
    written in place (every leaf at its storage, the caller's tree
    returned), one graph, two replays."""
    (jstep, jparams, jcache, jextra), (step, params, cache, extra) = \
        _decode_setup(arch, opts)
    ptrs = _ptrs(cache)
    rng = np.random.default_rng(1)
    cfg = step.model.cfg
    for s in range(STEPS):
        tok = rng.integers(0, cfg.vocab_size, size=(2, 1))
        pos = np.array([s, s + 1])
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok, jnp.int32),
                           jnp.asarray(pos, jnp.int32), *jextra)
        tl, out = step(params, cache, torch.from_numpy(tok),
                       torch.from_numpy(pos), *extra)
        assert out is cache and _ptrs(cache) == ptrs
        np.testing.assert_allclose(n(tl), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    st = step.stats()
    assert (st["graphs"], st["replays"], st["eager"]) == (1, STEPS - 1, 1)
    step.release()


@pytest.mark.parametrize("arch,opts", DECODES, ids=IDS)
def test_direct_call_is_the_step_bitwise(card, arch, opts):
    """``Step.__wrapped__`` (no graph) against the step's eager call,
    capture and replays, each from the same state (``reset_cache``): the
    logits and the cache it leaves bitwise equal."""
    _, (step, params, cache, extra) = _decode_setup(arch, opts)
    tok = torch.tensor([[3], [7]])
    pos = torch.tensor([2, 5])
    for _ in range(STEPS):
        step.reset_cache(cache)
        want, _ = step.__wrapped__(params, cache, tok, pos, *extra)
        after = [x.clone() for x in flatten(cache)[0]]
        step.reset_cache(cache)
        got, _ = step(params, cache, tok, pos, *extra)
        assert torch.equal(got, want)
        assert all(torch.equal(x, y)
                   for x, y in zip(flatten(cache)[0], after))
    assert step.stats()["replays"] == STEPS - 1
    step.release()


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "xlstm-1.3b",
                                  "whisper-medium"])
def test_reset_cache_is_a_fresh_cache(arch):
    opts = S.DecodeOptions(cache_len=24, enc_len=24) \
        if arch == "whisper-medium" else S.DecodeOptions()
    _, (step, params, cache, extra) = _decode_setup(arch, opts)
    fresh = [x.clone() for x in flatten(cache)[0]]
    ptrs = _ptrs(cache)
    for s in range(2):
        step(params, cache, torch.tensor([[3], [7]]), torch.tensor([s, s]),
             *extra)
    assert any(not torch.equal(x, y)
               for x, y in zip(flatten(cache)[0], fresh))
    step.reset_cache(cache)
    assert _ptrs(cache) == ptrs
    assert all(torch.equal(x, y) for x, y in zip(flatten(cache)[0], fresh))


def test_a_rebound_cache_leaf_is_refused(monkeypatch):
    _, (step, params, cache, extra) = _decode_setup("tinyllama-1.1b",
                                                    S.DecodeOptions())
    model = step.model
    inner = model.decode_step

    def rebinding(p, c, tokens, pos, *rest):
        logits, c = inner(p, c, tokens, pos, *rest)
        c[0].k = c[0].k.clone()
        return logits, c

    monkeypatch.setattr(model, "decode_step", rebinding)
    with pytest.raises(RuntimeError, match="rebinds a cache tensor"):
        step(params, cache, torch.tensor([[3], [7]]), torch.tensor([0, 1]))
    with pytest.raises(RuntimeError, match="rebinds a cache tensor"):
        step.__wrapped__(params, cache, torch.tensor([[3], [7]]),
                         torch.tensor([0, 1]))


def test_flatten_rebuilds_caches_and_compressed_weights():
    _, (step, params, cache, _) = _decode_setup(
        "tinyllama-1.1b", S.DecodeOptions(nm=(2, 4), kv_dtype="int8"))
    for tree in (params, cache):
        leaves, skel = flatten(tree)
        hash(skel)
        again = rebuild(skel, leaves)
        assert flatten(again)[1] == skel
        assert [id(x) for x in flatten(again)[0]] == [id(x)
                                                        for x in leaves]
    assert type(rebuild(flatten(cache)[1], flatten(cache)[0])[0]) \
        is type(cache[0])


@pytest.mark.parametrize("cross", [False, True], ids=["enc", "crosskv"])
def test_the_encoder_source_is_read_in_place(card, cross):
    """The decode graph binds whisper's encoder output (or its cross k/v)
    in place, as the params: no static buffer holds it, and a replay reads
    what the caller wrote there since the capture."""
    _, (step, params, cache, extra) = _decode_setup(
        "whisper-medium", S.DecodeOptions(cache_len=24, enc_len=24,
                                          cross_cache=cross))
    tok, pos = torch.tensor([[3], [7]]), torch.tensor([2, 5])
    for _ in range(2):                      # eager, capture
        step.reset_cache(cache)
        step(params, cache, tok, pos, *extra)
    for x in flatten(extra)[0]:
        x.mul_(0.5)
    step.reset_cache(cache)
    want, _ = step.__wrapped__(params, cache, tok, pos, *extra)
    step.reset_cache(cache)
    got, _ = step(params, cache, tok, pos, *extra)
    assert torch.equal(got, want)
    (entry,) = step.fn._scope.entries.values()
    bufs = [x for x in entry.inputs if isinstance(x, torch.Tensor)]
    assert len(bufs) == 2                            # tokens and positions
    assert step.stats()["graphs"] == 1
    step.release()


def test_fill_resets_a_cache_by_key_in_place():
    """``tree.fill_`` writes a one-row template into a cache of any batch,
    leaf by leaf and matched by key (a template whose dicts run in another
    order fills the same leaves), and ``data_ptrs`` sees no leaf moved."""
    _, (step, params, cache, extra) = _decode_setup("tinyllama-1.1b",
                                                    S.DecodeOptions())
    model = step.model
    fresh = [x.clone() for x in flatten(model.init_cache(2, 16))[0]]
    ptrs = data_ptrs(cache)
    step(params, cache, torch.tensor([[3], [7]]), torch.tensor([0, 1]))
    assert any(not torch.equal(x, y)
               for x, y in zip(flatten(cache)[0], fresh))
    tmpl = model.init_cache(1, 16)
    fill_(cache, dict(reversed(list(tmpl.items()))))
    assert data_ptrs(cache) == ptrs
    assert all(torch.equal(x, y) for x, y in zip(flatten(cache)[0], fresh))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-medium",
                                  "internvl2-76b"])
def test_prefill_step_replays_match_jax(card, arch):
    """The prefill step's eager call, capture and replays against JAX's
    jitted prefill at rtol/atol 1e-5, and bitwise its direct call; the
    params bound in place (no static buffer), the batch copied in."""
    jmodel, jparams, model, params = j_setup(arch)
    cell = ShapeCell("p", 16, 2, "prefill")
    jstep, _ = JS.make_prefill_step(jmodel, j_debug_mesh(),
                                    JCell("p", 16, 2, "prefill"))
    step, _ = S.make_prefill_step(model, MESH, cell)
    for seed in range(STEPS):
        jb, tb = batch_pair(model.cfg, cell, seed=seed)
        want = np.asarray(jstep(jparams, jb))
        got = step(params, tb)
        np.testing.assert_allclose(n(got), want, rtol=1e-5, atol=1e-5)
        assert torch.equal(got, step.__wrapped__(params, tb))
    (entry,) = step.fn._scope.entries.values()
    bufs = [x for x in entry.inputs if isinstance(x, torch.Tensor)]
    assert len(bufs) == len(tb)                      # the batch alone
    assert step.stats()["replays"] == STEPS - 1
    step.release()


KEYS = {"args", "first", "direct", "bitwise", "last", "times",
        "eager_times", "capture_ms", "peak", "pool_bytes", "graphs",
        "replays"}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "xlstm-1.3b",
                                  "whisper-medium"])
def test_timed_runs_direct_then_replayed(card, arch):
    """``timed_runs`` on the fake card: its keys, ``runs`` direct and
    ``runs`` replayed times, one graph released at the end, and the replay
    from a fresh cache bitwise the direct warm-up — also for xLSTM, whose
    state every timed call moved on."""
    from repro_torch.configs import registry
    from repro_torch.models.model_builder import build_model

    model = build_model(registry.get_config(arch, reduced=True),
                        device="cpu")
    opts = (S.DecodeOptions(cache_len=24, enc_len=24)
            if arch == "whisper-medium" else S.DecodeOptions())
    step, _ = S.make_decode_step(model, MESH,
                                 ShapeCell("decode_t", 24, 2, "decode"),
                                 opts)
    run = dryrun.timed_runs(step, 0, 3)
    assert set(run) == KEYS
    assert len(run["times"]) == len(run["eager_times"]) == 3
    assert run["bitwise"] and torch.equal(run["first"], run["direct"])
    assert (run["graphs"], run["peak"]) == (1, None)
    assert run["replays"] == 3 + 2          # capture's, 3 timed, the check
    assert step.fn._scope.pool is None and not step.fn._scope.entries


def test_timed_runs_counts_the_warm_up_and_the_timed_replays(card,
                                                             monkeypatch):
    """The kernel counts after ``timed_runs``: every step that ran — the
    direct warm-up and ``runs`` direct calls, the step's eager warm-up,
    the capture's replay, ``runs`` timed replays and the comparison's —
    and not the capture, which launches nothing (``graphs.Graph`` takes
    its count back; a counted wrapper in the decode body shows it)."""
    from repro_torch.configs import registry
    from repro_torch.models.model_builder import build_model

    class Counting(CardGraph):
        def __init__(self, fn, device, pool):
            before = kops.launch_counts()
            super().__init__(fn, device, pool)
            kops.take_launches(before)

    monkeypatch.setattr(graphs, "Graph", Counting)

    def counted(x):
        counted.launches += 1
        counted.by_shape[("x",)] = counted.by_shape.get(("x",), 0) + 1
        return x

    counted.launches, counted.by_shape = 0, {}
    monkeypatch.setattr(kops, "_counted", lambda: [counted])
    model = build_model(registry.get_config("tinyllama-1.1b", reduced=True),
                        device="cpu")
    inner = model.decode_step
    monkeypatch.setattr(model, "decode_step",
                        lambda p, c, tok, pos: inner(p, c, counted(tok),
                                                     pos))
    step, _ = S.make_decode_step(model, MESH,
                                 ShapeCell("decode_t", 16, 2, "decode"))
    dryrun.timed_runs(step, 0, 4)
    want = (1 + 4) + (1 + 1 + 4 + 1)
    assert counted.launches == want and counted.by_shape == {("x",): want}


def test_ladder_and_cell_records_carry_the_graph_fields():
    cell = ShapeCell("decode_32k", 32, 4, "decode")
    keep: dict = {}
    rec = perf.measure("whisper-medium", "decode_32k",
                       S.DecodeOptions(cache_len=24, cross_cache=True),
                       device="cpu", reduced=True, runs=2, cell=cell,
                       keep=keep)
    for r in (rec, dryrun.measure_cell("tinyllama-1.1b", cell,
                                       device="cpu", reduced=True, runs=2)):
        assert {"eager_ms", "eager_ms_all", "capture_ms", "pool_bytes",
                "graphs", "replays", "replay_bitwise",
                "eager_over_bound"} <= set(r)
        assert r["replay_bitwise"] and len(r["eager_ms_all"]) == 2
    assert rec["measured_ms"] > 0 and len(rec["measured_ms_all"]) == 2
    assert sorted(keep) == ["args", "logits", "step"]
    assert keep["logits"].dtype == torch.float32


def test_int8_check_reads_the_replayed_step(card):
    """``int8_cache_check`` takes its int8 logits from the step's replay
    (eager, capture, replay at its rows, released after)."""
    from repro_torch.configs import registry
    from repro_torch.models.model_builder import build_model

    model = build_model(registry.get_config("mistral-large-123b",
                                            reduced=True), device="cpu")
    step, _ = S.make_decode_step(model, MESH,
                                 ShapeCell("decode_32k", 64, 8, "decode"),
                                 S.DecodeOptions(kv_dtype="int8"))
    args = step.concrete_args(torch.Generator().manual_seed(0))
    seen = []
    inner = step.fn._run

    def spy(*a):
        out = inner(*a)
        seen.append(step.stats()["replays"])
        return out

    step.fn._run = spy
    r = perf.int8_cache_check(step, args)
    assert seen == [0, 1]                      # eager, then capture's replay
    assert r["max_abs"] < min(1.0, 0.1 * r["content"])
    assert step.fn._scope.pool is None


def test_the_lint_reads_the_new_captured_bodies():
    """repro-lint's capture rules (``jit-purity``, ``recompile-hazards``)
    start from every ``graphed`` site: the decode and prefill bodies and
    the sampler's chain, and the model code below them."""
    from pathlib import Path

    from repro_torch.analysis.engine import RepoIndex

    graph = RepoIndex.build(Path(__file__).resolve().parents[1] /
                            "src").graph
    reach = graph.jit_reachable()
    for key in ("repro_torch.launch.steps::make_decode_step.serve_step",
                "repro_torch.launch.steps::make_prefill_step.prefill",
                "repro_torch.util.tree::rebuild",
                "repro_torch.data.pipeline::_chain",
                "repro_torch.models.encdec::EncDecLM.decode_step",
                "repro_torch.models.xlstm_lm::XlstmLM.decode_step",
                "repro_torch.models.transformer::TransformerLM.block"):
        assert key in reach, key
    sites = [m for m, _, _, w in graph.jit_sites
             if w == "repro_torch.util.graphs.graphed"]
    assert sites.count("repro_torch.launch.steps") == 3    # + the train
    assert sites.count("repro_torch.data.pipeline") == 1


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-medium"])
def test_timed_runs_leaves_no_argument_alive(card, arch):
    """With the collector off, the step's arguments die with its record:
    nothing the step, its graphs or ``flatten`` / ``rebuild`` made keeps
    them (the card holds tens of GB of them, and the next ladder rung
    needs the room)."""
    import gc
    import weakref

    from repro_torch.configs import registry
    from repro_torch.models.model_builder import build_model

    model = build_model(registry.get_config(arch, reduced=True),
                        device="cpu")
    opts = (S.DecodeOptions(cache_len=24, enc_len=24, cross_cache=True)
            if arch == "whisper-medium" else S.DecodeOptions())
    step, _ = S.make_decode_step(model, MESH,
                                 ShapeCell("decode_t", 24, 2, "decode"),
                                 opts)
    gc.collect()
    gc.disable()
    try:
        run = dryrun.timed_runs(step, 0, 2)
        refs = [weakref.ref(x) for x in flatten(run["args"])[0]]
        del run
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
