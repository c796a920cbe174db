"""The port's paged KV cache on the CPU against the JAX package: the four
paged cache kinds' decode against the port's own contiguous decode and
against JAX's paged decode, the host-side ``Pager`` op by op, the paged
engine's tokens, statistics and pool pages against JAX's paged engine
(dense and compressed-resident trees, a constrained pool that preempts, a
trace larger than the contiguous capacity, prefix hits with copy-on-write,
the partial-page merge, sliding windows, deepseek-v3's latent caches), the
``ServeConfig`` validation and ``launch.serve --paged``.

Geometry as tests/test_paged_cache.py: page 8, max_len 32 (4 pages a slot).

Tolerances: paged vs contiguous decode in the port bit-equal (fp32 and
bf16); port vs JAX paged decode rtol/atol 1e-5 in fp32 and rtol 2e-2 /
atol 1e-2 in bf16, atol taken relative to the largest magnitude of JAX's
output.  The reference's paged tests (tests/test_paged_cache.py) run
fp32 only and state no bf16 bound, so the bf16 one is tests/
test_kernels.py's, scaled as bf16 rounds: relative to the output.  The
largest error seen is 0.0114 on one MLA element of outputs up to 4.75,
against the scaled bound of 0.0475 there; pager state,
plans, snapshots, audit errors, engine tokens and statistics exactly; the
pool lanes a slot's table maps rtol/atol 1e-5 (their positions exactly).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.core import PruneConfig as JPruneConfig  # noqa: E402
from repro.core import prune_model as j_prune_model  # noqa: E402
from repro.data.pipeline import calibration_batches  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models.model_builder import ModelAdapter as JAdapter  # noqa
from repro.models.model_builder import build_model as j_build  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServingEngine as JEngine  # noqa: E402
from repro.serve import pager as jpager  # noqa: E402
from repro.serve.compressed import compress_params as j_compress  # noqa
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models.model_builder import build_model  # noqa: E402
from repro_torch.serve import pager as tpager  # noqa: E402
from repro_torch.serve.engine import (Request, ServeConfig,  # noqa: E402
                                      ServingEngine)
from test_torch_fixtures import jax_tree_to_numpy, n  # noqa: E402

TINY = JModelConfig(
    name="paged-tiny", family="dense", num_layers=2, d_model=32,
    num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
    vocab_size=96, dtype="float32")
MLA_TINY = TINY.replace(
    name="paged-mla-tiny", q_lora_rank=16, kv_lora_rank=16,
    qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=16)
MAX_LEN = 32
PAGE = 8
PPS = MAX_LEN // PAGE
F32_TOL = {"rtol": 1e-5, "atol": 1e-5}
BF16_TOL = {"rtol": 2e-2, "atol": 1e-2}
STATS = ("decode_steps", "busy_slot_steps", "prefills", "prefill_tokens",
         "vtime", "preemptions", "page_faults", "cow_copies",
         "prefix_hit_tokens", "pages_hwm")


def _scaled(tol: dict, want: np.ndarray) -> dict:
    """``tol`` with atol taken relative to the reference's largest
    magnitude (values of order 1 keep it as stated)."""
    return {"rtol": tol["rtol"],
            "atol": tol["atol"] * max(1.0, float(np.abs(want).max()))}


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def carry(tree):
    return params_from_numpy(jax_tree_to_numpy(tree), device="cpu")


# --------------------------------------------------------------------------
# decode: paged == contiguous in the port (bitwise), and == JAX's paged
# --------------------------------------------------------------------------
def _tables(kind: str, B: int) -> np.ndarray:
    """private: slot b owns pages 1 + b·P … ; shuffled: a random
    permutation of the same pages, so logical order ≠ physical order."""
    pages = 1 + np.arange(B * PPS)
    if kind == "shuffled":
        pages = np.random.default_rng(5).permutation(pages)
    return pages.reshape(B, PPS).astype(np.int32)


DECODE_CASES = [(mla, kv, dt, tab)
                for mla in (False, True) for kv in ("", "int8")
                for dt in ("float32", "bfloat16")
                for tab in ("private", "shuffled")]


@pytest.mark.parametrize("mla,kv_dtype,dtype,table", DECODE_CASES,
                         ids=["-".join(filter(None, (
                             "mla" if c[0] else "gqa", c[1], c[2], c[3])))
                             for c in DECODE_CASES])
def test_paged_decode_bit_equal_contiguous_and_matches_jax(mla, kv_dtype,
                                                           dtype, table):
    """2·PAGE + 3 steps (two page boundaries) of B = 3 slots at ragged
    depths: the port's paged decode is bitwise its contiguous decode, and
    within the stated tolerance of JAX's paged decode on the same table."""
    jcfg = (MLA_TINY if mla else TINY).replace(kv_cache_dtype=kv_dtype,
                                               dtype=dtype)
    tcfg = port_cfg(jcfg)
    B, d = 3, jcfg.d_model
    jdt, tdt = jcfg.jdtype, tcfg.torch_dtype
    key = jax.random.PRNGKey(1)
    jp = (JA.mla_params(key, jcfg, jdt) if mla
          else JA.gqa_params(key, jcfg, jdt))
    tp = carry(jp)
    geom = dict(num_pages=1 + B * PPS, page_size=PAGE, pages_per_slot=PPS)
    tab = _tables(table, B)
    if mla:
        cont = A.mla_cache_init(tcfg, B, MAX_LEN, dtype=tdt)
        paged = A.mla_paged_cache_init(tcfg, B, dtype=tdt, **geom)
        jpaged = JA.mla_paged_cache_init(jcfg, B, dtype=jdt, **geom)

        def tdec(x, pos, c):
            return A.mla_decode(tp, tcfg, x, pos, c)

        def jdec(x, pos, c):
            return JA.mla_decode(jp, jcfg, x, pos, c)
    else:
        cont = A.gqa_cache_init(tcfg, B, MAX_LEN, dtype=tdt)
        paged = A.gqa_paged_cache_init(tcfg, B, dtype=tdt, **geom)
        jpaged = JA.gqa_paged_cache_init(jcfg, B, dtype=jdt, **geom)

        def tdec(x, pos, c):
            return A.gqa_decode(tp, tcfg, x, pos, c, theta=10000.0)

        def jdec(x, pos, c):
            return JA.gqa_decode(jp, jcfg, x, pos, c, theta=10000.0)
    assert A.is_paged(paged) and not A.is_paged(cont)
    assert type(paged).__name__ == type(jpaged).__name__
    assert A.paged_geometry(paged) == JA.paged_geometry(jpaged) == \
        (1 + B * PPS, PAGE, PPS, B)
    paged.table = torch.from_numpy(tab.astype(np.int64))
    jpaged = jpaged._replace(table=jnp.asarray(tab))
    jdec = jax.jit(jdec)
    rng = np.random.default_rng(1)
    lag = np.array([0, 3, 5])                  # ragged per-slot depths
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for t in range(2 * PAGE + 3 + lag.max()):
        pos = np.maximum(t - lag, 0)
        x = rng.normal(size=(B, 1, d)).astype(np.float32)
        tx = torch.from_numpy(x).to(tdt)
        tpos = torch.from_numpy(pos.astype(np.int64))
        y_c, _ = tdec(tx, tpos, cont)
        y_p, same = tdec(tx, tpos, paged)
        assert same is paged                   # written in place
        torch.testing.assert_close(y_p, y_c, rtol=0, atol=0)
        y_j, jpaged = jdec(jnp.asarray(x, jdt), jnp.asarray(pos, jnp.int32),
                           jpaged)
        want = np.asarray(y_j, np.float32)
        np.testing.assert_allclose(n(y_p), want, **_scaled(tol, want))
    for f in A._POOL_FIELDS[type(paged)]:
        got, want = n(getattr(paged, f)), np.asarray(getattr(jpaged, f),
                                                     np.float32)
        if got.dtype == np.int8:
            assert np.abs(got.astype(int) - want).max() <= 1
        else:
            np.testing.assert_allclose(got, want, **_scaled(tol, want))


def test_paged_cache_init_layout_matches_jax():
    """Kinds, fields, shapes and dtypes of the four paged kinds (tables,
    positions and lengths int64 in the port), and the helpers' names."""
    for jcfg in (TINY, MLA_TINY):
        for kv in ("", "int8"):
            c = jcfg.replace(kv_cache_dtype=kv)
            init, jinit = ((A.mla_paged_cache_init, JA.mla_paged_cache_init)
                           if c.kv_lora_rank else
                           (A.gqa_paged_cache_init, JA.gqa_paged_cache_init))
            geom = dict(num_pages=7, page_size=PAGE, pages_per_slot=PPS)
            got, want = init(port_cfg(c), 2, **geom), jinit(c, 2, **geom)
            assert type(got).__name__ == type(want).__name__
            assert [f.name for f in dataclasses.fields(got)] == \
                list(want._fields)
            assert A._POOL_FIELDS[type(got)] == JA._POOL_FIELDS[type(want)]
            for f in want._fields:
                g, w = getattr(got, f), getattr(want, f)
                assert tuple(g.shape) == w.shape, f
                want_dt = "int64" if str(w.dtype) == "int32" else str(w.dtype)
                assert str(g.dtype).removeprefix("torch.") == want_dt, f
                np.testing.assert_array_equal(n(g), np.asarray(w))
    assert [c.__name__ for c in A.PAGED_CACHE_TYPES] == \
        [c.__name__ for c in JA.PAGED_CACHE_TYPES]


def test_copy_pages_gathers_before_scattering():
    """``paged_copy_pages`` with a chain (1 → 2, 2 → 3) and scratch padding
    reads every source before it writes, as JAX's functional update."""
    cfg = port_cfg(TINY)
    c = A.gqa_paged_cache_init(cfg, 2, num_pages=5, page_size=PAGE,
                               pages_per_slot=PPS)
    jc = JA.gqa_paged_cache_init(TINY, 2, num_pages=5, page_size=PAGE,
                                 pages_per_slot=PPS)
    k = np.random.default_rng(2).normal(size=c.k.shape).astype(np.float32)
    c.k.copy_(torch.from_numpy(k))
    jc = jc._replace(k=jnp.asarray(k))
    src, dst = np.array([1, 2, 0, 0]), np.array([2, 3, 0, 0])
    A.paged_copy_pages(c, torch.from_numpy(src), torch.from_numpy(dst))
    jc = JA.paged_copy_pages(jc, jnp.asarray(src), jnp.asarray(dst))
    np.testing.assert_array_equal(n(c.k), np.asarray(jc.k))
    np.testing.assert_array_equal(n(c.k)[3], k[2])


# --------------------------------------------------------------------------
# the host-side pager, op by op
# --------------------------------------------------------------------------
def _plan(plan) -> dict:
    return {k: (list(map(int, v)) if isinstance(v, list) else int(v))
            for k, v in dataclasses.asdict(plan).items()}


def _state(pg) -> dict:
    snap = pg.snapshot()
    return {"table": pg.table.tolist(), "refs": pg.pool.refs.tolist(),
            "free": list(pg.pool._free), "used": pg.pool.used_pages,
            "prefix": None if pg.prefix is None else len(pg.prefix),
            "snap": {**snap, "table": snap["table"].tolist()}}


def _drive(mod, seed: int) -> list:
    """A seeded sequence of admit / register / fault_in / retire / evict
    on a small pool (3 slots × 4 pages of 4, 9 pages, 3 prefix entries),
    prompts drawn from two shared heads so prefixes match → the log of
    every plan, copy list, exhaustion and state."""
    rng = np.random.default_rng(seed)
    pg = mod.Pager(batch_slots=3, pages_per_slot=4, num_pages=9,
                   page_size=4, max_prefix_entries=3)
    heads = [rng.integers(0, 4, size=9) for _ in range(2)]
    pos, active, log = [0] * 3, [False] * 3, []
    for _ in range(120):
        op, slot = int(rng.integers(0, 5)), int(rng.integers(0, 3))
        if op <= 1 and not active[slot]:
            head = heads[int(rng.integers(0, 2))][:int(rng.integers(1, 10))]
            toks = np.concatenate([head, rng.integers(
                0, 4, size=int(rng.integers(0, 4)))]).astype(np.int32)
            try:
                log.append(("admit", _plan(pg.admit(slot, toks))))
            except mod.PoolExhausted:
                log.append(("admit exhausted", slot))
                continue
            pg.register(slot, toks)
            active[slot], pos[slot] = True, len(toks)
        elif op == 2 and active[slot] and pos[slot] < 16:
            try:
                log.append(("fault_in", pg.fault_in(slot, pos[slot])))
                pos[slot] += 1
            except mod.PoolExhausted:
                log.append(("fault exhausted", slot))
        elif op == 3 and active[slot]:
            pg.retire(slot)
            active[slot] = False
        elif op == 4 and pg.prefix is not None:
            log.append(("evict", pg.prefix.evict_one()))
        pg.check()
        log.append(_state(pg))
    return log, pg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pager_op_sequence_matches_jax(seed):
    tlog, tpg = _drive(tpager, seed)
    jlog, jpg = _drive(jpager, seed)
    assert tlog == jlog
    kinds = {e[0] for e in tlog if isinstance(e, tuple)}
    assert {"admit", "fault_in", "evict"} <= kinds
    assert any(e[0] == "admit" and e[1]["n_shared_tok"] for e in tlog
               if isinstance(e, tuple))
    assert any(e[0] == "fault_in" and e[1] for e in tlog
               if isinstance(e, tuple)), "no copy-on-write in the sequence"
    # snapshot → restore round trip, and the geometry checks
    snap = tpg.snapshot()
    fresh = tpager.Pager(batch_slots=3, pages_per_slot=4, num_pages=9,
                         page_size=4, max_prefix_entries=3)
    fresh.restore(snap)
    fresh.check()
    assert _state(fresh) == _state(tpg)
    other = tpager.Pager(batch_slots=3, pages_per_slot=4, num_pages=9,
                         page_size=8)
    with pytest.raises(ValueError, match="page_size"):
        other.restore(snap)


@pytest.mark.parametrize("corrupt", ["leak", "over", "free_ref", "dup_free"])
def test_pager_audit_names_the_same_page(corrupt):
    """The same corruption of the same state raises the same
    ``PagerAuditError`` (message, page, expected, actual) in both."""
    errs = []
    for mod in (tpager, jpager):
        _, pg = _drive(mod, 1)
        used = [p for p in range(1, 9) if pg.pool.refs[p] > 0]
        if corrupt == "leak":
            pg.pool.refs[used[0]] += 1
        elif corrupt == "over":
            pg.pool.refs[used[-1]] -= 1
        elif corrupt == "free_ref":
            pg.pool._free.append(used[0])
        else:
            pg.pool._free.append((pg.pool._free or used)[0])
        with pytest.raises(mod.PagerAuditError) as info:
            pg.check()
        e = info.value
        errs.append((str(e), e.page, e.expected, e.actual))
    assert errs[0] == errs[1]


def test_pager_admit_leaves_no_state_on_exhaustion():
    for mod in (tpager, jpager):
        pg = mod.Pager(batch_slots=2, pages_per_slot=4, num_pages=5,
                       page_size=4, prefix_reuse=False)
        pg.admit(0, np.arange(13, dtype=np.int32))
        before = _state(pg)
        with pytest.raises(mod.PoolExhausted):
            pg.admit(1, np.arange(9, dtype=np.int32))
        assert _state(pg) == before
    assert tpager.SCRATCH == jpager.SCRATCH == 0


# --------------------------------------------------------------------------
# the paged engine against JAX's paged engine
# --------------------------------------------------------------------------
def make_trace(seed: int, n_req: int, vocab: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"uid": uid,
             "prompt": rng.integers(
                 0, vocab, size=int(rng.integers(3, 10))).astype(np.int32),
             "max_new": int(rng.integers(1, 7))}
            for uid in range(n_req)]


def serve_both(jmodel, jparams, tmodel, tparams, trace, *, slots,
               waves=1, **paged):
    """The same trace through JAX's and the port's paged engines (``waves``
    > 1: the trace in that many sequential ``run`` calls, so later waves
    hit the prefix cache) with the pager audited after every step →
    (port outs, port engine, JAX outs, JAX engine)."""
    outs = []
    for eng_cls, req_cls, cfg_cls, model, params in (
            (ServingEngine, Request, ServeConfig, tmodel, tparams),
            (JEngine, JRequest, JServeConfig, jmodel, jparams)):
        eng = eng_cls(model, params, cfg_cls(
            batch_slots=slots, max_len=MAX_LEN, paged=True, page_size=PAGE,
            debug_checks=True, **paged))
        got = {}
        for w in range(waves):
            for spec in trace[w::waves]:
                eng.submit(req_cls(spec["uid"], spec["prompt"],
                                   max_new=spec["max_new"]))
            got.update({r.uid: r.out for r in eng.run()})
        eng.pager.check()
        outs += [got, eng]
    return outs


def assert_same(tout, teng, jout, jeng):
    assert tout == jout
    assert {k: teng.stats[k] for k in STATS} == \
        {k: jeng.stats[k] for k in STATS}
    assert _state(teng.pager) == _state(jeng.pager)


@pytest.fixture(scope="module")
def tiny():
    """TINY dense and magnitude-2:4 compressed trees in both packages."""
    jmodel = j_build(TINY)
    params = jmodel.init(jax.random.PRNGKey(0))
    batches = calibration_batches(TINY, num_samples=4, seq_len=8, batch=2)
    pruned, report = j_prune_model(
        params, JAdapter(jmodel), batches,
        JPruneConfig(method="magnitude", pattern="nm", n=2, m=4))
    comp = j_compress(pruned, report.masks, 2, 4)
    tmodel = build_model(port_cfg(TINY), device="cpu")
    return {"jmodel": jmodel, "tmodel": tmodel,
            "dense": (params, carry(params)), "comp": (comp, carry(comp)),
            "trace": make_trace(7, 8, TINY.vocab_size)}


ENGINE_CASES = {
    "dense": dict(tree="dense", slots=3),
    "compressed": dict(tree="comp", slots=3),
    "constrained_pool": dict(tree="dense", slots=3, num_pages=5,
                             prefix_reuse=False),
    "exceeds_contiguous": dict(tree="dense", slots=2),
    "prefix_waves": dict(tree="dense", slots=2, waves=2),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_paged_engine_matches_jax(tiny, case):
    kw = dict(ENGINE_CASES[case])
    jp, tp = tiny[kw.pop("tree")]
    trace = tiny["trace"]
    if case == "prefix_waves":                 # repeat every prompt
        trace = trace + [dict(s, uid=s["uid"] + 100) for s in trace]
    if case == "exceeds_contiguous":
        assert sum(len(s["prompt"]) + s["max_new"] for s in trace) > \
            kw["slots"] * MAX_LEN
    tout, teng, jout, jeng = serve_both(tiny["jmodel"], jp, tiny["tmodel"],
                                        tp, trace, **kw)
    assert_same(tout, teng, jout, jeng)
    assert teng.stats["page_faults"] > 0
    if case == "constrained_pool":
        assert teng.stats["preemptions"] > 0
        assert teng.pager.pool.used_pages == 0
    if case == "prefix_waves":
        assert teng.stats["prefix_hit_tokens"] > 0
        assert teng.stats["cow_copies"] > 0


def test_paged_engine_matches_contiguous_engine(tiny):
    """Port only: the paged engine's greedy tokens are the contiguous
    engine's, for the dense and the compressed tree."""
    for tree in ("dense", "comp"):
        tp = tiny[tree][1]
        outs = []
        for paged in (False, True):
            eng = ServingEngine(tiny["tmodel"], tp, ServeConfig(
                batch_slots=3, max_len=MAX_LEN, paged=paged, page_size=PAGE))
            for s in tiny["trace"]:
                eng.submit(Request(s["uid"], s["prompt"],
                                   max_new=s["max_new"]))
            outs.append({r.uid: r.out for r in eng.run()})
        assert outs[0] == outs[1]


def test_prefix_hit_and_partial_merge_match_jax(tiny):
    """A repeated prompt (full match: COW on the shared partial page) and
    two prompts sharing a page and 3 tokens more (the sharer keeps the
    full page and merges the partial one at admission), one slot."""
    jp, tp = tiny["dense"]
    rng = np.random.default_rng(4)
    head = rng.integers(0, TINY.vocab_size, size=PAGE + 3)
    a = np.concatenate([head, [1, 2]]).astype(np.int32)
    b = np.concatenate([head, [3, 4]]).astype(np.int32)
    trace = [{"uid": 0, "prompt": a, "max_new": 4},
             {"uid": 1, "prompt": b, "max_new": 4},
             {"uid": 2, "prompt": a, "max_new": 5}]
    tout, teng, jout, jeng = serve_both(tiny["jmodel"], jp, tiny["tmodel"],
                                        tp, trace, slots=1)
    assert_same(tout, teng, jout, jeng)
    assert teng.stats["prefix_hit_tokens"] >= PAGE + 3 + len(a)
    assert teng.stats["cow_copies"] > 0


def test_pool_pages_mid_flight_match_jax(tiny):
    """After 5 steps of a contended trace: the same tables, and the pool
    lanes each active slot's table maps (the lanes its positions mark
    valid) equal to JAX's."""
    jp, tp = tiny["dense"]
    engines = []
    for eng_cls, req_cls, cfg_cls, model, params in (
            (ServingEngine, Request, ServeConfig, tiny["tmodel"], tp),
            (JEngine, JRequest, JServeConfig, tiny["jmodel"], jp)):
        eng = eng_cls(model, params, cfg_cls(
            batch_slots=3, max_len=MAX_LEN, paged=True, page_size=PAGE,
            num_pages=7))
        for s in tiny["trace"]:
            eng.submit(req_cls(s["uid"], s["prompt"], max_new=10))
        for _ in range(5):
            assert eng.pump()
        engines.append(eng)
    teng, jeng = engines
    assert _state(teng.pager) == _state(jeng.pager)
    active = [s for s, r in enumerate(teng._slots) if r is not None]
    assert active
    for i, layer in teng._cache.items():
        jl = jeng._cache[i]
        ids = n(layer.pos_ids)
        np.testing.assert_array_equal(ids[active],
                                      np.asarray(jl.pos_ids)[active])
        assert n(layer.table).tolist() == np.asarray(jl.table).tolist()
        for f in A._POOL_FIELDS[type(layer)]:
            got = n(A._paged_gather(layer, f))[active]
            want = np.asarray(JA._paged_gather(jl, f))[active]
            valid = ids[active] >= 0
            np.testing.assert_allclose(got[valid], want[valid], **F32_TOL)


@pytest.mark.parametrize("global_every", [0, 2])
def test_sliding_window_paged_matches_jax(tiny, global_every):
    """Window 6: every layer a ring (global_every 0, as the reference's
    test), or rings beside a paged global layer (global_every 2).  Prefix
    reuse is off for windowed models."""
    jcfg = TINY.replace(sliding_window=6, global_every=global_every)
    jmodel = j_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(port_cfg(jcfg), device="cpu")
    tout, teng, jout, jeng = serve_both(jmodel, params, tmodel,
                                        carry(params), tiny["trace"],
                                        slots=3)
    assert_same(tout, teng, jout, jeng)
    assert teng.pager.prefix is None and jeng.pager.prefix is None
    kinds = [type(c).__name__ for c in teng._cache.values()]
    assert kinds == [type(c).__name__ for c in jeng._cache.values()]
    assert kinds == (["GqaCache", "PagedGqaCache"] if global_every
                     else ["GqaCache", "GqaCache"])


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_deepseek_paged_latent_caches_match_jax(kv_dtype):
    """deepseek-v3 REDUCED (MLA in every layer, MoE in two) with the
    paged bf16-kind and int8 latent caches, a constrained pool with prefix
    reuse: tokens, statistics and pager state exactly JAX's."""
    jcfg = j_get_config("deepseek-v3-671b", reduced=True).replace(
        kv_cache_dtype=kv_dtype)
    jmodel = j_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(port_cfg(jcfg), device="cpu")
    rng = np.random.default_rng(11)
    head = rng.integers(0, jcfg.vocab_size, size=10).astype(np.int32)
    trace = [{"uid": u, "prompt": np.concatenate(
        [head[:int(rng.integers(4, 11))],
         rng.integers(0, jcfg.vocab_size, size=2)]).astype(np.int32),
        "max_new": int(rng.integers(3, 7))} for u in range(5)]
    tout, teng, jout, jeng = serve_both(jmodel, params, tmodel,
                                        carry(params), trace, slots=2,
                                        num_pages=7)
    assert_same(tout, teng, jout, jeng)
    kind = "PagedQuantMlaCache" if kv_dtype else "PagedMlaCache"
    assert {type(c).__name__ for c in teng._cache.values()} == {kind}
    assert teng.stats["prefix_hit_tokens"] > 0


# --------------------------------------------------------------------------
# config validation and the CLI
# --------------------------------------------------------------------------
BAD_CONFIGS = [dict(paged=True, max_len=30, page_size=16),
               dict(batch_slots=2, max_len=32, paged=True, page_size=16,
                    num_pages=2),
               dict(paged=True, page_size=0)]


@pytest.mark.parametrize("kw", BAD_CONFIGS)
def test_serve_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as jerr:
        JServeConfig(**kw)
    with pytest.raises(ValueError) as terr:
        ServeConfig(**kw)
    assert str(terr.value) == str(jerr.value)
    ok = dict(batch_slots=2, max_len=32, paged=True, page_size=16,
              num_pages=3)
    assert ServeConfig(**ok).paged and JServeConfig(**ok).paged


def test_serve_cli_paged_on_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve as lserve

    monkeypatch.setattr("sys.argv", [
        "serve", "--paged", "--page-size", "8", "--device", "cpu",
        "--requests", "3", "--prompt-len", "5", "--max-new", "3",
        "--slots", "2"])
    lserve.main()
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out
    assert "  paged: hwm " in out and "pages of 4," in out
