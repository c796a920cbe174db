"""The port's supervised serving on the CPU against the JAX package: the
engine surface (wave scheduler, eos_id, deadlines, cancel, QueueFull,
sampling, snapshot/restore) and the fault supervisor (rollback + replay,
quarantine, EngineDown, backoff, snapshot persistence, the pager audit),
on one tiny dense model whose params the port gets from the JAX tree.

The recovery guarantee is **bitwise token parity**: a supervised engine
hit by a FaultPlan finishes every request with the greedy tokens of the
fault-free B = 1 oracle — the port's own, which is first held equal to
JAX's B = 1 oracle — and the same trace under JAX's supervisor gives the
same tokens, recoveries and firings.  Tokens, stats and firings are
compared exactly; nothing here has a tolerance.
"""
from __future__ import annotations

import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.models.model_builder import build_model as j_build  # noqa: E402
from repro.serve import FaultPlan as JFaultPlan  # noqa: E402
from repro.serve import FaultSpec as JFaultSpec  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServingEngine as JEngine  # noqa: E402
from repro.serve import Supervisor as JSupervisor  # noqa: E402
from repro.serve import SupervisorConfig as JSupervisorConfig  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model_builder import build_model  # noqa: E402
from repro_torch.serve.engine import (Request, ServeConfig,  # noqa: E402
                                      ServingEngine)
from repro_torch.serve.faults import (DeviceOom, EngineDown,  # noqa: E402
                                      FaultPlan, FaultSpec, QueueFull)
from repro_torch.serve.pager import Pager, PagerAuditError  # noqa: E402
from repro_torch.serve.supervisor import (DEGRADED, HEALTHY,  # noqa: E402
                                          Supervisor, SupervisorConfig)
from test_torch_fixtures import jax_tree_to_numpy  # noqa: E402

TINY = dict(name="sup-tiny", family="dense", num_layers=1, d_model=16,
            num_heads=2, num_kv_heads=2, head_dim=8, d_ff=32,
            vocab_size=48, dtype="float32")
MAX_LEN = 16
SPECS = [(3, 4), (1, 3), (4, 2), (2, 2), (4, 5), (3, 3)]   # (prompt, max_new)

_STATE: dict = {}


def _models():
    if not _STATE:
        jm = j_build(JModelConfig(**TINY))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(ModelConfig(**TINY), device="cpu")
        tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
        _STATE["mp"] = (jm, jp, tm, tp)
    return _STATE["mp"]


def _requests(specs=SPECS, seed=7, cls=Request, **kw):
    rng = np.random.default_rng(seed)
    return [cls(uid, rng.integers(0, 48, size=S).astype(np.int32),
                max_new=mn, **kw)
            for uid, (S, mn) in enumerate(specs)]


def _oracle(specs=SPECS, seed=7):
    """The port's fault-free B = 1 wave outputs — the parity reference."""
    key = ("oracle", tuple(specs), seed)
    if key not in _STATE:
        _, _, tm, tp = _models()
        outs = {}
        for r in _requests(specs, seed):
            eng = ServingEngine(tm, tp, ServeConfig(
                batch_slots=1, max_len=MAX_LEN, scheduler="wave"))
            eng.submit(r)
            (done,) = eng.run()
            outs[done.uid] = tuple(done.out)
        _STATE[key] = outs
    return _STATE[key]


def _engine(**kw):
    _, _, tm, tp = _models()
    cfg = dict(batch_slots=2, max_len=MAX_LEN)
    cfg.update(kw)
    return ServingEngine(tm, tp, ServeConfig(**cfg))


def _supervised_run(plan, *, specs=SPECS, seed=7, engine_kw=None,
                    sup_kw=None, on_token=None):
    eng = _engine(**(engine_kw or {}))
    sup = Supervisor(eng, SupervisorConfig(**(sup_kw or {})), faults=plan)
    for r in _requests(specs, seed, on_token=on_token):
        sup.submit(r)
    done = sup.run()
    return sup, {r.uid: tuple(r.out) for r in done}


def _jax_supervised_run(specs, *, engine_kw, sup_kw):
    jm, jp, _, _ = _models()
    eng = JEngine(jm, jp, JServeConfig(batch_slots=2, max_len=MAX_LEN,
                                       **engine_kw))
    plan = JFaultPlan.from_json(_STATE["plan_json"])
    sup = JSupervisor(eng, JSupervisorConfig(**sup_kw), faults=plan)
    for r in _requests(specs, 7, cls=JRequest):
        sup.submit(r)
    return sup, plan, {r.uid: tuple(r.out) for r in sup.run()}


# --------------------------------------------------------------------------
# the oracle itself, and the wave scheduler, against JAX
# --------------------------------------------------------------------------
def test_b1_oracle_matches_jax_b1_oracle():
    jm, jp, _, _ = _models()
    jouts = {}
    for r in _requests(cls=JRequest):
        eng = JEngine(jm, jp, JServeConfig(batch_slots=1, max_len=MAX_LEN,
                                           scheduler="wave"))
        eng.submit(r)
        (done,) = eng.run()
        jouts[done.uid] = tuple(done.out)
    assert _oracle() == jouts


@pytest.mark.parametrize("scheduler", ["wave", "continuous"])
def test_scheduler_tokens_and_stats_match_jax(scheduler):
    """Same-length prompts form waves of 2; mixed lengths split them.
    Tokens equal JAX's engine and the B = 1 oracle; stats equal JAX's."""
    specs = [(3, 4), (3, 2), (2, 5), (3, 3), (2, 1)]
    jm, jp, tm, tp = _models()
    jeng = JEngine(jm, jp, JServeConfig(batch_slots=2, max_len=MAX_LEN,
                                        scheduler=scheduler))
    teng = ServingEngine(tm, tp, ServeConfig(batch_slots=2, max_len=MAX_LEN,
                                             scheduler=scheduler))
    for r in _requests(specs, cls=JRequest):
        jeng.submit(r)
    for r in _requests(specs):
        teng.submit(r)
    jout = {r.uid: tuple(r.out) for r in jeng.run()}
    tout = {r.uid: tuple(r.out) for r in teng.run()}
    assert tout == jout == _oracle(specs)
    assert teng.stats == {k: jeng.stats[k] for k in teng.stats}


# --------------------------------------------------------------------------
# the recovery guarantee
# --------------------------------------------------------------------------
def test_three_fault_types_recover_bit_identical_and_match_jax():
    """NaN logits mid-decode + admission OOM + a pager burst that defeats
    the engine's preempt-retry loop, on the paged engine: tokens equal the
    oracle, and recoveries, faults and firings equal JAX's supervisor."""
    specs = [FaultSpec(site="decode_logits", at=(3,)),
             FaultSpec(site="prefill", at=(2,)),
             FaultSpec(site="pager_fault_in", at=(9,), count=4)]
    plan = FaultPlan(specs)
    _STATE["plan_json"] = plan.to_json()
    kw = dict(engine_kw=dict(paged=True, page_size=4),
              sup_kw=dict(snapshot_every=2, retry_budget=5))
    sup, outs = _supervised_run(plan, **kw)
    jsup, jplan, jouts = _jax_supervised_run(SPECS, **kw)
    assert outs == jouts == _oracle()
    assert plan.fired == jplan.fired
    assert set(plan.fired_by_site()) == {"decode_logits", "prefill",
                                         "pager_fault_in"}
    assert sup.stats["recoveries"] >= 3
    assert {k: sup.stats[k] for k in ("recoveries", "faults", "snapshots",
                                      "replayed_requests",
                                      "rollback_decode_steps")} == \
        {k: jsup.stats[k] for k in ("recoveries", "faults", "snapshots",
                                    "replayed_requests",
                                    "rollback_decode_steps")}
    assert sup.quarantined == [] and sup.state == HEALTHY


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("faults", [
    [("decode_logits", 2, 1)],
    [("prefill", 1, 1), ("decode_logits", 5, 2)],
    [("decode_logits", 0, 1), ("prefill", 4, 1), ("pager_fault_in", 6, 3)],
    [("prefill", 0, 2), ("pager_fault_in", 2, 5)],
])
def test_fault_mixes_recover_bit_identical(faults, paged):
    """Deterministic anchors of the JAX recovery properties: tokens equal
    the oracle, no quarantine, the pager audit clean at the end."""
    plan = FaultPlan([FaultSpec(site=s, at=(a,), count=c)
                      for s, a, c in faults])
    sup, outs = _supervised_run(
        plan, engine_kw=dict(paged=paged, page_size=4),
        sup_kw=dict(snapshot_every=3, retry_budget=64,
                    max_consecutive_recoveries=64))
    assert outs == _oracle()
    assert sup.quarantined == []
    if paged:
        sup.engine.pager.check()


def test_prefill_oom_is_attributed_to_one_request():
    plan = FaultPlan([FaultSpec(site="prefill", at=(1,))])
    sup, outs = _supervised_run(plan)
    assert outs == _oracle()
    assert sum(sup.retries.values()) == 1


def test_unsupervised_nan_logits_corrupt_output():
    """Without the supervisor's watchdog the NaN step is absorbed as
    garbage argmax tokens."""
    eng = _engine()
    eng.arm_faults(FaultPlan([FaultSpec(site="decode_logits", at=(1,))]))
    assert eng.watch_logits is False
    for r in _requests():
        eng.submit(r)
    assert {r.uid: tuple(r.out) for r in eng.run()} != _oracle()


def test_streamed_tokens_exactly_once_across_rollback():
    streamed: dict[int, list[int]] = {}

    def on_token(req, tok):
        streamed.setdefault(req.uid, []).append(int(tok))

    plan = FaultPlan([FaultSpec(site="decode_logits", at=(2,)),
                      FaultSpec(site="decode_logits", at=(6,))])
    sup, outs = _supervised_run(plan, sup_kw=dict(snapshot_every=2),
                                on_token=on_token)
    assert outs == _oracle()
    assert sup.stats["recoveries"] == 2
    assert {u: tuple(t) for u, t in streamed.items()} == _oracle()


def test_health_state_transitions():
    plan = FaultPlan([FaultSpec(site="decode_logits", at=(1,))])
    sup = Supervisor(_engine(), SupervisorConfig(healthy_after=2),
                     faults=plan)
    for r in _requests():
        sup.submit(r)
    states = []
    while sup.pump():
        states.append(sup.state)
    i = states.index(DEGRADED)
    assert states[i + 2] == HEALTHY
    assert sup.health()["ok"]


def test_step_deadline_watchdog_recovers():
    plan = FaultPlan([FaultSpec(site="decode_stall", at=(3,), payload=0.2)])
    sup, outs = _supervised_run(
        plan, sup_kw=dict(step_deadline_s=0.1, warmup_pumps=1,
                          snapshot_every=2))
    assert outs == _oracle()
    assert sup.stats["faults"] == {"StepDeadlineExceeded": 1}


def test_drain_finishes_inflight_work():
    """``drain`` pumps until idle (a fault on the way recovers) and
    reports True; with no time left it reports False."""
    plan = FaultPlan([FaultSpec(site="decode_logits", at=(2,))])
    sup = Supervisor(_engine(), faults=plan)
    for r in _requests():
        sup.submit(r)
    sup.pump()
    assert not sup.idle()
    assert sup.drain(timeout_s=-1.0) is False
    assert sup.drain(timeout_s=60.0) is True and sup.idle()
    assert {r.uid: tuple(r.out) for r in sup.results()} == _oracle()
    assert sup.health()["queued"] == sup.health()["active"] == 0


def test_engine_down_after_consecutive_recovery_budget():
    plan = FaultPlan([FaultSpec(site="decode_logits", at=(0,), count=1000)])
    sup = Supervisor(_engine(), SupervisorConfig(
        retry_budget=100, max_consecutive_recoveries=3), faults=plan)
    for r in _requests():
        sup.submit(r)
    with pytest.raises(EngineDown, match="consecutive"):
        sup.run()


def test_backoff_accumulates_and_caps():
    plan = FaultPlan([FaultSpec(site="decode_logits", at=(1,), count=3)])
    sup = Supervisor(_engine(), SupervisorConfig(
        retry_budget=100, backoff_base_s=0.01, backoff_cap_s=0.02),
        faults=plan)
    for r in _requests():
        sup.submit(r)
    sup.run()
    assert abs(sup.stats["backoff_s"] - 0.05) < 1e-9


def test_poison_request_quarantined_alone():
    poison = 2
    plan = FaultPlan([FaultSpec(site="prefill", uid=poison, count=0)])
    sup, outs = _supervised_run(plan, sup_kw=dict(retry_budget=3))
    assert sup.quarantined == [poison] and sup.retries[poison] == 3
    assert outs[poison] == ()
    assert {u: o for u, o in outs.items() if u != poison} == \
        {u: o for u, o in _oracle().items() if u != poison}
    (poisoned,) = [r for r in sup.results() if r.uid == poison]
    assert poisoned.error == "quarantined"


def test_snapshot_write_failure_degrades_not_crashes():
    plan = FaultPlan([FaultSpec(site="snapshot_write", at=(1,)),
                      FaultSpec(site="decode_logits", at=(5,))])
    sup, outs = _supervised_run(plan, sup_kw=dict(snapshot_every=2))
    assert outs == _oracle()
    assert sup.stats["snapshot_write_failures"] == 1


def test_pager_audit_runs_after_recovery(monkeypatch):
    plan = FaultPlan([FaultSpec(site="decode_logits", at=(3,))])
    eng = _engine(paged=True, page_size=4)
    sup = Supervisor(eng, SupervisorConfig(snapshot_every=2), faults=plan)
    calls = []
    orig = eng.pager.check
    monkeypatch.setattr(eng.pager, "check",
                        lambda: (calls.append(1), orig())[1])
    for r in _requests():
        sup.submit(r)
    assert {r.uid: tuple(r.out) for r in sup.run()} == _oracle()
    assert len(calls) == sup.stats["recoveries"] == 1


def test_corrupted_restore_surfaces_as_pager_audit_error():
    plan = FaultPlan([FaultSpec(site="decode_logits", at=(5,))])
    sup = Supervisor(_engine(paged=True, page_size=4),
                     SupervisorConfig(snapshot_every=100), faults=plan)
    for r in _requests():
        sup.submit(r)
    for _ in range(4):
        sup.pump()
    sup.checkpoint()
    pool = sup._snap["pager"]["pool"]
    mapped = [p for p in np.asarray(sup._snap["pager"]["table"]).ravel()
              if p > 0]
    pool["refs"] = list(pool["refs"])
    pool["refs"][int(mapped[0])] += 1
    with pytest.raises(PagerAuditError) as ei:
        sup.run()
    assert ei.value.page == int(mapped[0])


# --------------------------------------------------------------------------
# snapshot / restore
# --------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True])
def test_snapshot_is_a_host_copy_and_persists(paged, tmp_path):
    """A mid-flight snapshot holds CPU copies, not references: pumping on
    (every step writes the cache in place) leaves it unchanged, and
    restoring it — into the same engine after it ran on, and from its
    atomically persisted pickle into a fresh one — continues
    bit-identically to the oracle."""
    kw = dict(paged=True, page_size=4) if paged else {}
    sup = Supervisor(_engine(**kw), SupervisorConfig(
        snapshot_every=3, snapshot_dir=str(tmp_path)))
    eng = sup.engine
    for r in _requests():
        sup.submit(r)
    for _ in range(4):
        sup.pump()
    snap = eng.snapshot()
    frozen = {i: c.k.clone() for i, c in snap["device"]["cache"].items()}
    for _ in range(3):
        eng.pump()
    for i, c in snap["device"]["cache"].items():
        assert c.k.device.type == "cpu"
        assert torch.equal(c.k, frozen[i])
    eng.restore(snap)
    assert {r.uid: tuple(r.out) for r in eng.run()} == {
        u: o for u, o in _oracle().items()
        if u in {s["uid"] for s in snap["slots"] + snap["queue"]
                 if s is not None}}
    sup.checkpoint()
    disk = pickle.loads((tmp_path / "snapshot.pkl").read_bytes())
    assert not list(tmp_path.glob("*.tmp*"))
    fresh = _engine(**kw)
    fresh.restore(disk)
    assert fresh.idle() == eng.idle()


def test_restore_into_fresh_engine_finishes_trace():
    eng = _engine(paged=True, page_size=4)
    for r in _requests():
        eng.submit(r)
    for _ in range(3):
        eng.pump()
    snap = pickle.loads(pickle.dumps(eng.snapshot()))
    other = _engine(paged=True, page_size=4)
    other.restore(snap)
    other.pager.check()
    done = {r.uid: tuple(r.out) for r in eng.run()}
    done_restored = {r.uid: tuple(r.out) for r in other.run()}
    assert done_restored == done
    assert {**done, **{r["uid"]: tuple(r["out"])
                       for r in snap["finished"]}} == _oracle()


@pytest.mark.parametrize("src,dst,match", [
    (dict(paged=True, page_size=4, max_len=16),
     dict(paged=True, page_size=8, max_len=32), "max_len"),
    (dict(paged=True, page_size=4, num_pages=9),
     dict(paged=True, page_size=4, num_pages=7), "pages"),
    (dict(paged=True, page_size=4, batch_slots=2),
     dict(paged=True, page_size=4, batch_slots=3), "batch_slots"),
    (dict(paged=True, page_size=4), dict(), "paged"),
    (dict(), dict(scheduler="wave"), "scheduler"),
])
def test_restore_rejects_geometry_mismatch(src, dst, match):
    snap = _engine(**src).snapshot()
    with pytest.raises(ValueError, match=match):
        _engine(**dst).restore(snap)


def test_pager_restore_rejects_page_size_mismatch():
    kw = dict(batch_slots=2, pages_per_slot=4, num_pages=9)
    snap = Pager(page_size=4, **kw).snapshot()
    with pytest.raises(ValueError, match="page_size"):
        Pager(page_size=8, **kw).restore(snap)


# --------------------------------------------------------------------------
# the rest of the engine surface
# --------------------------------------------------------------------------
def test_prefill_fault_leaves_engine_state_clean():
    eng = _engine()
    eng.arm_faults(FaultPlan([FaultSpec(site="prefill", at=(0,))]))
    eng.submit(_requests()[0])
    with pytest.raises(DeviceOom):
        eng.pump()
    assert len(eng.queue) == 1 and all(r is None for r in eng._slots)
    (done,) = eng.run()
    assert tuple(done.out) == _oracle()[0]


def test_eos_stops_like_jax():
    """eos_id = the oracle's second token of request 4: every request
    stops at its first eos, in the port as in JAX."""
    eos = _oracle()[4][1]
    jm, jp, _, _ = _models()
    jeng = JEngine(jm, jp, JServeConfig(batch_slots=2, max_len=MAX_LEN,
                                        eos_id=eos))
    teng = _engine(eos_id=eos)
    for r in _requests(cls=JRequest):
        jeng.submit(r)
    for r in _requests():
        teng.submit(r)
    tout = {r.uid: tuple(r.out) for r in teng.run()}
    assert tout == {r.uid: tuple(r.out) for r in jeng.run()}
    want = {u: (o[:o.index(eos) + 1] if eos in o else o)
            for u, o in _oracle().items()}
    assert tout == want and len(tout[4]) <= 2


def test_cancel_deadline_and_telemetry():
    eng = _engine(batch_slots=1)
    reqs = _requests()
    reqs[5].deadline_s = 1e-9              # expires at the first pump
    for r in reqs:
        eng.submit(r)
    assert all(r.t_submit >= 0 for r in reqs)
    eng.pump()
    assert eng.cancel(1) and eng.cancel(0)   # queued, then in flight
    assert not eng.cancel(0) and not eng.cancel(99)
    done = {r.uid: r for r in eng.run()}
    assert done[5].error == "deadline" and done[5].out == []
    assert done[1].error == "cancelled" and done[1].out == []
    assert done[0].error == "cancelled" and len(done[0].out) >= 1
    for u in (2, 3, 4):
        assert done[u].error == "" and tuple(done[u].out) == _oracle()[u]
        assert done[u].t_submit <= done[u].t_first <= done[u].t_done


def test_bounded_queue_raises_queue_full_unless_forced():
    eng = _engine(max_queued=2)
    reqs = _requests()
    eng.submit(reqs[0])
    eng.submit(reqs[1])
    with pytest.raises(QueueFull) as ei:
        eng.submit(reqs[2])
    assert ei.value.retry_after_s >= 1.0
    eng.submit(reqs[2], force=True)
    assert len(eng.queue) == 3


@pytest.mark.parametrize("kw", [
    dict(temperature=0.0), dict(temperature=float("nan")),
    dict(max_queued=-1), dict(paged=True, scheduler="wave"),
])
def test_serve_config_validation(kw):
    with pytest.raises(ValueError):
        ServeConfig(**kw)


def test_sampling_reproducible_from_a_seeded_generator():
    """greedy=False draws from the engine's torch.Generator: one seed
    gives one token stream; another seed another; and a snapshot taken
    mid-run carries the generator state, so a restore continues the very
    same stream."""
    def run(seed, snap_at=None):
        _, _, tm, tp = _models()
        eng = ServingEngine(tm, tp, ServeConfig(
            batch_slots=2, max_len=MAX_LEN, greedy=False, temperature=0.8),
            gen=torch.Generator().manual_seed(seed))
        for r in _requests():
            eng.submit(r)
        if snap_at is not None:
            for _ in range(snap_at):
                eng.pump()
            snap = eng.snapshot()
            eng.run()
            eng.restore(snap)
        return {r.uid: tuple(r.out) for r in eng.run()}

    a = run(11)
    assert a == run(11)
    assert a != run(12)
    restored = run(11, snap_at=3)
    assert {u: o for u, o in a.items() if u in restored} == restored
    assert a != _oracle()


def test_supervisor_requires_continuous_scheduler():
    with pytest.raises(ValueError, match="continuous"):
        Supervisor(_engine(scheduler="wave"))


@pytest.mark.parametrize("kw", [
    {"snapshot_every": 0}, {"retry_budget": 0},
    {"max_consecutive_recoveries": 0},
])
def test_supervisor_config_validation(kw):
    with pytest.raises(ValueError):
        SupervisorConfig(**kw)


def test_jax_plan_classes_interoperate():
    """A plan written by the JAX package loads in the port unchanged."""
    jplan = JFaultPlan([JFaultSpec(site="decode_logits", at=(2,))])
    plan = FaultPlan.from_json(jplan.to_json())
    sup, outs = _supervised_run(plan)
    assert outs == _oracle() and sup.stats["recoveries"] == 1


# --------------------------------------------------------------------------
# the serving CLI's scheduler and supervisor flags (tinyllama REDUCED)
# --------------------------------------------------------------------------
def _cli(monkeypatch, capsys, *flags) -> tuple[list[str], str]:
    import sys

    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--device", "cpu",
                                      "--requests", "4", "--max-new", "5",
                                      *flags])
    serve.main()
    out = capsys.readouterr().out
    return [ln for ln in out.splitlines() if ln.startswith("  req ")], out


@pytest.mark.parametrize("flags,expect", [
    (("--scheduler", "wave"), "wave: "),
    (("--fault-plan", "decode_logits@2;prefill@1"),
     "supervisor: state=healthy recoveries=2"),
    (("--supervise", "--snapshot-every", "2", "--retry-budget", "4",
      "--max-queued", "8", "--deadline", "60"), "recoveries=0"),
])
def test_serve_cli_scheduler_and_supervisor_flags(monkeypatch, capsys, flags,
                                                  expect):
    """Each flag set serves the same tokens as the plain continuous run;
    a fault plan implies --supervise and recovers."""
    plain, _ = _cli(monkeypatch, capsys)
    got, out = _cli(monkeypatch, capsys, *flags)
    assert got == plain and len(plain) == 4
    assert expect in out
