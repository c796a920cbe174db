"""The port's fault-injection core (``repro_torch/faults.py``) against the
JAX package's ``repro/faults.py``: the same plans serialize to the same
JSON bytes, parse the same compact strings, fire at the same invocations
for every trigger shape (the seeded Bernoulli one too: both draw from
numpy's ``default_rng``), and raise the same exception tree.  Everything
is compared exactly."""
from __future__ import annotations

import numpy as np
import pytest

import repro.faults as J
import repro_torch.faults as T
import repro_torch.serve.faults as TS

COMPACT = [
    "decode_logits@5",
    "decode_logits@5;pager_fault_in@7x6;prefill~3;sse_stall@0+0.5",
    " decode_logits@1 ; ; prefill~0 ;",
    "decode_stall@9+0.25;journal_write@3;cholesky@0;hessian_accum@0",
    "calib_batch@2~1;snapshot_write@0x2",
]


def _plans(mod):
    """Plans of every trigger shape, built through ``mod``'s classes."""
    S = mod.FaultSpec
    return [
        mod.FaultPlan([S(site="decode_logits", at=(3,), count=2),
                       S(site="prefill", uid=1, count=0),
                       S(site="decode_stall", prob=0.3, count=5,
                         payload=0.25)], seed=7),
        mod.FaultPlan([S(site="prefill", at=(1, 4), uid=5),
                       S(site="pager_fault_in", at=(0, 6), count=3)]),
        mod.FaultPlan([S(site="decode_logits", prob=0.5, count=0),
                       S(site="decode_logits", prob=1.0, count=3)], seed=42),
        mod.FaultPlan([S(site=s, at=(0,)) for s in mod.SITES], seed=1),
    ]


@pytest.mark.parametrize("i", range(4))
def test_to_json_byte_equal(i):
    assert _plans(T)[i].to_json() == _plans(J)[i].to_json()


@pytest.mark.parametrize("text", COMPACT)
def test_parse_byte_equal(text):
    tp, jp = T.FaultPlan.parse(text, seed=3), J.FaultPlan.parse(text, seed=3)
    assert tp.to_json() == jp.to_json()
    assert T.FaultPlan.from_json(jp.to_json()).to_json() == jp.to_json()
    assert J.FaultPlan.from_json(tp.to_json()).to_json() == tp.to_json()


def _sequence(seed: int) -> list[tuple[str, int]]:
    rng = np.random.default_rng(seed)
    return [(str(rng.choice(J.SITES)), int(rng.integers(-1, 6)))
            for _ in range(300)]


@pytest.mark.parametrize("i", range(4))
def test_fire_sequences_equal_jax(i):
    """The same call sequence over every site: each returns the same spec
    (or none), and the firing logs and counters end equal."""
    tp, jp = _plans(T)[i], _plans(J)[i]
    for site, uid in _sequence(i):
        th, jh = tp.fire(site, uid=uid), jp.fire(site, uid=uid)
        assert (th is None) == (jh is None)
        if th is not None:
            assert th.to_dict() == jh.to_dict()
    assert tp.fired == jp.fired
    assert tp.fired_by_site() == jp.fired_by_site()
    assert tp.invocations == jp.invocations
    assert tp._firings == jp._firings


@pytest.mark.parametrize("seed", [0, 42, 43])
def test_bernoulli_trigger_equals_jax(seed):
    def pattern(mod):
        plan = mod.FaultPlan([mod.FaultSpec(site="decode_logits", prob=0.5,
                                            count=0)], seed=seed)
        return [plan.fire("decode_logits") is not None for _ in range(64)]

    assert pattern(T) == pattern(J)
    assert any(pattern(T)) and not all(pattern(T))


def test_counters_do_not_roll_back():
    plan = T.FaultPlan([T.FaultSpec(site="decode_logits", at=(1,))])
    assert plan.fire("decode_logits") is None
    assert plan.fire("decode_logits") is not None
    assert plan.fire("decode_logits") is None      # consumed: index 2
    assert plan.invocations["decode_logits"] == 3


def test_sites_and_exports_equal_jax():
    assert (T.SERVE_SITES, T.PRUNE_SITES, T.SITES) == \
        (J.SERVE_SITES, J.PRUNE_SITES, J.SITES)
    assert T.__all__ == J.__all__
    import repro.serve.faults as JS
    assert TS.__all__ == JS.__all__
    assert all(getattr(TS, n) is getattr(T, n) for n in TS.__all__)


def test_taxonomy_class_tree_equals_jax():
    names = [n for n in J.__all__ if isinstance(getattr(J, n), type)]
    for name in names:
        jb = [b.__name__ for b in getattr(J, name).__mro__]
        tb = [b.__name__ for b in getattr(T, name).__mro__]
        assert tb == jb, name
    assert issubclass(T.DeviceOom, T.EngineFault)
    assert not issubclass(T.EngineDown, T.EngineFault)
    exc = T.DeviceOom("x", site="prefill", uid=3)
    assert (exc.site, exc.uid) == ("prefill", 3)
    assert T.QueueFull("full", retry_after_s=2.5).retry_after_s == 2.5
    assert T.SingularHessian("s", path="p", attempts=5).attempts == 5


@pytest.mark.parametrize("kw", [
    {"at": (-1,)}, {"at": (0,), "count": 0}, {"prob": 1.5}, {"prob": -0.1},
    {"count": -1, "uid": 0}, {},
])
def test_bad_specs_rejected_like_jax(kw):
    with pytest.raises(ValueError) as te:
        T.FaultSpec(site="decode_logits", **kw)
    with pytest.raises(ValueError) as je:
        J.FaultSpec(site="decode_logits", **kw)
    assert str(te.value) == str(je.value)


def test_from_json_and_load(tmp_path):
    with pytest.raises(ValueError, match="version"):
        T.FaultPlan.from_json('{"version": 2, "specs": []}')
    with pytest.raises(ValueError, match="unknown fault-plan keys"):
        T.FaultPlan.from_json('{"version": 1, "specs": [], "extra": 1}')
    with pytest.raises(ValueError, match="unknown fault site"):
        T.FaultSpec(site="warp_core_breach", at=(0,))
    plan = T.FaultPlan([T.FaultSpec(site="decode_logits", at=(2,))], seed=3)
    p = tmp_path / "plan.json"
    p.write_text(plan.to_json())
    assert T.FaultPlan.load(str(p)).specs == plan.specs
    assert T.FaultPlan.load(plan.to_json()).seed == 3
    assert T.FaultPlan.load("decode_logits@2").specs == plan.specs
    p.write_text("{not json")
    with pytest.raises(ValueError):
        T.FaultPlan.load(str(p))
