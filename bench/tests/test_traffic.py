"""The traffic generators: the same seed gives the same inputs, and the
sizes follow the mixes' parameters."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench.lib import traffic

BENCH = Path(__file__).resolve().parents[1]
SERVE = json.loads((BENCH / "traffic" / "gen-closed-64.json").read_text())
PRUNE = json.loads((BENCH / "traffic" / "thanos-2to4-c128x2048.json")
                   .read_text())
BIG = 2 ** 31 + 987654321


def plan(seed):
    return traffic.closed_loop_plan(SERVE, seed, 151936, torch.device("cpu"),
                                    torch)


def test_closed_loop_is_deterministic_per_seed():
    a, b, c = plan(BIG), plan(BIG), plan(BIG + 1)
    for f in ("prompt_len", "max_new", "ids"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
        assert not np.array_equal(getattr(a, f), getattr(c, f))


def test_closed_loop_sizes_follow_the_mix():
    p = plan(BIG)
    n, rounds = SERVE["clients"], SERVE["rounds"]
    assert p.prompt_len.shape == p.max_new.shape == (rounds, n)
    lo, hi = SERVE["prompt"]["min"], SERVE["prompt"]["max"]
    assert p.prompt_len.min() >= lo and p.prompt_len.max() <= hi
    lo, hi = SERVE["output"]["min"], SERVE["output"]["max"]
    assert p.max_new[1:].min() >= lo and p.max_new[1:].max() <= hi
    # round 0 is the remainder of a request caught in flight
    assert p.max_new[0].min() >= 1 and p.max_new[0].max() <= hi
    assert p.ids.min() >= 0 and p.ids.max() < 151936
    # every request fits the engine's cache rows
    assert (p.prompt_len + p.max_new).max() <= SERVE["max_len"]


def test_every_seed_draws_the_same_sizes_in_another_order():
    a, b = plan(BIG), plan(7)
    # the same client sequences, dealt to the clients in another order
    sa = sorted(map(tuple, np.concatenate([a.max_new, a.prompt_len]).T))
    sb = sorted(map(tuple, np.concatenate([b.max_new, b.prompt_len]).T))
    assert sa == sb
    assert not np.array_equal(a.max_new, b.max_new)
    for j in range(1, 6):
        assert sorted(a.max_new[j]) == sorted(b.max_new[j])


def test_antithetic_rounds_balance_each_client():
    p = plan(BIG)
    lo, hi = SERVE["output"]["min"], SERVE["output"]["max"]
    pair = p.max_new[1] * p.max_new[2]       # log-uniform: u and 1 − u
    assert np.allclose(pair, lo * hi, rtol=0.01)
    plo, phi = SERVE["prompt"]["min"], SERVE["prompt"]["max"]
    assert np.all(np.abs(p.prompt_len[1] + p.prompt_len[2] - (plo + phi))
                  <= 1)


def test_calibration_ids_follow_the_job():
    a = traffic.calibration_ids(PRUNE, BIG, 32768, "cpu", torch)
    b = traffic.calibration_ids(PRUNE, BIG, 32768, "cpu", torch)
    assert len(a) == PRUNE["sequences"] // PRUNE["batch"]
    assert all(t.shape == (PRUNE["batch"], PRUNE["seq_len"]) for t in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(torch.cat(a).max()) < 32768


def test_sub_seed_takes_any_whole_seed():
    seeds = {traffic.sub_seed(s, 1) for s in (0, 1, 2 ** 31, 2 ** 40 + 3)}
    assert len(seeds) == 4
    assert all(0 <= s < 2 ** 63 for s in seeds)
    with pytest.raises(ValueError):
        traffic.calibration_ids(dict(PRUNE, batch=3), 1, 10, "cpu", torch)
