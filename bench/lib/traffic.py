"""Traffic generators, one general generator per kind of mix.  A mix is a
data file under ``bench/traffic/``; its ``kind`` names the driver
(``bench/drivers/<kind>.py``) and these functions read its parameters.

Sizes are stratified and the same for every seed; the seed changes their
order (which client sends which sequence of requests) and every token id,
so it changes what is computed, not how much.  Token ids are drawn on the
device from the seed, in one call.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

MASK63 = (1 << 63) - 1


def sub_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed for one stream, mixed from the run's seed and a salt
    (splitmix64 steps: any whole seed, however large, maps in)."""
    z = seed & ((1 << 64) - 1)
    for s in (*salt, 0x9E3779B97F4A7C15):
        z = (z + (s & ((1 << 64) - 1)) + 0x9E3779B97F4A7C15) & ((1 << 64) - 1)
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
        z ^= z >> 31
    return z & MASK63


def strata(n: int) -> np.ndarray:
    """The midpoints of n equal strata of [0, 1]."""
    return (np.arange(n) + 0.5) / n


def uniform_int(q: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Quantiles q of the uniform law on the integers lo..hi."""
    return np.minimum(lo + np.floor(q * (hi - lo + 1)), hi).astype(np.int64)


def log_uniform_int(q: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Quantiles q of the log-uniform law on [lo, hi], rounded."""
    v = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


LAWS = {"uniform": uniform_int, "log_uniform": log_uniform_int}


@dataclasses.dataclass
class ClosedLoopPlan:
    """Each client's requests, round by round: ``prompt_len[j, c]``,
    ``max_new[j, c]`` and ``ids[j, c, :prompt_len[j, c]]`` (host int64)."""

    prompt_len: np.ndarray
    max_new: np.ndarray
    ids: np.ndarray


def closed_loop_plan(mix: dict, seed: int, vocab: int, device,
                     torch) -> ClosedLoopPlan:
    """Requests of a closed loop: ``mix["clients"]`` clients, each sending
    its next request when its last one completes.  Round j gives client c
    its j-th request.  The lengths are the same for every seed: within a
    round the clients take a permutation of the same stratified quantiles
    of the length laws (drawn once, from the mix alone), and round 2k
    mirrors round 2k − 1 client by client (quantile 1 − u for u), so a
    client's work over two rounds varies little.  Round 0 stands in for a
    loop already running: each of its outputs is cut to a stratified share
    of its length (the rest of a request caught in flight), so completions
    are spread from the window's start.  The seed deals these sequences of
    lengths to the clients in another order and draws every token id."""
    n, rounds = int(mix["clients"]), int(mix["rounds"])
    fixed = np.random.default_rng(sub_seed(0, 1))
    p, o = mix["prompt"], mix["output"]
    q = strata(n)
    qp = np.stack([fixed.permutation(q) for _ in range(rounds)])
    qo = np.stack([fixed.permutation(q) for _ in range(rounds)])
    qp[2::2] = 1.0 - qp[1:rounds - 1:2][:len(qp[2::2])]
    qo[2::2] = 1.0 - qo[1:rounds - 1:2][:len(qo[2::2])]
    prompt_len = LAWS[p["law"]](qp, int(p["min"]), int(p["max"]))
    max_new = LAWS[o["law"]](qo, int(o["min"]), int(o["max"]))
    share = fixed.permutation(q)
    max_new[0] = np.maximum(1, np.ceil(share * max_new[0])).astype(np.int64)
    deal = np.random.default_rng(sub_seed(seed, 1)).permutation(n)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    ids = torch.randint(0, vocab, (rounds, n, int(p["max"])), generator=gen,
                        device=device).cpu().numpy()
    return ClosedLoopPlan(prompt_len[:, deal], max_new[:, deal], ids)


def calibration_ids(job: dict, seed: int, vocab: int, device, torch):
    """A prune job's calibration set: ``sequences`` × ``seq_len`` token ids
    uniform over the vocabulary, drawn on the device → a list of
    (``batch``, ``seq_len``) int64 batches."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 3))
    n, s, b = int(job["sequences"]), int(job["seq_len"]), int(job["batch"])
    if n % b:
        raise ValueError(f"sequences={n} is not a multiple of batch={b}")
    ids = torch.randint(0, vocab, (n, s), generator=gen, device=device)
    return list(ids.split(b))
