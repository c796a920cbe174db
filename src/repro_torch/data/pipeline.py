"""Deterministic synthetic token pipeline — the offline stand-in for C4
(port of ``repro/data/pipeline.py``).

Same statistics as the JAX corpus: Zipfian unigram marginals mixed with a
low-rank bigram Markov chain, so activation norms are heavy-tailed and
next-token loss degrades measurably under pruning.  The JAX corpus draws
with threefry; this one draws with numpy's PCG64 from the same seeds, so the
two streams have the same law but different tokens (the tests hand the JAX
tokens to both packages where they compare them).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

@dataclasses.dataclass(frozen=True)
class SyntheticCorpus:
    """A deterministic 'corpus': Zipf unigrams + rank-k bigram mixing."""

    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.1          # Zipf exponent for unigram marginals
    mix_rank: int = 8            # rank of the bigram transition structure
    mix_weight: float = 0.55     # P(next ~ bigram) vs P(next ~ unigram)

    def _unigram_probs(self) -> np.ndarray:
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-self.zipf_a)
        return probs / probs.sum()

    def sample(self, rng: np.random.Generator, batch: int,
               seq_len: int) -> np.ndarray:
        """(batch, seq_len) int64 tokens drawn with ``rng``: the first from
        the unigram law, each next one from mix·bigram(prev) + (1−mix)·uni."""
        uni = self._unigram_probs()
        lang = np.random.default_rng([self.seed, 7])   # fixes the language
        e = lang.normal(size=(self.vocab_size, self.mix_rank)) * 1.5
        d = e[lang.permutation(self.vocab_size)]       # decoder ≠ encoder
        out = np.empty((batch, seq_len), np.int64)
        out[:, 0] = _categorical(rng, np.broadcast_to(uni, (batch, uni.size)))
        for t in range(1, seq_len):
            big = e[out[:, t - 1]] @ d.T                     # (batch, V)
            big = np.exp(big - big.max(axis=-1, keepdims=True))
            big *= self.mix_weight / big.sum(axis=-1, keepdims=True)
            out[:, t] = _categorical(rng, big + (1.0 - self.mix_weight) * uni)
        return out


def _categorical(rng: np.random.Generator, probs: np.ndarray) -> np.ndarray:
    """One draw per row of (unnormalised) probabilities, by inverse CDF."""
    cdf = np.cumsum(probs, axis=-1)
    u = rng.random((probs.shape[0], 1)) * cdf[:, -1:]
    return np.minimum((cdf < u).sum(axis=-1), probs.shape[-1] - 1)


def calibration_batches(cfg, *, num_samples: int = 32, seq_len: int = 256,
                        batch: int = 8, seed: int = 1234,
                        corpus_seed: int = 0, device="cuda"
                        ) -> list[dict[str, torch.Tensor]]:
    """``num_samples // batch`` batches of {"tokens": (batch, seq_len)} on
    ``device`` (CUDA unless the caller passes ``device="cpu"``).

    ``corpus_seed`` fixes the language; ``seed`` only decorrelates the
    sampled sequences (one numpy stream per batch index).
    """
    device = resolve_device(device)
    if num_samples % batch:
        raise ValueError(f"num_samples={num_samples} must be a multiple of "
                         f"batch={batch}")
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seed=corpus_seed)
    return [{"tokens": torch.from_numpy(corpus.sample(
                np.random.default_rng([seed, i]), batch, seq_len)).to(device)}
            for i in range(num_samples // batch)]


def heldout_loss(model, params, cfg, *, num_batches: int = 4,
                 seq_len: int = 256, batch: int = 8, seed: int = 9999,
                 corpus_seed: int = 0) -> float:
    """Mean next-token CE on a held-out synthetic slice (perplexity proxy):
    the same language as calibration, fresh sequences."""
    batches = calibration_batches(
        cfg, num_samples=num_batches * batch, seq_len=seq_len, batch=batch,
        seed=seed, corpus_seed=corpus_seed, device=model.device)
    with torch.no_grad():
        losses = [float(model.loss(params, b)) for b in batches]
    return float(np.mean(losses))
