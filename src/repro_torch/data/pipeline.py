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
import functools

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


@functools.lru_cache(maxsize=64)
def _sample(vocab_size: int, corpus_seed: int, seed: int, index: int,
            batch: int, seq_len: int) -> np.ndarray:
    """Batch ``index`` of the stream ``seed``: drawn once per process and
    kept (the draw is deterministic, and at a vocabulary of 262 144 it
    takes tens of seconds on the host), so a held-out slice taken before
    and after pruning is sampled once."""
    corpus = SyntheticCorpus(vocab_size=vocab_size, seed=corpus_seed)
    return corpus.sample(np.random.default_rng([seed, index]), batch,
                         seq_len)


def calibration_batches(cfg, *, num_samples: int = 32, seq_len: int = 256,
                        batch: int = 8, seed: int = 1234,
                        corpus_seed: int = 0, device="cuda"
                        ) -> list[dict[str, torch.Tensor]]:
    """``num_samples // batch`` batches of {"tokens": (batch, seq_len)} on
    ``device`` (CUDA unless the caller passes ``device="cpu"``).

    ``corpus_seed`` fixes the language; ``seed`` only decorrelates the
    sampled sequences (one numpy stream per batch index).  An encoder–
    decoder model gets {"frames": (batch, seq_len, d_model), "dec_tokens":
    (batch, min(dec_seq, seq_len))}: the frames stub is standard normal in
    the model dtype, drawn from a generator seeded with ``seed + 1``.  A
    VLM gets {"tokens": (batch, seq_len − n_img), "patch_embeds": (batch,
    n_img, d_model)} with n_img = min(vlm_image_tokens, seq_len // 2): the
    patch stub is standard normal in the model dtype, drawn from a generator
    seeded with ``seed + 2``.
    """
    device = resolve_device(device)
    if num_samples % batch:
        raise ValueError(f"num_samples={num_samples} must be a multiple of "
                         f"batch={batch}")
    toks = [torch.from_numpy(_sample(cfg.vocab_size, corpus_seed, seed, i,
                                     batch, seq_len).copy()).to(device)
            for i in range(num_samples // batch)]
    if cfg.family == "vlm":
        gen = torch.Generator(device=device).manual_seed(seed + 2)
        n_img = min(cfg.vlm_image_tokens, seq_len // 2)
        return [{"tokens": t[:, :seq_len - n_img],
                 "patch_embeds": torch.randn(
                     (batch, n_img, cfg.d_model), generator=gen,
                     device=device).to(cfg.torch_dtype)} for t in toks]
    if cfg.family != "encdec":
        return [{"tokens": t} for t in toks]
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return [{"frames": torch.randn((batch, seq_len, cfg.d_model),
                                   generator=gen, device=device).to(
                                       cfg.torch_dtype),
             "dec_tokens": t[:, :min(cfg.dec_seq, seq_len)]} for t in toks]


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
