"""Deterministic synthetic token pipeline — the offline stand-in for C4
(port of ``repro/data/pipeline.py``).

Same statistics as the JAX corpus: Zipfian unigram marginals mixed with a
low-rank bigram Markov chain, so activation norms are heavy-tailed and
next-token loss degrades measurably under pruning.  The JAX corpus draws
with threefry; this one draws with numpy's PCG64 from the same seeds, so the
two streams have the same law but different tokens (the tests hand the JAX
tokens to both packages where they compare them).

Every stream draws on its device as JAX's jitted samplers do, through one
inverse-CDF chain (``chain``): uniform draws u (batch, seq_len) in, the
first token from the unigram law, each next one from mix·softmax(e[prev]·
dᵀ) + (1−mix)·uni, each the first index whose running sum reaches
u·total.  The chain is ``graphed``: one CUDA graph a shape inside an open
``graphs.scope()``, inline on the CPU and outside a scope.  No random
number is drawn inside it.

* The training stream (``TrainStream``) draws u with a ``torch.Generator``
  seeded from (seed, host_id, step) and runs the chain in float32 from a
  scope of its own: from its second batch on a batch is one replay.  Its
  tokens differ from numpy's and from JAX's; the law is the same.
* The calibration set and the held-out slice take u from numpy's stream
  ``[seed, i]`` in the order ``SyntheticCorpus.sample`` reads it and run
  the chain in float64, so their tokens are numpy's host draw: only a tie
  at a running sum's last bit could part them.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.util import graphs


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


@functools.lru_cache(maxsize=8)
def _language(corpus: SyntheticCorpus, device: torch.device,
              dtype: torch.dtype = torch.float32):
    """(uni, e, dᵀ) of ``corpus`` as ``dtype`` tensors on ``device``: the
    unigram law and the bigram encoder/decoder from ``default_rng([seed,
    7])``, as ``SyntheticCorpus.sample`` draws them."""
    lang = np.random.default_rng([corpus.seed, 7])
    e = lang.normal(size=(corpus.vocab_size, corpus.mix_rank)) * 1.5
    d = e[lang.permutation(corpus.vocab_size)]
    as_t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return as_t(corpus._unigram_probs()), as_t(e), as_t(d.T.copy())


def _chain(u: torch.Tensor, uni: torch.Tensor, e: torch.Tensor,
           dt: torch.Tensor, mix: float) -> torch.Tensor:
    """(batch, seq_len) int64 tokens by the law of ``SyntheticCorpus.
    sample`` from uniform draws ``u`` (batch, seq_len) in their dtype: the
    first token from the unigram law ``uni``, each next one from
    mix·softmax(e[prev]·dᵀ) + (1−mix)·uni, each the first index whose
    running sum reaches u·total — ``(cdf < u·total).sum()``, numpy's
    rule."""
    batch, seq_len = u.shape
    out = torch.empty((batch, seq_len), dtype=torch.int64, device=u.device)
    last = uni.shape[0] - 1
    cdf = torch.cumsum(uni, 0).expand(batch, -1).contiguous()
    out[:, 0] = torch.searchsorted(cdf, u[:, :1] * cdf[:, -1:])[:, 0] \
        .clamp_(max=last)
    rest = (1.0 - mix) * uni
    for t in range(1, seq_len):
        big = e[out[:, t - 1]] @ dt                        # (batch, V)
        big = torch.exp(big - big.amax(dim=-1, keepdim=True))
        big *= mix / big.sum(dim=-1, keepdim=True)
        cdf = torch.cumsum(big + rest, dim=-1)
        out[:, t] = torch.searchsorted(cdf, u[:, t:t + 1] * cdf[:, -1:]
                                       )[:, 0].clamp_(max=last)
    return out


# JAX's jitted samplers: the language bound in place, u copied in
chain = graphs.graphed(_chain, static=("mix",), donate=("uni", "e", "dt"))


def sample_torch(corpus: SyntheticCorpus, gen: torch.Generator, batch: int,
                 seq_len: int) -> torch.Tensor:
    """(batch, seq_len) int64 tokens on ``gen``'s device, by the law of
    ``SyntheticCorpus.sample``: u from ``gen`` (one ``torch.rand``), then
    the float32 ``chain``."""
    dev = gen.device
    u = torch.rand((batch, seq_len), generator=gen, device=dev)
    return chain(u, *_language(corpus, dev), corpus.mix_weight)


def _categorical(rng: np.random.Generator, probs: np.ndarray) -> np.ndarray:
    """One draw per row of (unnormalised) probabilities, by inverse CDF."""
    cdf = np.cumsum(probs, axis=-1)
    u = rng.random((probs.shape[0], 1)) * cdf[:, -1:]
    return np.minimum((cdf < u).sum(axis=-1), probs.shape[-1] - 1)


def numpy_uniforms(rng: np.random.Generator, batch: int,
                   seq_len: int) -> np.ndarray:
    """The (batch, seq_len) doubles ``SyntheticCorpus.sample`` reads from
    ``rng``, position by position: ``rng.random((batch, 1))`` a position is
    the same stream, in the same order, as ``rng.random((seq_len,
    batch)).T``."""
    return np.ascontiguousarray(rng.random((seq_len, batch)).T)


@functools.lru_cache(maxsize=64)
def _sample(corpus: SyntheticCorpus, seed: int, index: int, batch: int,
            seq_len: int, device: torch.device) -> torch.Tensor:
    """Batch ``index`` of the stream ``seed`` on ``device``: numpy's
    uniforms through the float64 ``chain`` — ``corpus.sample(np.random.
    default_rng([seed, index]), batch, seq_len)``'s tokens — drawn once a
    process and kept, so a held-out slice taken before and after pruning
    is sampled once."""
    u = torch.from_numpy(numpy_uniforms(np.random.default_rng(
        [seed, index]), batch, seq_len)).to(device)
    return chain(u, *_language(corpus, device, torch.float64),
                 corpus.mix_weight)


@dataclasses.dataclass
class CalibrationStream:
    """The paper's calibration set: ``num_samples`` fixed sequences (§5.1),
    ``num_samples // batch`` batches of {"tokens": (batch, seq_len)} drawn
    on ``device`` (CUDA unless the caller passes ``device="cpu"``), batch i
    numpy's draw from the stream ``[seed, i]``."""

    corpus: SyntheticCorpus
    num_samples: int = 128
    seq_len: int = 2048
    batch: int = 8
    seed: int = 1234
    device: "str | torch.device" = "cuda"

    def batches(self) -> list[dict[str, torch.Tensor]]:
        if self.num_samples % self.batch:
            raise ValueError(f"num_samples={self.num_samples} must be a "
                             f"multiple of batch={self.batch}")
        device = resolve_device(self.device)
        return [{"tokens": _sample(self.corpus, self.seed, i, self.batch,
                                   self.seq_len, device).clone()}
                for i in range(self.num_samples // self.batch)]


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
    toks = [b["tokens"] for b in CalibrationStream(
        SyntheticCorpus(vocab_size=cfg.vocab_size, seed=corpus_seed),
        num_samples=num_samples, seq_len=seq_len, batch=batch, seed=seed,
        device=device).batches()]
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
    the same language as calibration, fresh sequences, drawn on the
    model's device.  JAX jits the loss once a call; here it runs eagerly:
    a graph captured for four batches costs more than its three replays
    save (tinyllama-1.1b on an H100, ``chip_smoke.heldout_timing``: 213.5
    ms graphed against 152.3 ms eager, the mean of two calls each)."""
    batches = calibration_batches(
        cfg, num_samples=num_batches * batch, seq_len=seq_len, batch=batch,
        seed=seed, corpus_seed=corpus_seed, device=model.device)
    with torch.no_grad():
        losses = [float(model.loss(params, b)) for b in batches]
    return float(np.mean(losses))


def _stream_seed(seed: int, host_id: int, step: int) -> int:
    """A 63-bit generator seed that is a pure function of the triple."""
    state = np.random.SeedSequence([seed, host_id, step]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


@dataclasses.dataclass
class TrainStream:
    """Infinite deterministic training stream.

    ``batch_at(step)`` is a pure function of (seed, host_id, step): restarts
    resume mid-epoch with no iterator state, and each host generates only
    its own shard (a host-sliced batch of ``global_batch // num_hosts``
    rows), drawn on ``device`` (CUDA unless the caller passes
    ``device="cpu"``).
    """

    corpus: SyntheticCorpus
    global_batch: int
    seq_len: int
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    device: "str | torch.device" = "cuda"

    def __post_init__(self):
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global_batch={self.global_batch} must be a "
                             f"multiple of num_hosts={self.num_hosts}")
        self.device = resolve_device(self.device)
        # JAX jits the sampler once a stream: the chain's graph and pool
        self._sample = graphs.Compiled(sample_torch, sample_torch)

    def batch_at(self, step: int) -> dict[str, torch.Tensor]:
        gen = torch.Generator(device=self.device).manual_seed(
            _stream_seed(self.seed, self.host_id, int(step)))
        return {"tokens": self._sample(
            self.corpus, gen, self.global_batch // self.num_hosts,
            self.seq_len)}

    def stats(self) -> dict:
        """The sampler's graphs (``graphs.Scope.stats``)."""
        return self._sample.stats()

    def release(self) -> None:
        """Drop the sampler's graph and return its pool to the card."""
        self._sample.release()

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
