"""The synthetic corpus's samplers (``data/pipeline.py``) on the CPU: one
inverse-CDF chain for every stream, as JAX's jitted samplers.

* The float64 chain fed numpy's uniforms of the stream ``[seed, i]``
  draws exactly ``SyntheticCorpus.sample``'s tokens (numpy's host draw,
  the law's definition) — at every REDUCED vocabulary of the registry and
  at gemma3's 262 144 for one (2, 16) draw; ``numpy_uniforms`` is the
  stream ``sample`` reads, in its order.
* ``TrainStream.batch_at`` on the fake card of ``test_torch_train_capture``
  (its chain eager, captured, then replayed) is bitwise the eager
  ``sample_torch`` draw on the same seeds, and the stream owns one graph.
* ``calibration_batches(device="cpu")`` keeps its keys, shapes and dtypes
  for every family, its tokens numpy's; ``_sample`` keys on the device.

The sampler's law against the exact one is
``test_torch_trainer.py::test_sampler_law_matches_numpy``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import pipeline as P  # noqa: E402
from repro_torch.util import graphs  # noqa: E402
from test_torch_prune_capture import _fake  # noqa: E402
from test_torch_train_capture import CardGraph  # noqa: E402

VOCABS = sorted({registry.get_config(a, reduced=True).vocab_size
                 for a in registry.ARCHS})


@pytest.fixture
def card(monkeypatch):
    _fake(monkeypatch)
    monkeypatch.setattr(graphs, "Graph", CardGraph)
    yield
    assert graphs._local().scope is None


def _chain64(corpus, seed, index, batch, seq_len):
    u = torch.from_numpy(P.numpy_uniforms(np.random.default_rng(
        [seed, index]), batch, seq_len))
    return P.chain(u, *P._language(corpus, torch.device("cpu"),
                                   torch.float64), corpus.mix_weight)


def test_numpy_uniforms_are_the_stream_sample_reads():
    rng = np.random.default_rng([7, 2])
    want = np.concatenate([rng.random((3, 1)) for _ in range(5)], axis=1)
    got = P.numpy_uniforms(np.random.default_rng([7, 2]), 3, 5)
    assert got.shape == (3, 5) and got.flags.c_contiguous
    assert np.array_equal(got, want)


@pytest.mark.parametrize("vocab", VOCABS)
def test_float64_chain_is_numpys_draw(vocab):
    corpus = P.SyntheticCorpus(vocab_size=vocab)
    for seed, index in ((1234, 0), (1234, 1), (9999, 3)):
        want = corpus.sample(np.random.default_rng([seed, index]), 4, 24)
        got = _chain64(corpus, seed, index, 4, 24)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want)


def test_float64_chain_is_numpys_draw_at_gemma3s_vocabulary():
    vocab = registry.get_config("gemma3-1b").vocab_size
    assert vocab == 262_144
    corpus = P.SyntheticCorpus(vocab_size=vocab)
    want = corpus.sample(np.random.default_rng([9999, 0]), 2, 16)
    assert np.array_equal(_chain64(corpus, 9999, 0, 2, 16).numpy(), want)


def test_calibration_draws_numpys_tokens_once_per_device():
    cfg = registry.get_config("tinyllama-1.1b", reduced=True)
    P._sample.cache_clear()
    got = P.calibration_batches(cfg, num_samples=8, seq_len=12, batch=4,
                                seed=5, device="cpu")
    corpus = P.SyntheticCorpus(vocab_size=cfg.vocab_size)
    for i, b in enumerate(got):
        assert np.array_equal(b["tokens"].numpy(), corpus.sample(
            np.random.default_rng([5, i]), 4, 12))
    again = P.calibration_batches(cfg, num_samples=8, seq_len=12, batch=4,
                                  seed=5, device="cpu")
    info = P._sample.cache_info()
    assert (info.misses, info.hits) == (2, 2)
    assert all(a["tokens"] is not b["tokens"] and
               torch.equal(a["tokens"], b["tokens"])
               for a, b in zip(got, again))
    assert P._sample(corpus, 5, 0, 4, 12, torch.device("meta")).is_meta
    assert P._sample.cache_info().misses == 3


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_calibration_batches_keys_shapes_and_dtypes(arch):
    cfg = registry.get_config(arch, reduced=True)
    batches = P.calibration_batches(cfg, num_samples=4, seq_len=16, batch=2,
                                    device="cpu")
    assert len(batches) == 2
    for b in batches:
        if cfg.family == "encdec":
            assert sorted(b) == ["dec_tokens", "frames"]
            assert b["frames"].shape == (2, 16, cfg.d_model)
            assert b["frames"].dtype == cfg.torch_dtype
            toks = b["dec_tokens"]
            assert toks.shape == (2, min(cfg.dec_seq, 16))
        elif cfg.family == "vlm":
            n_img = min(cfg.vlm_image_tokens, 8)
            assert sorted(b) == ["patch_embeds", "tokens"]
            assert b["patch_embeds"].shape == (2, n_img, cfg.d_model)
            assert b["patch_embeds"].dtype == cfg.torch_dtype
            toks = b["tokens"]
            assert toks.shape == (2, 16 - n_img)
        else:
            assert list(b) == ["tokens"]
            toks = b["tokens"]
            assert toks.shape == (2, 16)
        assert toks.dtype == torch.int64 and toks.device.type == "cpu"
        assert 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size


def test_train_stream_replays_are_the_eager_draws(card):
    """Four batches from the stream's scope — eager, capture, replays —
    against ``sample_torch`` called outside any scope on the same seeds:
    bitwise equal, one graph, three replays; the draw of ``u`` stays
    outside the graph (each batch's tokens differ)."""
    corpus = P.SyntheticCorpus(vocab_size=64)
    stream = P.TrainStream(corpus, global_batch=4, seq_len=12, seed=3,
                           device="cpu")
    got = [stream.batch_at(s)["tokens"] for s in range(4)]
    for s, toks in enumerate(got):
        gen = torch.Generator().manual_seed(P._stream_seed(3, 0, s))
        assert torch.equal(toks, P.sample_torch(corpus, gen, 4, 12))
    assert len({tuple(t.flatten().tolist()) for t in got}) == 4
    st = stream.stats()
    assert (st["graphs"], st["replays"], st["eager"]) == (1, 3, 1)
    stream.release()
    assert stream.stats()["graphs"] == 1 and not stream._sample._scope.entries


def test_the_chain_binds_the_language_and_copies_u(card):
    """The chain's graph: u through a static buffer, the language matrices
    bound in place (donated), the mixing weight a static key."""
    corpus = P.SyntheticCorpus(vocab_size=32)
    uni, e, dt = P._language(corpus, torch.device("cpu"))
    sc = graphs.Scope(measure=True)
    with graphs.scope(sc):
        for s in range(3):
            u = torch.rand((2, 6), generator=torch.Generator().manual_seed(s))
            out = P.chain(u, uni, e, dt, corpus.mix_weight)
            assert torch.equal(out, P._chain(u, uni, e, dt,
                                             corpus.mix_weight))
    (entry,) = sc.entries.values()
    bufs = [x for x in entry.inputs if isinstance(x, torch.Tensor)]
    assert len(bufs) == 1 and bufs[0].shape == (2, 6)
    sc.close()
