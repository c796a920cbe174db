"""The tooling's compiled prefill and decode steps on a card (marked
``cuda``: they skip without one; this file imports no JAX):

    python -m pytest -q --noconftest -m cuda tests/test_torch_tooling_capture_cuda.py

``make_decode_step``'s step runs its first call eagerly, captures its
second over the params, the donated cache and an enc-dec's encoder
source (all bound in place) and replays from then on;
``make_prefill_step``'s over the params with the batch copied in.  Each
replay is held bitwise against the direct call (``step.__wrapped__``) from the same cache state (``Step.reset_cache``),
REDUCED configs in bf16: a plain decode, 2:4 weights served through K2
inside the graph (its launches added back by each replay), an int8
cache, whisper with and without its cross k/v cached, xLSTM's recurrent
state, and a prefill.  A decode that rebinds a cache tensor is refused;
``dryrun.timed_runs`` reports one graph, its pool and a bitwise replay;
the training stream's replayed draws are the eager ones.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.dist.sharding import MeshShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models.model_builder import build_model  # noqa: E402
from repro_torch.util.tree import data_ptrs, flatten  # noqa: E402

MESH = MeshShape(("data", "model"), (1, 1))
CELL = ShapeCell("decode_t", 64, 4, "decode")
REPLAYS = 3


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return resolve_device("cuda")


def _decode(arch: str, opts: S.DecodeOptions, dev, seed: int = 0):
    cfg = registry.get_config(arch, reduced=True).replace(dtype="bfloat16")
    step, _ = S.make_decode_step(build_model(cfg, device=dev), MESH, CELL,
                                 opts)
    return step, step.concrete_args(
        torch.Generator(device=dev).manual_seed(seed))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,opts", [
    ("tinyllama-1.1b", S.DecodeOptions()),
    ("tinyllama-1.1b", S.DecodeOptions(nm=(2, 4))),
    ("mistral-large-123b", S.DecodeOptions(kv_dtype="int8")),
    ("whisper-medium", S.DecodeOptions(cache_len=48, enc_len=40)),
    ("whisper-medium", S.DecodeOptions(cache_len=48, enc_len=40,
                                       cross_cache=True)),
    ("xlstm-1.3b", S.DecodeOptions()),
], ids=["plain", "nm24", "int8", "encdec", "encdec-crosskv", "xlstm"])
def test_decode_replays_are_the_direct_call_bitwise(cuda, arch, opts):
    from repro_torch.kernels import nm_spmm

    step, args = _decode(arch, opts, cuda)
    ptrs = data_ptrs(args[1])
    k2 = nm_spmm.nm_matmul_cuda.launches
    step.reset_cache(args[1])
    want, _ = step.__wrapped__(*args)
    per_step = nm_spmm.nm_matmul_cuda.launches - k2
    assert (per_step > 0) == bool(opts.nm)
    for _ in range(2 + REPLAYS):            # eager, capture, replays
        step.reset_cache(args[1])
        k2 = nm_spmm.nm_matmul_cuda.launches
        got, out = step(*args)
        torch.cuda.synchronize()
        assert out is args[1]
        assert data_ptrs(args[1]) == ptrs
        assert torch.equal(got, want)
        # a capture launches nothing; the warm-up and each replay count
        # the step's K2 launches
        assert nm_spmm.nm_matmul_cuda.launches - k2 in (0, per_step)
    st = step.stats()
    assert (st["graphs"], st["replays"]) == (1, 1 + REPLAYS)
    assert st["pool_bytes"] > 0
    step.release()


@pytest.mark.cuda
@pytest.mark.parametrize("cross", [False, True], ids=["enc", "crosskv"])
def test_the_encoder_source_is_read_in_place(cuda, cross):
    """The decode graph binds the encoder output (or its cross k/v) in
    place, as the params: a replay reads what the caller wrote there, and
    no static buffer holds it."""
    step, args = _decode("whisper-medium", S.DecodeOptions(
        cache_len=48, enc_len=40, cross_cache=cross), cuda)
    enc = flatten(args[4])[0]
    for _ in range(2):                      # eager, capture
        step.reset_cache(args[1])
        step(*args)
    for x in enc:
        x.mul_(0.5)
    step.reset_cache(args[1])
    want, _ = step.__wrapped__(*args)
    step.reset_cache(args[1])
    got, _ = step(*args)
    assert torch.equal(got, want)
    (entry,) = step.fn._scope.entries.values()
    assert sum(isinstance(x, torch.Tensor) for x in entry.inputs) == 2
    assert step.stats()["graphs"] == 1
    step.release()


@pytest.mark.cuda
def test_prefill_replays_are_the_direct_call_bitwise(cuda):
    cfg = registry.get_config("tinyllama-1.1b",
                              reduced=True).replace(dtype="bfloat16")
    step, _ = S.make_prefill_step(build_model(cfg, device=cuda), MESH,
                                  ShapeCell("p", 64, 2, "prefill"))
    gen = torch.Generator(device=cuda).manual_seed(0)
    params, batch = step.concrete_args(gen)
    want = step.__wrapped__(params, batch)
    for _ in range(2 + REPLAYS):
        assert torch.equal(step(params, batch), want)
    other = registry.concrete_batch(cfg, step.cell, gen, device=cuda)
    assert torch.equal(step(params, other), step.__wrapped__(params, other))
    assert step.stats()["graphs"] == 1
    step.release()


@pytest.mark.cuda
def test_a_rebound_cache_leaf_raises(cuda, monkeypatch):
    step, args = _decode("tinyllama-1.1b", S.DecodeOptions(), cuda)
    inner = step.model.decode_step

    def rebinding(p, c, tokens, pos, *rest):
        logits, c = inner(p, c, tokens, pos, *rest)
        c[0].k = c[0].k.clone()
        return logits, c

    monkeypatch.setattr(step.model, "decode_step", rebinding)
    with pytest.raises(RuntimeError, match="rebinds a cache tensor"):
        step(*args)
    step.release()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "xlstm-1.3b"])
def test_timed_runs_replay_bitwise(cuda, arch):
    step, _ = _decode(arch, S.DecodeOptions(), cuda)
    run = dryrun.timed_runs(step, 0, 3)
    assert run["bitwise"] and run["graphs"] == 1
    assert run["pool_bytes"] > 0 and run["peak"] > 0
    assert len(run["times"]) == len(run["eager_times"]) == 3
    assert step.fn._scope.pool is None


@pytest.mark.cuda
def test_train_stream_replays_are_the_eager_draws(cuda):
    from repro_torch.data import pipeline as P

    corpus = P.SyntheticCorpus(vocab_size=512)
    stream = P.TrainStream(corpus, global_batch=4, seq_len=32, seed=1,
                           device=cuda)
    for s in range(4):
        got = stream.batch_at(s)["tokens"]
        gen = torch.Generator(device=cuda).manual_seed(
            P._stream_seed(1, 0, s))
        assert torch.equal(got, P.sample_torch(corpus, gen, 4, 32))
    st = stream.stats()
    assert (st["graphs"], st["replays"]) == (1, 3)
    stream.release()


@pytest.mark.cuda
def test_calibration_on_the_card_is_numpys_draw(cuda):
    import numpy as np

    from repro_torch.data import pipeline as P

    cfg = registry.get_config("tinyllama-1.1b", reduced=True)
    got = P.calibration_batches(cfg, num_samples=8, seq_len=24, batch=4,
                                seed=11, device=cuda)
    corpus = P.SyntheticCorpus(vocab_size=cfg.vocab_size)
    for i, b in enumerate(got):
        assert b["tokens"].is_cuda
        assert np.array_equal(b["tokens"].cpu().numpy(), corpus.sample(
            np.random.default_rng([11, i]), 4, 24))
