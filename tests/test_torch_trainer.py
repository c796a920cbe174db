"""The port's trainer loop, training stream, training CLI and the paper's
sparse finetune on the CPU: the straggler watchdog's JAX test sequence; a
run killed after 4 of 8 steps and resumed from its checkpoint equal to an
uninterrupted run bitwise (params, both moments, the losses of steps 4–7);
``TrainStream`` pure in (seed, host_id, step) and host-sliced; the device
sampler's law against numpy's ``SyntheticCorpus.sample`` and the exact
law; the CLI's resume; and prune → sparse finetune on tinyllama REDUCED
against the JAX package's flow from the same 2:4-pruned tree and the same
JAX-drawn batches."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.pipeline import SyntheticCorpus as JCorpus  # noqa: E402
from repro.data.pipeline import TrainStream as JTrainStream  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import sparsity_preserving as j_sparse  # noqa: E402
from repro.optim.schedules import cosine_warmup as j_cosine  # noqa: E402
from repro.train.step import make_train_step as j_make_train_step  # noqa
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import (SyntheticCorpus,  # noqa: E402
                                       TrainStream, sample_torch)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.model_builder import build_model  # noqa: E402
from repro_torch.optim import (AdamW, cosine_warmup,  # noqa: E402
                               linear_warmup, sparsity_preserving)
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from repro_torch.train.trainer import StragglerWatchdog  # noqa: E402
from test_torch_fixtures import (assert_step_params_close,  # noqa: E402
                                 flat_numpy, jax_tree_to_numpy, t,
                                 train_pair)


def test_straggler_watchdog():
    wd = StragglerWatchdog(factor=3.0, beta=0.5, warmup=3)
    for _ in range(6):
        assert not wd.observe(0.10)
    assert wd.observe(0.45)          # 4.5× EWMA → flagged
    assert wd.flagged == 1
    # EWMA not poisoned by the straggler
    assert wd.ewma < 0.12
    assert not wd.observe(0.11)


def _trainer(model, total, d, cfg):
    stream = TrainStream(SyntheticCorpus(vocab_size=cfg.vocab_size),
                         global_batch=4, seq_len=32, device="cpu")
    return Trainer(model, AdamW(weight_decay=0.1, clip_norm=1.0),
                   linear_warmup(1e-3, 2, 8), stream,   # same horizon
                   TrainerConfig(total_steps=total, ckpt_dir=str(d),
                                 save_every=4, log_every=100,
                                 remat="block"))


def test_trainer_restart_bitwise(tmp_path):
    """Kill/restart reproduces the uninterrupted run bitwise (counter-based
    data + checkpointed optimizer ⇒ the same trajectory)."""
    cfg = get_config("tinyllama-1.1b", reduced=True)
    model = build_model(cfg, device="cpu")
    gen = lambda: torch.Generator().manual_seed(0)
    full = _trainer(model, 8, tmp_path / "full", cfg)
    p_full, o_full = full.run(gen())
    first = _trainer(model, 4, tmp_path / "resume", cfg)
    first.run(gen())
    logs: list[str] = []
    second = _trainer(model, 8, tmp_path / "resume", cfg)
    p_res, o_res = second.run(gen(), log=logs.append)
    assert logs[0] == "restored checkpoint at step 4"
    assert [h["step"] for h in second.history] == [4, 5, 6, 7]
    assert [h["loss"] for h in second.history] == \
        [h["loss"] for h in full.history[4:]]
    assert int(o_res.step) == int(o_full.step) == 8
    for a, b in ((p_full, p_res), (o_full.mu, o_res.mu),
                 (o_full.nu, o_res.nu)):
        fa, fb = flat_numpy(a), flat_numpy(b)
        assert fa.keys() == fb.keys()
        assert all(np.array_equal(fa[k], fb[k]) for k in fa)


def test_train_stream_pure_and_host_sliced():
    corpus = SyntheticCorpus(vocab_size=64)
    s = TrainStream(corpus, global_batch=6, seq_len=9, device="cpu")
    a, b = s.batch_at(5)["tokens"], s.batch_at(5)["tokens"]
    assert a.shape == (6, 9) and a.dtype == torch.int64
    assert torch.equal(a, b) and not torch.equal(a, s.batch_at(6)["tokens"])
    assert int(a.min()) >= 0 and int(a.max()) < 64
    assert torch.equal(next(iter(s))["tokens"], s.batch_at(0)["tokens"])
    hosts = [TrainStream(corpus, global_batch=6, seq_len=9, num_hosts=3,
                         host_id=h, device="cpu").batch_at(5)["tokens"]
             for h in range(3)]
    assert all(h.shape == (2, 9) for h in hosts)
    assert not torch.equal(hosts[0], hosts[1])
    other = TrainStream(corpus, global_batch=6, seq_len=9, seed=1,
                        device="cpu")
    assert not torch.equal(a, other.batch_at(5)["tokens"])
    with pytest.raises(ValueError, match="multiple of num_hosts"):
        TrainStream(corpus, global_batch=5, seq_len=9, num_hosts=2,
                    device="cpu")


def _exact_law(corpus):
    """(first-token law, transition matrix) of ``corpus``, in float64."""
    uni = corpus._unigram_probs()
    lang = np.random.default_rng([corpus.seed, 7])
    e = lang.normal(size=(corpus.vocab_size, corpus.mix_rank)) * 1.5
    d = e[lang.permutation(corpus.vocab_size)]
    big = e @ d.T
    big = np.exp(big - big.max(axis=1, keepdims=True))
    big /= big.sum(axis=1, keepdims=True)
    return uni, corpus.mix_weight * big + (1 - corpus.mix_weight) * uni


def _freqs(tokens: np.ndarray, V: int):
    first = np.bincount(tokens[:, 0], minlength=V) / tokens.shape[0]
    pairs = tokens[:, :-1] * V + tokens[:, 1:]
    big = np.bincount(pairs.ravel(), minlength=V * V) / pairs.size
    return first, big


def test_sampler_law_matches_numpy():
    """The torch sampler and numpy's against the exact law on V = 16:
    first-token and bigram frequencies from 4 096 rows of 24 tokens, each
    within total variation 0.03 of the exact law (the seeded draws sit at
    0.020 and 0.014; a mixing weight 0.1 off gives 0.09 on the bigrams, a
    Zipf exponent 1.0 for 1.1 gives 0.033 and 0.037) and of each other."""
    V, B, S = 16, 4096, 24
    corpus = SyntheticCorpus(vocab_size=V)
    tt = sample_torch(corpus, torch.Generator().manual_seed(3), B, S).numpy()
    nt = corpus.sample(np.random.default_rng(3), B, S)
    uni, trans = _exact_law(corpus)
    dist, big = uni.copy(), np.zeros((V, V))
    for _ in range(S - 1):                 # bigram law averaged over t
        big += dist[:, None] * trans
        dist = dist @ trans
    big = (big / (S - 1)).ravel()
    tv = lambda p, q: 0.5 * float(np.abs(p - q).sum())
    (tf, tb), (nf, nb) = _freqs(tt, V), _freqs(nt, V)
    for f, b in ((tf, tb), (nf, nb)):
        assert tv(f, uni) < 0.03 and tv(b, big) < 0.03
    assert tv(tf, nf) < 0.03 and tv(tb, nb) < 0.03


def test_cli_trains_and_resumes_on_cpu(tmp_path, capsys):
    argv = ["--device", "cpu", "--steps", "4", "--save-every", "2",
            "--ckpt-dir", str(tmp_path), "--batch", "2", "--seq", "32"]
    tr = train_cli.main(argv)
    out = capsys.readouterr().out
    assert "done: first loss" in out and len(tr.history) == 4
    assert "restored" not in out
    tr = train_cli.main(argv[:3] + ["6"] + argv[4:])
    out = capsys.readouterr().out
    assert "restored checkpoint at step 4" in out.splitlines()[0]
    assert [h["step"] for h in tr.history] == [4, 5]
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    assert "checkpoint: step 6" in out


def _nm_masks(params: dict, n: int = 2, m: int = 4) -> dict:
    """2:4 magnitude masks (1 = pruned) of every block linear kernel,
    (in, out), groups of m along the input dim."""
    masks = {}
    for i, blk in params["blocks"].items():
        for group, lins in blk.items():
            for name, leaf in lins.items():
                if not (isinstance(leaf, dict) and "w" in leaf):
                    continue
                w = np.abs(np.asarray(leaf["w"], np.float32))
                g = w.reshape(w.shape[0] // m, m, w.shape[1])
                rank = np.argsort(np.argsort(g, axis=1, kind="stable"),
                                  axis=1, kind="stable")
                masks[("blocks", i, group, name, "w")] = \
                    (rank < n).reshape(w.shape).astype(np.float32)
    return masks


def test_sparse_finetune_matches_jax():
    """prune → 3 sparse-finetune steps (``examples/sparse_finetune.py``'s
    optimizer and schedule) in both packages: pruned coordinates stay
    exactly 0, and the params after 3 steps agree within 1e-6 + 1e-4·|p|
    outside the lr·sign(g) coordinates (|Δ| ≤ 2·Σlr there)."""
    jmodel, jparams, _, model, _, _ = train_pair("tinyllama-1.1b")
    jnp_params = jax_tree_to_numpy(jparams)
    masks = _nm_masks(jnp_params)
    jpruned = jax.tree.map(lambda x: x, jnp_params)
    for (_, i, grp, name, _w), mk in masks.items():
        jpruned["blocks"][i][grp][name]["w"] = \
            jpruned["blocks"][i][grp][name]["w"] * (1 - mk)
    pruned = params_from_numpy(jpruned, device="cpu")
    kw = dict(weight_decay=0.01, clip_norm=1.0)
    jopt = j_sparse(JAdamW(**kw), {k: jnp.asarray(v)
                                   for k, v in masks.items()})
    opt = sparsity_preserving(AdamW(**kw), {k: t(v)
                                            for k, v in masks.items()})
    jstep = j_make_train_step(jmodel, jopt, j_cosine(5e-4, 2, 16),
                              remat="none", donate=False)
    step = make_train_step(model, opt, cosine_warmup(5e-4, 2, 16),
                           remat="block")
    cfg = get_config("tinyllama-1.1b", reduced=True)
    stream = JTrainStream(JCorpus(vocab_size=cfg.vocab_size),
                          global_batch=4, seq_len=32)
    jp = jax.tree.map(jnp.asarray, jpruned)
    js, s, p = jopt.init(jp), opt.init(pruned), pruned
    lrs = []
    for i in range(3):
        tok = np.asarray(stream.batch_at(1000 + i)["tokens"])
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(tok)})
        p, s, m = step(p, s, {"tokens": torch.from_numpy(np.array(tok)).long()})
        lrs.append(float(jm["lr"]))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            1e-5 * abs(float(jm["loss"]))
    got, want = flat_numpy(p), flat_numpy(jax_tree_to_numpy(jp))
    for (_, i, grp, name, w), mk in masks.items():
        key = ("blocks", i, grp, name, w)
        assert (got[key][mk > 0.5] == 0).all()
        assert (want[key][mk > 0.5] == 0).all()
    # the last step's grads decide where lr·sign(g) may differ; all three
    # steps' lr bound the drift there
    jgrads = jax.grad(jmodel.loss)(jp, {"tokens": jnp.asarray(tok)})
    assert_step_params_close(jax_tree_to_numpy(jp), p,
                             jax_tree_to_numpy(jgrads), sum(lrs))
