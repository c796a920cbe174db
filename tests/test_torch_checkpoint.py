"""The port's checkpointer on the CPU: the JAX package's checkpoint tests
ported (round trip with bf16 and int keys over 3 shards; atomic renames
and retention; a stale ``.tmp`` ignored; restore across shard counts 1, 2
and 8), then the shared on-disk format both ways — a checkpoint written by
the JAX package loads in the port and one written by the port loads in the
JAX package, bitwise, with the same file names and equal manifests."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_checkpoint as j_load  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint.checkpointer import checkpoint_bytes  # noqa
from test_torch_fixtures import t  # noqa: E402


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "a": {"w": torch.arange(131072, dtype=torch.float32).reshape(256,
                                                                     512)},
        "b": {"x": torch.ones((7,), dtype=torch.bfloat16),
              "blocks": {0: {"k": torch.zeros((3, 3))},
                         1: {"k": torch.ones((3, 3))}}},
        "step": torch.tensor(5, dtype=torch.int32),
    }
    save_checkpoint(str(tmp_path), 42, tree, num_shards=3)
    assert sorted(os.listdir(tmp_path / "step_00000042")) == [
        "manifest.json", "shard_00000.npz", "shard_00001.npz",
        "shard_00002.npz"]
    step, back = load_checkpoint(str(tmp_path))
    assert step == 42
    assert back["b"]["x"].dtype == torch.bfloat16
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 5
    assert set(back["b"]["blocks"].keys()) == {0, 1}   # int keys restored
    assert torch.equal(back["a"]["w"], tree["a"]["w"])
    assert back["a"]["w"].device.type == "cpu"
    man = json.loads((tmp_path / "step_00000042" / "manifest.json")
                     .read_text())
    assert man["leaves"]["a/w"]["split"] == [86, 85, 85]


def test_checkpoint_atomic_and_retention(tmp_path):
    tree = {"w": torch.ones((8, 8))}
    for s in (10, 20, 30, 40):
        save_checkpoint(str(tmp_path), s, tree, keep_last=2)
    assert latest_step(str(tmp_path)) == 40
    steps = sorted(int(n[5:]) for n in os.listdir(tmp_path)
                   if n.startswith("step_") and not n.endswith(".tmp"))
    assert steps == [30, 40]
    # a stale .tmp dir must be ignored by restore
    os.makedirs(tmp_path / "step_00000099.tmp", exist_ok=True)
    assert latest_step(str(tmp_path)) == 40
    assert load_checkpoint(str(tmp_path))[0] == 40
    assert checkpoint_bytes(str(tmp_path), 40) > 8 * 8 * 4


def test_manager_saves_every_n_and_restores(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every=3)
    assert mgr.restore_latest() == (None, None)
    saved = [s for s in range(1, 8)
             if mgr.maybe_save(s, {"w": torch.full((2,), float(s))})]
    assert saved == [3, 6] and mgr.save_seconds > 0
    step, tree = mgr.restore_latest()
    assert step == 6 and float(tree["w"][0]) == 6.0
    assert mgr.restore_seconds > 0


@pytest.mark.parametrize("shards", [1, 2, 8])
def test_elastic_restore_across_shard_counts(tmp_path, shards):
    rng = np.random.default_rng(0)
    tree = {"blocks": {i: {"w": t(rng.normal(size=(64, 128)).astype(
        np.float32))} for i in range(4)},
        "norm": {"scale": torch.ones((128,), dtype=torch.bfloat16)}}
    save_checkpoint(str(tmp_path), 7, tree, num_shards=shards,
                    shard_threshold=1024)
    step, back = load_checkpoint(str(tmp_path))
    assert step == 7
    for i in range(4):
        assert torch.equal(back["blocks"][i]["w"], tree["blocks"][i]["w"])
    assert back["norm"]["scale"].dtype == torch.bfloat16


def _numpy_tree(rng):
    """A tree with every leaf kind the trainer writes: fp32 and bf16
    kernels (split and not), int keys, a 0-d int32 step."""
    return {"params": {"blocks": {0: {"w": rng.normal(size=(300, 257)),
                                      "b": rng.normal(size=(257,))},
                                  1: {"w": rng.normal(size=(2, 70000))}},
                       "embed": {"table": rng.normal(size=(520, 128))}},
            "opt": {"step": np.int32(3),
                    "mu": {"x": rng.normal(size=(9, 4))}}}


def _as(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _as(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _dtype(path):
    if path[-1] == "step":
        return np.int32
    return jnp.bfloat16 if path[-1] in ("w", "table") and \
        path[1] in (0, "embed") else np.float32


def _bits(x) -> np.ndarray:
    a = np.asarray(x) if not isinstance(x, torch.Tensor) else (
        x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
        else x.numpy())
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


@pytest.mark.parametrize("shards", [1, 4])
def test_cross_format_both_ways(tmp_path, shards):
    rng = np.random.default_rng(5)
    src = _numpy_tree(rng)
    jtree = _as(src, lambda p, a: jnp.asarray(a, _dtype(p)))
    ttree = _as(jtree, lambda p, a: t(np.asarray(a)))
    j_save(str(tmp_path / "jax"), 11, jtree, num_shards=shards)
    save_checkpoint(str(tmp_path / "port"), 11, ttree, num_shards=shards)
    dj, dp = tmp_path / "jax" / "step_00000011", \
        tmp_path / "port" / "step_00000011"
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dp))
    assert json.loads((dj / "manifest.json").read_text()) == \
        json.loads((dp / "manifest.json").read_text())
    for name in sorted(os.listdir(dj)):
        if name.endswith(".npz"):
            with np.load(dj / name) as a, np.load(dp / name) as b:
                assert sorted(a.files) == sorted(b.files)
                assert all(np.array_equal(a[k], b[k]) and
                           a[k].dtype == b[k].dtype for k in a.files)
    want = _flat(jtree)
    # JAX save → port load
    step, back = load_checkpoint(str(tmp_path / "jax"))
    got = _flat(back)
    assert step == 11 and got.keys() == want.keys()
    for k, w in want.items():
        assert str(got[k].dtype).split(".")[-1] == str(np.asarray(w).dtype)
        assert np.array_equal(_bits(got[k]), _bits(w)), k
    # port save → JAX load
    step, jback = j_load(str(tmp_path / "port"))
    got = _flat(jback)
    assert step == 11 and got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == np.asarray(w).dtype
        assert np.array_equal(_bits(got[k]), _bits(w)), k


@pytest.mark.parametrize("compressed", [False, True])
def test_shard_reader_matches_np_load(tmp_path, compressed):
    """The direct shard reader against ``np.load``: C and Fortran order, a
    0-d and an empty member; a compressed archive falls back to np.load."""
    from repro_torch.checkpoint.checkpointer import _read_npz

    a = {"f": np.asfortranarray(np.arange(12.0).reshape(3, 4)),
         "c": np.arange(10, dtype=np.uint16).reshape(2, 5),
         "z": np.int32(7), "e": np.zeros((0, 3), np.float32)}
    path = str(tmp_path / "s.npz")
    (np.savez_compressed if compressed else np.savez)(path, **a)
    got = _read_npz(path)
    with np.load(path) as want:
        assert sorted(got) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype
            assert got[k].shape == want[k].shape
            assert np.array_equal(got[k], want[k])
