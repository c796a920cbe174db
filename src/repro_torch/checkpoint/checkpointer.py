"""Sharded, atomic, elastically-restorable checkpointing (port of
``repro/checkpoint/checkpointer.py``; the same on-disk format, so a
checkpoint written by either package loads in the other).

Layout of one checkpoint:

    <dir>/step_000123/
        manifest.json        tree structure, leaf→shard map, dtypes, step
        shard_00000.npz      leaf arrays (split by leading axis over shards)
        shard_00001.npz
        ...

* **Atomicity** — everything is written into ``step_X.tmp`` and renamed to
  ``step_X`` only after the manifest is fsync'd; restore ignores ``.tmp``.
* **Sharding** — leaves of at least ``shard_threshold`` elements whose
  leading axis is at least ``num_shards`` are split along axis 0; every
  other leaf goes to shard 0.  bfloat16 is stored as its uint16 bits.
* **Elastic restore** — the manifest stores logical shapes; restore returns
  full logical CPU tensors, and the caller places them.
* **Retention** — the newest ``keep_last`` steps are kept.

The shard files are written and read on one thread each.  A shard is read
straight from the archive (``np.savez`` stores its members uncompressed):
one seek and one ``readinto`` a leaf instead of ``np.load``'s 256 KiB
chunks through ``zipfile``, the slow part of restoring a full-size model.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import struct
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.util.io import atomic_write_json

SEP = "/"
# a zip local file header: signature, 5 × u16, 3 × u32, name and extra sizes
_LOCAL_HEADER = struct.Struct("<4s5H3L2H")


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in sorted(tree.items(), key=lambda kv: str(kv[0])):
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (str(i),)))
        return out
    return {SEP.join(prefix): tree}


def _unflatten(flat: dict, treedef_meta: dict):
    """Rebuild nested dicts (int keys restored where the manifest says)."""
    root: dict = {}
    for key, leaf in flat.items():
        parts = key.split(SEP)
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    int_keys = set(treedef_meta.get("int_key_paths", []))

    def fix(node, prefix=()):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            key_path = SEP.join(prefix + (k,))
            kk = int(k) if key_path in int_keys else k
            out[kk] = fix(v, prefix + (k,))
        return out

    return fix(root)


def _int_key_paths(tree, prefix=()):
    """Record which dict keys were ints so restore round-trips exactly."""
    paths = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            p = prefix + (str(k),)
            if isinstance(k, int):
                paths.append(SEP.join(p))
            paths.extend(_int_key_paths(v, p))
    return paths


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """→ (array as stored, dtype tag); bfloat16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype_tag: str) -> torch.Tensor:
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = arr.copy(order="C")         # keeps a 0-d leaf 0-d
    if dtype_tag == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(
    directory: str,
    step: int,
    tree,
    *,
    num_shards: int = 4,
    shard_threshold: int = 1 << 16,
    keep_last: int = 3,
) -> str:
    """Write one atomic checkpoint; returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {
        "step": step,
        "format": 1,
        "num_shards": num_shards,
        "leaves": {},
        "int_key_paths": _int_key_paths(tree),
    }
    shards: list[dict[str, np.ndarray]] = [{} for _ in range(num_shards)]

    for key, leaf in _flatten(tree).items():
        stored, dtype_tag = _to_numpy(leaf)
        entry = {"shape": list(stored.shape), "dtype": dtype_tag}
        if stored.size >= shard_threshold and stored.ndim >= 1 and \
                stored.shape[0] >= num_shards:
            pieces = np.array_split(stored, num_shards, axis=0)
            entry["split"] = [int(p.shape[0]) for p in pieces]
            for s, piece in enumerate(pieces):
                shards[s][key] = piece
        else:
            entry["split"] = None
            shards[0][key] = stored
        manifest["leaves"][key] = entry

    with ThreadPoolExecutor(num_shards) as pool:
        list(pool.map(lambda sp: np.savez(
            os.path.join(tmp, f"shard_{sp[0]:05d}.npz"), **sp[1]),
            enumerate(shards)))
    atomic_write_json(os.path.join(tmp, "manifest.json"), manifest,
                      indent=None)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    # retention
    for old in latest_steps(directory)[:-keep_last]:
        shutil.rmtree(os.path.join(directory, f"step_{old:08d}"),
                      ignore_errors=True)
    return final


def latest_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                out.append(int(name[len("step_"):]))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = latest_steps(directory)
    return steps[-1] if steps else None


def load_checkpoint(directory: str, step: int | None = None):
    """→ (step, tree of CPU tensors with logical shapes)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    n = manifest["num_shards"]
    with ThreadPoolExecutor(n) as pool:
        shards = list(pool.map(
            lambda s: _read_npz(os.path.join(path, f"shard_{s:05d}.npz")),
            range(n)))
    flat = {}
    for key, entry in manifest["leaves"].items():
        if entry["split"] is None:
            arr = shards[0][key]
        else:
            arr = np.concatenate([sh[key] for sh in shards if key in sh],
                                 axis=0)
        flat[key] = _to_tensor(arr, entry["dtype"])
    return step, _unflatten(flat, manifest)


def _read_npz(path: str) -> dict[str, np.ndarray]:
    """Every array of an ``np.savez`` archive: each stored member's bytes
    read straight into a new array; ``np.load`` reads the archive if a
    member is compressed or has a header format this reader does not
    know."""
    with zipfile.ZipFile(path) as zf:
        infos = zf.infolist()
    out = {}
    with open(path, "rb") as f:
        for info in infos:
            if info.compress_type != zipfile.ZIP_STORED:
                break
            f.seek(info.header_offset)
            head = _LOCAL_HEADER.unpack(f.read(_LOCAL_HEADER.size))
            f.seek(info.header_offset + _LOCAL_HEADER.size + head[-2]
                   + head[-1])
            version = np.lib.format.read_magic(f)
            if version not in ((1, 0), (2, 0)):
                break
            read_header = (np.lib.format.read_array_header_1_0
                           if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            if dtype.hasobject:
                break
            arr = np.empty(shape, dtype, order="F" if fortran else "C")
            buf = arr.reshape(-1, order="A").view(np.uint8)
            got = 0
            while got < buf.size:
                k = f.readinto(buf[got:])
                if not k:
                    raise EOFError(f"{path}: {info.filename} is truncated")
                got += k
            out[info.filename.removesuffix(".npy")] = arr
        else:
            return out
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def checkpoint_bytes(directory: str, step: int) -> int:
    """Bytes on disk of one checkpoint."""
    path = os.path.join(directory, f"step_{step:08d}")
    return sum(os.path.getsize(os.path.join(path, n))
               for n in os.listdir(path))


@dataclasses.dataclass
class CheckpointManager:
    """Save-every-N orchestration used by the trainer.  Wall seconds of the
    last save and restore are kept in ``save_seconds``/``restore_seconds``
    (0.0 until one happens)."""

    directory: str
    save_every: int = 100
    keep_last: int = 3
    num_shards: int = 4
    save_seconds: float = dataclasses.field(default=0.0, init=False)
    restore_seconds: float = dataclasses.field(default=0.0, init=False)

    def maybe_save(self, step: int, tree) -> bool:
        if step % self.save_every != 0:
            return False
        t0 = time.perf_counter()
        save_checkpoint(
            self.directory, step, tree,
            num_shards=self.num_shards, keep_last=self.keep_last,
        )
        self.save_seconds = time.perf_counter() - t0
        return True

    def restore_latest(self):
        """→ (step, tree) or (None, None) when no checkpoint exists."""
        t0 = time.perf_counter()
        try:
            out = load_checkpoint(self.directory)
        except FileNotFoundError:
            return None, None
        self.restore_seconds = time.perf_counter() - t0
        return out
