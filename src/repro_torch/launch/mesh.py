"""Production and debug meshes (port of ``repro/launch/mesh.py``).

Topology of the production layout:
  single-pod  (16, 16)        axes ("data", "model")         = 256 devices
  multi-pod   (2, 16, 16)     axes ("pod", "data", "model")  = 512 devices

The production meshes are ``MeshShape``s: the spec functions of
``dist/sharding.py`` read only axis names and sizes, so a 16 × 16 layout is
derived with no ranks at all.  The debug mesh is a real ``DeviceMesh`` over
the ranks of the current process group, as ``dist/`` takes it.
"""
from __future__ import annotations

import torch

from repro_torch.dist.sharding import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_debug_mesh(devices=None, *, device_type: str = "cuda"):
    """An (n, 1) ("data", "model") ``DeviceMesh`` over ``devices`` (ranks of
    the current group; default every rank of it).  Without a process group
    this process starts a one-rank gloo group on an in-memory store, so
    ``make_debug_mesh(device_type="cpu")`` is 1 × 1, as JAX's is on one CPU
    device."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    ranks = list(devices) if devices is not None else \
        list(range(dist.get_world_size()))
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(len(ranks), 1),
                      mesh_dim_names=("data", "model"))
