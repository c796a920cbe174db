"""Resilient prune jobs: crash-safe journaling and exact resume (port of
``repro/core/jobs.py``).

A block-wise prune of a large model is a long sequential job whose state
(the calibration carries, the cross-block Hessian accumulators) lives only
in process memory.  ``PruneJob`` makes it restartable with
**bitwise-identical** output:

* Every completed layer is journaled to ``job_dir/layers/`` the moment it
  is solved: the pruned kernel + mask (``NNNNN.npz``) first, then the
  ``LayerReport`` fragment (``NNNNN.json``) — the *fragment* is the
  completion marker, so a crash between the two leaves an orphan ``.npz``
  that the resume simply overwrites.  All writes are atomic (tmp + fsync
  + ``os.replace`` via ``repro_torch.util.io``).

* ``job_dir/manifest.json`` pins everything the run depends on — the
  recipe as passed, the **expanded** plan (sparsity allocation runs
  exactly once, before the first journal write), the numerical-guard
  policy, and a SHA-256 digest of the calibration batches.  Resume
  validates all of it and refuses to continue a journal that belongs to
  a different run.

* Resume does **not** skip forward passes.  Pass-1 capture replays for
  every block, so cross-block state — weight-shared Hessian accumulators,
  the carries entering later blocks — is bitwise that of an uninterrupted
  run; only the per-layer solves of journaled layers become loads.

Tensors are stored as raw bytes + dtype string + shape, as the JAX
journal stores them: numpy has no bf16, so the bytes are taken through a
``uint8`` view of the tensor and read back with ``torch.frombuffer``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import re
from typing import Any

import numpy as np
import torch

from repro_torch.core.plan import PruneConfig, PrunePlan, as_plan
from repro_torch.core.schedule import (LayerReport, PruneReport,
                                       collect_hessian_stats, prune_model)
from repro_torch.faults import FaultPlan, JournalWriteError
from repro_torch.util.io import atomic_write_bytes, atomic_write_json

Tensor = torch.Tensor

JOURNAL_VERSION = 1
_FRAGMENT_RE = re.compile(r"^(\d{5})\.json$")


def _tensor_bytes(t: Tensor) -> tuple[bytes, str, list[int]]:
    t = t.detach().cpu().contiguous()
    raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return raw, str(t.dtype).removeprefix("torch."), list(t.shape)


def _tensor_from(raw: bytes, dtype: str, shape) -> Tensor:
    return torch.frombuffer(bytearray(raw), dtype=getattr(torch, dtype)
                            ).reshape(tuple(shape))


def batch_digest(batches) -> str:
    """SHA-256 over the calibration stream (batches are dicts of tensors or
    bare tensors): each batch's keys in sorted order, each leaf's shape,
    then its values as little-endian int64 (integer leaves) or float32
    (floating leaves; bf16 widens exactly).  The fixed dtypes make the
    digest the same for the same batches on the host and on the card.  Identical batches ⇒ identical Hessians ⇒
    resume parity; a changed stream must be detected, not blended with
    journaled layers."""
    h = hashlib.sha256()
    for b in batches:
        leaves = sorted(b.items()) if isinstance(b, dict) else [("", b)]
        for key, t in leaves:
            t = t.detach().cpu()
            a = (t.to(torch.float32).numpy().astype("<f4")
                 if t.is_floating_point()
                 else t.to(torch.int64).numpy().astype("<i8"))
            h.update(str((key, tuple(t.shape))).encode())
            h.update(a.tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class LayerRecord:
    """One journaled layer: the report fragment plus (for pruned layers)
    the replacement kernel in storage layout (in, out) and its mask."""

    report: LayerReport
    kernel: Tensor | None = None
    mask: Tensor | None = None


class PruneJournal:
    """Append-only per-layer journal under ``job_dir``.

    ``completed`` is the length of the *contiguous* fragment prefix
    ``00000.json .. NNNNN.json`` — a gap means everything after it is
    state from a torn run and is ignored (and overwritten on resume).
    Stray ``*.tmp`` files from interrupted atomic writes never match the
    fragment pattern.
    """

    def __init__(self, job_dir: str):
        self.job_dir = job_dir
        self.layers_dir = os.path.join(job_dir, "layers")
        os.makedirs(self.layers_dir, exist_ok=True)
        self.completed = self._scan()

    def _fragment(self, ordinal: int) -> str:
        return os.path.join(self.layers_dir, f"{ordinal:05d}.json")

    def _payload(self, ordinal: int) -> str:
        return os.path.join(self.layers_dir, f"{ordinal:05d}.npz")

    def _scan(self) -> int:
        done = {int(m.group(1)) for name in os.listdir(self.layers_dir)
                if (m := _FRAGMENT_RE.match(name))}
        n = 0
        while n in done:
            n += 1
        return n

    def write(self, ordinal: int, report: LayerReport, *,
              kernel: Tensor | None = None, mask: Tensor | None = None,
              faults: FaultPlan | None = None) -> None:
        """Journal one completed layer: payload (.npz) before fragment
        (.json), the fragment's existence being the commit point.  The
        ``journal_write`` site fires before anything is written, so an
        injected failure leaves the journal as it was."""
        if faults is not None and faults.fire("journal_write") is not None:
            raise JournalWriteError(
                f"injected journal failure (layer {ordinal})",
                site="journal_write")
        frag: dict[str, Any] = {"version": JOURNAL_VERSION,
                                "report": report.to_dict(),
                                "has_payload": kernel is not None}
        if kernel is not None:
            kraw, kdt, kshape = _tensor_bytes(kernel)
            arrs = {"kernel": np.frombuffer(kraw, np.uint8)}
            frag["kernel_dtype"], frag["kernel_shape"] = kdt, kshape
            if mask is not None:
                mraw, mdt, mshape = _tensor_bytes(mask)
                arrs["mask"] = np.frombuffer(mraw, np.uint8)
                frag["mask_dtype"], frag["mask_shape"] = mdt, mshape
            buf = io.BytesIO()
            np.savez(buf, **arrs)
            atomic_write_bytes(self._payload(ordinal), buf.getvalue())
        atomic_write_json(self._fragment(ordinal), frag)
        self.completed = max(self.completed, ordinal + 1)

    def load(self, ordinal: int) -> LayerRecord:
        """The journaled layer ``ordinal``; tensors come back on the host."""
        with open(self._fragment(ordinal)) as f:
            frag = json.load(f)
        if frag.get("version") != JOURNAL_VERSION:
            raise ValueError(
                f"journal fragment {ordinal} has version "
                f"{frag.get('version')!r}, expected {JOURNAL_VERSION}")
        report = LayerReport.from_dict(frag["report"])
        kernel = mask = None
        if frag.get("has_payload"):
            with np.load(self._payload(ordinal)) as z:
                kernel = _tensor_from(z["kernel"].tobytes(),
                                      frag["kernel_dtype"],
                                      frag["kernel_shape"])
                if "mask" in z.files:
                    mask = _tensor_from(z["mask"].tobytes(),
                                        frag["mask_dtype"],
                                        frag["mask_shape"])
        return LayerRecord(report=report, kernel=kernel, mask=mask)


class _MeshJournal:
    """The journal as the ranks of a mesh share it: the lead rank (rank 0
    of the mesh) writes, every rank reads, and each write's outcome is
    broadcast, so a failed write raises on every rank at the same layer and
    no rank runs on into a collective the others never reach."""

    def __init__(self, journal: PruneJournal, mesh, lead: bool, group):
        self.journal, self.lead, self.group = journal, lead, group
        self.device = torch.device(mesh.device_type)

    @property
    def completed(self) -> int:
        return self.journal.completed

    def load(self, ordinal: int) -> LayerRecord:
        return self.journal.load(ordinal)

    def write(self, ordinal: int, report: LayerReport, **kw) -> None:
        import torch.distributed as dist

        err = None
        if self.lead:
            try:
                self.journal.write(ordinal, report, **kw)
            except Exception as e:      # re-raised below, after the vote
                err = e
        flag = torch.tensor([err is not None], dtype=torch.int32,
                            device=self.device)
        dist.broadcast(flag, src=dist.get_global_rank(self.group, 0),
                       group=self.group)
        if err is not None:
            raise err
        if int(flag[0]):
            raise JournalWriteError(
                f"journal write failed on the lead rank (layer {ordinal})",
                site="journal_write")


class PruneJob:
    """Journaled ``prune_model`` run rooted at ``job_dir``.

    Fresh run: expands the plan's sparsity allocation (once), writes the
    manifest, then drives ``prune_model`` with a journal.  ``resume=True``
    validates the manifest against the caller's recipe + batches and
    continues from the last completed layer; the output is bitwise that of
    an uninterrupted run.  The final artifact is ``job_dir/report.json``
    (atomic) — its presence marks the job finished, and resuming a
    finished job replays entirely from the journal.

    ``mesh`` (a DeviceMesh) runs every layer solve row-parallel
    (``prune_model(mesh=)``); every rank of the mesh runs the job with the
    same arguments.  The lead rank (rank 0 of the mesh) alone writes the
    manifest, the journal and the report; every rank validates the manifest
    and resumes from the journal.
    """

    MANIFEST = "manifest.json"
    REPORT = "report.json"

    def __init__(self, job_dir: str, *, on_singular: str = "escalate",
                 max_escalations: int = 4, min_calib_samples: int = 1,
                 faults: FaultPlan | None = None, mesh=None):
        self.job_dir = job_dir
        self.on_singular = on_singular
        self.max_escalations = max_escalations
        self.min_calib_samples = min_calib_samples
        self.faults = faults
        self.mesh = mesh

    def _manifest_path(self) -> str:
        return os.path.join(self.job_dir, self.MANIFEST)

    def report_path(self) -> str:
        return os.path.join(self.job_dir, self.REPORT)

    def _build_manifest(self, recipe: PrunePlan, plan: PrunePlan,
                        digest: str, num_batches: int) -> dict:
        return {
            "version": JOURNAL_VERSION,
            "recipe": recipe.to_dict(),
            "plan": plan.to_dict(),
            "on_singular": self.on_singular,
            "max_escalations": self.max_escalations,
            "min_calib_samples": self.min_calib_samples,
            "num_batches": num_batches,
            "batch_digest": digest,
        }

    def _ranks(self):
        """(lead, group, barrier) for this process: the lead is rank 0 of
        the mesh's group; without a mesh the process leads alone and the
        barrier does nothing."""
        if self.mesh is None:
            return True, None, lambda: None
        import torch.distributed as dist

        from repro_torch.dist.prune import axis_group
        from repro_torch.dist.sharding import axis_names

        group = axis_group(self.mesh, axis_names(self.mesh)).group
        return (dist.get_rank(group) == 0, group,
                lambda: dist.barrier(group=group))

    def run(self, params, adapter, batches,
            plan: "PrunePlan | PruneConfig", *, resume: bool = False,
            keep_masks: bool = True, progress=None
            ) -> tuple[Any, PruneReport]:
        lead, group, barrier = self._ranks()
        recipe = as_plan(plan)
        batches = list(batches)
        digest = batch_digest(batches)
        manifest_path = self._manifest_path()

        if resume:
            if not os.path.exists(manifest_path):
                raise FileNotFoundError(
                    f"--resume: no manifest at {manifest_path} — nothing "
                    "to resume (start without --resume to begin a job)")
            with open(manifest_path) as f:
                manifest = json.load(f)
            if manifest.get("version") != JOURNAL_VERSION:
                raise ValueError(
                    f"job manifest version {manifest.get('version')!r} != "
                    f"{JOURNAL_VERSION}")
            if manifest["recipe"] != recipe.to_dict():
                raise ValueError(
                    "--resume: plan does not match the journaled job "
                    f"(manifest {manifest_path}); refusing to blend "
                    "journaled layers from a different recipe")
            if manifest["batch_digest"] != digest:
                raise ValueError(
                    "--resume: calibration batches differ from the "
                    "journaled job (digest mismatch); resumed Hessians "
                    "would not match journaled layers")
            if manifest["on_singular"] != self.on_singular or \
                    manifest["max_escalations"] != self.max_escalations or \
                    manifest["min_calib_samples"] != self.min_calib_samples:
                raise ValueError(
                    "--resume: numerical-guard policy differs from the "
                    "journaled job (on_singular/max_escalations/"
                    "min_calib_samples must match the original run)")
            # the manifest's expanded plan is authoritative: allocation
            # ran exactly once, in the original run
            run_plan = PrunePlan.from_dict(manifest["plan"])
        else:
            if os.path.exists(manifest_path):
                raise FileExistsError(
                    f"job dir {self.job_dir} already holds a job "
                    f"({manifest_path} exists); pass resume=True to "
                    "continue it or choose a fresh --job-dir")
            run_plan = recipe
            if run_plan.allocation is not None:
                run_plan = run_plan.allocate_sparsity(
                    collect_hessian_stats(params, adapter, batches))
            barrier()           # every rank has seen the job dir free
            if lead:
                os.makedirs(self.job_dir, exist_ok=True)
                atomic_write_json(
                    manifest_path, self._build_manifest(
                        recipe, run_plan, digest, len(batches)))
        barrier()               # the manifest is down before any journal

        journal = PruneJournal(self.job_dir)
        if self.mesh is not None:
            journal = _MeshJournal(journal, self.mesh, lead, group)
        pruned, report = prune_model(
            params, adapter, batches, run_plan, keep_masks=keep_masks,
            progress=progress, journal=journal, faults=self.faults,
            mesh=self.mesh, on_singular=self.on_singular,
            max_escalations=self.max_escalations,
            min_calib_samples=self.min_calib_samples)
        if lead:
            report.save(self.report_path())
        barrier()
        return pruned, report
