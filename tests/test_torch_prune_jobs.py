"""The port's resumable prune jobs (``repro_torch/core/jobs.py``) on the
CPU, mirroring tests/test_prune_jobs.py and held against the JAX package.

The property under test: a job killed at any layer boundary (by the
``journal_write`` or ``calib_batch`` fault site) and resumed gives params,
masks and per-layer reports **bitwise** equal to one uninterrupted run —
on a tiny 2-block tanh MLP (4 journaled layers) in both sparsity patterns,
and on tinyllama REDUCED through the CLI.  The journal keeps bf16 bytes
exactly; resume refuses a manifest of another run; the three prune sites
(``calib_batch``, ``hessian_accum``, ``cholesky``) act as in JAX; and the
report JSON equals JAX's on the same inputs apart from timing (``seconds``
is left out; ``obs_loss`` within rtol 1e-4, an fp32 sum over two
solvers; every other field exactly).
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.faults import FaultPlan as JFaultPlan  # noqa: E402
from repro_torch.core import (LayerReport, PruneConfig, PruneJob,  # noqa
                              PruneJournal, PrunePlan, PruneRule,
                              batch_digest, prune_model)
from repro_torch.core.jobs import _tensor_bytes  # noqa: E402
from repro_torch.faults import (CalibrationError, FaultPlan,  # noqa: E402
                                JournalWriteError, SingularHessian)
from repro_torch.launch import prune as prune_cli  # noqa: E402
from test_torch_fixtures import n  # noqa: E402

NAMES = ("fc1", "fc2")
D, NBLOCKS = 16, 2


class TinyAdapter:
    """2 blocks × (fc1, fc2) tanh MLP over tensors (kernels (in, out))."""

    def num_blocks(self, params):
        return len(params["blocks"])

    def prepare(self, params, batch):
        return batch

    def block_apply(self, params, i, carry, *, capture):
        caps, x = {}, carry
        for name in NAMES:
            if capture:
                caps[("blocks", i, name, "w")] = x
            x = torch.tanh(x @ params["blocks"][i][name]["w"])
        return x, caps

    def block_linear_paths(self, params, i):
        return [("blocks", i, name, "w") for name in NAMES]


class JTinyAdapter(TinyAdapter):
    def block_apply(self, params, i, carry, *, capture):
        caps, x = {}, carry
        for name in NAMES:
            if capture:
                caps[("blocks", i, name, "w")] = x
            x = jnp.tanh(x @ params["blocks"][i][name]["w"])
        return x, caps


def _numpy_problem():
    rng = np.random.default_rng(7)
    params = {i: {nm: (rng.normal(size=(D, D)) / np.sqrt(D)).astype(
        np.float32) for nm in NAMES} for i in range(NBLOCKS)}
    batches = [rng.normal(size=(8, D)).astype(np.float32) for _ in range(2)]
    return params, batches


@pytest.fixture(scope="module")
def problem():
    p, b = _numpy_problem()
    params = {"blocks": {i: {nm: {"w": torch.from_numpy(w.copy())}
                             for nm, w in blk.items()}
                         for i, blk in p.items()}}
    return params, TinyAdapter(), [torch.from_numpy(x.copy()) for x in b]


CELLS = {
    "unstructured": dict(method="thanos", pattern="unstructured", p=0.5,
                         block_size=8),
    "nm": dict(method="thanos", pattern="nm", n=2, m=4, block_size=8),
}


def _equal_trees(a, b):
    for i in range(NBLOCKS):
        for nm in NAMES:
            assert torch.equal(a["blocks"][i][nm]["w"],
                               b["blocks"][i][nm]["w"]), (i, nm)


def _equal_reports(a, b):
    assert len(a.layers) == len(b.layers)
    for ra, rb in zip(a.layers, b.layers):
        assert dataclasses.replace(ra, seconds=0.0) == \
            dataclasses.replace(rb, seconds=0.0)
    assert list(a.masks) == list(b.masks)
    for path in a.masks:
        assert torch.equal(a.masks[path], b.masks[path])


# --------------------------------------------------------------------------
# journal mechanics
# --------------------------------------------------------------------------
def test_journal_round_trips_bf16_bytes(tmp_path):
    j = PruneJournal(str(tmp_path))
    k = torch.arange(12, dtype=torch.bfloat16).reshape(3, 4) * 0.1
    m = torch.eye(3, 4)
    rep = LayerReport(path=("blocks", 0, "moe", "w", 3), sparsity=0.5,
                      obs_loss=1.5, seconds=0.1)
    j.write(0, rep, kernel=k, mask=m)
    rec = j.load(0)
    assert rec.kernel.dtype == torch.bfloat16 and torch.equal(rec.kernel, k)
    assert torch.equal(rec.mask, m)
    assert rec.report == rep and rec.report.path[-1] == 3   # int survives
    assert j.completed == 1
    frag = json.load(open(tmp_path / "layers" / "00000.json"))
    assert (frag["kernel_dtype"], frag["kernel_shape"]) == ("bfloat16",
                                                            [3, 4])
    # the bytes are bf16's own: the JAX journal reads them back exactly
    raw, _, _ = _tensor_bytes(k)
    assert raw == k.view(torch.int16).numpy().tobytes()


def test_journal_completed_is_contiguous_prefix_and_ignores_tmp(tmp_path):
    j = PruneJournal(str(tmp_path))
    rep = LayerReport(path=("p",), sparsity=0.0, obs_loss=0.0, seconds=0.0,
                      skipped=True)
    j.write(0, rep)
    j.write(2, rep)
    open(tmp_path / "layers" / "00001.json.tmp.1", "w").close()
    assert PruneJournal(str(tmp_path)).completed == 1


def test_journal_write_fault_leaves_journal_untouched(tmp_path):
    j = PruneJournal(str(tmp_path))
    rep = LayerReport(path=("p",), sparsity=0.5, obs_loss=0.0, seconds=0.0)
    with pytest.raises(JournalWriteError):
        j.write(0, rep, kernel=torch.ones(2, 2),
                faults=FaultPlan.parse("journal_write@0"))
    assert os.listdir(tmp_path / "layers") == []


def test_batch_digest_fixed_dtypes():
    """The digest reads values widened to fixed dtypes: int32 and int64
    tokens digest alike, a bf16 leaf digests as its exact fp32 widening,
    and any changed value changes it."""
    tok = torch.arange(12).reshape(3, 4)
    assert batch_digest([{"tokens": tok}]) == \
        batch_digest([{"tokens": tok.to(torch.int32)}])
    pe = torch.randn(2, 3, generator=torch.Generator().manual_seed(0))
    assert batch_digest([{"p": pe.to(torch.bfloat16)}]) == \
        batch_digest([{"p": pe.to(torch.bfloat16).float()}])
    assert batch_digest([{"tokens": tok}]) != \
        batch_digest([{"tokens": tok + 1}])


# --------------------------------------------------------------------------
# uninterrupted journaled run ≡ plain prune_model; kill + resume ≡ both
# --------------------------------------------------------------------------
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_journaled_run_matches_plain(problem, tmp_path, cell):
    params, adapter, batches = problem
    oracle, orep = prune_model(params, adapter, batches,
                               PruneConfig(**CELLS[cell]))
    job = PruneJob(str(tmp_path / "job"))
    pruned, rep = job.run(params, adapter, batches,
                          PruneConfig(**CELLS[cell]))
    _equal_trees(oracle, pruned)
    _equal_reports(orep, rep)
    with open(job.report_path()) as f:
        assert json.load(f)["mean_sparsity"] == pytest.approx(0.5)


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("kill", ["journal_write@0", "journal_write@1",
                                  "journal_write@2", "journal_write@3",
                                  "calib_batch@2"])
def test_kill_resume_bitwise_parity(problem, tmp_path, kill, cell):
    params, adapter, batches = problem
    cfg = PruneConfig(**CELLS[cell])
    oracle, orep = prune_model(params, adapter, batches, cfg)
    job_dir = str(tmp_path / "job")
    with pytest.raises((JournalWriteError, CalibrationError)):
        PruneJob(job_dir, faults=FaultPlan.parse(kill)).run(
            params, adapter, batches, cfg)
    pruned, rep = PruneJob(job_dir).run(params, adapter, batches, cfg,
                                        resume=True)
    _equal_trees(oracle, pruned)
    _equal_reports(orep, rep)


def test_double_kill_then_resume_and_replay(problem, tmp_path):
    params, adapter, batches = problem
    cfg = PruneConfig(**CELLS["unstructured"])
    oracle, orep = prune_model(params, adapter, batches, cfg)
    job_dir = str(tmp_path / "job")
    for resume in (False, True):
        with pytest.raises(JournalWriteError):
            PruneJob(job_dir, faults=FaultPlan.parse("journal_write@1")).run(
                params, adapter, batches, cfg, resume=resume)
    p1, r1 = PruneJob(job_dir).run(params, adapter, batches, cfg,
                                   resume=True)
    _equal_trees(oracle, p1)
    _equal_reports(orep, r1)
    p2, r2 = PruneJob(job_dir).run(params, adapter, batches, cfg,
                                   resume=True)     # finished: replay only
    _equal_trees(p1, p2)
    assert [r.seconds for r in r2.layers] == [r.seconds for r in r1.layers]


def test_skip_rules_survive_resume(problem, tmp_path):
    params, adapter, batches = problem
    plan = PrunePlan(rules=(
        PruneRule(match="*/fc2/*", cfg=None, name="skip"),
        PruneRule(match="*", cfg=PruneConfig(**CELLS["unstructured"]))))
    oracle, orep = prune_model(params, adapter, batches, plan)
    job_dir = str(tmp_path / "job")
    with pytest.raises(JournalWriteError):
        PruneJob(job_dir, faults=FaultPlan.parse("journal_write@2")).run(
            params, adapter, batches, plan)
    pruned, rep = PruneJob(job_dir).run(params, adapter, batches, plan,
                                        resume=True)
    _equal_trees(oracle, pruned)
    _equal_reports(orep, rep)
    assert sum(r.skipped for r in rep.layers) == 2


# --------------------------------------------------------------------------
# resume validation
# --------------------------------------------------------------------------
def _killed(problem, job_dir):
    params, adapter, batches = problem
    with pytest.raises(JournalWriteError):
        PruneJob(job_dir, faults=FaultPlan.parse("journal_write@1")).run(
            params, adapter, batches, PruneConfig(**CELLS["unstructured"]))


@pytest.mark.parametrize("what", ["plan", "batches", "policy", "path",
                                  "fresh", "missing"])
def test_resume_refuses_a_different_run(problem, tmp_path, what):
    params, adapter, batches = problem
    job_dir = str(tmp_path / "job")
    cfg = PruneConfig(**CELLS["unstructured"])
    if what == "missing":
        with pytest.raises(FileNotFoundError, match="to resume"):
            PruneJob(job_dir).run(params, adapter, batches, cfg,
                                  resume=True)
        return
    _killed(problem, job_dir)
    job, kw = PruneJob(job_dir), dict(resume=True)
    if what == "plan":
        cfg, match = PruneConfig(**CELLS["nm"]), "plan does not match"
    elif what == "batches":
        batches, match = [b + 1.0 for b in batches], "digest mismatch"
    elif what == "policy":
        job, match = PruneJob(job_dir, on_singular="fail"), "policy differs"
    elif what == "fresh":
        kw, match = {}, "resume"
    else:
        frag = os.path.join(job_dir, "layers", "00000.json")
        d = json.load(open(frag))
        d["report"]["path"] = ["blocks", 9, "zzz", "w"]
        json.dump(d, open(frag, "w"))
        match = "different model"
    with pytest.raises((ValueError, FileExistsError), match=match):
        job.run(params, adapter, batches, cfg, **kw)


# --------------------------------------------------------------------------
# the prune sites and the report, against JAX
# --------------------------------------------------------------------------
def _jax_run(plan_text, cell):
    p, b = _numpy_problem()
    params = {"blocks": {i: {nm: {"w": jnp.asarray(w)} for nm, w in
                             blk.items()} for i, blk in p.items()}}
    return J.prune_model(params, JTinyAdapter(), [jnp.asarray(x) for x in b],
                         J.PruneConfig(**CELLS[cell]),
                         faults=(JFaultPlan.parse(plan_text) if plan_text
                                 else None))


@pytest.mark.parametrize("plan_text", ["", "cholesky@0", "cholesky@0x2",
                                       "hessian_accum@0",
                                       "hessian_accum@1;cholesky@3"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_prune_sites_and_report_json_match_jax(problem, plan_text, cell):
    params, adapter, batches = problem
    _, rep = prune_model(params, adapter, batches, PruneConfig(**CELLS[cell]),
                         faults=(FaultPlan.parse(plan_text) if plan_text
                                 else None))
    _, jrep = _jax_run(plan_text, cell)
    td, jd = rep.to_dict(), jrep.to_dict()
    for d in (td, jd):
        d.pop("seconds")
        for row in d["rules"]:
            row.pop("seconds")
    tl, jl = td.pop("layers"), jd.pop("layers")
    for t_row, j_row in zip(tl, jl, strict=True):
        t_row.pop("seconds"), j_row.pop("seconds")
        np.testing.assert_allclose(t_row.pop("obs_loss"),
                                   j_row.pop("obs_loss"), rtol=1e-4)
        assert t_row == j_row
    for row in td["rules"] + jd["rules"]:
        row.pop("obs_loss")
    assert td == jd
    for path, mk in jrep.masks.items():
        np.testing.assert_array_equal(n(rep.masks[path]), np.asarray(mk))
    if plan_text.startswith("cholesky@0"):
        want = 2 if "x2" in plan_text else 1
        assert rep.layers[0].damp_attempts == want
        assert rep.layers[0].percdamp_used == pytest.approx(0.01 * 10**want)
    if plan_text.startswith("hessian_accum@0"):
        assert [r.calib_skipped for r in rep.layers] == [1, 0, 0, 0]


def test_cholesky_site_drives_fail_policy(problem):
    params, adapter, batches = problem
    with pytest.raises(SingularHessian):
        prune_model(params, adapter, batches,
                    PruneConfig(**CELLS["unstructured"]),
                    on_singular="fail", faults=FaultPlan.parse("cholesky@0"))
    _, rep = prune_model(params, adapter, batches,
                         PruneConfig(**CELLS["unstructured"]),
                         on_singular="fallback:magnitude", max_escalations=1,
                         faults=FaultPlan.parse("cholesky@0x2"))
    assert rep.layers[0].fallback == "magnitude"


# --------------------------------------------------------------------------
# the CLI on tinyllama REDUCED
# --------------------------------------------------------------------------
def test_cli_job_dir_fault_plan_resume(tmp_path, monkeypatch):
    """``--job-dir --fault-plan journal_write@3`` dies at layer 3;
    ``--resume`` finishes it, bitwise equal to an uninterrupted run."""
    job = str(tmp_path / "j")
    argv = ["prune", "--job-dir", job, "--device", "cpu", "--pattern", "nm"]
    monkeypatch.setattr(sys, "argv", argv + ["--fault-plan",
                                             "journal_write@3"])
    with pytest.raises(JournalWriteError):
        prune_cli.main()
    assert PruneJournal(job).completed == 3
    monkeypatch.setattr(sys, "argv", ["prune", "--resume", "--device", "cpu"])
    with pytest.raises(SystemExit):
        prune_cli.main()                    # --resume needs --job-dir
    monkeypatch.setattr(sys, "argv", argv + ["--resume"])
    prune_cli.main()
    assert os.path.exists(os.path.join(job, "report.json"))
    cell = PruneConfig(method="thanos", pattern="nm", n=2, m=4,
                       block_size=64)
    resumed, rrep, _ = prune_cli.prune_arch(
        "tinyllama-1.1b", cell, log=None, device="cpu", job_dir=job,
        resume=True)
    plain, prep, _ = prune_cli.prune_arch("tinyllama-1.1b", cell, log=None,
                                          device="cpu")
    for path in prep.masks:
        assert torch.equal(rrep.masks[path], prep.masks[path])
        blk = resumed["blocks"][path[1]]
        ref = plain["blocks"][path[1]]
        for k in path[2:]:
            blk, ref = blk[k], ref[k]
        assert torch.equal(blk, ref)
