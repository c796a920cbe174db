"""The port's repro-lint (``repro_torch.analysis``) on the CPU: the JAX
package's rule fixtures of the kept rules, re-pointed at the port's layout
(``src/repro_torch``, ``repro_torch.faults``, ``repro_torch.util.io``, the
serve entry modules), the dtype rule's torch cases, suppressions and the
baseline, the CLI, a self-lint of ``src/repro_torch`` (empty baseline),
the meta-device contract sweep, and ``Finding`` fingerprints and JSON
byte-equal to JAX's.  ``jit-purity`` and ``recompile-hazards`` read the
code a CUDA graph captures; their fixtures are in
``tests/test_torch_capture.py``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis.engine import RepoIndex, run_rules
from repro_torch.analysis.findings import (Baseline, Finding,
                                           findings_from_json,
                                           findings_to_json,
                                           suppressed_lines)
from repro_torch.analysis.rules import RULES

REPO_ROOT = Path(__file__).resolve().parents[1]


def make_repo(tmp_path, files: dict[str, str]) -> RepoIndex:
    src = tmp_path / "src"
    for rel, text in files.items():
        p = src / "repro_torch" / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return RepoIndex.build(src)


def rule_findings(idx: RepoIndex, rule_name: str):
    return run_rules(idx, [RULES[rule_name]])


def test_rules_are_the_kept_five():
    """All seven of JAX's rules, in JAX's report order (the name is from
    when the two capture rules were not ported)."""
    assert list(RULES) == ["jit-purity", "fault-hook-cost",
                           "serve-never-decompresses", "atomic-writes",
                           "recompile-hazards", "dtype-discipline",
                           "import-hygiene"]


# ====================================================== fault-hook-cost
_FAULT_REGISTRY = """\
    SERVE_SITES = ("alpha", "beta")
    PRUNE_SITES = ("gamma",)
    SITES = SERVE_SITES + PRUNE_SITES

    class FaultPlan:
        def fire(self, site):
            return None
"""


class TestFaultHookCost:
    def test_clean_registry_all_guarded(self, tmp_path):
        idx = make_repo(tmp_path, {
            "faults.py": _FAULT_REGISTRY,
            "serve/engine.py": """\
                def step(self):
                    if self.faults is not None:
                        f = self.faults.fire("alpha")
                    if self.faults is not None and \\
                            self.faults.fire("beta") is not None:
                        raise RuntimeError
                def prune(faults):
                    hit = faults is not None and \\
                        faults.fire("gamma") is not None
                    return hit
            """,
        })
        assert rule_findings(idx, "fault-hook-cost") == []

    def test_flags_unguarded_fire(self, tmp_path):
        idx = make_repo(tmp_path, {
            "faults.py": _FAULT_REGISTRY,
            "serve/engine.py": """\
                def step(self):
                    self.faults.fire("alpha")
                    if self.faults is not None:
                        self.faults.fire("beta")
                def prune(faults):
                    if faults is not None:
                        faults.fire("gamma")
            """,
        })
        found = rule_findings(idx, "fault-hook-cost")
        assert len(found) == 1
        assert "not guarded" in found[0].message
        assert "'alpha'" in found[0].message

    def test_flags_double_and_dead_and_unknown_sites(self, tmp_path):
        idx = make_repo(tmp_path, {
            "faults.py": _FAULT_REGISTRY,
            "serve/engine.py": """\
                def a(self):
                    if self.faults is not None:
                        self.faults.fire("alpha")
                def b(self):
                    if self.faults is not None:
                        self.faults.fire("alpha")
                        self.faults.fire("nonsite")
                def c(faults):
                    if faults is not None:
                        faults.fire("beta")
            """,
        })
        msgs = [f.message for f in rule_findings(idx, "fault-hook-cost")]
        assert any("more than one call site" in m for m in msgs)
        assert any("missing from" in m and "repro_torch.faults" in m
                   for m in msgs)
        assert any("no call site" in m and "'gamma'" in m for m in msgs)


# ============================================== serve-never-decompresses
class TestServeNeverDecompresses:
    @pytest.mark.parametrize("seed", ["serve/engine.py",
                                      "serve/supervisor.py"])
    def test_flags_path_from_engine_and_supervisor(self, tmp_path, seed):
        idx = make_repo(tmp_path, {
            "serve/compressed.py": """\
                def decompress_params(params):
                    return params
            """,
            "serve/helpers.py": """\
                from repro_torch.serve.compressed import decompress_params
                def densify(params):
                    return decompress_params(params)
            """,
            seed: """\
                from repro_torch.serve.helpers import densify
                class ServingEngine:
                    def restore(self, snap):
                        return densify(snap)
            """,
        })
        found = rule_findings(idx, "serve-never-decompresses")
        assert len(found) == 1
        assert "decompress_params" in found[0].message
        assert found[0].path.endswith(seed)

    def test_oracle_use_outside_serve_is_fine(self, tmp_path):
        idx = make_repo(tmp_path, {
            "serve/compressed.py": """\
                def decompress_params(params):
                    return params
            """,
            "serve/engine.py": """\
                class ServingEngine:
                    def restore(self, snap):
                        return snap
            """,
            "oracle.py": """\
                from repro_torch.serve.compressed import decompress_params
                def check(params):
                    return decompress_params(params)
            """,
        })
        assert rule_findings(idx, "serve-never-decompresses") == []

    def test_external_root_is_not_a_repo_method(self, tmp_path):
        """``torch.save`` does not edge into a repo ``save`` (the import
        resolver's external-root rule, with the port's package root)."""
        idx = make_repo(tmp_path, {
            "serve/compressed.py": """\
                def decompress_params(params):
                    return params
                def save(params):
                    return decompress_params(params)
            """,
            "serve/engine.py": """\
                import torch
                class ServingEngine:
                    def snapshot(self, state, path):
                        torch.save(state, path)
            """,
        })
        assert rule_findings(idx, "serve-never-decompresses") == []


# ====================================================== atomic-writes
class TestAtomicWrites:
    def test_flags_raw_write_open(self, tmp_path):
        idx = make_repo(tmp_path, {"core/journal.py": """\
            import json
            def save(path, obj):
                with open(path, "w") as f:
                    json.dump(obj, f)
        """})
        found = rule_findings(idx, "atomic-writes")
        assert len(found) == 1
        assert 'open(..., "w")' in found[0].message
        assert "repro_torch.util.io" in found[0].message

    def test_mode_keyword_and_binary_flagged(self, tmp_path):
        idx = make_repo(tmp_path, {"core/journal.py": """\
            def save(path, data):
                open(path, mode="wb").write(data)
        """})
        assert len(rule_findings(idx, "atomic-writes")) == 1

    def test_read_open_and_io_module_exempt(self, tmp_path):
        idx = make_repo(tmp_path, {
            "core/journal.py": """\
                def load(path):
                    with open(path) as f:
                        return f.read()
            """,
            "util/io.py": """\
                def atomic_write_bytes(path, data):
                    with open(path + ".tmp", "wb") as f:
                        f.write(data)
            """,
        })
        assert rule_findings(idx, "atomic-writes") == []


# ==================================================== dtype-discipline
_ENTRY = """\
    from repro_torch.core.solve import solve
    def main(h):
        return solve(h)
"""


class TestDtypeDiscipline:
    def test_flags_dtypeless_numpy_in_reached_core(self, tmp_path):
        idx = make_repo(tmp_path, {
            "core/solve.py": """\
                import numpy as np

                def damp(h):
                    return h + np.eye(h.shape[0])

                def solve(h):
                    return damp(h)
            """,
            "launch/prune.py": _ENTRY,
        })
        found = rule_findings(idx, "dtype-discipline")
        assert len(found) == 1
        assert "numpy.eye" in found[0].message
        assert found[0].symbol == "damp"

    @pytest.mark.parametrize("expr,word", [
        ("h.to(torch.float64)", "torch.float64"),
        ("h.double()", ".double()"),
        ("torch.zeros(3, dtype=torch.double)", "torch.double"),
        ("np.linalg.inv(h)", "numpy.linalg.inv"),
    ])
    def test_flags_torch_float64_in_reached_core(self, tmp_path, expr,
                                                 word):
        idx = make_repo(tmp_path, {
            "core/solve.py": f"""\
                import numpy as np
                import torch

                def solve(h):
                    return {expr}
            """,
            "serve/engine.py": _ENTRY,
        })
        msgs = [f.message for f in rule_findings(idx, "dtype-discipline")]
        assert len(msgs) == 1 and word in msgs[0]

    def test_flags_np_linalg_f64_and_torch_linalg_in_kernels(self,
                                                             tmp_path):
        idx = make_repo(tmp_path, {"kernels/op.py": """\
            import numpy as np
            import torch

            def bad_solve(h):
                lo = np.linalg.cholesky(h)
                return lo.astype(np.float64)

            def wrapper(h):
                return torch.linalg.cholesky(h)
        """})
        msgs = [f.message for f in rule_findings(idx, "dtype-discipline")]
        assert any("numpy.linalg.cholesky" in m for m in msgs)
        assert any("numpy.float64" in m for m in msgs)
        assert any("torch.linalg.cholesky" in m and "kernel" in m
                   for m in msgs)

    def test_explicit_dtype_unreached_core_and_core_linalg_fine(self,
                                                                tmp_path):
        idx = make_repo(tmp_path, {
            "core/solve.py": """\
                import numpy as np
                import torch

                def journal_digest(x):
                    return np.asarray(x)        # nothing serves or prunes it

                def solve(h):
                    return torch.linalg.cholesky(h * np.float32(2.0))
            """,
            "launch/prune.py": _ENTRY,
            "data/pipeline.py": """\
                import numpy as np

                def ranks(v):
                    return np.arange(1, v + 1, dtype=np.float64)
            """,
        })
        assert rule_findings(idx, "dtype-discipline") == []


# ===================================================== import-hygiene
class TestImportHygiene:
    def test_flags_partial_shim(self, tmp_path):
        idx = make_repo(tmp_path, {
            "faults.py": """\
                __all__ = ["A", "B", "C"]
                class A: pass
                class B: pass
                class C: pass
            """,
            "serve/faults.py": """\
                from repro_torch.faults import A, B
                __all__ = ["A", "B"]
            """,
        })
        found = rule_findings(idx, "import-hygiene")
        assert len(found) == 1
        assert "missing C" in found[0].message

    def test_star_shim_and_non_shim_fine(self, tmp_path):
        idx = make_repo(tmp_path, {
            "faults.py": """\
                __all__ = ["A", "B", "C"]
                class A: pass
                class B: pass
                class C: pass
            """,
            "serve/faults.py": """\
                from repro_torch.faults import *  # noqa: F401,F403
                __all__ = ["A", "B"]
            """,
            "serve/engine.py": """\
                from repro_torch.faults import A

                def use():
                    return A()
            """,
        })
        assert rule_findings(idx, "import-hygiene") == []


# ============================================ suppressions and baseline
class TestSuppressionMechanics:
    def test_same_line_and_line_above(self):
        src = ("x = 1  # lint: disable=rule-a\n"
               "# lint: disable=rule-b\n"
               "y = 2\n")
        sup = suppressed_lines(src)
        assert "rule-a" in sup[1]
        assert "rule-b" in sup[2] and "rule-b" in sup[3]

    def test_suppression_silences_matching_rule_only(self, tmp_path):
        idx = make_repo(tmp_path, {"core/journal.py": """\
            def save(path, obj):
                # lint: disable=atomic-writes
                with open(path, "w") as f:
                    f.write(obj)

            def save2(path, obj):
                # lint: disable=dtype-discipline
                with open(path, "w") as f:
                    f.write(obj)
        """})
        found = rule_findings(idx, "atomic-writes")
        assert len(found) == 1
        assert found[0].symbol == "save2"


class TestBaselineMechanics:
    def _finding(self, msg="m", path="src/repro_torch/a.py", line=1):
        return Finding(path=path, line=line, rule="atomic-writes",
                       severity="error", message=msg)

    def test_multiset_absorption(self):
        f1, f2 = self._finding(line=1), self._finding(line=99)
        base = Baseline.from_findings([f1])      # one entry, two findings
        fresh = base.new_findings([f1, f2])
        assert len(fresh) == 1                   # second occurrence is new
        assert base.stale_entries([f1, f2]) == []

    def test_stale_entry_detection(self):
        f1 = self._finding("fixed-one")
        base = Baseline.from_findings([f1, self._finding("still-there")])
        stale = base.stale_entries([self._finding("still-there")])
        assert len(stale) == 1
        assert stale[0]["message"] == "fixed-one"

    def test_fingerprint_stable_across_line_moves(self):
        assert self._finding(line=3).fingerprint() == \
            self._finding(line=300).fingerprint()

    def test_json_round_trip(self):
        fs = [self._finding("a"), self._finding("b", line=7)]
        doc = findings_to_json(fs)
        back = findings_from_json(doc)
        assert back == fs
        assert json.loads(doc)["findings"][0]["fingerprint"] == \
            fs[0].fingerprint()

    def test_fingerprint_and_json_byte_equal_jax(self):
        from repro.analysis import findings as J

        kw = dict(path="src/repro_torch/serve/engine.py", line=12,
                  rule="atomic-writes", severity="error",
                  message='raw open(..., "w") — route durable writes',
                  symbol="Engine.save")
        f, jf = Finding(**kw), J.Finding(**kw)
        assert f.fingerprint() == jf.fingerprint()
        assert findings_to_json([f]) == J.findings_to_json([jf])
        assert Baseline.from_findings([f]).dump() == \
            J.Baseline.from_findings([jf]).dump()
        assert f.render() == jf.render()


# ================================================= self-lint (the port)
class TestSelfLint:
    def test_port_clean_with_empty_baseline(self):
        idx = RepoIndex.build(REPO_ROOT / "src")
        assert all(p.startswith("src/repro_torch/") for p in idx.files)
        findings = run_rules(idx, list(RULES.values()))
        assert findings == [], "\n".join(f.render() for f in findings)
        base = json.loads((REPO_ROOT / "src/repro_torch/analysis/"
                           "baseline.json").read_text())
        assert base == {"version": 1, "findings": []}

    def test_cli_check_exits_zero(self, tmp_path):
        from repro_torch.analysis.__main__ import main
        out = tmp_path / "findings.json"
        rc = main(["--no-contracts", "--check", "--root", str(REPO_ROOT),
                   "--json", str(out)])
        assert rc == 0
        doc = json.loads(out.read_text())
        assert doc == {"version": 1, "findings": []}

    def test_cli_rules_subset_and_unknown_rule(self):
        from repro_torch.analysis.__main__ import main
        rc = main(["--rules", "atomic-writes,import-hygiene",
                   "--check", "--root", str(REPO_ROOT)])
        assert rc == 0
        with pytest.raises(SystemExit):
            main(["--rules", "no-such-rule", "--root", str(REPO_ROOT)])

    def test_module_check_without_jax(self):
        """``python -m repro_torch.analysis --check`` (the reduced sweep)
        exits 0 with JAX and the JAX package unimportable."""
        code = ("import sys, runpy; sys.modules['jax'] = None; "
                "sys.modules['repro'] = None; "
                "sys.argv = ['repro_torch.analysis', '--check', "
                "'--reduced']; runpy.run_module('repro_torch.analysis', "
                "run_name='__main__')")
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=300,
                             env={"PYTHONPATH": str(REPO_ROOT / "src"),
                                  "PATH": "/usr/bin:/bin"},
                             cwd=str(REPO_ROOT))
        assert out.returncode == 0, out.stderr[-2000:]
        assert "repro-lint: 0 finding(s)" in out.stderr


# ======================================== layer 2: contract sweep
class TestContracts:
    def test_reduced_sweep_clean_on_representative_archs(self):
        from repro_torch.analysis.contracts import run_contracts
        fs = run_contracts(archs=("tinyllama-1.1b", "qwen3-moe-30b-a3b"),
                           reduced=True, repo_root=str(REPO_ROOT))
        assert fs == [], "\n".join(f.render() for f in fs)

    def test_full_config_sweep_clean_on_moe_and_mla(self):
        from repro_torch.analysis.contracts import run_contracts
        fs = run_contracts(archs=("qwen3-moe-30b-a3b", "deepseek-v3-671b"))
        assert fs == [], "\n".join(f.render() for f in fs)

    def test_sweep_reports_drift_not_crashes(self, monkeypatch):
        from repro_torch.analysis import contracts

        def boom(cfg, device="cuda"):
            raise RuntimeError("boom")

        monkeypatch.setattr("repro_torch.models.model_builder.build_model",
                            boom)
        fs = contracts.run_contracts(archs=("tinyllama-1.1b",))
        assert [f.rule for f in fs] == ["contract-sweep-error"]
        assert "boom" in fs[0].message

    def test_contracts_catch_a_broken_decode(self, monkeypatch):
        """A decode that changes its cache's dtypes is reported."""
        import torch

        from repro_torch.analysis import contracts
        from repro_torch.models.transformer import TransformerLM

        real = TransformerLM.decode_step

        def bad(self, params, cache, tokens, pos, embeds=None):
            logits, cache = real(self, params, cache, tokens, pos)
            for c in cache.values():
                if hasattr(c, "pos_ids"):
                    c.pos_ids = c.pos_ids.to(torch.int32)
            return logits, cache

        monkeypatch.setattr(TransformerLM, "decode_step", bad)
        fs = contracts.run_contracts(archs=("tinyllama-1.1b",),
                                     reduced=True)
        assert any(f.rule == "contract-cache-geometry" for f in fs)


# ============================================ the compiled train steps
_GRAPHED_HELPER = """\
    class graphed:
        def __init__(self, fn=None, *, static=(), donate=()):
            self.fn = fn
"""


def test_the_train_steps_are_capture_roots():
    """``graphed(step_body, donate=...)`` and the sharded step's and the
    tooling's bodies seed the captured set; through the builders' values
    (the annotated optimizer, the bound loss, the schedule parameter,
    ``checkpoint(model.block, ...)``) it reaches the update, the masked
    update, the schedules, the loss and the model blocks — and not the
    Hessian accumulator's ``update``."""
    reach = RepoIndex.build(REPO_ROOT / "src").graph.jit_reachable()
    for key in ("repro_torch.train.step::make_train_step.step_body",
                "repro_torch.train.step::make_sharded_train_step."
                "local_grads",
                "repro_torch.train.step::make_sharded_train_step."
                "sharded_update",
                "repro_torch.launch.steps::make_train_step.micro_body",
                "repro_torch.train.step::value_and_grad",
                "repro_torch.train.step::_loss_with_remat.loss",
                "repro_torch.optim.adamw::AdamW.update",
                "repro_torch.optim.adamw::AdamW._update",
                "repro_torch.optim.adamw::clip_by_global_norm",
                "repro_torch.optim.adamw::global_norm",
                "repro_torch.optim.masked::SparsityPreserving.update",
                "repro_torch.optim.masked::_zero",
                "repro_torch.optim.schedules::constant.lr_schedule",
                "repro_torch.optim.schedules::cosine_warmup.lr_schedule",
                "repro_torch.optim.schedules::linear_warmup.lr_schedule",
                "repro_torch.models.transformer::TransformerLM.block",
                "repro_torch.models.transformer::TransformerLM.embed_batch",
                "repro_torch.models.transformer::TransformerLM."
                "loss_from_carry"):
        assert key in reach, key
    assert "repro_torch.core.hessian::HessianAccumulator.update" \
        not in reach


def test_jit_purity_flags_a_host_lr_in_the_captured_update(tmp_path):
    """The port's own sources with ``float(lr)`` planted in AdamW's update:
    one finding, reached from the train step's body."""
    import shutil

    src = tmp_path / "src"
    shutil.copytree(REPO_ROOT / "src/repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = src / "repro_torch/optim/adamw.py"
    text = path.read_text()
    planted = text.replace("        dev = ps[0].device\n",
                           "        dev = ps[0].device\n"
                           "        lr = float(lr)\n")
    assert planted != text
    path.write_text(planted)
    found = rule_findings(RepoIndex.build(src), "jit-purity")
    assert [(f.symbol, f.path.endswith("optim/adamw.py")) for f in found] \
        == [("AdamW._update", True)]
    assert "float() over a tensor expression" in found[0].message
    assert "make_train_step." in found[0].message


def test_recompile_flags_a_scalar_handed_to_a_donated_graph(tmp_path):
    """A per-call Python scalar in a donated step's signature: every lr
    would key a graph of its own (or be baked into one)."""
    idx = make_repo(tmp_path, {"util/graphs.py": _GRAPHED_HELPER,
                               "mod.py": """\
        from repro_torch.util import graphs

        def step(params, batch, lr: float):
            return params

        def build():
            return graphs.graphed(step, donate=("params",))
    """})
    found = rule_findings(idx, "recompile-hazards")
    assert len(found) == 1 and "`lr`" in found[0].message


def test_builder_values_resolve_to_their_functions(tmp_path):
    """The call graph's three refinements on a fixture: a method of an
    annotated parameter reaches only that class's method; a name bound
    from a call reaches the called function and its nested defs; a
    parameter called as a function reaches the functions of its name."""
    idx = make_repo(tmp_path, {"util/graphs.py": _GRAPHED_HELPER,
                               "opt.py": """\
        class Opt:
            def update(self, g):
                return g

        class Acc:
            def update(self, x):
                return x

        def make_sched():
            def sched(step):
                return step
            return sched

        def make_loss():
            def loss(p):
                return p
            return loss
    """, "step.py": """\
        from repro_torch.opt import Opt, make_loss
        from repro_torch.util import graphs

        def build(opt: Opt, sched):
            loss_fn = make_loss()

            def body(p, count):
                lr = sched(count)
                return opt.update(loss_fn(p) * lr)

            return graphs.graphed(body, donate=("p",))
    """})
    reach = idx.graph.jit_reachable()
    for key in ("repro_torch.step::build.body", "repro_torch.opt::Opt.update",
                "repro_torch.opt::make_loss.loss",
                "repro_torch.opt::make_sched.sched"):
        assert key in reach, key
    assert "repro_torch.opt::Acc.update" not in reach
