"""PrunePlan — recipe-driven, per-layer pruning (port of
``repro/core/plan.py``).

A ``PrunePlan`` is an ordered list of ``PruneRule``s, each mapping an
fnmatch (or regex) pattern over the param *path string* —
``"blocks/3/mlp/gate/w"`` — to a ``PruneConfig`` cell or to ``skip`` (the
layer stays dense).  Resolution is **first match wins**; a path no rule
matches is skipped.  ``PrunePlan.uniform(cfg)`` is a single ``"*"`` rule,
the same run as a bare ``PruneConfig``.

Plans round-trip through JSON (``to_json`` writes the same bytes as the
JAX package for the same plan), so one recipe in ``examples/recipes/``
drives both packages' ``prune_model``, CLIs and mixed-residency serving.

``allocate_sparsity`` redistributes per-layer ``p`` under a global budget:
``uniform``, or ``hessian_trace`` (BESA-style: layers with a small mean
Hessian trace get more sparsity), from the stats of
``core.schedule.collect_hessian_stats``.

``python -m repro_torch.core.plan --check DIR`` validates every ``*.json``
recipe under DIR.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import functools
import json
import math
import re
from typing import Any, Iterable, Mapping

from repro_torch.core.api import ON_SINGULAR, PruneConfig
from repro_torch.util.io import atomic_write_text

ALLOCATION_POLICIES = ("uniform", "hessian_trace")
_SCHEMA_VERSION = 1

Path = tuple[Any, ...]


def path_str(path: "Path | str") -> str:
    """Canonical string form of a param path: elements joined with '/'."""
    if isinstance(path, str):
        return path
    return "/".join(str(k) for k in path)


@functools.lru_cache(maxsize=512)
def _compiled(pattern: str) -> "re.Pattern":
    return re.compile(pattern)


@dataclasses.dataclass(frozen=True)
class PruneRule:
    """One plan entry: path pattern → PruneConfig cell, or skip.

    ``match`` is an fnmatch glob over the '/'-joined param path ('*'
    crosses '/'); with ``regex=True`` it is a ``re.fullmatch`` regex.
    ``cfg=None`` means *skip*: every path this rule claims stays dense.

    ``on_singular`` is the rule's numerical-failure policy (``fail`` /
    ``escalate`` / ``fallback:magnitude`` — see
    ``core.api.prune_layer_guarded``); the empty default inherits the
    run-level policy (``prune_model(..., on_singular=)``), so recipes
    only pin it where a layer family needs special treatment (e.g.
    ``fallback:magnitude`` on embeddings whose calibration stream is
    known-sparse).
    """

    match: str
    cfg: PruneConfig | None = None
    regex: bool = False
    name: str = ""
    on_singular: str = ""        # "" = inherit the run-level policy

    def __post_init__(self):
        if not self.match:
            raise ValueError("rule match pattern must be non-empty")
        if self.on_singular and self.on_singular not in ON_SINGULAR:
            raise ValueError(
                f"rule {self.match!r}: unknown on_singular policy "
                f"{self.on_singular!r}; known: {ON_SINGULAR} (or '' to "
                "inherit)")
        if self.regex:
            try:
                _compiled(self.match)
            except re.error as e:
                raise ValueError(f"bad regex {self.match!r}: {e}") from e

    @property
    def skip(self) -> bool:
        return self.cfg is None

    def matches(self, path: "Path | str") -> bool:
        s = path_str(path)
        if self.regex:
            return _compiled(self.match).fullmatch(s) is not None
        return fnmatch.fnmatchcase(s, self.match)

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"match": self.match}
        if self.regex:
            d["regex"] = True
        if self.name:
            d["name"] = self.name
        if self.on_singular:
            d["on_singular"] = self.on_singular
        if self.cfg is None:
            d["action"] = "skip"
        else:
            d["cfg"] = self.cfg.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "PruneRule":
        known = {"match", "regex", "name", "action", "cfg", "on_singular"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown rule keys {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        if "match" not in d:
            raise ValueError(f"rule needs a 'match' pattern: {dict(d)}")
        action = d.get("action", "prune" if "cfg" in d else None)
        if action == "skip":
            if "cfg" in d:
                raise ValueError(
                    f"rule {d['match']!r}: 'action: skip' excludes 'cfg'")
            cfg = None
        elif action == "prune":
            if "cfg" not in d:
                raise ValueError(f"rule {d['match']!r}: 'cfg' required")
            cfg = PruneConfig.from_dict(d["cfg"])
        else:
            raise ValueError(
                f"rule {d['match']!r} needs 'cfg' or 'action': 'skip' "
                f"(got action={action!r})")
        return cls(match=d["match"], cfg=cfg,
                   regex=bool(d.get("regex", False)),
                   name=str(d.get("name", "")),
                   on_singular=str(d.get("on_singular", "")))


@dataclasses.dataclass(frozen=True)
class AllocationSpec:
    """Non-uniform sparsity allocation carried by a plan.

    ``budget`` is the size-weighted mean sparsity target over the layers
    the allocation touches; per-layer p is clipped to [p_min, p_max].
    """

    policy: str = "uniform"
    budget: float = 0.5
    p_min: float = 0.05
    p_max: float = 0.95

    def __post_init__(self):
        if self.policy not in ALLOCATION_POLICIES:
            raise ValueError(f"unknown allocation policy {self.policy!r}; "
                             f"known: {ALLOCATION_POLICIES}")
        if not 0.0 <= self.budget < 1.0:
            raise ValueError(f"budget={self.budget} must be in [0, 1)")
        if not 0.0 <= self.p_min <= self.p_max < 1.0:
            raise ValueError(
                f"need 0 <= p_min <= p_max < 1, got "
                f"p_min={self.p_min} p_max={self.p_max}")
        if not self.p_min <= self.budget <= self.p_max:
            raise ValueError(
                f"budget={self.budget} is unattainable: per-layer p is "
                f"clipped to [{self.p_min}, {self.p_max}], so the "
                f"size-weighted mean can never reach it")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "AllocationSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown allocation keys {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class LayerStat:
    """Per-layer saliency statistics consumed by ``allocate_sparsity``."""

    size: int            # kernel parameter count (weighting)
    trace: float         # mean Hessian diagonal tr(H)/b (saliency proxy)


@dataclasses.dataclass(frozen=True)
class PrunePlan:
    """Ordered ``PruneRule``s; first match wins, no match = skip."""

    rules: tuple[PruneRule, ...]
    allocation: AllocationSpec | None = None

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))

    # ------------------------------------------------------- constructors
    @classmethod
    def uniform(cls, cfg: PruneConfig) -> "PrunePlan":
        """Single catch-all rule — bit-exactly the old global-cfg path."""
        return cls(rules=(PruneRule(match="*", cfg=cfg),))

    # --------------------------------------------------------- resolution
    def resolve(self, path: "Path | str") -> tuple[int, PruneConfig | None]:
        """→ (matched rule index, cfg).  (-1, None) = no rule claims the
        path; (i, None) = rule i is a skip rule.  Either way None = dense."""
        for i, rule in enumerate(self.rules):
            if rule.matches(path):
                return i, rule.cfg
        return -1, None

    def cfg_for(self, path: "Path | str") -> PruneConfig | None:
        return self.resolve(path)[1]

    # ------------------------------------------------ sparsity allocation
    def allocate_sparsity(
        self,
        stats: Mapping[str, LayerStat],
        *,
        policy: str | None = None,
        budget: float | None = None,
        p_min: float | None = None,
        p_max: float | None = None,
    ) -> "PrunePlan":
        """Redistribute per-layer ``p`` under a global budget.

        For every path in ``stats`` whose resolved cfg carries a target
        sparsity ``p`` (pattern "unstructured"/"structured" — n:m cells
        have fixed density), an exact-match rule with the reallocated p is
        *prepended*, shadowing the generic rule for that path; everything
        else resolves as before.  Defaults come from ``self.allocation``.

        uniform: every touched layer at the budget.  hessian_trace: layer
        weight w_l = 1/(1+log1p(trace_l)); p_l = clip(c·w_l, p_min, p_max)
        with c bisected so the size-weighted mean hits the budget (BESA-
        style: salient layers keep more weights).  The returned plan has
        ``allocation=None`` — it *is* the allocation's output.
        """
        spec = self.allocation or AllocationSpec()
        spec = AllocationSpec(
            policy=policy if policy is not None else spec.policy,
            budget=budget if budget is not None else spec.budget,
            p_min=p_min if p_min is not None else spec.p_min,
            p_max=p_max if p_max is not None else spec.p_max,
        )

        touched: list[tuple[str, PruneConfig, str, LayerStat]] = []
        for path, st in stats.items():
            idx, cfg = self.resolve(path)
            if cfg is not None and cfg.pattern in ("unstructured",
                                                   "structured"):
                # the prepended exact-match rule shadows rules[idx] for
                # this path — carry its on_singular policy along
                touched.append((path_str(path), cfg,
                                self.rules[idx].on_singular, st))
        if not touched:
            return PrunePlan(rules=self.rules, allocation=None)

        if spec.policy == "uniform":
            target = {path: spec.budget for path, _, _, _ in touched}
        else:
            weights = {
                path: 1.0 / (1.0 + math.log1p(max(st.trace, 0.0)))
                for path, _, _, st in touched
            }
            sizes = {path: max(st.size, 1) for path, _, _, st in touched}
            total = sum(sizes.values())

            def mean_p(c: float) -> float:
                return sum(
                    sizes[p] * min(max(c * weights[p], spec.p_min),
                                   spec.p_max)
                    for p in weights) / total

            lo, hi = 0.0, spec.p_max / min(weights.values())
            for _ in range(64):                 # monotone → bisection
                mid = 0.5 * (lo + hi)
                if mean_p(mid) < spec.budget:
                    lo = mid
                else:
                    hi = mid
            c = 0.5 * (lo + hi)
            target = {
                path: min(max(c * weights[path], spec.p_min), spec.p_max)
                for path, _, _, _ in touched
            }

        per_layer = tuple(
            PruneRule(match=path, name="alloc", on_singular=pol,
                      cfg=dataclasses.replace(cfg, p=target[path]))
            for path, cfg, pol, _ in touched
        )
        return PrunePlan(rules=per_layer + self.rules, allocation=None)

    # ------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        d: dict[str, Any] = {
            "version": _SCHEMA_VERSION,
            "rules": [r.to_dict() for r in self.rules],
        }
        if self.allocation is not None:
            d["allocation"] = self.allocation.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "PrunePlan":
        known = {"version", "rules", "allocation"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown plan keys {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        version = d.get("version", _SCHEMA_VERSION)
        if version != _SCHEMA_VERSION:
            raise ValueError(f"unsupported plan schema version {version!r} "
                             f"(this build reads {_SCHEMA_VERSION})")
        if "rules" not in d or not isinstance(d["rules"], (list, tuple)):
            raise ValueError("plan needs a 'rules' list")
        rules = tuple(PruneRule.from_dict(r) for r in d["rules"])
        alloc = d.get("allocation")
        return cls(rules=rules,
                   allocation=(None if alloc is None
                               else AllocationSpec.from_dict(alloc)))

    def to_json(self, *, indent: int | None = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "PrunePlan":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path: str) -> "PrunePlan":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str) -> None:
        atomic_write_text(path, self.to_json() + "\n")


def as_plan(plan_or_cfg: "PrunePlan | PruneConfig") -> PrunePlan:
    """Normalize the public prune entry points' config argument: a bare
    ``PruneConfig`` is the compat shim for the pre-plan API."""
    if isinstance(plan_or_cfg, PrunePlan):
        return plan_or_cfg
    if isinstance(plan_or_cfg, PruneConfig):
        return PrunePlan.uniform(plan_or_cfg)
    raise TypeError(
        f"expected PrunePlan or PruneConfig, got {type(plan_or_cfg)!r}")


# --------------------------------------------------------------------------
# recipe validation entry point
# --------------------------------------------------------------------------
def check_recipes(paths: Iterable[str]) -> list[str]:
    """Validate recipe files; returns failure messages (empty = all OK)."""
    failures = []
    for p in paths:
        try:
            plan = PrunePlan.load(p)
            print(f"OK   {p}: {len(plan.rules)} rule(s)"
                  + (f", allocation={plan.allocation.policy}"
                     if plan.allocation else ""))
        except Exception as e:  # noqa: BLE001 — report every bad recipe
            failures.append(f"{p}: {e}")
            print(f"FAIL {p}: {e}")
    return failures


def _main(argv=None) -> int:
    import argparse
    import glob
    import os

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.plan",
        description="validate PrunePlan JSON recipes")
    ap.add_argument("paths", nargs="*", help="recipe files")
    ap.add_argument("--check", default="",
                    help="directory: validate every *.json under it")
    args = ap.parse_args(argv)

    files = list(args.paths)
    if args.check:
        files += sorted(glob.glob(os.path.join(args.check, "*.json")))
    if not files:
        print("no recipes to check")
        return 1
    failures = check_recipes(files)
    if failures:
        print(f"\n{len(failures)} invalid recipe(s)")
        return 1
    print(f"\nall {len(files)} recipe(s) valid")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
