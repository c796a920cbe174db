"""Public pruning API — config dataclass + pluggable method/pattern registry
(port of ``repro/core/api.py``).

Layout: ``W ∈ R^{c×b}``, rows = outputs, columns = inputs; model kernels are
stored (in, out) and ``core/schedule.py`` transposes.

Methods are registered, not hard-coded: ``register_method(name, {pattern:
fn})`` makes a method available to ``prune_layer``, the ``PruneConfig``
validator, the CLIs' ``--method``/``--pattern`` choices and the recipe layer
(``core/plan.py``).  ``METHODS`` and ``PATTERNS`` are live tuple-like views
over the registry.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Mapping, Sequence

import torch

from repro_torch.core import magnitude, sparsegpt, thanos, wanda
from repro_torch.core.hessian import h_finite
from repro_torch.core.solver import solution_finite
from repro_torch.core.thanos import PruneResult
from repro_torch.faults import SingularHessian

Tensor = torch.Tensor

# fn(w, h, cfg) -> PruneResult; w (c, b), h = 2XXᵀ (b, b) or None
PatternFn = Callable[[Tensor, "Tensor | None", "PruneConfig"], PruneResult]


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """One registered pruning method: its per-pattern solvers + traits."""

    name: str
    patterns: Mapping[str, PatternFn]
    data_aware: bool = True      # True → prune_layer demands a Hessian


class _RegistryView(Sequence):
    """Tuple-like live view over registry keys (insertion-ordered)."""

    def __init__(self, mapping: Mapping):
        self._mapping = mapping

    def __iter__(self) -> Iterator[str]:
        return iter(self._mapping)

    def __contains__(self, item) -> bool:
        return item in self._mapping

    def __len__(self) -> int:
        return len(self._mapping)

    def __getitem__(self, i):
        return tuple(self._mapping)[i]

    def __eq__(self, other):
        # equal to any sequence of the same names, False (not TypeError)
        # for everything else; unhashable because the registry is mutable
        if isinstance(other, (_RegistryView, tuple, list)):
            return tuple(self) == tuple(other)
        return NotImplemented

    __hash__ = None

    def __repr__(self) -> str:
        return repr(tuple(self._mapping))


_REGISTRY: dict[str, MethodSpec] = {}
_PATTERN_ORDER: dict[str, None] = {}     # insertion-ordered set of patterns

METHODS = _RegistryView(_REGISTRY)
PATTERNS = _RegistryView(_PATTERN_ORDER)


def register_method(name: str, patterns: Mapping[str, PatternFn], *,
                    data_aware: bool = True,
                    overwrite: bool = False) -> MethodSpec:
    """Register a pruning method under ``name``; new pattern names join
    ``PATTERNS`` in first-seen order."""
    if not patterns:
        raise ValueError(f"method {name!r}: at least one pattern required")
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"method {name!r} already registered "
                         "(pass overwrite=True to replace)")
    spec = MethodSpec(name=name, patterns=dict(patterns),
                      data_aware=data_aware)
    _REGISTRY[name] = spec
    for p in patterns:
        _PATTERN_ORDER.setdefault(p, None)
    return spec


def unregister_method(name: str) -> None:
    """Remove a registered method (pattern names stay in ``PATTERNS``)."""
    _REGISTRY.pop(name, None)


def method_spec(name: str) -> MethodSpec:
    spec = _REGISTRY.get(name)
    if spec is None:
        raise ValueError(
            f"unknown method {name!r}; registered: {tuple(_REGISTRY)}")
    return spec


@dataclasses.dataclass(frozen=True)
class PruneConfig:
    """One experiment cell: method × sparsity pattern × hyperparameters."""

    method: str = "thanos"
    pattern: str = "unstructured"
    p: float = 0.5              # target sparsity (unstructured/structured)
    n: int = 2                  # n:m — zeros per group
    m: int = 4                  # n:m — group size
    block_size: int = 128       # Thanos B (paper: 128 unstructured, 512 n:m)
    alpha: float = 0.0          # outlier-row fraction
    percdamp: float = 0.01
    row_chunk: int = 0          # Appendix H.2 vertical chunking

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method!r}; registered: "
                             f"{tuple(METHODS)}")
        if self.pattern not in PATTERNS:
            raise ValueError(f"unknown pattern {self.pattern!r}; registered: "
                             f"{tuple(PATTERNS)}")
        if not 0.0 <= self.p < 1.0:
            raise ValueError(f"target sparsity p={self.p} must be in [0, 1)")
        if not 0 < self.n < self.m:
            raise ValueError(
                f"n:m needs 0 < n < m, got n={self.n} m={self.m}")
        if not self.percdamp > 0:
            raise ValueError(
                f"percdamp={self.percdamp} must be > 0 (Hessian damping)")
        if not 0.0 <= self.alpha < 1.0:
            raise ValueError(
                f"outlier fraction alpha={self.alpha} must be in [0, 1)")

    def tag(self) -> str:
        pat = {"unstructured": f"p{self.p}", "nm": f"{self.n}:{self.m}",
               "structured": f"struct{self.p}"}.get(self.pattern,
                                                    self.pattern)
        a = f"_a{self.alpha}" if self.alpha else ""
        return f"{self.method}_{pat}{a}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "PruneConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown PruneConfig fields {sorted(unknown)}; "
                f"known: {sorted(known)}")
        return cls(**d)


def prune_layer(w: Tensor, h: "Tensor | None", cfg: PruneConfig
                ) -> PruneResult:
    """Prune one linear layer W (c, b) given its Hessian H = 2XXᵀ (b, b)."""
    spec = method_spec(cfg.method)
    if spec.data_aware and h is None:
        raise ValueError(f"{cfg.method} is data-aware: Hessian required")
    fn = spec.patterns.get(cfg.pattern)
    if fn is None:
        raise ValueError(
            f"method {cfg.method!r} does not support pattern "
            f"{cfg.pattern!r}; supported: {tuple(spec.patterns)}")
    return fn(w, h, cfg)


# --------------------------------------------------------------------------
# numerical guards: singular-Hessian policies + adaptive damping escalation
# --------------------------------------------------------------------------
ON_SINGULAR = ("fail", "escalate", "fallback:magnitude")


@dataclasses.dataclass(frozen=True)
class GuardInfo:
    """What ``prune_layer_guarded`` had to do to complete a layer:
    ``damp_attempts`` failed solve attempts (each escalation ×10 percdamp),
    the damping of the attempt that produced the result (0.0 for the
    magnitude fallback), the fallback fired, and whether H was finite."""

    damp_attempts: int = 0
    percdamp_used: float = 0.0
    fallback: str = ""
    h_finite: bool = True


def prune_layer_guarded(w: Tensor, h: "Tensor | None", cfg: PruneConfig, *,
                        on_singular: str = "escalate",
                        max_escalations: int = 4, faults=None,
                        path: str = "") -> tuple[PruneResult, GuardInfo]:
    """``prune_layer`` with numerical guards: an ill-conditioned H surfaces
    as a policy decision, never as silent NaN weights.

    An attempt fails when any output (weights, loss) is non-finite — the
    port's factorizations turn a non-PD matrix into NaNs
    (``hessian.cholesky_nan``), as ``jnp.linalg.cholesky`` does.
    ``fail`` raises :class:`SingularHessian` on the first failed attempt;
    ``escalate`` retries with percdamp ×10 per attempt, up to
    ``max_escalations`` extra attempts, then raises;
    ``fallback:magnitude`` escalates, then completes the layer data-free.
    A non-finite H skips escalation: damping cannot repair entries.
    ``faults`` is an armed :class:`repro_torch.faults.FaultPlan`: the
    ``cholesky`` site fires once per attempt, and a firing counts as a
    failed factorization (it drives every policy on a healthy H).
    """
    if on_singular not in ON_SINGULAR:
        raise ValueError(f"unknown on_singular policy {on_singular!r}; "
                         f"known: {ON_SINGULAR}")
    if max_escalations < 0:
        raise ValueError(f"max_escalations must be >= 0, "
                         f"got {max_escalations}")

    def magnitude_fallback(attempts: int, finite_h: bool):
        res = prune_layer(w, h, dataclasses.replace(cfg, method="magnitude"))
        return res, GuardInfo(damp_attempts=attempts, percdamp_used=0.0,
                              fallback="magnitude", h_finite=finite_h)

    where = f" ({path})" if path else ""
    if h is not None and not h_finite(h):
        if on_singular == "fallback:magnitude":
            return magnitude_fallback(0, False)
        raise SingularHessian(
            f"non-finite Hessian{where}: damping cannot repair Inf/NaN "
            "entries (check the calibration stream / accumulator skip "
            "counter)", path=path, attempts=0)

    tries = 1 if on_singular == "fail" else 1 + max_escalations
    for k in range(tries):
        cfg_k = (cfg if k == 0 else
                 dataclasses.replace(cfg, percdamp=cfg.percdamp * 10.0 ** k))
        if faults is not None and faults.fire("cholesky") is not None:
            continue
        res = prune_layer(w, h, cfg_k)
        if solution_finite(res.weights, res.loss):
            return res, GuardInfo(damp_attempts=k,
                                  percdamp_used=cfg_k.percdamp)
    if on_singular == "fallback:magnitude":
        return magnitude_fallback(tries, True)
    raise SingularHessian(
        f"singular Hessian{where}: {tries} solve attempt(s) non-finite "
        f"(percdamp escalated {cfg.percdamp} → "
        f"{cfg.percdamp * 10.0 ** (tries - 1)}); "
        "set on_singular='fallback:magnitude' to complete the layer "
        "data-free", path=path, attempts=tries)


def reconstruction_error(w0: Tensor, w1: Tensor, h: Tensor) -> Tensor:
    """‖(Ŵ−W)X‖²_F computed from the Hessian: tr(Δ (H/2) Δᵀ)  (Eq. 1)."""
    d = (w1 - w0).to(torch.float32)
    return torch.einsum("ib,bk,ik->", d, 0.5 * h.to(torch.float32), d)


# --------------------------------------------------------------------------
# built-in registrations (the paper's method + the three baselines), in the
# JAX module's order
# --------------------------------------------------------------------------
register_method("thanos", {
    "unstructured": lambda w, h, cfg: thanos.prune_unstructured(
        w, h, p=cfg.p, block_size=cfg.block_size, percdamp=cfg.percdamp,
        row_chunk=cfg.row_chunk, alpha=cfg.alpha),
    "nm": lambda w, h, cfg: thanos.prune_nm(
        w, h, n=cfg.n, m=cfg.m, block_size=cfg.block_size,
        percdamp=cfg.percdamp, row_chunk=cfg.row_chunk, alpha=cfg.alpha),
    "structured": lambda w, h, cfg: thanos.prune_structured(
        w, h, p=cfg.p, alpha=cfg.alpha, percdamp=cfg.percdamp),
})

register_method("sparsegpt", {
    "unstructured": lambda w, h, cfg: sparsegpt.prune_unstructured(
        w, h, p=cfg.p, mask_blocksize=cfg.block_size, percdamp=cfg.percdamp),
    "nm": lambda w, h, cfg: sparsegpt.prune_nm(
        w, h, n=cfg.n, m=cfg.m, blocksize=cfg.block_size,
        percdamp=cfg.percdamp),
    "structured": lambda w, h, cfg: sparsegpt.prune_structured(
        w, h, p=cfg.p, blocksize=cfg.block_size, percdamp=cfg.percdamp),
})

register_method("wanda", {
    "unstructured": lambda w, h, cfg: wanda.prune_unstructured(w, h, p=cfg.p),
    "nm": lambda w, h, cfg: wanda.prune_nm(w, h, n=cfg.n, m=cfg.m),
    "structured": lambda w, h, cfg: wanda.prune_structured(w, h, p=cfg.p),
})

register_method("magnitude", {
    "unstructured": lambda w, h, cfg: magnitude.prune_unstructured(w, p=cfg.p),
    "nm": lambda w, h, cfg: magnitude.prune_nm(w, n=cfg.n, m=cfg.m),
    "structured": lambda w, h, cfg: magnitude.prune_structured(w, p=cfg.p),
}, data_aware=False)
