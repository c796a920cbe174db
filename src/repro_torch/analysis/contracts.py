"""Layer 2: abstract-eval contract sweep (zero FLOPs; port of
``repro/analysis/contracts.py``).

Builds every config in ``configs/registry.py`` × the serve representations
(dense, NmCompressed/NmStackedCompressed, paged/contiguous caches) on the
``meta`` device — the port's ``eval_shape`` — and checks the structural
contracts the serving stack assumes but runtime tests only probe
pointwise:

* ``contract-decode-pos``      — decode accepts both a python int and a
                                 ``(B,)`` int64 position; the registry's
                                 decode specs say so.
* ``contract-cache-geometry``  — ``init_cache`` leaves are batch-leading;
                                 ``decode_step`` returns a cache with the
                                 *identical* structure/shapes/dtypes (the
                                 static-signature contract continuous
                                 batching relies on).
* ``contract-compressed-aux``  — a compressed leaf's static fields (n, m,
                                 b, idx_bits[, E]) are hashable, values
                                 carry the model dtype, and compressed
                                 decode emits the same logits shape/dtype
                                 as dense.
* ``contract-paged-geometry``  — paged caches expose the page pool and
                                 survive a decode step structurally.
* ``contract-pspec-divides``   — every mesh axis a derived
                                 fsdp/param/cache PartitionSpec assigns
                                 actually divides that dim (the
                                 divisibility-fallback invariant), on a
                                 ``MeshShape`` (2, 4).
* ``contract-recipe-drift``    — every committed n:m recipe still matches
                                 at least one linear path in the zoo.

Every decode of every family, MoE dispatch included, runs on ``meta``
(the decode path has no data-dependent shape or ``.item()``), so no
contract falls back to a REDUCED config on the CPU: each runs at the
config the sweep is asked for.
"""
from __future__ import annotations

import dataclasses
import glob
import os
from typing import Iterable

import torch

from repro_torch.analysis.findings import Finding

_REG_PATH = "src/repro_torch/configs/registry.py"
_B, _L = 4, 32                      # decode geometry for the sweep
_MESH = (("data", "model"), (2, 4))


def _finding(arch: str, rule: str, msg: str,
             path: str = _REG_PATH) -> Finding:
    return Finding(path=path, line=1, rule=rule, severity="error",
                   symbol=arch, message=msg)


def _leaves_with_paths(tree, prefix=()):
    """(path, leaf) over nested dicts, lists/tuples and dataclasses; a
    compressed leaf is one leaf."""
    from repro_torch.core.sparsity import NmCompressed, NmStackedCompressed

    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, prefix + (i,))
    elif dataclasses.is_dataclass(tree) and not isinstance(
            tree, (type, NmCompressed, NmStackedCompressed)):
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if isinstance(v, torch.Tensor):
                yield prefix + (f.name,), v
    else:
        yield prefix, tree


def _signature(tree) -> list:
    """Structure, shapes and dtypes of a tree, leaf by leaf."""
    return [(path, type(leaf).__name__, tuple(getattr(leaf, "shape", ())),
             getattr(leaf, "dtype", None))
            for path, leaf in _leaves_with_paths(tree)]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _decode_args(cfg, a_params, a_cache, pos):
    from repro_torch.configs.registry import TOKEN_DTYPE

    tok = _meta((_B, 1), TOKEN_DTYPE)
    if cfg.family == "encdec":
        return (a_params, a_cache, tok, pos,
                _meta((_B, 64, cfg.d_model), cfg.torch_dtype))
    return (a_params, a_cache, tok, pos)


def _aux(leaf) -> tuple:
    """A compressed leaf's static fields (the JAX pytree's aux data)."""
    return tuple(getattr(leaf, f.name) for f in dataclasses.fields(leaf)
                 if not isinstance(getattr(leaf, f.name), torch.Tensor))


def _check_arch(arch: str, *, reduced: bool) -> list[Finding]:
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES
    from repro_torch.core.sparsity import NmCompressed, NmStackedCompressed
    from repro_torch.launch.steps import (abstract_cache, abstract_nm_params,
                                          abstract_params, meta_model)
    from repro_torch.models.model_builder import build_model

    out: list[Finding] = []
    cfg = registry.get_config(arch, reduced=reduced)
    model = build_model(cfg, device="cpu")
    mm = meta_model(model)

    # -- registry decode specs say pos is (B,) (or ()) int64 ---------------
    for cell in SHAPES.values():
        if cell.kind != "decode" or not registry.cell_supported(cfg, cell):
            continue
        pos = registry.decode_specs(cfg, cell).get("pos")
        if pos is None or tuple(pos.shape) not in ((), (cell.global_batch,)) \
                or pos.dtype != registry.TOKEN_DTYPE:
            out.append(_finding(
                arch, "contract-decode-pos",
                f"registry.decode_specs[{cell.name}] pos is "
                f"{getattr(pos, 'shape', None)}/"
                f"{getattr(pos, 'dtype', None)} — contract is () or (B,) "
                f"{registry.TOKEN_DTYPE}"))

    a_params = abstract_params(model)
    a_cache = abstract_cache(model, _B, _L)
    want = _signature(a_cache)

    # -- cache geometry: batch-leading leaves ------------------------------
    for path, leaf in _leaves_with_paths(a_cache):
        if getattr(leaf, "ndim", 0) >= 1 and leaf.shape[0] != _B:
            out.append(_finding(
                arch, "contract-cache-geometry",
                f"init_cache leaf {'/'.join(map(str, path))} has leading "
                f"dim {leaf.shape[0]} != batch {_B}"))

    # -- decode with vector and scalar pos; cache stability ----------------
    dense_logits = None
    for pos in (_meta((_B,), registry.TOKEN_DTYPE), _L - 1):
        shape = "(B,)" if isinstance(pos, torch.Tensor) else "()"
        try:
            logits, cache_out = mm.decode_step(
                *_decode_args(cfg, a_params, abstract_cache(model, _B, _L),
                              pos))
            dense_logits = logits
            if tuple(logits.shape) != (_B, 1, cfg.vocab_size):
                out.append(_finding(
                    arch, "contract-decode-pos",
                    f"decode logits shape {tuple(logits.shape)} != "
                    f"({_B}, 1, {cfg.vocab_size})"))
            if _signature(cache_out) != want:
                out.append(_finding(
                    arch, "contract-cache-geometry",
                    "decode_step returned a cache whose structure/shapes/"
                    "dtypes differ from its input — decode signatures must "
                    "be static across steps"))
        except Exception as e:  # noqa: BLE001 — any failure is drift
            out.append(_finding(
                arch, "contract-decode-pos",
                f"decode_step failed on meta with pos shape {shape}: "
                f"{type(e).__name__}: {e} — the decode API contract is pos "
                f"() or (B,) {registry.TOKEN_DTYPE}"))

    # -- compressed leaves: static fields, dtype, logits -------------------
    a_nm = abstract_nm_params(model, 2, 4)
    n_comp = 0
    for path, leaf in _leaves_with_paths(a_nm):
        if not isinstance(leaf, (NmCompressed, NmStackedCompressed)):
            continue
        n_comp += 1
        aux = _aux(leaf)
        try:
            hash(aux)
        except TypeError:
            out.append(_finding(
                arch, "contract-compressed-aux",
                f"compressed leaf {'/'.join(map(str, path))} static fields "
                f"{aux!r} are unhashable"))
        if leaf.values.dtype != cfg.torch_dtype:
            out.append(_finding(
                arch, "contract-compressed-aux",
                f"compressed leaf {'/'.join(map(str, path))} values dtype "
                f"{leaf.values.dtype} != model dtype {cfg.torch_dtype}"))
    if n_comp == 0:
        out.append(_finding(
            arch, "contract-compressed-aux",
            "abstract_nm_params(2, 4) produced zero compressed leaves — "
            "the arch has no compressible linears?"))
    try:
        nm_logits, _ = mm.decode_step(*_decode_args(
            cfg, a_nm, abstract_cache(model, _B, _L),
            _meta((_B,), registry.TOKEN_DTYPE)))
        if dense_logits is not None and (
                nm_logits.shape != dense_logits.shape or
                nm_logits.dtype != dense_logits.dtype):
            out.append(_finding(
                arch, "contract-compressed-aux",
                f"compressed decode logits {tuple(nm_logits.shape)}/"
                f"{nm_logits.dtype} != dense "
                f"{tuple(dense_logits.shape)}/{dense_logits.dtype}"))
    except Exception as e:  # noqa: BLE001
        out.append(_finding(
            arch, "contract-compressed-aux",
            f"decode_step failed on meta with compressed params: "
            f"{type(e).__name__}: {e}"))

    # -- paged cache (transformer families) --------------------------------
    if hasattr(mm, "init_paged_cache"):
        num_pages, page_size, pps = 8, 8, _L // 8
        a_paged = mm.init_paged_cache(_B, num_pages=num_pages,
                                      page_size=page_size,
                                      pages_per_slot=pps)
        paged_sig = _signature(a_paged)
        if not any(num_pages in tuple(getattr(leaf, "shape", ()))
                   for _p, leaf in _leaves_with_paths(a_paged)):
            out.append(_finding(
                arch, "contract-paged-geometry",
                f"init_paged_cache exposes no leaf with a num_pages="
                f"{num_pages} pool dim"))
        try:
            _logits, paged_out = mm.decode_step(*_decode_args(
                cfg, a_params, a_paged, _meta((_B,), registry.TOKEN_DTYPE)))
            if _signature(paged_out) != paged_sig:
                out.append(_finding(
                    arch, "contract-paged-geometry",
                    "decode_step over the paged cache changed its "
                    "structure/shapes/dtypes"))
        except Exception as e:  # noqa: BLE001
            out.append(_finding(
                arch, "contract-paged-geometry",
                f"decode_step failed on meta over the paged cache: "
                f"{type(e).__name__}: {e}"))

    # -- pspec divisibility -------------------------------------------------
    out.extend(_check_pspecs(arch, a_params, a_cache))
    return out


def _check_pspecs(arch: str, a_params, a_cache) -> list[Finding]:
    from repro_torch.dist import sharding as D

    mesh = D.MeshShape(*_MESH)
    sizes = D.axis_sizes(mesh)
    out: list[Finding] = []

    def check(tree, specs, what: str):
        def one(path, leaf, spec):
            for dim, entry in enumerate(spec):
                if entry is None:
                    continue
                axes = entry if isinstance(entry, tuple) else (entry,)
                size = 1
                for a in axes:
                    size *= sizes[a]
                if dim >= leaf.ndim or leaf.shape[dim] % size != 0:
                    out.append(_finding(
                        arch, "contract-pspec-divides",
                        f"{what} spec {spec} on leaf "
                        f"{'/'.join(D._path_names(path))} shape "
                        f"{tuple(leaf.shape)}: axes {axes} (size {size}) do "
                        f"not divide dim {dim}",
                        path="src/repro_torch/dist/sharding.py"))

        D.map_with_path(one, tree, specs)

    check(a_params, D.param_pspecs(a_params, mesh), "param")
    check(a_params, D.fsdp_pspecs(a_params, mesh), "fsdp")
    check(a_cache, D.cache_pspecs(a_cache, mesh, _B), "cache")
    return out


def _check_recipes(root: str) -> list[Finding]:
    """Committed n:m recipes must still match linear paths in the zoo."""
    from repro_torch.configs import registry
    from repro_torch.core.plan import PrunePlan
    from repro_torch.launch.steps import abstract_params
    from repro_torch.models.model_builder import build_model

    recipe_dir = os.path.join(root, "examples", "recipes")
    recipes = sorted(glob.glob(os.path.join(recipe_dir, "*.json")))
    if not recipes:
        return []
    trees = {}
    for arch in ("tinyllama-1.1b", "qwen3-moe-30b-a3b"):
        model = build_model(registry.get_config(arch), device="cpu")
        a = abstract_params(model)
        paths = []
        for i in range(model.num_blocks()):
            paths.extend(model.block_linear_paths(a, i))
        trees[arch] = paths

    out: list[Finding] = []
    for path in recipes:
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        try:
            plan = PrunePlan.load(path)
        except Exception as e:  # noqa: BLE001
            out.append(Finding(
                path=rel, line=1, rule="contract-recipe-drift",
                severity="error", symbol="",
                message=f"recipe fails to load: {type(e).__name__}: {e}"))
            continue
        has_nm = any(
            r.cfg is not None and getattr(r.cfg, "pattern", None) == "nm"
            for r in getattr(plan, "rules", ()))
        if not has_nm:
            continue
        matched = any(
            (c := plan.cfg_for(p)) is not None and c.pattern == "nm"
            for paths in trees.values() for p in paths)
        if not matched:
            out.append(Finding(
                path=rel, line=1, rule="contract-recipe-drift",
                severity="error", symbol="",
                message="recipe's n:m rules match no linear path in the "
                        "zoo (tinyllama, qwen3-moe) — path patterns have "
                        "drifted"))
    return out


def run_contracts(archs: Iterable[str] | None = None, *,
                  reduced: bool = False,
                  repo_root: str | None = None) -> list[Finding]:
    from repro_torch.configs import registry

    archs = tuple(archs) if archs is not None else registry.ARCHS
    findings: list[Finding] = []
    for arch in archs:
        try:
            findings.extend(_check_arch(arch, reduced=reduced))
        except Exception as e:  # noqa: BLE001 — sweep must report, not die
            findings.append(_finding(
                arch, "contract-sweep-error",
                f"contract sweep crashed: {type(e).__name__}: {e}"))
    if repo_root is not None:
        findings.extend(_check_recipes(repo_root))
    return sorted(findings)
