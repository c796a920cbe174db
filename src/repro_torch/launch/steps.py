"""Step builders for the dry run, the perf ladders and the drivers (port of
``repro/launch/steps.py``).

One builder per shape-cell kind:

* ``train``   — microbatched, remat'd train step (``train/step.py``'s
  remat 'block'): the microbatches run in sequence with fp32 gradient
  accumulation (one sequence per data-parallel replica per microbatch by
  default), then one AdamW update (bf16 moments).
* ``prefill`` — forward to **last-token logits only** (a (B, S, V) logit
  tensor at 32k × 262k vocab is half a terabyte; no server builds it).
* ``decode``  — one-token ``serve_step`` against a seq_len-deep cache.

Every builder returns ``(step, abstract_args)``: ``abstract_args`` are
tensors on the ``meta`` device (the port's ``ShapeDtypeStruct``), built
without allocating, and ``step`` is a ``Step`` — callable on real
arguments, carrying the layouts its arguments take on the mesh
(``in_specs``, from ``dist/sharding.py``) and able to draw real arguments
of the abstract ones' shapes (``concrete_args``).  What JAX gets from
``jit(...).lower(*abstract_args)`` the port gets by running the step: the
abstract arguments give every byte count, the concrete ones the card's
time.  Under one rank the specs change no result.

JAX's block runner scans the periodic segments of ``plan_segments``; the
port keeps ``plan_segments`` (the same plan) and runs every block in order,
which is what a scan over a segment computes.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeCell
from repro_torch.core.schedule import get_path, set_path
from repro_torch.dist import sharding as D
from repro_torch.optim import AdamW, AdamWState
from repro_torch.optim.schedules import cosine_warmup
from repro_torch.train.step import (DONATED, TrainStep, _loss_with_remat,
                                    advance, value_and_grad)
from repro_torch.util import graphs
from repro_torch.util.tree import map_tree


# --------------------------------------------------------------------------
# abstract trees on the meta device
# --------------------------------------------------------------------------
def meta_model(model):
    """A copy of ``model`` that builds its trees on ``meta``."""
    out = copy.copy(model)
    out.device = torch.device("meta")
    return out


def _with_cfg(model, cfg):
    """A copy of ``model`` under another config, on the same device."""
    out = copy.copy(model)
    out.cfg = cfg
    return out


def abstract_params(model):
    """The model's param tree on ``meta``.  Memoized per (model class,
    config): every caller reads the tree and none writes it (a swap of
    leaves, as ``abstract_nm_params`` makes, copies the dicts on its
    path), and a full config's init is the sweep's main cost."""
    return _abstract_params(type(model), model.cfg)


@functools.lru_cache(maxsize=32)
def _abstract_params(cls, cfg):
    model = cls(cfg, device="cpu")
    model.device = torch.device("meta")
    return model.init(torch.Generator())


def abstract_cache(model, batch: int, max_len: int):
    return meta_model(model).init_cache(batch, max_len)


def _dp_size(mesh) -> int:
    return D._size(mesh, D.data_axes(mesh))


# --------------------------------------------------------------------------
# periodic layer-segment planning (MaxText-style, as JAX's)
# --------------------------------------------------------------------------
def block_param_path(model, i: int) -> tuple:
    """Where block i's params live in the tree (JAX's
    ``model.block_param_path``)."""
    cfg = model.cfg
    if cfg.family == "encdec":
        E = cfg.encoder_layers
        return ("enc", i) if i < E else ("dec", i - E)
    if cfg.family == "hybrid":
        return ("mamba", i)
    return ("blocks", i)


def behavior_key(model, i: int) -> tuple:
    """What makes two blocks of equal shapes behave differently (JAX's
    ``model.behavior_key``): rope theta, window and MoE-ness for the
    transformers, the shared set for the hybrid, sLSTM-ness for xLSTM."""
    cfg = model.cfg
    if cfg.family == "encdec":
        return ("enc" if i < cfg.encoder_layers else "dec",)
    if cfg.family == "hybrid":
        shared = bool(cfg.attn_every and (i + 1) % cfg.attn_every == 0)
        which = (((i + 1) // cfg.attn_every - 1) % cfg.num_shared_attn
                 if shared else -1)
        return (shared, which)
    if cfg.family == "ssm":
        k = cfg.slstm_every
        return (bool(k) and (i + 1) % k == 0,)
    return (model._theta(i), model._window(i), cfg.layer_is_moe(i))


def _block_signature(model, a_params, i: int):
    sub = get_path(a_params, block_param_path(model, i))
    shapes = []
    D.map_with_path(lambda path, leaf: shapes.append(
        (tuple(D._path_names(path)), tuple(leaf.shape), str(leaf.dtype))),
        sub)
    return (behavior_key(model, i), tuple(sorted(shapes)))


def plan_segments(sigs: list) -> list[tuple]:
    """[('unroll', [i..])] | [('scan', start, period, count)] covering 0..L-1.

    Greedy periodic chunking: at each position find the (period, count) with
    maximal coverage where the motif of ``period`` signatures repeats
    ``count`` ≥ 2 times; unroll single layers when no repetition exists.
    """
    L = len(sigs)
    segs: list[tuple] = []
    i = 0
    pending: list[int] = []

    def flush():
        nonlocal pending
        if pending:
            segs.append(("unroll", list(pending)))
            pending = []

    while i < L:
        best = None  # (coverage, -period, period, count)
        for p in range(1, min(16, (L - i) // 2) + 1):
            motif = sigs[i:i + p]
            k = 1
            while sigs[i + k * p: i + (k + 1) * p] == motif:
                k += 1
            if k >= 2 and (best is None or (p * k, -p) > (best[0], best[1])):
                best = (p * k, -p, p, k)
        if best is not None and best[0] >= 4:
            flush()
            segs.append(("scan", i, best[2], best[3]))
            i += best[0]
        else:
            pending.append(i)
            i += 1
    flush()
    return segs


def make_block_runner(model, *, block_fn):
    """→ run(params, carry): every block in order.  JAX scans the periodic
    segments of ``plan_segments`` to shorten its compile; run eagerly, a
    scan segment is its blocks one after another, so the port loops over
    them all."""
    def run(params, carry):
        for i in range(model.num_blocks()):
            carry = block_fn(params, carry, i)
        return carry

    return run


# --------------------------------------------------------------------------
# the step object
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Step:
    """A built step: ``step(*args)`` runs it; ``in_specs`` are the
    PartitionSpecs of its arguments on the mesh it was built for;
    ``concrete_args(gen)`` draws real arguments of the abstract ones'
    shapes on the model's device (random-init weights from ``gen``; with
    ``DecodeOptions.nm``, magnitude n:m masks packed by
    ``compress_params``)."""

    fn: Callable
    kind: str
    model: Any
    cell: ShapeCell
    in_specs: tuple
    opts: "DecodeOptions | None" = None
    optimizer: "AdamW | None" = None

    def __call__(self, *args):
        return self.fn(*args)

    def concrete_args(self, generator: torch.Generator) -> tuple:
        model, cfg, cell = self.model, self.model.cfg, self.cell
        params = model.init(generator)
        if self.kind == "train":
            batch = registry.concrete_batch(cfg, cell, generator,
                                            device=model.device)
            return params, self.optimizer.init(params), batch
        if self.kind == "prefill":
            return params, registry.concrete_batch(cfg, cell, generator,
                                                   device=model.device)
        opts = self.opts
        if opts.nm:
            params = magnitude_nm_params(model, params, *opts.nm)
        B = cell.global_batch
        max_len = opts.cache_len or cell.seq_len
        cache = model.init_cache(B, max_len)
        dev = model.device
        tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=generator,
                               device=dev)
        # every row at the deepest slot: the step reads the whole cache
        pos = torch.full((B,), max_len - 1, dtype=registry.TOKEN_DTYPE,
                         device=dev)
        if cfg.family != "encdec":
            return params, cache, tokens, pos
        enc = torch.randn((B, opts.enc_len or 1500, cfg.d_model),
                          generator=generator, device=dev).to(cfg.torch_dtype)
        if opts.cross_cache:
            with torch.no_grad():
                enc = model.precompute_cross_kv(params, enc)
        return params, cache, tokens, pos, enc


# ==========================================================================
# train
# ==========================================================================
def make_train_step(model, mesh, cell, *, microbatches: int = 0,
                    optimizer: "AdamW | None" = None):
    """→ (step, (params, opt, batch) on meta).

    step(params, opt, batch) → (params, opt, metrics); batch is the *global*
    batch, split into ``microbatches`` chunks of consecutive rows run in
    sequence with fp32 grad accumulation (1 sequence per DP replica per
    chunk by default), then one AdamW update in place (JAX's
    ``donate_argnums=(0, 1)``).  The step is a ``train.step.TrainStep``:
    the microbatch loop and the update run from one CUDA graph on the card
    over the donated params and moments (inline on the CPU).
    """
    cfg = model.cfg
    optimizer = optimizer or AdamW(weight_decay=0.1, clip_norm=1.0,
                                   moment_dtype="bfloat16")
    lr = cosine_warmup(3e-4, 2000, 100_000)
    loss_fn = _loss_with_remat(model, "block")

    B = cell.global_batch
    n_micro = microbatches or max(1, B // _dp_size(mesh))
    assert B % n_micro == 0

    def micro_body(params, mu, nu, count, batch):
        rows = B // n_micro
        tot_loss = None
        tot_g = None
        for k in range(n_micro):
            mb = {key: x[k * rows:(k + 1) * rows] for key, x in batch.items()}
            loss, g = value_and_grad(loss_fn, params, mb)
            loss = loss.to(torch.float32)
            g = map_tree(lambda x: x.to(torch.float32), g)
            if tot_g is None:
                tot_loss, tot_g = loss, g
            else:
                tot_loss = tot_loss + loss
                tot_g = map_tree(torch.add, tot_g, g)
        grads = map_tree(lambda g: g / n_micro, tot_g)
        new_params, new_opt = optimizer.update(
            grads, AdamWState(step=count, mu=mu, nu=nu), params, lr(count),
            inplace=True)
        return new_params, new_opt.mu, new_opt.nu, {
            "loss": tot_loss / n_micro}

    body = graphs.graphed(micro_body, donate=DONATED)
    step = TrainStep(functools.partial(advance, body),
                     functools.partial(advance, micro_body))

    a_params = abstract_params(model)
    a_opt = optimizer.init(a_params)
    a_batch = registry.input_specs(cfg, cell)
    p_specs = D.fsdp_pspecs(a_params, mesh)
    in_specs = (p_specs, type(a_opt)(step=D.P(), mu=p_specs, nu=p_specs),
                D.batch_pspecs(a_batch, mesh))
    return (Step(step, "train", model, cell, in_specs, optimizer=optimizer),
            (a_params, a_opt, a_batch))


# ==========================================================================
# prefill
# ==========================================================================
def make_prefill_step(model, mesh, cell):
    """→ (step, (params, batch) on meta): last-token logits (B, 1, V)."""
    from repro_torch.models import layers as L

    cfg = model.cfg
    run = make_block_runner(
        model, block_fn=lambda p, c, i: model.block(p, i, c))

    @torch.no_grad()
    def prefill(params, batch):
        carry = model.embed_batch(params, batch)
        carry = run(params, carry)
        key = "dec_h" if "dec_h" in carry else "h"
        h = carry[key][:, -1:, :]
        norm_name = "dec_norm" if "dec_norm" in params else "final_norm"
        h = L.norm(params[norm_name], h)
        if getattr(cfg, "tie_embeddings", True) or "lm_head" not in params:
            return L.unembed(params["embed"], h)
        return h @ params["lm_head"]["w"]

    a_params = abstract_params(model)
    a_batch = registry.input_specs(cfg, cell)
    in_specs = (D.fsdp_pspecs(a_params, mesh),
                D.batch_pspecs(a_batch, mesh))
    return Step(prefill, "prefill", model, cell, in_specs), (a_params,
                                                             a_batch)


# ==========================================================================
# decode
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class DecodeOptions:
    """Levers of the decode step (the perf ladders' rungs).

    weight_sharding: 'fsdp' streams weight shards per step (fits anything,
        pays all-gathers); 'tp' keeps weights resident sharded on the model
        axis only (no per-step weight collectives — needs P/16 ≤ HBM).
        On one card both lay every weight on it whole.
    kv_dtype: '' = model dtype; 'int8' = quantized cache (½ bytes); 'bf16'
        = xLSTM's matrix memory in bf16.
    cache_len: 0 = cell.seq_len; else architecture-aware self-cache depth
        (e.g. Whisper's decoder never exceeds dec_seq=448).
    nm: (n, m) to serve against NmCompressed linear weights (paper §4.8 —
        weight stream shrinks to keep/m + index overhead).
    enc_len: encoder-source length override for enc-dec decode.
    cross_cache: enc-dec: precomputed per-layer cross-attention k/v.
    """

    weight_sharding: str = "fsdp"
    kv_dtype: str = ""
    cache_len: int = 0
    nm: tuple | None = None
    enc_len: int = 0
    cross_cache: bool = False


def _linear_paths(model, a) -> list:
    paths = []
    for i in range(model.num_blocks()):
        paths.extend(model.block_linear_paths(a, i))
    return paths


def _plan_cell(plan, n, m, path) -> tuple:
    """(compress?, n, m) of one path under a plan or a global (n, m)."""
    if plan is None:
        return True, n, m
    cfg = plan.cfg_for(path)
    nm = cfg is not None and cfg.pattern == "nm"
    return (nm, cfg.n, cfg.m) if nm else (False, None, None)


def abstract_nm_params(model, n: int | None = None, m: int | None = None,
                       *, plan=None):
    """Abstract params with prunable linears swapped for compressed meta
    leaves — 2-D kernels become ``NmCompressed`` and 3-D MoE expert stacks
    one ``NmStackedCompressed`` (values (E, d_out, g·keep) + nibble-packed
    indices), mirroring what ``serve.compressed.compress_params`` produces.

    With a global ``(n, m)`` every eligible linear compresses; with a
    ``PrunePlan`` each path resolves through the plan's rules and only
    paths whose cell has pattern "nm" compress, with *their own* (n, m).
    An expert stack compresses only when every slice resolves to one shared
    (n, m) cell (compress_params' packability contract; here the stack
    just stays dense).  MLA's ``wkv_b`` (``NON_STREAMABLE_KERNELS``) stays
    dense, as compress_params leaves it.
    """
    from repro_torch.core.sparsity import (NON_STREAMABLE_KERNELS,
                                           NmCompressed, NmStackedCompressed)

    if plan is None and (n is None or m is None):
        raise ValueError("abstract_nm_params needs (n, m) or plan=")

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    a = abstract_params(model)
    stacks: dict[tuple, dict[int, tuple | None]] = {}
    for path in _linear_paths(model, a):
        nm, pn, pm = _plan_cell(plan, n, m, path)
        if isinstance(path[-1], int):     # expert slice — group by stack
            stacks.setdefault(path[:-1], {})[path[-1]] = \
                (pn, pm) if nm else None
            continue
        if not nm:
            continue                      # dense under this plan
        if any(p in NON_STREAMABLE_KERNELS
               for p in path if isinstance(p, str)):
            continue                      # absorbed-decode raw weight
        kernel = get_path(a, path)
        if kernel.ndim != 2:
            continue
        d_in, d_out = kernel.shape
        if d_in % pm:
            continue
        gk = d_in // pm * (pm - pn)
        packed = NmCompressed(
            values=meta((d_out, gk), kernel.dtype),
            indices=meta((d_out, (gk + 1) // 2), torch.uint8),
            n=pn, m=pm, b=d_in, idx_bits=4)
        a = set_path(a, path[:-1] + ("w",), packed)

    for base, cells in stacks.items():
        kernel = get_path(a, base)
        if kernel.ndim != 3:
            continue
        E, d_in, d_out = kernel.shape
        got = {e: c for e, c in cells.items() if c is not None}
        if set(got) != set(range(E)) or len(set(got.values())) != 1:
            continue                      # unpackable stack — stays dense
        pn, pm = next(iter(got.values()))
        if d_in % pm:
            continue
        gk = d_in // pm * (pm - pn)
        packed = NmStackedCompressed(
            values=meta((E, d_out, gk), kernel.dtype),
            indices=meta((E, d_out, (gk + 1) // 2), torch.uint8),
            n=pn, m=pm, b=d_in, E=E, idx_bits=4)
        a = set_path(a, base, packed)
    return a


def magnitude_nm_params(model, params, n: int | None = None,
                        m: int | None = None, *, plan=None):
    """``params`` with the linears ``abstract_nm_params`` compresses packed
    by ``compress_params`` under magnitude n:m masks (no calibration: the
    serve step's bytes and shapes are what matter).  One path (or expert
    stack) at a time, so a mask is never held for the whole model."""
    from repro_torch.core.masks import nm_mask
    from repro_torch.core.sparsity import NON_STREAMABLE_KERNELS
    from repro_torch.serve.compressed import compress_params

    def mask_of(w, pm, pn):                 # (in, out) kernel → (in, out)
        ones = torch.ones((w.shape[0],), device=w.device)
        return nm_mask(w.T.float(), ones, pn, pm).T.to(w.dtype)

    groups: dict[tuple, dict] = {}
    for path in _linear_paths(model, params):
        nm, pn, pm = _plan_cell(plan, n, m, path)
        if not nm or any(p in NON_STREAMABLE_KERNELS
                         for p in path if isinstance(p, str)):
            continue
        base = path[:-1] if isinstance(path[-1], int) else path
        groups.setdefault(base, {})[path] = (pn, pm)
    out = params
    for base, paths in groups.items():
        cells = set(paths.values())
        kernel = get_path(out, base)
        if len(cells) != 1 or kernel.shape[-2] % next(iter(cells))[1]:
            continue                          # stays dense, as abstract
        pn, pm = next(iter(cells))
        if kernel.ndim == 3 and len(paths) != kernel.shape[0]:
            continue
        masks = {p: mask_of(get_path(out, p), pm, pn) for p in paths}
        out = compress_params(out, masks, pn, pm)
    return out


def make_decode_step(model, mesh, cell,
                     opts: DecodeOptions = DecodeOptions()):
    """→ (step, (params, cache, tokens, pos[, enc]) on meta)."""
    cfg = model.cfg
    if opts.kv_dtype:
        cfg = cfg.replace(kv_cache_dtype=opts.kv_dtype)
        model = _with_cfg(model, cfg)
    B = cell.global_batch
    max_len = opts.cache_len or cell.seq_len

    a_params = (abstract_nm_params(model, *opts.nm) if opts.nm
                else abstract_params(model))
    a_cache = abstract_cache(model, B, max_len)
    specs = registry.decode_specs(cfg, cell)
    if opts.enc_len and "enc_out" in specs:
        e = specs["enc_out"]
        specs["enc_out"] = torch.empty((e.shape[0], opts.enc_len,
                                        e.shape[2]), dtype=e.dtype,
                                       device="meta")

    p_specs = (D.param_pspecs(a_params, mesh)
               if opts.weight_sharding == "tp"
               else D.fsdp_pspecs(a_params, mesh))
    c_specs = D.cache_pspecs(a_cache, mesh, B)
    dp = D.data_axes(mesh)
    tok_spec = D.P(D._entry(dp)) if B % _dp_size(mesh) == 0 else D.P()
    in_specs = (p_specs, c_specs, D.P(*tok_spec, None), tok_spec)
    args = (a_params, a_cache, specs["tokens"], specs["pos"])

    if cfg.family == "encdec":
        enc = specs["enc_out"]
        if opts.cross_cache:
            with torch.no_grad():
                enc = meta_model(model).precompute_cross_kv(a_params, enc)
            enc_spec = D.cache_pspecs(enc, mesh, B)
        else:
            enc_spec = D.batch_spec(mesh, enc.shape[0], rank=3)

        @torch.no_grad()
        def serve_step(params, cache, tokens, pos, enc_out):
            return model.decode_step(params, cache, tokens, pos, enc_out)

        in_specs += (enc_spec,)
        args += (enc,)
    else:
        @torch.no_grad()
        def serve_step(params, cache, tokens, pos):
            return model.decode_step(params, cache, tokens, pos)

    return Step(serve_step, "decode", model, cell, in_specs, opts=opts), args


def make_step(model, mesh, cell):
    if cell.kind == "train":
        return make_train_step(model, mesh, cell)
    if cell.kind == "prefill":
        return make_prefill_step(model, mesh, cell)
    return make_decode_step(model, mesh, cell)
