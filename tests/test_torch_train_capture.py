"""The compiled train step on the CPU: ``make_train_step`` (JAX's jitted,
donated step), the sharded step's two segments and the tooling's
microbatched step, run through ``util.graphs.graphed`` with donation, on
tinyllama REDUCED.

On a card the step's first call runs eagerly, its second captures a CUDA
graph over the caller's params and moments (donated: bound in place, not
copied) and a static copy of the batch and of the step counter, and later
calls replay it.  Here every call runs inline unless the fake card of
``test_torch_prune_capture`` is installed; its graph is replaced by
``CardGraph``, which does what a capture does that the CPU would not:

* the capture computes nothing — the function runs once for its outputs,
  its writes to tensors that existed before it are rolled back, and the
  outputs it allocated are poisoned (a replay must recompute them);
* a host read of a tensor (``float``, ``item``, ``bool``) raises, as the
  card refuses a sync while a stream captures;

and its replay recomputes the outputs from the static buffers and the
donated tensors.  A key that let a stale buffer through, a donated leaf
copied or cloned, a step counter or lr baked into the graph, or an output
returned without its clone shows as a wrong bit or a raised read.
"""
from __future__ import annotations

import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim.schedules import cosine_warmup as j_cosine  # noqa: E402
from repro.train.step import make_train_step as j_make_train_step  # noqa
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.core.schedule import get_path  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.optim import (AdamW, AdamWState, cosine_warmup,  # noqa: E402
                               sparsity_preserving)
from repro_torch.train.step import (make_sharded_train_step,  # noqa: E402
                                    make_train_step)
from repro_torch.util import graphs  # noqa: E402
from repro_torch.util.tree import leaves, map_tree  # noqa: E402
from test_torch_fixtures import (TRAIN_LR, assert_step_params_close,  # noqa
                                 jax_tree_to_numpy, train_pair)
from test_torch_prune_capture import FakeGraph, _fake  # noqa: E402

OPT = dict(weight_decay=0.1, clip_norm=1.0)
STEPS = 4


def _ptr(t) -> int:
    return t.untyped_storage().data_ptr()


class _CaptureMode(TorchDispatchMode):
    """A capture's rules on the CPU: a host read of a tensor raises; with
    ``undo``, every write to a tensor whose storage existed before the
    mode is rolled back by ``restore()``, and ``fresh`` holds the storages
    the mode's ops allocated."""

    def __init__(self, undo: bool):
        super().__init__()
        self.undo, self.fresh, self.saved = undo, set(), {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._local_scalar_dense.default:
            raise RuntimeError("a tensor read on the host inside a capture")
        if self.undo:
            schema = func._schema
            vals = list(args) + [kwargs.get(a.name)
                                 for a in schema.arguments[len(args):]]
            for a, v in zip(schema.arguments, vals):
                if a.alias_info is None or not a.alias_info.is_write:
                    continue
                for t in (v if isinstance(v, (list, tuple)) else [v]):
                    if isinstance(t, torch.Tensor) and \
                            _ptr(t) not in self.fresh and \
                            _ptr(t) not in self.saved:
                        s = t.untyped_storage()
                        self.saved[_ptr(t)] = (s, s.clone())
        out = func(*args, **kwargs)
        if self.undo:
            rets = func._schema.returns
            outs = [out] if len(rets) == 1 else list(out or ())
            for r, o in zip(rets, outs):
                if r.alias_info is None:
                    self.fresh.update(_ptr(t) for t in pytree.tree_leaves(o)
                                      if isinstance(t, torch.Tensor))
        return out

    def restore(self) -> None:
        for s, copy in self.saved.values():
            s.copy_(copy)


class CardGraph(FakeGraph):
    """``FakeGraph`` with a capture that computes nothing and refuses host
    reads (the module docstring)."""

    def __init__(self, fn, device, pool):
        self.fn, self.pool, self.replays = fn, pool, 0
        self.tally, self.capture_s = [], 0.0
        mode = _CaptureMode(undo=True)
        with mode:
            out = fn()
        mode.restore()
        self.out = pytree.tree_map(
            lambda t: self._poison(t) if isinstance(t, torch.Tensor) and
            _ptr(t) in mode.fresh else t, out)
        FakeGraph.made.append(weakref.ref(self))

    def replay(self):
        with _CaptureMode(undo=False):
            return super().replay()


@pytest.fixture
def card(monkeypatch):
    _fake(monkeypatch)
    monkeypatch.setattr(graphs, "Graph", CardGraph)
    yield
    assert graphs._local().scope is None


@pytest.fixture(scope="module")
def pair():
    return train_pair("tinyllama-1.1b")


def clone(tree):
    return map_tree(torch.clone, tree)


def same(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def batches(batch, n: int = STEPS) -> list:
    """``n`` distinct batches of ``batch``'s shape (tokens rolled)."""
    return [{k: torch.roll(v, i, dims=1) for k, v in batch.items()}
            for i in range(n)]


def run(step, params, state, bs) -> tuple:
    ms = []
    for b in bs:
        params, state, m = step(params, state, b)
        ms.append({k: v.clone() for k, v in m.items()})
    return params, state, ms


def schedule():
    return cosine_warmup(TRAIN_LR, 0, STEPS)


# ------------------------------------------------------------- donation
def test_donated_leaves_are_bound_in_place_and_the_batch_is_copied(card,
                                                                   pair):
    """Four steps (eager, capture, replays): every step returns the
    caller's own tensors, the graph's inputs hold static buffers for the
    batch and the counter only, and the numbers are bitwise the direct
    body's."""
    *_, model, params, batch = pair
    opt = AdamW(**OPT)
    p, bs = clone(params), batches(batch)
    st = opt.init(p)
    ptrs = [x.data_ptr() for x in leaves(p) + leaves(st.mu) + leaves(st.nu)]
    objs = [id(x) for x in leaves(p) + leaves(st.mu) + leaves(st.nu)]
    step = make_train_step(model, opt, schedule())
    for i, b in enumerate(bs):
        p, st, _ = step(p, st, b)
        trees = leaves(p) + leaves(st.mu) + leaves(st.nu)
        assert [x.data_ptr() for x in trees] == ptrs, i
        assert [id(x) for x in trees] == objs, i
    (entry,) = step._scope.entries.values()
    bufs = [x for x in entry.inputs if isinstance(x, torch.Tensor)]
    assert len(bufs) == len(batch) + 1               # batch and counter
    assert all(_ptr(x) not in {_ptr(b) for b in bs[-1].values()}
               for x in bufs)
    assert step.stats()["graphs"] == 1 and step.stats()["replays"] == 3
    rp, rs = clone(params), opt.init(params)
    rp, rs, _ = run(step.__wrapped__, rp, rs, bs)
    assert same(p, rp) and same(st.mu, rs.mu) and same(st.nu, rs.nu)


def test_without_donation_the_callers_trees_are_untouched(card, pair):
    *_, model, params, batch = pair
    opt = AdamW(**OPT)
    p0 = clone(params)
    st0 = opt.init(p0)
    before = clone(p0), clone(st0.mu)
    step = make_train_step(model, opt, schedule(), donate=False)
    p, st = p0, st0
    for b in batches(batch):
        p, st, _ = step(p, st, b)
        assert all(x.data_ptr() != y.data_ptr()
                   for x, y in zip(leaves(p), leaves(p0)))
    assert same(p0, before[0]) and same(st0.mu, before[1])
    assert int(st0.step) == 0 and int(st.step) == STEPS
    rp, rs = clone(params), opt.init(params)
    rp, rs, _ = run(make_train_step(model, opt, schedule()).__wrapped__, rp,
                    rs, batches(batch))
    assert same(p, rp) and same(st.nu, rs.nu)


def test_a_new_shape_or_a_restored_tree_is_a_new_key(card, pair):
    """Another sequence length keys a graph of its own; a tree restored
    into new storage does too, and the graphs of the tree it replaced are
    dropped once that tree is gone."""
    *_, model, params, batch = pair
    opt = AdamW(**OPT)
    step = make_train_step(model, opt, schedule())
    p, st = clone(params), opt.init(params)
    for b in batches(batch, 3):
        p, st, _ = step(p, st, b)
    short = {k: v[:, :16] for k, v in batch.items()}
    p, st, _ = step(p, st, short)
    assert len(step._scope.entries) == 2
    old = weakref.ref(leaves(p)[0].untyped_storage())
    p, st = clone(p), AdamWState(st.step, clone(st.mu), clone(st.nu))
    gc.collect()
    assert old() is None
    p, st, _ = step(p, st, batch)                # the restored tree: eager
    assert len(step._scope.entries) == 1
    for b in batches(batch, 2):
        p, st, _ = step(p, st, b)
    assert step.stats()["graphs"] == 2 and int(st.step) == 7
    step.release()
    assert step._scope.entries == {} and step._scope.pool is None


# ----------------------------------------------------- the step counter
def test_the_counter_and_the_schedule_follow_every_replay(card, pair):
    """Six steps under a cosine schedule that changes lr at every step:
    the host counter advances, lr is the schedule's at that step, and
    the params (through bc1, bc2 and lr) are bitwise the direct run's."""
    *_, model, params, batch = pair
    opt, sched = AdamW(**OPT), cosine_warmup(TRAIN_LR, 1, 6)
    step = make_train_step(model, opt, sched)
    p, st, ms = run(step, clone(params), opt.init(params), batches(batch, 6))
    assert st.step.device.type == "cpu" and st.step.dtype == torch.int32
    assert int(st.step) == 6 and step.stats()["replays"] == 5
    want = [float(sched(torch.tensor(i, dtype=torch.int32)))
            for i in range(6)]
    assert [float(m["lr"]) for m in ms] == want
    assert len(set(want)) == 6
    rp, rs, rms = run(step.__wrapped__, clone(params), opt.init(params),
                      batches(batch, 6))
    assert same(p, rp) and same(st.mu, rs.mu) and same(st.nu, rs.nu)
    assert all(torch.equal(m[k], r[k]) for m, r in zip(ms, rms) for k in m)


def test_an_update_that_reads_lr_on_the_host_fails(card, pair, monkeypatch):
    """The update reading ``float(lr)`` — a value a graph would bake in at
    its capture — runs inline but is refused by the capture."""
    *_, model, params, batch = pair
    real = AdamW._update

    def host_lr(self, grads, state, params, lr, inplace):
        return real(self, grads, state, params, float(lr), inplace)

    monkeypatch.setattr(AdamW, "_update", host_lr)
    opt = AdamW(**OPT)
    run(make_train_step(model, opt, schedule()).__wrapped__, clone(params),
        opt.init(params), batches(batch, 2))
    step = make_train_step(model, opt, schedule())
    p, st, _ = step(clone(params), opt.init(params), batch)   # eager
    with pytest.raises(RuntimeError, match="read on the host"):
        step(p, st, batch)


def test_the_masked_finetune_keeps_pruned_coordinates_at_zero(card, pair):
    *_, model, params, batch = pair
    p = clone(params)
    gen = torch.Generator().manual_seed(0)
    masks = {}
    for path in (("blocks", 0, "mlp", "gate", "w"),
                 ("blocks", 1, "attn", "wq", "w")):
        m = torch.rand(get_path(p, path).shape, generator=gen) < 0.5
        get_path(p, path).masked_fill_(m, 0)
        masks[path] = m.float()
    opt = sparsity_preserving(AdamW(**OPT), masks)
    step = make_train_step(model, opt, schedule())
    q, st, _ = run(step, clone(p), opt.init(p), batches(batch))
    for path, m in masks.items():
        assert get_path(q, path)[m > 0.5].abs().max() == 0
        assert not torch.equal(get_path(q, path), get_path(p, path))
    assert step.stats()["replays"] == 3


# ----------------------------------------------------- against JAX's step
def _load(dst, src) -> None:
    """Write the numpy (JAX) tree ``src`` into the tensors of ``dst`` in
    place: the donated storage stays, so the graph keeps replaying."""
    for x, v in zip(leaves(dst), leaves(src)):
        x.copy_(torch.from_numpy(np.array(v, np.float32)).to(x.dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_four_replayed_steps_match_jaxs_jitted_step(card, dtype):
    """Four steps of the graphed path (eager, capture, replays) under a
    cosine schedule that changes lr at every step, each from JAX's state
    at that step (written into the donated tensors in place; the counter
    JAX's), against JAX's jitted ``make_train_step`` at
    test_torch_train.py's tolerances: lr exactly, loss and grad_norm at
    rel 1e-5 (bf16: 1e-2 and 2e-2), the new params by
    ``assert_step_params_close`` (bf16: its bf16 tolerances).  In bf16
    each step starts from zero moments: that file's bound holds for an
    update lr·c·sign(g) (c ≤ 1 at every t through bc1 and bc2), and the
    two frameworks' bf16 grads differ by up to 5e-2 of a leaf's max, which
    carried moments turn into |Δ| beyond it.  Then four steps of the graph
    from the start are bitwise the direct body's."""
    bf16 = dtype == "bfloat16"
    jmodel, jparams, jbatch, model, params, batch = train_pair(
        "tinyllama-1.1b", dtype=dtype)
    jopt, opt = JAdamW(**OPT), AdamW(**OPT)
    jstep = j_make_train_step(jmodel, jopt, j_cosine(TRAIN_LR, 0, STEPS),
                              remat="block", donate=False)
    jgrad = jax.jit(jax.value_and_grad(jmodel.loss))
    jp, js = jparams, jopt.init(jparams)
    step = make_train_step(model, opt, schedule())
    p, st = clone(params), opt.init(params)
    tol = {"loss": 1e-2 if bf16 else 1e-5,
           "grad_norm": 2e-2 if bf16 else 1e-5, "lr": 0.0}
    kw = dict(rtol=1e-2, atol=1e-5, small=5e-2) if bf16 else {}
    for i in range(STEPS):
        if bf16:
            js = js._replace(mu=jopt.init(jp).mu, nu=jopt.init(jp).nu)
        _load(p, jax_tree_to_numpy(jp))
        _load(st.mu, jax_tree_to_numpy(js.mu))
        _load(st.nu, jax_tree_to_numpy(js.nu))
        st = AdamWState(torch.tensor(int(js.step), dtype=torch.int32),
                        st.mu, st.nu)
        _, jg = jgrad(jp, jbatch)
        jp, js, jm = jstep(jp, js, jbatch)
        p, st, m = step(p, st, batch)
        for k, r in tol.items():
            a, b = float(m[k]), float(jm[k])
            assert abs(a - b) <= r * abs(b), (i, k, a, b)
        assert_step_params_close(jax_tree_to_numpy(jp), p,
                                 jax_tree_to_numpy(jg), TRAIN_LR, **kw)
    assert step.stats()["replays"] == 3 and int(st.step) == STEPS
    p, st, _ = run(step, clone(params), opt.init(params), [batch] * STEPS)
    rp, rs, _ = run(step.__wrapped__, clone(params), opt.init(params),
                    [batch] * STEPS)
    assert same(p, rp) and same(st.mu, rs.mu) and same(st.nu, rs.nu)


# ------------------------------------------------------ the sharded step
@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A one-rank gloo group in this process and its 1 × 1 mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    store = tmp_path_factory.mktemp("gloo1") / "store"
    dist.init_process_group("gloo", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                               "model"))
    finally:
        dist.destroy_process_group()


def test_one_rank_sharded_segments_are_bitwise_make_train_step(card, mesh1,
                                                               pair):
    """The two graphed segments (loss + grads into the step's buffer,
    then the update) with the eager all-reduce between them, against the
    graphed ``make_train_step``: losses, lr, params and both moments
    bitwise; the DTensors' local storage is bound in place."""
    from repro_torch.dist.sharding import shard_params

    *_, model, params, batch = pair
    opt = AdamW(**OPT)
    ref = make_train_step(model, opt, schedule())
    rp, rs = clone(params), opt.init(params)
    s0 = opt.init(params)
    sp = shard_params(clone(params), mesh1, fsdp=False)
    ss = AdamWState(s0.step, shard_params(s0.mu, mesh1, fsdp=False),
                    shard_params(s0.nu, mesh1, fsdp=False))
    ptrs = [d.to_local().data_ptr() for d in leaves(sp)]
    step = make_sharded_train_step(model, opt, schedule(), mesh1, batch,
                                   params)
    for b in batches(batch):
        rp, rs, rm = ref(rp, rs, b)
        sp, ss, sm = step(sp, ss, b)
        assert torch.equal(sm["loss"], rm["loss"])
        assert torch.equal(sm["lr"], rm["lr"])
    assert [d.to_local().data_ptr() for d in leaves(sp)] == ptrs
    full = lambda t: map_tree(lambda d: d.full_tensor(), t)  # noqa: E731
    assert same(full(sp), rp) and same(full(ss.mu), rs.mu)
    assert same(full(ss.nu), rs.nu) and int(ss.step) == STEPS
    st = step.stats()
    assert st["graphs"] == 2 and st["replays"] == 6


# ------------------------------------------------ the tooling's step
def test_the_microbatched_step_replays_its_eager_run(card, mesh1, pair):
    """``launch/steps.make_train_step`` (2 microbatches, bf16 moments):
    four steps from one donated graph, bitwise its direct run."""
    *_, model, params, batch = pair
    step, _ = S.make_train_step(model, mesh1,
                                ShapeCell("smoke", 32, 2, "train"),
                                microbatches=2)
    opt = step.optimizer
    p, st, ms = run(step, clone(params), opt.init(params), batches(batch))
    assert step.fn.stats()["graphs"] == 1
    assert step.fn.stats()["replays"] == 3
    rp, rs, rms = run(step.fn.__wrapped__, clone(params), opt.init(params),
                      batches(batch))
    assert same(p, rp) and same(st.mu, rs.mu) and same(st.nu, rs.nu)
    assert all(torch.equal(m["loss"], r["loss"]) for m, r in zip(ms, rms))
    assert st.mu["blocks"][0]["mlp"]["gate"]["w"].dtype == torch.bfloat16


def test_on_the_cpu_the_step_runs_inline(pair):
    """Without a card no key is made: the step is its direct body."""
    *_, model, params, batch = pair
    opt = AdamW(**OPT)
    step = make_train_step(model, opt, schedule())
    p, st, _ = run(step, clone(params), opt.init(params), batches(batch, 2))
    assert step.stats()["calls"] == 0 and step._scope.entries == {}
    rp, rs, _ = run(step.__wrapped__, clone(params), opt.init(params),
                    batches(batch, 2))
    assert same(p, rp) and same(st.mu, rs.mu)
