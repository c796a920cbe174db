"""The compiled train step's CUDA graphs on a card (marked ``cuda``: they
skip without one; this file imports no JAX, so it runs where JAX is
absent):

    python -m pytest -q --noconftest -m cuda tests/test_torch_train_capture_cuda.py

``make_train_step``'s step runs its first call eagerly, captures its
second over the donated params and moments, and replays from then on.
The reference is the same body called directly (``step.__wrapped__``):
with deterministic algorithms on, a replay runs the kernels the direct
call runs, so params, both moments, losses and grad norms are bitwise
equal over four steps of a cosine schedule whose lr changes at every
step — a graph that baked in the capture's counter or lr fails.  Every
family's REDUCED model in bf16; then the donated storage, the memory a
replay holds, the pool's release, the tooling's microbatched step and a
refused capture.
"""
from __future__ import annotations

import gc

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.model_builder import build_model  # noqa: E402
from repro_torch.optim import AdamW, cosine_warmup  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from repro_torch.util import graphs  # noqa: E402
from repro_torch.util.tree import leaves, map_tree  # noqa: E402

CELL = ShapeCell("smoke", 32, 2, "train")
STEPS = 4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return resolve_device("cuda")


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


def _setup(arch: str, dev, seed: int = 0):
    cfg = registry.get_config(arch, reduced=True).replace(dtype="bfloat16")
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init(gen)
    batches = [registry.concrete_batch(cfg, CELL, gen, device=dev)
               for _ in range(STEPS)]
    return model, params, batches


def _run(step, opt, params, batches) -> tuple:
    p, ms = map_tree(torch.clone, params), []
    st = opt.init(p)
    for b in batches:
        p, st, m = step(p, st, b)
        ms.append({k: v.clone() for k, v in m.items()})
    torch.cuda.synchronize()
    return p, st, ms


def _same(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", registry.ARCHS)
def test_every_family_replays_bitwise_the_direct_step(cuda, deterministic,
                                                      arch):
    model, params, batches = _setup(arch, cuda)
    opt = AdamW(weight_decay=0.1, clip_norm=1.0)
    step = make_train_step(model, opt, cosine_warmup(1e-3, 1, STEPS))
    p, st, ms = _run(step, opt, params, batches)
    rp, rs, rms = _run(step.__wrapped__, opt, params, batches)
    assert step.stats()["graphs"] == 1 and step.stats()["replays"] == 3
    assert _same(p, rp) and _same(st.mu, rs.mu) and _same(st.nu, rs.nu)
    for m, r in zip(ms, rms):
        assert all(torch.equal(m[k], r[k]) for k in m), arch
    assert len({float(m["lr"]) for m in ms}) == STEPS
    step.release()


@pytest.mark.cuda
def test_donated_storage_stays_and_replays_hold_no_new_memory(cuda):
    model, params, batches = _setup("tinyllama-1.1b", cuda)
    opt = AdamW()
    step = make_train_step(model, opt, cosine_warmup(1e-3, 1, 8))
    p = map_tree(torch.clone, params)
    st = opt.init(p)
    trees = lambda: leaves(p) + leaves(st.mu) + leaves(st.nu)  # noqa: E731
    ptrs = [x.data_ptr() for x in trees()]
    held = []
    for i in range(8):
        p, st, m = step(p, st, batches[i % STEPS])
        del m
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated(cuda))
        assert [x.data_ptr() for x in trees()] == ptrs, i
    assert held[2:] == [held[2]] * 6, held
    assert step.stats()["replays"] == 7


@pytest.mark.cuda
def test_the_pool_is_returned_when_the_step_is_released(cuda):
    model, params, batches = _setup("tinyllama-1.1b", cuda)
    opt = AdamW()
    step = make_train_step(model, opt, cosine_warmup(1e-3, 1, STEPS))
    p = map_tree(torch.clone, params)
    st = opt.init(p)
    p, st, _ = step(p, st, batches[0])              # eager: the warm-up
    before = graphs.settled_reserve(cuda)
    for b in batches[1:]:
        p, st, _ = step(p, st, b)
    pool = step.stats()["pool_bytes"]
    assert pool > 0
    step.release()
    gc.collect()
    assert graphs.settled_reserve(cuda) <= before


@pytest.mark.cuda
def test_the_microbatched_tooling_step_replays_bitwise(cuda, deterministic):
    from repro_torch.dist.sharding import MeshShape
    from repro_torch.launch import steps as S

    model, params, batches = _setup("tinyllama-1.1b", cuda)
    step, _ = S.make_train_step(model, MeshShape(("data", "model"), (1, 1)),
                                CELL, microbatches=2)
    opt = step.optimizer
    p, st, ms = _run(step, opt, params, batches)
    rp, rs, rms = _run(step.fn.__wrapped__, opt, params, batches)
    assert step.fn.stats()["replays"] == 3
    assert _same(p, rp) and _same(st.mu, rs.mu) and _same(st.nu, rs.nu)
    assert all(torch.equal(m["loss"], r["loss"]) for m, r in zip(ms, rms))


@pytest.mark.cuda
def test_an_update_reading_lr_on_the_host_is_refused(cuda, monkeypatch):
    """``float(lr)`` in the update: the eager warm-up runs, the capture
    raises (a sync while the stream captures) — no eager fallback."""
    real = AdamW._update

    def host_lr(self, grads, state, params, lr, inplace):
        return real(self, grads, state, params, float(lr), inplace)

    monkeypatch.setattr(AdamW, "_update", host_lr)
    model, params, batches = _setup("tinyllama-1.1b", cuda)
    opt = AdamW()
    step = make_train_step(model, opt, cosine_warmup(1e-3, 1, STEPS))
    p = map_tree(torch.clone, params)
    p, st, _ = step(p, opt.init(p), batches[0])
    with pytest.raises(RuntimeError):
        step(p, st, batches[1])
    step.release()
