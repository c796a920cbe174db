"""Shared helpers of the PyTorch port's tests (``tests/test_torch_*.py``).

Importing this module caps torch's intra-op threads: the suite runs in
several pytest-xdist workers at once, and each would otherwise start one
thread per core.  Inputs are made with numpy from a seed and handed to both
packages; JAX stays on the CPU.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)


def t(a, dtype=None) -> "torch.Tensor":
    """numpy / JAX array → CPU tensor (bfloat16 through its bits)."""
    from repro_torch.convert import tensor_from_numpy

    out = tensor_from_numpy(np.asarray(a), device="cpu")
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    """tensor → numpy (float32 for bfloat16)."""
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.detach().cpu().numpy()


def jax_tree_to_numpy(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def test_thread_cap():
    assert torch.get_num_threads() == 1


# ------------------------------------------------------------ train parity
# one train step of a REDUCED arch in both packages (test_torch_train*.py)
TRAIN_CELL = ("smoke", 32, 2, "train")      # ShapeCell: seq 32, batch 2
TRAIN_LR = 1e-3


def train_pair(arch: str, **replace):
    """(JAX model, JAX params, JAX batch, port model, port params, port
    batch) of ``arch`` REDUCED (``.replace(**replace)``) from PRNGKey(0),
    the batch from ``concrete_batch`` on TRAIN_CELL."""
    import jax

    from repro.configs.base import ShapeCell
    from repro.configs.registry import concrete_batch
    from repro.configs.registry import get_config as j_get_config
    from repro.models.model_builder import build_model as j_build
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.model_builder import build_model

    jcfg = j_get_config(arch, reduced=True).replace(**replace)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jbatch = concrete_batch(jcfg, ShapeCell(*TRAIN_CELL))
    cfg = get_config(arch, reduced=True).replace(**replace)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")
    batch = {k: (t(v).long() if np.issubdtype(np.asarray(v).dtype,
                                               np.integer) else t(v))
             for k, v in jbatch.items()}
    return jmodel, jparams, jbatch, model, params, batch


def flat_numpy(tree, prefix=()) -> dict:
    """{path: float32 numpy} of a JAX (numpy) or port (tensor) tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_numpy(v, prefix + (k,)))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: n(tree).astype(np.float32)}
    return {prefix: np.asarray(tree, np.float32)}


def assert_grads_close(jgrads, grads, frac: float) -> float:
    """Every leaf: max |Δ| ≤ frac · max |g_jax|; → the worst ratio."""
    jf, tf = flat_numpy(jgrads), flat_numpy(grads)
    assert jf.keys() == tf.keys()
    worst = 0.0
    for k, jg in jf.items():
        scale = float(np.abs(jg).max())
        err = float(np.abs(tf[k] - jg).max())
        assert err <= frac * scale + 1e-30, (k, err, scale)
        worst = max(worst, err / scale if scale else 0.0)
    return worst


def assert_step_params_close(jnew, new, jgrads, lr: float, *,
                             rtol: float = 1e-4, atol: float = 1e-6,
                             small: float = 1e-3) -> None:
    """New params within atol + rtol·|p|; where JAX's |g| is below
    ``small`` of the leaf's max the first Adam step is lr·sign(g) and the
    two signs may differ, so |Δ| ≤ 2·lr."""
    jf, tf, gf = flat_numpy(jnew), flat_numpy(new), flat_numpy(jgrads)
    assert jf.keys() == tf.keys()
    for k, jp in jf.items():
        g = np.abs(gf[k])
        tiny = g < small * g.max()
        err = np.abs(tf[k] - jp)
        bad = (err > atol + rtol * np.abs(jp)) & ~tiny
        assert not bad.any(), (k, float(err[bad].max()))
        assert float(err[tiny].max(initial=0.0)) <= \
            2 * lr + atol + rtol * float(np.abs(jp).max()), k
