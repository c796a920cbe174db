"""``prune_model`` keeps its Hessian accumulators across blocks, as the JAX
schedule does: a linear applied in several blocks (a weight-shared layer)
and pruned at its last one is pruned from the statistics of every block
that applied it.

The adapter is synthetic: two blocks apply one (16, 16) linear, block 0 to
its input scaled per channel by up to e², block 1 to its input as is; the
linear is pruned (Thanos 2:4) in block 1.  The Hessian of block 0's inputs
dominates the sum, so a schedule that dropped it would choose other masks.
Masks exactly equal to JAX's, weights rtol 5e-3 / atol 5e-4 (as
tests/test_torch_slice.py); the mask chosen from block 1's inputs alone
differs from the right one."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import PruneConfig as JPruneConfig  # noqa: E402
from repro.core import prune_model as j_prune_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.core.api import PruneConfig  # noqa: E402
from repro_torch.core.schedule import prune_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from test_torch_fixtures import n, t  # noqa: E402

D = 16
PATH = ("shared", "w")
SCALE = np.exp(np.linspace(-2.0, 2.0, D)).astype(np.float32)
CELL = dict(method="thanos", pattern="nm", n=2, m=4, block_size=64)


class _Shared:
    """Block i: h ← h + tanh(dense(W, x_i)), x_0 = h·SCALE, x_1 = h; the
    one linear is pruned in the last block that applies it."""

    def __init__(self, xp, dense, tanh, blocks=(0, 1)):
        self.xp, self.dense, self.tanh, self.blocks = xp, dense, tanh, blocks

    def num_blocks(self, params):
        return 2

    def prepare(self, params, batch):
        return batch["x"]

    def block_apply(self, params, i, h, *, capture):
        tape = {} if capture else None
        x = h * self.xp(SCALE) if i == 0 else h
        out = h
        if i in self.blocks:
            out = h + self.tanh(self.dense(params["shared"], x, tape,
                                           ("shared",)))
        return out, (tape or {})

    def block_linear_paths(self, params, i):
        return [PATH] if i == self.blocks[-1] else []


def _inputs():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(D, D)).astype(np.float32) / 4.0
    xs = [rng.normal(size=(4, 8, D)).astype(np.float32) for _ in range(2)]
    return w, xs


def _port(blocks=(0, 1)):
    w, xs = _inputs()
    adapter = _Shared(torch.from_numpy, L.dense, torch.tanh, blocks)
    return prune_model({"shared": {"w": t(w)}}, adapter,
                       [{"x": t(x)} for x in xs], PruneConfig(**CELL))


def test_shared_linear_pruned_from_every_block_matches_jax():
    w, xs = _inputs()
    jadapter = _Shared(jnp.asarray, JL.dense, jnp.tanh)
    jpruned, jrep = j_prune_model({"shared": {"w": jnp.asarray(w)}},
                                  jadapter,
                                  [{"x": jnp.asarray(x)} for x in xs],
                                  JPruneConfig(**CELL))
    tpruned, trep = _port()
    assert list(trep.masks) == list(jrep.masks) == [PATH]
    np.testing.assert_array_equal(n(trep.masks[PATH]),
                                  np.asarray(jrep.masks[PATH]))
    np.testing.assert_allclose(n(tpruned["shared"]["w"]),
                               np.asarray(jpruned["shared"]["w"]),
                               rtol=5e-3, atol=5e-4)
    assert [r.path for r in trep.layers] == [PATH]


def test_block0_statistics_change_the_mask():
    """Control: the mask from block 1's inputs alone (the linear applied
    in block 1 only) is not the mask from both blocks — the sum above
    really carries block 0's Hessian."""
    _, both = _port()
    _, last = _port(blocks=(1,))
    assert not torch.equal(both.masks[PATH], last.masks[PATH])
