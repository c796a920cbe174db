"""The port's train step on the CPU against the JAX package's for deepseek
(MLA + MoE), zamba2 (Mamba2 + shared attention), xlstm (mLSTM/sLSTM) and
whisper (encoder–decoder), REDUCED, at the tolerances of
test_torch_train.py: loss rel 1e-5, every leaf's gradient within 1e-4 of
its max |g|, one jitted JAX step against ``make_train_step`` (loss, lr,
grad_norm rel 1e-5; new params 1e-6 + 1e-4·|p| outside the lr·sign(g)
coordinates).  remat 'block' equals 'none' bitwise for zamba2, xlstm and
whisper (their blocks carry recurrent state and the encoder output).
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from test_torch_train import remat_bitwise, step_parity  # noqa: E402

ARCHS = ("deepseek-v3-671b", "zamba2-7b", "xlstm-1.3b", "whisper-medium")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    step_parity(arch)


@pytest.mark.parametrize("arch", ("zamba2-7b", "xlstm-1.3b",
                                  "whisper-medium"))
def test_remat_block_equals_none_bitwise(arch):
    remat_bitwise(arch)
