"""The yardstick's arithmetic: percentiles over every sample, rates over
the whole window, and the FLOP and byte counts against hand counts on
small shapes."""
import numpy as np
import pytest

from bench.lib import flops, stats
from bench.lib.common import PEAK_BF16_FLOPS, PEAK_HBM_BYTES


@pytest.mark.parametrize("q", [0, 25, 50, 90, 95, 100])
def test_percentile_is_over_every_sample(q):
    rng = np.random.default_rng(7)
    xs = list(rng.exponential(size=1001))
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    # one far sample moves the top percentile: nothing is dropped or chunked
    assert stats.percentile(xs + [1e9], 100) == 1e9


def test_rate_uses_the_whole_window():
    assert stats.rate(300, 10.0, 40.0) == 10.0
    with pytest.raises(ValueError):
        stats.rate(1, 5.0, 5.0)


class Cfg:
    d_model, num_heads, num_kv_heads, head_dim = 8, 2, 1, 4
    num_experts, num_experts_per_tok, moe_d_ff, num_dense_layers = 4, 2, 6, 0
    d_ff, vocab_size, num_layers = 0, 10, 1


def test_token_flops_hand_count():
    # q 8·8 + k, v 2·8·4 + o 8·8 = 192; router 8·4 + 2 experts · 3 · 8 · 6
    # = 320; attention at context 3: 2 · 2 heads · 4 · 3 = 48; head 80
    assert flops.token_flops(Cfg, 3) == 2.0 * (192 + 320 + 48 + 80)
    assert flops.token_flops(Cfg, 3, head=False) == 2.0 * (192 + 320 + 48)


def test_block_forward_is_the_sum_over_positions():
    seq = sum(flops.token_flops(Cfg, p + 1, head=False) for p in range(5))
    assert flops.block_forward_flops(Cfg, 0, 3, 5) == 3 * seq


def test_k2_bound_hand_count():
    # W (c=16, b=32) 2:4 in bf16, 4-bit indices, x (B=2, 32)
    kept = 16 * 16
    nbytes = kept * 2 + kept * 0.5 + (2 * 32 + 2 * 16) * 2
    ops = 2.0 * 2 * kept
    assert flops.k2_bound_s(2, 16, 32, 4) == max(nbytes / PEAK_HBM_BYTES,
                                                  ops / PEAK_BF16_FLOPS)


def test_k1_bound_hand_count():
    assert flops.k1_ops(4, 3) == 4 * 3 * 4
    nbytes = 4 * 3 * 2 + 2 * 9 * 4
    assert flops.k1_bound_s(4, 3) == max(nbytes / PEAK_HBM_BYTES,
                                         48 / PEAK_BF16_FLOPS)
    # at the cell's shapes the bound is compute-bound
    assert flops.k1_bound_s(4096, 12288) == pytest.approx(
        flops.k1_ops(4096, 12288) / PEAK_BF16_FLOPS)
