#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # from the root of a checkout

Phases (each ends in ``torch.cuda.synchronize()``; any failure exits
non-zero without the final result line):

1. build   — compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
             (one ``nvcc`` per source, in parallel).
tooling. tooling — right after the build, on the empty card and in a
             spawned process of its own, the JAX package's tooling as
             the port runs it: (a) the dry run's
             abstract sweep of all 40 (arch, cell) pairs on the 16 × 16
             mesh (meta device: fits, bottleneck, roofline step on the
             H100's peaks); (b) ``--measure``: every supported decode cell
             whose arguments fit one card at full depth runs on the card;
             (c) the three perf ladders (mistral-large-123b, xlstm-1.3b,
             whisper-medium decode_32k) at full width, B = 128 and the
             cell's cache depth, each cut in depth only (perf.LADDER_DEPTH;
             whisper's cache448 rungs also at full depth); (d) the prefill
             step at tinyllama-1.1b's full width and depth, prefill_32k cut
             to B = 1 and PREFILL_SEQ tokens.  Each of (b)–(d) is a
             compiled step (``dryrun.timed_runs``): 5 direct calls after a
             warm-up, then its CUDA graph — warm-up, capture, 5 replays —
             and one more replay from the fresh cache, bitwise the direct
             call's logits; per cell and rung the eager, capture and
             replayed ms, pool bytes, peak bytes and replayed / eager over
             the bound.  nm rungs' replayed first-step logits against the
             decompressed tree at rel ≤ 5e-2 (xlstm's on the rung's first
             block, its own step replayed, as phase families holds it),
             int8 rungs' replayed logits against a bf16 cache filled with
             the same random k/v at max |Δ| < 1.0 and < 0.1 × the filled
             cache's own effect; then K2 checked and timed at the nm
             rungs' B = 128 shapes beside torch.matmul and the bound (rows
             added to phase 5's).
draws. draws — right after tooling: gemma3-1b's held-out slice (vocabulary
             262 144) and tinyllama-1.1b's calibration batches drawn on
             the card by the float64 chain from numpy's uniforms, token
             for token numpy's host draw (made in a spawned process a
             batch once the tooling phase is done); both seconds printed.
2. kernels — hold each kernel against its plain PyTorch version on the card:
             K1 (Hessian update) fp32/bf16 at b ∈ {2048, 5632}, a masked-rows
             batch and a NaN batch that must be skipped; K2 (n:m matmul) at
             the serving shapes for idx_bits 4/8, fp32/bf16, plus odd shapes;
             then the MoE path's shapes: K1 at (1024, 4096) and at the
             expert capacity buffers (80, 2048) / (80, 768) with a random
             row mask, K2 at qwen3-moe's attention shapes, K3 (stacked
             expert matmul) at both full-width expert leaves and odd shapes;
             then K1 and K2 at deepseek-v3's MLA and MLP shapes (MLA_K1,
             MLA_K2), at gemma3-1b's (GEMMA_K1, GEMMA_K2) and at the
             families' (ZAMBA_*, XLSTM_*, WHISPER_*; K2 also at (4, 4096)
             and at whisper's encoder rows, B = 6000) and at dense2's
             (DENSE2_K1, DENSE2_K2: b = 28 672, too wide for K2's 8-row
             blocks, on the many-row kernel at B = 1 and 4), each K2
             launch's plan printed and two launches bitwise equal.
3. prune   — the dense path: Thanos 2:4 prunes tinyllama-1.1b at full width
             and depth from a seeded random init (K1 carries the Hessians).
             Every prune of every phase runs its solves and block passes
             from CUDA graphs (``util.graphs``, captured at a key's second
             use) and prints its graphs, replays, capture seconds, pool
             bytes, the card's reserve before and after, and its seconds
             (``graphs_line``).
prune-graphs. right after phase 3, outside the path's counts: (a) the twelve
             method × pattern solves at tinyllama's four full-width shapes
             (PG_SHAPES), each replayed against its direct eager call on two
             (W, H) pairs in turn — weights, mask and loss bitwise — with
             the direct and replayed ms, capture s and pool bytes; (b) the
             first PG_BLOCKS blocks of phase 3's graphed prune against an
             eager loop of ``block_apply``, ``HessianAccumulator`` and the
             solver called directly: 0 differing mask entries, bf16 weights
             max |Δ| 0.
4. serve   — compress the pruned linears and serve 4 requests through the
             continuous-batching engine, compressed-resident (K2 carries
             every pruned linear); then hold the kernel path's first-step
             logits against the same params decompressed and served dense;
             then serve the same requests with the int8 KV cache
             (QuantGqaCache) and hold its logits against the bf16 cache's;
             then ``heldout_loss``'s 4-batch loss at full width, graphed
             (capture included) against eager, in turns, losses bitwise
             equal.
graphs. graphs — every ServingEngine on the card serves from CUDA graphs
             of its model step (B = 1 admissions, B = 4 decode; a wave
             engine one B = 4 graph), and every serve prints the graphs
             each engine captured and replayed.  This phase, right after
             phase 4 (tinyllama bf16, int8 and paged) and inside 4m
             (qwen3-moe: K3 in the graph) and families (zamba2, xlstm: the
             recurrent state written in place), serves the phase-4 trace
             captured and through an eager ``model.decode_step`` loop (B =
             1 prefills, then a B = 4 lockstep decode): tokens identical,
             K2 and K3 launches equal, the logits' max |Δ| printed
             (expected 0), tok/s both ways, the capture's seconds and its
             pool's bytes, and one replayed and one eager step at B = 4
             and B = 1.
train. train — right after phase 4, on phase 3's pruned tree and masks:
             (a) ``python -m repro_torch.launch.train`` on tinyllama at full
             width and depth, batch 8 × 256, 4 steps saving at step 4 (an
             11 GB checkpoint; the free disk must hold twice it), then a
             second run to step 6 that must print ``restored checkpoint at
             step 4``, losses finite, the checkpoint's bytes and save and
             restore seconds printed; (b) ``Trainer`` at full width cut to
             TRAIN_RESTART_LAYERS layers, remat 'block': 8 uninterrupted
             steps against 4 + a resume, params, both moments and the
             losses of steps 4–7 bitwise equal (deterministic algorithms
             on for this check only); (c) the paper's sparse finetune at
             full size: FINETUNE_STEPS steps of the sparsity-preserving
             AdamW (wd 0.01, clip 1.0, cosine 5e-4) on a clone of the
             pruned tree, from ``TrainStream`` step 1000, from the step's
             CUDA graph (step 1 eager, step 2 captured, then replays; (a)
             and (b) run graphed too) — every pruned coordinate of the 154
             masked linears exactly 0, held-out loss below the pruned
             tree's, strict 2:4 compression 0.625, the phase-4 request
             set served (K2 launches counted), the first-step logits
             against the decompressed tree at rel ≤ 5e-2; the eager,
             capture and replayed step ms, tokens/s, the graph's capture
             s and pool bytes, peak memory, the stream's draw (batch 1
             eager, batch 2 the capture, then replays of its sampler's
             graph, every draw bitwise the eager ``sample_torch``), and
             eager / replayed ms of the loss, loss + grads without and
             with remat, and the update alone (its own graph: a capture
             holds no timing event) printed; (c′) REPLAY_STEPS steps of
             a cosine schedule on fresh clones, from the graph against
             the direct function — params, moments, losses, grad norms
             bitwise equal (deterministic algorithms on), and not so
             with an update that reads the capture's lr planted.
base. baselines — the paper's comparison methods on phase 3's dense
             tinyllama tree: SparseGPT (block 64), Wanda and magnitude each
             prune 2:4 (K1), compress and serve the phase-4 request set
             (K2), with held-out losses, exact launch counts and the
             first-step logits; then the four methods prune layer 0's gate
             (5632, 2048) unstructured p = 0.5 on its K1 Hessian (Thanos and
             SparseGPT must beat magnitude's reconstruction error), and
             SparseGPT 2:4 on that (w, H) runs on the card and on the CPU
             (errors within 1 %, ≥ 0.99 of the mask entries agreeing).
plan. plan — tinyllama under examples/recipes/mixed_2to4_serve.json: MLP
             2:4, attention unstructured, served with mixed residency (K2
             for the MLP, 66 launches a model step; attention dense); the
             bytes ratios, the report's rule rollup, the first-step logits;
             then besa_trace_budget.json's sparsity allocation over one
             dense capture pass (K1), its budget and clip held.
4m. moe    — the MoE path: qwen3-moe-30b-a3b at full width, depth cut to
             MOE_LAYERS layers, Thanos 2:4 prunes every expert slice on its
             routed tokens (K1), every expert stack packs into one stacked
             leaf, and the engine serves the phase-4 request set (K3 for
             the expert stacks, K2 for attention); exact launch counts and
             the first-step logits against the decompressed params.
4mla. mla  — the MLA path: deepseek-v3-671b at full width, depth cut to
             its MLA_LAYERS leading dense layers; Thanos 2:4 prunes their
             8 linears a layer (K1 at b up to 18 432), every wkv_b serves
             dense (one CompressionDowngrade each), the engine serves the
             phase-4 request set with the bf16 latent cache (MlaCache) and
             again with the int8 one (QuantMlaCache); exact launch counts, the
             first-step logits against the decompressed params and the
             int8 logits against the bf16 cache's.
paged. paged — the paged KV cache (page pools shared by the slots, prefix
             reuse, copy-on-write, preemption), every engine auditing its
             pager after every step: tinyllama (phase 4's tree) serves the
             phase-4 set on an auto-sized pool (tokens identical to phase
             4's), a prefix trace (prefix hits and copies required, tokens
             identical to the contiguous engine's), the phase-4 set on the
             progress-floor pool (preemptions required, pool drained) and
             with the int8 pool (tokens identical to phase 4's int8 run);
             after the mla phase, deepseek-v3 serves it with both paged
             latent caches (tokens identical to that phase's); then
             gemma3-1b at full width, depth cut 26 → GEMMA_LAYERS (5
             local layers and the global one): Thanos 2:4 prune (K1,
             2 · 7 · L launches), compress, and 4 requests — one of 528
             tokens, which wraps every window-512 ring — served contiguous
             and paged in the mixed layout (1 page pool beside 5 rings),
             tokens identical, K2 in every serve, and the first-step logits
             against the decompressed params.
families. families — the recurrent and encoder–decoder families, bf16
             from seed 0, each pruned with Thanos 2:4 B=64 on 2 × 8 × 128
             tokens (K1), compressed (0.625 of dense bytes) and decoded
             compressed-resident (K2), with exact launch counts:
             zamba2-7b at full width, depth cut 81 → 24 (shared sites 5,
             11, 17, 23: each shared set pruned once, at its second site,
             from both sites' Hessians), the phase-4 set served with bf16
             and int8 shared caches; xlstm-1.3b at full width, depth cut
             48 → XLSTM_LAYERS (14 mLSTM, 2 sLSTM blocks), served, its
             bf16 matrix memory against fp32; each engine's
             tokens against teacher-forced B = 1 loops; whisper-medium at
             full width, depth cut to WHISPER_LAYERS + WHISPER_LAYERS:
             encode 4 × 1500 frames (K2 at x
             (6000, b)), cross k/v once, 12 greedy tokens at B = 4,
             identical to the uncached decode's; every family's
             first-step logits against its decompressed tree (xlstm's
             in bf16 at one block and in fp32 at XLSTM_DEPTHS, where a
             lane shift planted in one block must fail the check).
dense2. dense2 — the rest of the dense family and the VLM backbone, bf16
             from seed 0, each pruned with Thanos 2:4 B=64 on 2 × 8 × 128
             tokens (K1), compressed (0.625 of dense bytes) and serving the
             phase-4 request set compressed-resident (K2), launch counts
             exact, first-step logits against the decompressed tree at rel
             ≤ 5e-2: h2o-danube-1.8b at full width, 8 of 24 layers
             (head_dim 80, every layer a window of 4096), also served
             paged — every layer a ring, no pool — with tokens identical
             to the contiguous engine's; mistral-large-123b and internvl2-76b at
             full width, depth cut to 1 layer (DENSE2_LAYERS); internvl
             calibrated on the VLM batch (64 image + 64 text positions a
             row), then VLM_IMAGE patch embeddings through
             decode_step(embeds=) and VLM_TEXT tokens from an empty cache,
             its last logits against ``forward`` on the same batch over the
             decompressed tree at rel ≤ 5e-2.
robust. robust — on phase 4's compressed tinyllama tree, right after the
             paged part: (a) the supervised continuous engine serves the
             phase-4 set without faults (its longest pump sets the step
             deadline: twice it, at least 0.5 s), then under
             ``decode_logits@5;prefill@2;decode_stall@9+<deadline + 1 s>``
             (snapshots persisted atomically), and paged under the same
             plan plus ``pager_fault_in@7x6``: every request completes,
             recoveries > 0, every site fired, tokens identical to phase
             4's, the pager audit clean; (b) a snapshot taken after 6
             pumps (host tensors only), pickled, written atomically and
             restored into a fresh engine: both continue with phase 4's
             tokens; (c) a PruneJob on tinyllama at full width cut to
             JOB_LAYERS layers killed by ``journal_write@JOB_KILL`` and
             resumed is bitwise equal to an uninterrupted one; cholesky@0
             escalates layer 0 once and hessian_accum@0 makes its
             calib_skipped 1 (on SITE_LAYERS layers); (d) the SSE front
             end on 127.0.0.1 streams two requests with phase 4's tokens,
             /healthz answers, and one slot with a queue of one answers a
             third request 503.  Launches: K2 154 a model step (each
             engine's ``graph_stats()`` counts its steps, eager or
             replayed), K1 those of the prune jobs.
dist. dist — right after robust, on phase 3's tree, over two spawned
             ranks on the one card (NCCL refuses two ranks on one device:
             its answer is printed once; so gloo, FileStore in a temp dir
             under build/, a (2, 1) ("data", "model") mesh): (a)
             ``prune_model(mesh=)`` at full width and depth, every solve
             split over both ranks — 0 mask entries differing from phase
             3's, index bytes equal, weights' max |Δ| (bf16 tree; fp32 on
             layer 0's up and down against their local solve), summed OBS
             losses against phase 3's, K1 308 launches a rank, the first
             step served through K2 at rel ≤ 5e-2; (b) a one-rank NCCL
             group in this process: ``prune_layer_sharded`` of layer 0's up
             bitwise ``prune_layer`` for three patterns; (c) each rank's
             calibration batch through K1, all-reduced: bitwise
             ``combine`` and within rtol 1e-6 of one accumulator over both;
             (d) DIST_STEPS steps of ``make_sharded_train_step`` on the
             train phase's batch against ``make_train_step`` (losses within
             DIST_LOSS_TOL, params within 6·lr + 3·2⁻⁷·|p|), the eager,
             capture and median replayed step ms and one gradient
             all-reduce's share of the replayed step; (e) int8 compression of a
             full gradient tree: a quarter of the fp32 bytes, residual ≤ 4
             scales, the card's payload bitwise the host's.
   Then the redesigned kernels at odd shapes: K1 at ragged tokens and b
             with and without a row mask (xtx exactly symmetric, NaN batch
             skipped), and K1's wgmma kernel under every plan it can take
             (ring configuration, tile, token split, xtx prefetch) at
             K1_PLAN_SHAPES onto a non-zero xtx, two launches bitwise
             equal; K3 with all-zero and filled row groups mixed (their
             outputs bitwise +0); K2's tensor-core path at every path shape
             and ragged c for B ∈ K2_BATCHES (its plan checked, two
             launches bitwise equal), its cluster split, a NaN weight (NaN
             out, no skip) and strided / offset x; K2's many-row kernel
             (plan mode 3: from B = 64 and for rows too wide for 8-row
             blocks) at ragged shapes from B = 64 to 6 000, every tile and
             split, every 2:4 position pair in every metadata slot, a NaN
             weight, strided x, and an x off alignment on the 8-row plan,
             each also against the fp32 product (the dense bf16 product's
             error + 2⁻⁸); K3's decode-occupancy kernel (plan mode 4) on
             both full-width qwen3-moe leaves with x from moe_ffn's
             dispatch of 1–115 tokens, 4- and 8-bit indices, C = 48,
             ZERO_K3's ragged shapes under every split and depth, idle
             groups bitwise +0 (all-zero and −0 x, a NaN weight in a
             skipped expert), a NaN weight's column, and a CUDA graph
             replayed on a second routing bitwise its direct call; the
             mode-2 tensor-core kernel on the same leaves and shapes and
             through the wrapper on an x off alignment.
5. times   — each kernel at each main-path shape: kernel, plain version and
             one library call (K1 also the bf16 tensor-core addmm), beside
             the bound the card's peaks give; K3 also at the serving path's
             decode occupancy (x from moe_ffn's own dispatch of 1 and 4
             tokens), its bound counting only the weights of active row
             groups, beside the mode-2 kernel timed in the same run and
             torch.bmm over the whole stack and over the active experts.
             K2's rows also print the plan and its kernel, the
             warp-per-row kernel (K2's design before the tensor-core path)
             timed in this run beside its time recorded in PERF.md and, on
             many-row rows, the 8-row kernel likewise; then K2's device
             time per model step of each path and its launch-weighted
             total, each beside the library's.  K1's rows print their plan
             (which must be the wgmma kernel's) beside the mma.sync
             kernel's recorded time and their eager time over the replay
             (one run of 10 calls, and the median of five), rows at 16 384
             tokens (K1_LONG: a split plan and unsplit ones) are added,
             then K1's launch-weighted total beside the bf16 addmm's and
             the bound (K1's operations: the symmetric half); one torch.profiler trace of K1 launch
             pairs (scan, product) is printed first.

Kernel launch counts are zeroed just before each path (phases 3,
train's serve, robust, dist (in each rank), baselines, plan, 4m, mla and
each part of paged, of families and of dense2; the tooling ladders,
whose nm rungs count every step ``timed_runs`` ran, direct and replayed)
and read just after its serve (the mla path: after both serves; gemma3: after its paged serve;
baselines and plan also per method and per step); the comparison and
timing launches are not counted, nor are the contiguous serves the paged
ones are held against (``uncounted``).  The tinyllama rows of phase 5
carry the robust, dist (both ranks), baselines, plan and paged paths'
launches at the same shapes (``path_launches``), the deepseek-v3 rows the paged path's.  The
line before the last is the kernels JSON; the last line is the device JSON.  Results are
also written to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): HBM bytes/s and operations/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}


def k1_ops(rows: int, b: int) -> int:
    """K1's operations on ``rows`` valid token rows: the products of the
    symmetric half of XᵀX, rows · b · (b + 1) (a multiply and an add for
    each of b (b + 1) / 2 sums), which is all the kernel computes."""
    return rows * b * (b + 1)


MOE_ARCH = "qwen3-moe-30b-a3b"
# 48 layers hold 61 GB of bf16 weights before a compressed copy and give
# ~18 000 expert solves; 2 layers keep every width and the phase short
# (4 until the script neared its time limit: ~45 s of expert solves less)
MOE_LAYERS = 2
# x (C, b) → W (E, c, b) of the two full-width expert leaves: gate/up, down
MOE_LEAVES = [(128, 8, 768, 2048), (128, 8, 2048, 768)]
MOE_ATTN = [(4096, 2048), (512, 2048), (2048, 4096)]      # K2, (c, b)
# K1: (tokens, b, row mask): attention inputs, expert capacity buffers
MOE_K1 = [(1024, 2048, False), (1024, 4096, False), (80, 2048, True),
          (80, 768, True)]
# the paper's comparison methods, run beside phase 3's Thanos
BASELINES = ("sparsegpt", "wanda", "magnitude")
MLA_ARCH = "deepseek-v3-671b"
# the first of its three leading dense layers (num_dense_layers = 3): a
# full-width MoE block needs ~110 GB of expert Hessians at once under the
# port's schedule (3 layers until the script neared its time limit)
MLA_LAYERS = 1
# K2, (c, b): wq_a, wq_b, wkv_a, wo, gate/up and down (wkv_b serves dense)
MLA_K2 = [(1536, 7168), (24576, 1536), (576, 7168), (7168, 16384),
          (18432, 7168), (7168, 18432)]
# K1 at x (1024, b): the inputs of wq_a/wkv_a/gate/up, wq_b, wkv_b, wo, down
MLA_K1 = [7168, 1536, 512, 16384, 18432]
# tokens a page in the paged phase; the request set's rows (16 prompt + 12
# new + 8) rounded up to a multiple of it, so a paged slot's logical row is
# as long as a contiguous one — the condition of their bitwise parity
PAGE = 16
SERVE_MAX_LEN = 48
# the prefix trace: 4 prompts of one 40-token head (2½ pages) and distinct
# 7-token tails, so each prompt ends inside its third page and its first
# decode write copies that registered page, then request 0's prompt again;
# rows of 64 tokens (4 pages) hold a prompt and its 12 new tokens
PREFIX_HEAD, PREFIX_TAIL, PREFIX_MAX_LEN = 40, 7, 64
GEMMA_ARCH = "gemma3-1b"
# depth cut 26 → 6 (5 local layers and the global one, the model's own
# pattern): its 587 single-token model steps a serve dominated the script
GEMMA_LAYERS = 6
# one 528-token prompt wraps every local ring (window 512); rows of 544
# tokens (34 pages) hold it and its 12 new tokens
GEMMA_LONG, GEMMA_MAX_LEN = 528, 544
# K1 at x (1024, b): the inputs of wq/wk/wv/gate/up, wo, down; K2, (c, b):
# wq, wk/wv, gate/up, wo, down
GEMMA_K1 = [1152, 1024, 6912]
GEMMA_K2 = [(1024, 1152), (256, 1152), (6912, 1152), (1152, 1024),
            (1152, 6912)]
# the families phase: zamba2-7b's depth cut 81 → 24 keeps 4 shared sites
# (5, 11, 17, 23), so each shared set runs twice; K1 at x (1024, b) and K2
# (c, b) at every path shape: zamba2's in/out_proj, shared q/k/v/o, gate/up,
# down; xlstm's up, q/k/v, i/f gates (4 output rows), down, sLSTM gates;
# whisper's attention, fc1, fc2
ZAMBA_LAYERS = 24
ZAMBA_K1 = [3584, 7168, 14336]
ZAMBA_K2 = [(14704, 3584), (3584, 7168), (3584, 3584), (14336, 3584),
            (3584, 14336)]
# xlstm-1.3b's depth cut 48 → 16 (14 mLSTM, 2 sLSTM blocks: every 8th)
XLSTM_LAYERS = 16
XLSTM_K1 = [2048, 4096]
XLSTM_K2 = [(8192, 2048), (4096, 4096), (4, 4096), (2048, 4096),
            (2048, 2048)]
# the depths at which xlstm's first-step logits are held (depth_profile)
XLSTM_DEPTHS = (1, 8, 16)
# whisper-medium's depth cut 24 + 24 → 8 + 8 (encoder + decoder layers)
WHISPER_LAYERS = 8
WHISPER_K1 = [1024, 4096]
WHISPER_K2 = [(1024, 1024), (4096, 1024), (1024, 4096)]
# 4 sources of the 30 s window (1500 frames), 12 greedy tokens: the encoder
# runs K2 at x (6000, b), the decoder at B = 4
WHISPER_FRAMES, WHISPER_NEW = 1500, 12
WHISPER_B = (4, 4 * WHISPER_FRAMES)
# the dense2 phase: h2o-danube-1.8b cut 24 → 8 layers (time: 24 held 3.6
# GB of bf16 weights); mistral-large-123b's 88 layers hold ~244 GB and
# internvl2-76b's 80 ~137 GB of bf16 weights, so both are cut to 1 layer
# (every width kept: ~4.3 GB and ~4.7 GB with embedding and head; 2 layers
# until the script neared its time limit)
DENSE2_LAYERS = {"h2o-danube-1.8b": 8, "mistral-large-123b": 1,
                 "internvl2-76b": 1}
# K1 at x (1024, b): the inputs of wq/wk/wv/wo/gate/up, down; K2, (c, b):
# wq/wo, wk/wv, gate/up, down — down at b = 28 672 runs K2's many-row kernel
# at B = 1 and 4 (one 8-row block's rows do not fit 227 KB)
DENSE2_K1 = {"h2o-danube-1.8b": [2560, 6912],
             "mistral-large-123b": [12288, 28672],
             "internvl2-76b": [8192, 28672]}
DENSE2_K2 = {"h2o-danube-1.8b": [(2560, 2560), (640, 2560), (6912, 2560),
                                 (2560, 6912)],
             "mistral-large-123b": [(12288, 12288), (1024, 12288),
                                    (28672, 12288), (12288, 28672)],
             "internvl2-76b": [(8192, 8192), (1024, 8192), (28672, 8192),
                               (8192, 28672)]}
# internvl's image prefix: 64 patch embeddings then 16 text tokens, fed
# one position a step through decode_step(embeds=) from an empty cache
VLM_IMAGE, VLM_TEXT = 64, 16
# the robust phase's prune job: tinyllama at full width cut to 4 layers
# (28 journaled linears; the kill at layer 14 is block 2's first), and the
# cholesky / hessian_accum runs on 1 layer
JOB_LAYERS, JOB_KILL, SITE_LAYERS = 4, 14, 1
# the train phase: batches of 8 × 256 tokens; the bitwise restart runs at
# full width cut to 2 layers (a checkpoint of ~2.2 GB, not ~11 GB); the
# sparse finetune takes 16 steps at full width and depth
TRAIN_BATCH, TRAIN_SEQ, TRAIN_RESTART_LAYERS, FINETUNE_STEPS = 8, 256, 2, 16
# (c′): replayed vs eager steps of the finetune; the timed replays of one
# graphed call (the update alone, the loss / grad split)
REPLAY_STEPS, TIMED_REPLAYS = 6, 5
# the dist phase: two ranks on the one card; (d) takes DIST_STEPS sharded
# train steps at lr DIST_LR on the train phase's batch (step 1 eager, step
# 2 the capture, the rest replays), its losses held to DIST_LOSS_TOL of
# make_train_step's on the whole batch; a rank's collectives give up after
# DIST_PG_TIMEOUT s, the ranks after DIST_JOIN_TIMEOUT s
DIST_STEPS, DIST_LR, DIST_LOSS_TOL = 4, 1e-4, 1e-2
# prune-graphs: tinyllama's four linear shapes (c, b) — q/o, k/v, gate/up,
# down — and the blocks of phase 3's prune held against the eager loop
PG_SHAPES = [(2048, 2048), (256, 2048), (5632, 2048), (2048, 5632)]
PG_BLOCKS = 4
GRAPH_LINES: dict = {}        # label → graphs_line's record, this run
DIST_PG_TIMEOUT, DIST_JOIN_TIMEOUT = 180, 360
K3_REPLACES = ("src/repro/kernels/ops.py:151-161 (loops the pallas_call of "
               "src/repro/kernels/nm_spmm.py:135)")
MAXB_ROWS = 8                 # capacity rows K3 computes per row group
# K3's __global__ by plan mode, as the kernels line names it
K3_KERNELS = {0: "nm_stacked_kernel", 1: "nm_stacked_kernel",
              2: "nm_stacked_tc_kernel", 4: "nm_stacked_sp_dec_kernel"}
# K3's launch-weighted ms over qwen3-moe's path and its bound before the
# decode-occupancy kernel (PERF.md §6's earlier K3 rows; NVIDIA H100 80GB
# HBM3, 700 W), printed beside this run's
K3_BEFORE_MS, K3_BEFORE_BOUND_MS = 13.66, 3.73
# K2's time per launch with the warp-per-row kernel, as PERF.md records it
# (NVIDIA H100 80GB HBM3, 700 W), printed beside this run's
WARP_ROW_K2_MS = {"B=1 W (2048, 2048)": 0.0065, "B=4 W (2048, 2048)": 0.0126,
              "B=1 W (256, 2048)": 0.0051, "B=4 W (256, 2048)": 0.0089,
              "B=1 W (5632, 2048)": 0.0124, "B=4 W (5632, 2048)": 0.0283,
              "B=1 W (2048, 5632)": 0.0133, "B=4 W (2048, 5632)": 0.0299,
              "B=1 W (4096, 2048)": 0.0085, "B=4 W (4096, 2048)": 0.0202,
              "B=1 W (512, 2048)": 0.0052, "B=4 W (512, 2048)": 0.0089,
              "B=1 W (2048, 4096)": 0.0103, "B=4 W (2048, 4096)": 0.0225}
# K2, (c, b): tinyllama's q/o, k/v, gate/up and down linears
SERVE_K2 = [(2048, 2048), (256, 2048), (5632, 2048), (2048, 5632)]
# K2's __global__ by plan mode, as the kernels line names it
K2_KERNELS = {0: "nm_kernel", 1: "nm_kernel", 2: "nm_tc_kernel",
              3: "nm_sp_rows_kernel", 4: "nm_sp_dec_kernel"}
# K2's time per launch with the 8-row tensor-core kernel at the rows that
# now take the many-row kernel, as PERF.md records it (the wide rows PRs
# 17–19, whisper PR 18, the ladders PR 22; NVIDIA H100 80GB HBM3, 700 W),
# printed beside this run's
TC8_K2_MS = {"B=4 W (7168, 16384)": 0.1220, "B=4 W (7168, 18432)": 0.1359,
             "B=4 W (3584, 14336)": 0.0584, "B=1 W (12288, 28672)": 0.2594,
             "B=4 W (12288, 28672)": 0.3977, "B=1 W (8192, 28672)": 0.1743,
             "B=4 W (8192, 28672)": 0.2674,
             "B=6000 W (1024, 1024)": 0.5728, "B=6000 W (4096, 1024)": 2.2744,
             "B=6000 W (1024, 4096)": 1.9966,
             "B=128 W (12288, 12288)": 2.9515, "B=128 W (1024, 12288)": 0.2459,
             "B=128 W (28672, 12288)": 6.7912,
             "B=128 W (12288, 28672)": 7.2141, "B=128 W (8192, 2048)": 0.1702,
             "B=128 W (4096, 4096)": 0.1828, "B=128 W (4, 4096)": 0.0051,
             "B=128 W (2048, 4096)": 0.0956, "B=128 W (2048, 2048)": 0.0454}
# K2's time per launch on the 8-row tensor-core kernel (mode 2) at every
# B = 1 / B = 4 row of PERF.md §6's table that ran it before the decode
# kernel (NVIDIA H100 80GB HBM3, 700 W): printed beside this run's rows, and
# their launch-weighted sum (719.0 ms at the table's launches) beside this
# run's; K2's launch-weighted total then (877.93 ms)
MODE2_K2_MS = {
    "B=1 W (2048, 2048)": 0.0052, "B=4 W (2048, 2048)": 0.0053,
    "B=1 W (256, 2048)": 0.0032, "B=4 W (256, 2048)": 0.0032,
    "B=1 W (5632, 2048)": 0.0088, "B=4 W (5632, 2048)": 0.0088,
    "B=1 W (2048, 5632)": 0.0098, "B=4 W (2048, 5632)": 0.0106,
    "B=1 W (4096, 2048)": 0.0072, "B=4 W (4096, 2048)": 0.0073,
    "B=1 W (512, 2048)": 0.0034, "B=4 W (512, 2048)": 0.0034,
    "B=1 W (2048, 4096)": 0.0079, "B=4 W (2048, 4096)": 0.0084,
    "B=1 W (1536, 7168)": 0.0106, "B=4 W (1536, 7168)": 0.013,
    "B=1 W (24576, 1536)": 0.0226, "B=4 W (24576, 1536)": 0.0238,
    "B=1 W (576, 7168)": 0.0062, "B=4 W (576, 7168)": 0.0072,
    "B=1 W (7168, 16384)": 0.0716, "B=1 W (18432, 7168)": 0.0578,
    "B=4 W (18432, 7168)": 0.0879, "B=1 W (7168, 18432)": 0.0904,
    "B=1 W (1024, 1152)": 0.0033, "B=4 W (1024, 1152)": 0.0033,
    "B=1 W (256, 1152)": 0.0028, "B=4 W (256, 1152)": 0.0028,
    "B=1 W (6912, 1152)": 0.0071, "B=4 W (6912, 1152)": 0.0075,
    "B=1 W (1152, 1024)": 0.0034, "B=4 W (1152, 1024)": 0.0034,
    "B=1 W (1152, 6912)": 0.0094, "B=4 W (1152, 6912)": 0.0123,
    "B=1 W (14704, 3584)": 0.0253, "B=4 W (14704, 3584)": 0.0357,
    "B=1 W (3584, 7168)": 0.0158, "B=4 W (3584, 7168)": 0.0248,
    "B=1 W (3584, 3584)": 0.0101, "B=4 W (3584, 3584)": 0.0122,
    "B=1 W (14336, 3584)": 0.0251, "B=4 W (14336, 3584)": 0.0353,
    "B=1 W (3584, 14336)": 0.0393, "B=1 W (8192, 2048)": 0.0105,
    "B=4 W (8192, 2048)": 0.011, "B=1 W (4096, 4096)": 0.0121,
    "B=4 W (4096, 4096)": 0.0141, "B=1 W (4, 4096)": 0.0036,
    "B=4 W (4, 4096)": 0.0039, "B=4 W (1024, 1024)": 0.0032,
    "B=4 W (4096, 1024)": 0.0051, "B=4 W (1024, 4096)": 0.0058,
    "B=1 W (2560, 2560)": 0.007, "B=4 W (2560, 2560)": 0.0074,
    "B=1 W (640, 2560)": 0.0038, "B=4 W (640, 2560)": 0.0041,
    "B=1 W (6912, 2560)": 0.0115, "B=4 W (6912, 2560)": 0.014,
    "B=1 W (2560, 6912)": 0.0127, "B=4 W (2560, 6912)": 0.0182,
    "B=1 W (12288, 12288)": 0.0866, "B=4 W (12288, 12288)": 0.1239,
    "B=1 W (1024, 12288)": 0.0111, "B=4 W (1024, 12288)": 0.0124,
    "B=1 W (28672, 12288)": 0.1823, "B=4 W (28672, 12288)": 0.2778,
    "B=1 W (8192, 8192)": 0.0338, "B=4 W (8192, 8192)": 0.0492,
    "B=1 W (1024, 8192)": 0.0082, "B=4 W (1024, 8192)": 0.0089,
    "B=1 W (28672, 8192)": 0.0973, "B=4 W (28672, 8192)": 0.1407}
MODE2_ROWS_MS, K2_BEFORE_MS = 719.0, 877.93
# the tensor-core K2's checks: ragged c (the cluster split), its batch
# sizes, and (c, b, B) of the NaN-weight and x-view checks
K2_RAGGED = [(37, 128), (129, 256), (300, 512)]
K2_BATCHES = (1, 2, 3, 4, 5, 8, 9, 17)
K2_CLUSTER = [(256, 2048), (512, 2048), (37, 1024), (300, 512)]
K2_EDGE = [(2048, 2048, 4), (256, 2048, 1), (37, 128, 9)]
# the many-row path (plan mode 3): (c, b) ragged against its tiles and its
# stages of 64 columns (b = 96 and 1 056: 3 and 33 steps of 32), its rows
# from the threshold (K2._ROWS_MIN_B, added at run time) to whisper's
# encoder, and the shape every tile and split is held at
K2_ROWS_RAGGED = [(200, 1056), (100, 96), (1000, 512)]
# the decode path (plan mode 4): its batch sizes, and the ragged shape every
# tile, split and ring depth is held at (34 column steps: 9 stages, the
# last one cut)
K2_DEC_BATCHES = (1, 2, 3, 4, 5, 8, 9, 17, 31, 33, 63)
K2_DEC_TILES = (300, 1088)
K2_ROWS_BATCHES = (127, 129, 6000)
K2_ROWS_TILES = (300, 1056, 129)
# the redesign checks: K1 at ragged (tokens, b); K3 (E, C, c, b, n, m)
# with all-zero row groups, from a full-width leaf to ragged shapes
ODD_K1 = [(37, 100), (37, 770), (80, 100), (80, 770)]
# K1's wgmma kernel in every ring configuration, token split and xtx
# prefetch point: (tokens, b) ragged against the stages and tiles, unmasked
# and with a row mask (NaN in the masked rows), onto a non-zero symmetric
# xtx; and K1's phase-5 rows at 16 384 tokens (the calibration pipeline's
# 8 × 2 048 a batch), which no path launches: b = 1 024 plans a token
# split over a cluster, 2 048 and 5 632 do not
K1_PLAN_SHAPES = [(1041, 776, False), (300, 200, True)]
K1_LONG = [(16384, 1024), (16384, 2048), (16384, 5632)]
# K1's phase-5 times on the mma.sync kernel the wgmma one replaced, by
# row shape: each K1 row's "earlier ms", printed beside the row and in no
# kernels line (chip_smoke's final run before the wgmma kernel; NVIDIA H100
# 80GB HBM3, 700.00 W)
K1_EARLIER_MS = {
    "x (1024, 512) bf16": 0.0262, "x (1024, 1024) bf16": 0.0264,
    "x (1024, 1152) bf16": 0.0267, "x (1024, 1536) bf16": 0.0411,
    "x (1024, 2048) bf16": 0.0475, "x (1024, 2560) bf16": 0.0522,
    "x (1024, 3584) bf16": 0.1044, "x (1024, 4096) bf16": 0.1150,
    "x (1024, 5632) bf16": 0.2052, "x (1024, 6912) bf16": 0.2955,
    "x (1024, 7168) bf16": 0.3154, "x (1024, 8192) bf16": 0.3924,
    "x (1024, 12288) bf16": 0.8385, "x (1024, 14336) bf16": 1.1695,
    "x (1024, 16384) bf16": 1.5632, "x (1024, 18432) bf16": 2.0119,
    "x (1024, 28672) bf16": 5.0022, "x (80, 2048) bf16 + row mask": 0.0170,
    "x (80, 768) bf16 + row mask": 0.0082}
# the tooling phase: K2 at the ladders' decode batch, at the (c, b) the nm
# rungs launch — mistral's wq/wo, wk/wv, gate/up, down and xlstm's five
TOOLING_B = 128
TOOLING_TIMEOUT = 400        # s: the phase in its child process
# the ladders' gates: nm rungs' first step rel ≤ NM_REL against the
# decompressed tree (xlstm's on the rung's first NM_GATE_BLOCKS blocks);
# int8 rungs' max |Δ| < INT8_TOL and < INT8_SHARE × the filled cache's own
# effect on the logits
NM_REL, NM_GATE_BLOCKS = 5e-2, {"xlstm-1.3b/decode_32k": 1}
INT8_TOL, INT8_SHARE = 1.0, 0.1
TOOLING_K2 = {"mistral-large-123b": DENSE2_K2["mistral-large-123b"],
              "xlstm-1.3b": XLSTM_K2}
# tooling (d): the prefill step at tinyllama-1.1b's full width and depth on
# prefill_32k cut to B = 1 and PREFILL_SEQ tokens: the port's attention
# holds (B, H, S, S) scores in fp32 (137 GB at 32 768; 8.6 GB at 8 192)
PREFILL_SEQ, PREFILL_RUNS = 8192, 3
# the draws check: the slices drawn on the card against numpy's host draw
# (name → arch, seed, batches, batch, seq_len): heldout_loss's slice of
# gemma3-1b (vocabulary 262 144) and phase 3's calibration batches; the
# host draws run in spawned processes, one a batch, after the tooling
# phase, and the card's draws once they are done
DRAWS = {"gemma3-1b held-out": ("gemma3-1b", 9999, 4, 8, 256),
         "tinyllama-1.1b calibration": ("tinyllama-1.1b", 1234, 2, 8, 128)}
DRAWS_TIMEOUT = 300          # s: the host draws, from their start
# K3's decode-occupancy checks: the dispatch's token counts (C = 8 up to
# 115 tokens, moe.capacity), as tools/k3_plan_sweep.py sweeps them
K3_DEC_TOKENS = (1, 2, 4, 8, 16, 32, 64, 115)
ZERO_K3 = [(128, 8, 768, 2048, 2, 4), (6, 3, 37, 128, 2, 4),
           (6, 17, 300, 128, 5, 8), (5, 17, 37, 96, 2, 4),
           (4, 3, 33, 104, 5, 8), (4, 17, 200, 512, 2, 4)]


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def ptxas_entries(log: str, kernel: str) -> list:
    """(template arguments, "registers …, spill …") of each entry function
    of ``-Xptxas -v``'s report whose mangled name holds ``kernel``."""
    out, current, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1) if kernel in m.group(1) else None
            spill = ""
            continue
        if current is None:
            continue
        if "spill stores" in line:
            spill = re.sub(r".*ptxas info\s*:\s*", "", line).strip()
        m = re.search(r"Used (\d+) registers.*", line)
        if m:
            args = re.findall(r"L[ib](\d+)E", current)
            out.append((f"<{', '.join(args)}>",
                        f"{m.group(0)}; {spill}"))
            current = None
    return out


def gpu_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def device_ms(fn, per_graph: int, replays: int = 5) -> float:
    """Device time of one ``fn`` call: ``per_graph`` calls captured in one
    CUDA graph and replayed, so the host's launch overhead drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


def bmm_active_ms(x, dense, act) -> float:
    """Device time of ``torch.bmm`` over only the active experts of a K3
    leaf: x (E, C, b) and dense (E, c, b) gathered at the experts with an
    active row group (``act``, (E, G) bool) before the timing, the weights
    rotated through copies until they pass 96 MiB, so that they stream
    from HBM as the kernel's rotated weights do (the L2 holds 50 MB)."""
    import torch

    idx = act.any(dim=1).nonzero().flatten()
    xa = x[idx].contiguous()
    wa = dense[idx].transpose(-1, -2).contiguous()
    n = min(8, math.ceil(96 * 2**20 / max(1, wa.numel() * 2)) + 1)
    ws = [wa] + [wa.clone() for _ in range(n - 1)]
    ring = itertools.cycle(ws)
    return device_ms(lambda: torch.bmm(xa, next(ring)), 4 * n)


def eager_runs(fn, iters: int, repeats: int) -> list:
    """Time of one eager ``fn`` call, host launch overhead included, in each
    of ``repeats`` runs of ``iters`` back-to-back calls (after one call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(repeats):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return runs


def eager_ms(fn, iters: int) -> float:
    """Time of one eager ``fn`` call, host launch overhead included: one
    run of ``iters`` back-to-back calls."""
    return eager_runs(fn, iters, 1)[0]


def k1_eager_fields(fn) -> dict:
    """A K1 row's eager times: one run of 10 calls (``eager_ms``, the
    measurement K1's rows always had) and the median of five such runs
    beside it (``eager_median_ms``: one run's host share moves by tens of
    µs from run to run on a shared host)."""
    runs = eager_runs(fn, 10, 5)
    return {"eager_ms": runs[0], "eager_median_ms": statistics.median(runs)}


def addmm_bf16_ms(acc, xb, per_graph: int):
    """The tensor-core library route for K1's product: one
    ``torch.addmm(acc, xbᵀ, xb, out_dtype=float32)`` on bf16 x, or "not
    available" where this torch lacks the ``out_dtype`` overload."""
    import torch

    try:
        torch.addmm(acc, xb.T, xb, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return "not available"
    return device_ms(lambda: torch.addmm(acc, xb.T, xb,
                                         out_dtype=torch.float32), per_graph)


def k1_plan_fields(x, valid, xtx) -> dict:
    """A K1 row's plan, as ``_k1_plan`` chooses it for these operands."""
    from repro_torch.kernels import hessian_accum as K1

    BM, CS, variant, smem, pf = K1.k1_operands(x, valid, xtx)[2]
    return {"plan": {"variant": K1.VARIANTS[variant], "code": variant,
                     "tile": BM, "cluster": CS, "smem": smem,
                     "prefetch_eighths": pf}}


def k1_trace(dev) -> dict:
    """One ``torch.profiler`` trace of K1 launch pairs (the scan, then the
    product as its programmatic dependent) replayed from a CUDA graph at
    x (1024, 1024) and (1024, 2048): each kernel's device time, how long
    after the scan's start the product starts, and the pair's period."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import hessian_accum as K1

    out = {}
    for b in (1024, 2048):
        x = torch.randn((1024, b), device=dev).to(torch.bfloat16)
        acc = [torch.zeros((b, b), device=dev), torch.zeros((), device=dev),
               torch.zeros((), device=dev)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                K1.hessian_update_cuda(x, None, *acc)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(5):
                K1.hessian_update_cuda(x, None, *acc)
        graph.replay()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type.name == "CUDA"),
                     key=lambda e: e.time_range.start)
        scans = [e for e in evs if "scan_kernel" in e.name]
        prods = [e for e in evs if "xtx_wg_kernel" in e.name]
        check(len(scans) == len(prods) == 5,
              f"K1 trace at (1024, {b}): {len(scans)} scans, {len(prods)} "
              "products on the device")
        mean = statistics.fmean
        rec = {"plan": list(K1.k1_operands(x, None, acc[0])[2]),
               "scan_us": mean(e.time_range.elapsed_us() for e in scans),
               "product_us": mean(e.time_range.elapsed_us() for e in prods),
               "product_after_scan_us": mean(
                   p.time_range.start - q.time_range.start
                   for q, p in zip(scans, prods)),
               "pair_us": (prods[-1].time_range.end
                           - scans[0].time_range.start) / 5}
        out[f"x (1024, {b})"] = rec
        print(f"  K1 trace x (1024, {b}) plan {rec['plan']}: scan "
              f"{rec['scan_us']:.2f} us, product {rec['product_us']:.2f} us "
              f"starting {rec['product_after_scan_us']:.2f} us after the "
              f"scan's start, {rec['pair_us']:.2f} us a launch pair")
        del x, acc, graph
    return out


def errs(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|)."""
    d = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return d, d / scale if scale else d


def nm_mask3(w, n: int, m: int):
    """n:m magnitude mask of a stacked (E, c, b) weight (1.0 = pruned)."""
    import torch

    from repro_torch.core.masks import nm_mask

    E, c, b = w.shape
    ones = torch.ones((b,), device=w.device)
    return nm_mask(w.reshape(E * c, b).float(), ones, n, m).reshape(E, c, b)


def moe_kernel_checks(gen, dev) -> dict:
    """Phase 2 at the MoE path's shapes: K1 with the capacity buffers' row
    masks, K2 at qwen3-moe's attention shapes, K3 at the full-width expert
    leaves and odd shapes.  → errors and bf16 operands for phase 5."""
    import torch

    from repro_torch.core.masks import nm_mask
    from repro_torch.core.sparsity import pack_nm, pack_nm_stacked
    from repro_torch.kernels import hessian_accum as K1, nm_spmm as K2

    out: dict = {"k1": {}, "k2": {}, "k3": {}, "packs2": {}, "packs3": {}}
    for dtype in (torch.float32, torch.bfloat16):
        for tok, b, masked in MOE_K1:
            x = torch.randn((tok, b), generator=gen, device=dev).to(dtype)
            valid = (torch.rand((tok,), generator=gen, device=dev) < 0.6
                     if masked else None)
            if masked:
                x[~valid] = torch.nan             # garbage in unrouted rows
            acc_k = [torch.zeros((b, b), device=dev),
                     torch.zeros((), device=dev), torch.zeros((), device=dev)]
            acc_p = [t.clone() for t in acc_k]
            for _ in range(2):
                K1.hessian_update_cuda(x, valid, *acc_k)
                K1.hessian_update_plain(x, valid, *acc_p)
            torch.cuda.synchronize()
            e = errs(acc_k[0], acc_p[0])
            rows = 2.0 * (float(valid.sum()) if masked else tok)
            check(torch.allclose(acc_k[0], acc_p[0], rtol=1e-3, atol=2e-2)
                  and torch.equal(acc_k[0], acc_k[0].T)
                  and float(acc_k[1]) == float(acc_p[1]) == rows
                  and float(acc_k[2]) == 0.0,
                  f"K1 ({tok}, {b}) {dtype} masked={masked}: err {e[0]:.3g}"
                  f", count {float(acc_k[1])} vs {rows}")
            out["k1"][(tok, b, str(dtype))] = e
    for (c, b) in MOE_ATTN:
        for dtype in (torch.float32, torch.bfloat16):
            w = (torch.randn((c, b), generator=gen, device=dev)
                 / math.sqrt(b)).to(dtype)
            mask = nm_mask(w.float(), torch.ones((b,), device=dev), 2, 4)
            for B in (1, 4):
                x = torch.randn((B, b), generator=gen, device=dev).to(dtype)
                for bits in (4, 8):
                    pk = pack_nm(w, mask, 2, 4, idx_bits=bits)
                    y_k = K2.nm_matmul_cuda(x, pk.values, pk.indices, n=2,
                                            m=4, b=b, idx_bits=bits)
                    y_p = K2.nm_matmul_plain(x, pk.values, pk.indices, 2, 4,
                                             b, bits)
                    torch.cuda.synchronize()
                    e = errs(y_k, y_p)
                    tol = ((1e-4, 1e-4) if dtype == torch.float32
                           else (2e-2, 1e-2))
                    check(torch.allclose(y_k.float(), y_p.float(),
                                         rtol=tol[0], atol=tol[1]),
                          f"K2 c={c} b={b} B={B} {dtype} idx{bits}: max abs "
                          f"err {e[0]:.3g}")
                    out["k2"][(B, c, b, str(dtype), bits)] = e
                    if dtype == torch.bfloat16 and bits == 4:
                        out["packs2"][(c, b)] = (pk, w.masked_fill(
                            mask > 0.5, 0))
    # full-width leaves, then odd shapes: ragged rows, C < 8 and C > 8
    # (two row chunks), b not a multiple of 8, keep = 3 (scalar path)
    cases = [(E, C, c, b, 2, 4) for E, C, c, b in MOE_LEAVES]
    cases += [(5, 3, 37, 96, 2, 4), (5, 3, 37, 96, 5, 8),
              (3, 17, 33, 100, 2, 4)]
    n3, worst3 = 0, {torch.float32: (0.0, 0.0), torch.bfloat16: (0.0, 0.0)}
    for (E, C, c, b, n, m) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            w = (torch.randn((E, c, b), generator=gen, device=dev)
                 / math.sqrt(b)).to(dtype)
            mask = nm_mask3(w, n, m)
            x = torch.randn((E, C, b), generator=gen, device=dev).to(dtype)
            for bits in (4, 8):
                pk = pack_nm_stacked(w, mask, n, m, idx_bits=bits)
                y_k = K2.nm_matmul_stacked_cuda(x, pk.values, pk.indices,
                                                n=n, m=m, b=b, idx_bits=bits)
                y_p = K2.nm_matmul_stacked_plain(x, pk.values, pk.indices, n,
                                                 m, b, bits)
                torch.cuda.synchronize()
                e = errs(y_k, y_p)
                # K2's tolerances: fp32 sum order; bf16 one output rounding
                tol = ((1e-4, 1e-4) if dtype == torch.float32
                       else (2e-2, 1e-2))
                check(y_k.shape == (E, C, c) and y_k.dtype == dtype and
                      torch.allclose(y_k.float(), y_p.float(), rtol=tol[0],
                                     atol=tol[1]),
                      f"K3 E={E} C={C} c={c} b={b} {n}:{m} {dtype} "
                      f"idx{bits}: max abs err {e[0]:.3g}")
                out["k3"][(E, C, c, b, str(dtype), bits)] = e
                worst3[dtype] = max(worst3[dtype], e)
                n3 += 1
                if dtype == torch.bfloat16 and bits == 4 and \
                        (E, C, c, b) in MOE_LEAVES:
                    out["packs3"][(E, C, c, b)] = pk
            del w, mask, x
    print(f"kernels: MoE shapes: hessian_xtx {len(out['k1'])} and nm_matmul "
          f"{len(out['k2'])} checks ok; nm_matmul_stacked (cuda) vs plain: "
          f"{n3} checks ok; max abs/rel err fp32 "
          f"{worst3[torch.float32][0]:.3g}/{worst3[torch.float32][1]:.3g} "
          f"(rtol 1e-4 / atol 1e-4), bf16 {worst3[torch.bfloat16][0]:.3g}/"
          f"{worst3[torch.bfloat16][1]:.3g} (rtol 2e-2 / atol 1e-2)")
    return out


def redesign_checks(gen, dev) -> None:
    """Phase 2 for the redesigned K1 and K3 against their plain versions:
    K1 at ragged tokens and b (rows not 16-byte aligned), with and without
    a row mask — xtx exactly symmetric, a NaN in a valid row skips the
    batch; K3 with a mix of all-zero and filled row groups (whole experts,
    and at C = 17 the middle group of live experts), C ∈ {3, 8, 17}, 2:4 and
    5:8, fp32/bf16, 4/8-bit indices — every output of an all-zero group
    bitwise +0.  Tolerances as in the checks above: K1 rtol 1e-3 /
    atol 2e-2; K3 fp32 1e-4, bf16 rtol 2e-2 / atol 1e-2."""
    import torch

    from repro_torch.core.sparsity import pack_nm_stacked
    from repro_torch.kernels import hessian_accum as K1, nm_spmm as K2

    n1 = 0
    for (tok, b), masked, dtype in itertools.product(
            ODD_K1, (False, True), (torch.float32, torch.bfloat16)):
        x = torch.randn((tok, b), generator=gen, device=dev).to(dtype)
        valid = (torch.rand((tok,), generator=gen, device=dev) < 0.6
                 if masked else None)
        if masked:
            x[~valid] = torch.nan                 # garbage in masked rows
        acc_k = [torch.zeros((b, b), device=dev),
                 torch.zeros((), device=dev), torch.zeros((), device=dev)]
        acc_p = [t.clone() for t in acc_k]
        for _ in range(2):
            K1.hessian_update_cuda(x, valid, *acc_k)
            K1.hessian_update_plain(x, valid, *acc_p)
        torch.cuda.synchronize()
        e = errs(acc_k[0], acc_p[0])
        before = acc_k[0].clone()
        row = 0 if valid is None else int(valid.nonzero()[0])
        x[row, b // 2] = torch.nan                # a poisoned valid row
        K1.hessian_update_cuda(x, valid, *acc_k)
        torch.cuda.synchronize()
        check(torch.allclose(before, acc_p[0], rtol=1e-3, atol=2e-2)
              and torch.equal(before, before.T)
              and float(acc_k[1]) == float(acc_p[1])
              and torch.equal(acc_k[0], before) and float(acc_k[2]) == 1.0,
              f"K1 odd ({tok}, {b}) {dtype} masked={masked}: err {e[0]:.3g}"
              f", symmetric {torch.equal(before, before.T)}, skipped "
              f"{float(acc_k[2])}")
        n1 += 1
    n1p = k1_plan_checks(gen, dev)
    n3, zeros = 0, 0
    for (E, C, c, b, n, m), dtype in itertools.product(
            ZERO_K3, (torch.float32, torch.bfloat16)):
        w = (torch.randn((E, c, b), generator=gen, device=dev)
             / math.sqrt(b)).to(dtype)
        mask = nm_mask3(w, n, m)
        x = torch.randn((E, C, b), generator=gen, device=dev).to(dtype)
        idle = torch.arange(E, device=dev) % 2 == 0
        x[idle] = 0.0
        x[1, 0, 0] = -0.0                         # −0 counts as zero
        if C > 8:
            x[~idle, 8:16] = 0.0
        for bits in (4, 8):
            pk = pack_nm_stacked(w, mask, n, m, idx_bits=bits)
            y_k = K2.nm_matmul_stacked_cuda(x, pk.values, pk.indices, n=n,
                                            m=m, b=b, idx_bits=bits)
            y_p = K2.nm_matmul_stacked_plain(x, pk.values, pk.indices, n, m,
                                             b, bits)
            torch.cuda.synchronize()
            e = errs(y_k, y_p)
            tol = ((1e-4, 1e-4) if dtype == torch.float32
                   else (2e-2, 1e-2))
            raw = y_k.view(torch.int16 if dtype == torch.bfloat16
                           else torch.int32)
            zero = raw[idle]
            if C > 8:
                zero = torch.cat([zero.flatten(),
                                  raw[~idle, 8:16].flatten()])
            check(torch.allclose(y_k.float(), y_p.float(), rtol=tol[0],
                                 atol=tol[1]) and bool((zero == 0).all()),
                  f"K3 zero groups E={E} C={C} c={c} b={b} {n}:{m} {dtype} "
                  f"idx{bits}: max abs err {e[0]:.3g}, all-zero groups "
                  f"+0: {bool((zero == 0).all())}")
            n3 += 1
            zeros += zero.numel()
        del w, mask, x
    print(f"kernels: redesign checks: hessian_xtx at ragged shapes {n1} ok "
          f"(symmetric, NaN batch skipped), in every wgmma ring "
          f"configuration, split and prefetch point {n1p} ok (onto a "
          f"non-zero xtx, two launches bitwise equal); nm_matmul_stacked "
          f"with all-zero "
          f"row groups {n3} ok, {zeros} outputs of all-zero groups bitwise +0")


def k1_plan_checks(gen, dev) -> int:
    """K1's wgmma kernel under every plan it can take — each ring
    configuration and tile, token splits CS ∈ ``hessian_accum.SPLITS``, the
    xtx prefetch at 7 eighths — at ``K1_PLAN_SHAPES``, against the plain version (rtol
    1e-3 / atol 2e-2) onto a non-zero symmetric xtx (the reduction adds),
    xtx exactly symmetric, count exact, a second launch on the same inputs
    bitwise the first.  → checks made."""
    import torch

    from repro_torch.kernels import hessian_accum as K1

    rings = [(K1.K1_WG, 64), (K1.K1_WG, 128), (K1.K1_WG_TIGHT, 64),
             (K1.K1_WG_DEEP, 64)]
    n = 0
    for tok, b, masked in K1_PLAN_SHAPES:
        x = torch.randn((tok, b), generator=gen, device=dev).to(
            torch.bfloat16)
        valid = None
        if masked:
            valid = torch.rand((tok,), generator=gen, device=dev) < 0.6
            x[~valid] = torch.nan
        s = torch.randn((b, b), generator=gen, device=dev)
        base = [s + s.T, torch.full((), 5.0, device=dev),
                torch.zeros((), device=dev)]
        acc_p = [t.clone() for t in base]
        K1.hessian_update_plain(x, valid, *acc_p)
        for (variant, BM), CS, pf in itertools.product(rings, K1.SPLITS,
                                                       (0, 7)):
            plan = (BM, CS, variant, K1.k1_smem(variant, BM), pf)
            runs = []
            for _ in range(2):
                acc = [t.clone() for t in base]
                K1._launch(x, valid, *acc, plan)
                runs.append(acc)
            torch.cuda.synchronize()
            acc = runs[0]
            e = errs(acc[0], acc_p[0])
            check(torch.allclose(acc[0], acc_p[0], rtol=1e-3, atol=2e-2)
                  and torch.equal(acc[0], acc[0].T)
                  and float(acc[1]) == float(acc_p[1])
                  and float(acc[2]) == 0.0
                  and torch.equal(runs[1][0], acc[0]),
                  f"K1 plan {plan} at ({tok}, {b}) masked={masked}: err "
                  f"{e[0]:.3g}, count {float(acc[1])} vs {float(acc_p[1])}, "
                  f"two launches equal {torch.equal(runs[1][0], acc[0])}")
            n += 1
        del x, s, base, acc_p, runs
    return n


def k2_tc_checks(gen, dev) -> None:
    """Phase 2 for K2's tensor-core path (bf16 2:4, the served format)
    against its plain version at bf16 rtol 2e-2 / atol 1e-2: every path
    shape and the ragged K2_RAGGED widths at B ∈ K2_BATCHES, 4- and 8-bit
    indices, each launch's plan checked to be the tensor-core path and two
    launches bitwise equal; the cluster split at c ≤ 512 (K2_CLUSTER, CS
    2/4/8, explicit plans) and where the plan itself splits (rows too wide
    for one block); a
    NaN kept weight (NaN in its output column, no skip); x as a strided
    view and as a contiguous view one element off 16-byte alignment."""
    import torch

    from repro_torch.core.masks import nm_mask
    from repro_torch.core.sparsity import pack_nm
    from repro_torch.kernels import nm_spmm as K2

    tol = {"rtol": 2e-2, "atol": 1e-2}

    def pack(c, b, bits, nan_row=None):
        w = (torch.randn((c, b), generator=gen, device=dev)
             / math.sqrt(b)).to(torch.bfloat16)
        mask = nm_mask(w.float(), torch.ones((b,), device=dev), 2, 4)
        if nan_row is not None:
            w[nan_row, int((mask[nan_row] < 0.5).nonzero()[0])] = torch.nan
        return pack_nm(w, mask, 2, 4, idx_bits=bits)

    def run(x, pk, b, bits, what, mode=None):
        plan = K2._k2_operands(x, pk.values, pk.indices, 2, 4, b, bits)[3]
        if mode is None:
            mode = tc_mode(pk.values.shape[0], b, x.shape[0], bits)
        check(plan[0] == mode, f"K2 {what}: plan {plan} is not mode {mode} "
              "(4: decode, 3: many rows, 2: 8 rows on the tensor cores)")
        y_k = K2.nm_matmul_cuda(x, pk.values, pk.indices, n=2, m=4, b=b,
                                idx_bits=bits)
        y_2 = K2.nm_matmul_cuda(x, pk.values, pk.indices, n=2, m=4, b=b,
                                idx_bits=bits)
        y_p = K2.nm_matmul_plain(x, pk.values, pk.indices, 2, 4, b, bits)
        torch.cuda.synchronize()
        check(torch.equal(y_k.view(torch.int16), y_2.view(torch.int16)),
              f"K2 {what}: two launches differ")
        if plan[0] == 4:
            # the 8-row kernel, which the decode path took over here (what
            # an unaligned x still takes), held against the plain version
            c, L = pk.values.shape
            tc8 = K2._k2_plan(c, b, L, pk.indices.shape[1], x.shape[0], 2,
                              True, 2, 4, False)
            y_8 = K2._launch_k2(x.contiguous(), pk.values, pk.indices, 2, 4,
                                b, bits, tc8)
            check(tc8[0] == 2 and torch.allclose(y_8.float(), y_p.float(),
                                                 **tol),
                  f"K2 {what}: the 8-row plan {tc8} against the plain "
                  f"version: max abs err {errs(y_8, y_p)[0]:.3g}")
        return y_k, y_p, plan

    n_ok, worst, plans = 0, (0.0, 0.0), set()
    for (c, b), bits in itertools.product(
            [*SERVE_K2, *MOE_ATTN, *K2_RAGGED], (4, 8)):
        pk = pack(c, b, bits)
        for B in K2_BATCHES:
            x = torch.randn((B, b), generator=gen, device=dev).to(
                torch.bfloat16)
            y_k, y_p, plan = run(x, pk, b, bits, f"({c}, {b}) B={B} "
                                 f"idx{bits}")
            e = errs(y_k, y_p)
            check(y_k.shape == (B, c) and torch.allclose(
                y_k.float(), y_p.float(), **tol),
                f"K2 tc ({c}, {b}) B={B} idx{bits}: max abs err {e[0]:.3g}")
            worst = max(worst, e)
            plans.add(plan[1])
            n_ok += 1
        del pk
    # the cluster split: explicit plans at c ≤ 512, and the wrapper's own
    # plan where rows are too wide for one block (b = 16384 at B = 8)
    n_cs = 0
    for (c, b), CS, B in itertools.product(K2_CLUSTER, (2, 4, 8),
                                           (1, 4, 9)):
        pk = pack(c, b, 4)
        x = torch.randn((B, b), generator=gen, device=dev).to(torch.bfloat16)
        plan = (2, CS, K2._k2_smem(b, pk.values.shape[1], pk.indices.shape[1],
                                   B, CS), 8, 8)
        y_k = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, 4, plan)
        y_2 = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, 4, plan)
        y_p = K2.nm_matmul_plain(x, pk.values, pk.indices, 2, 4, b, 4)
        torch.cuda.synchronize()
        e = errs(y_k, y_p)
        check(torch.allclose(y_k.float(), y_p.float(), **tol)
              and torch.equal(y_k, y_2),
              f"K2 cluster CS={CS} ({c}, {b}) B={B}: max abs err {e[0]:.3g}")
        worst = max(worst, e)
        n_cs += 1
    # rows too wide for one 8-row block (b = 16384 at B = 8): the 8-row
    # plan splits them over 2 CTAs (what an unaligned x runs), the wrapper's
    # own plan hands them to the many-row path
    for B in (1, 8):
        pk = pack(64, 16384, 4)
        x = torch.randn((B, 16384), generator=gen, device=dev).to(
            torch.bfloat16)
        y_k, y_p, plan = run(x, pk, 16384, 4, f"wide rows B={B}")
        tc8 = K2._k2_plan(64, 16384, 8192, 4096, B, 2, True, 2, 4, False)
        y_8 = K2._launch_k2(x, pk.values, pk.indices, 2, 4, 16384, 4, tc8)
        torch.cuda.synchronize()
        check(tc8[:2] == (2, 2 if B == 8 else 1) and all(torch.allclose(
            y.float(), y_p.float(), **tol) for y in (y_k, y_8)),
            f"K2 wide rows (64, 16384) B={B}: plans {plan} / {tc8}, max abs "
            f"err {errs(y_k, y_p)[0]:.3g} / {errs(y_8, y_p)[0]:.3g}")
        plans.add(tc8[1])
        n_cs += 1
    n_nan = 0
    for (c, b, B), bits in itertools.product(K2_EDGE, (4, 8)):
        pk = pack(c, b, bits, nan_row=c // 2)
        x = torch.randn((B, b), generator=gen, device=dev).to(torch.bfloat16)
        y_k, y_p, _ = run(x, pk, b, bits, f"NaN weight ({c}, {b}) B={B}")
        check(bool(torch.isnan(y_k[:, c // 2]).all()) and torch.allclose(
            y_k.float(), y_p.float(), equal_nan=True, **tol),
            f"K2 NaN weight ({c}, {b}) B={B} idx{bits}: NaN column "
            f"{bool(torch.isnan(y_k[:, c // 2]).all())}")
        n_nan += 1
    n_view = 0
    for c, b, B in K2_EDGE:
        pk = pack(c, b, 4)
        strided = torch.randn((B, b + 8), generator=gen, device=dev).to(
            torch.bfloat16)[:, 3:3 + b]
        offset = torch.randn((B * b + 1,), generator=gen, device=dev).to(
            torch.bfloat16)[1:].view(B, b)
        for name, x in (("strided", strided), ("offset", offset)):
            y_k, y_p, _ = run(x, pk, b, 4, f"{name} x ({c}, {b}) B={B}")
            check(torch.allclose(y_k.float(), y_p.float(), **tol),
                  f"K2 {name} x ({c}, {b}) B={B}: max abs err "
                  f"{errs(y_k, y_p)[0]:.3g}")
            n_view += 1
    print(f"kernels: nm_matmul tensor-core paths vs plain: {n_ok} checks ok "
          f"(B ∈ {K2_BATCHES}, idx 4/8, path and ragged shapes), max abs/"
          f"rel err {worst[0]:.3g}/{worst[1]:.3g} (rtol 2e-2 / atol 1e-2), "
          f"two launches bitwise equal; cluster splits {sorted(plans)}; "
          f"cluster checks {n_cs} ok (CS 2/4/8 at c ≤ 512, wide rows); NaN "
          f"weight {n_nan} ok (NaN column, no skip); strided / offset x "
          f"{n_view} ok")
    k2_rows_checks(gen, dev, pack, run)
    k2_dec_checks(gen, dev, pack, run)


def k2_dec_checks(gen, dev, pack, run) -> None:
    """Phase 2 for K2's decode path (plan mode 4, nm_sp_dec_kernel): every
    path shape of the serving phases' K2 checks and K2_RAGGED at B ∈
    K2_DEC_BATCHES, 4- and 8-bit indices — through the wrapper where it
    plans mode 4 (counted), else under the decode plan launched directly —
    two launches bitwise equal; every split and ring depth under
    explicit plans; every 2:4 position pair in every slot of a metadata
    word at N = 8; a NaN kept weight; x strided (copied: mode 4) and one
    element off alignment (mode 2); a CUDA-graph replay bitwise the direct
    call.  Each against the plain version at rtol 2e-2 / atol 1e-2 and the
    fp32 product: max rel err at most the dense bf16 product's + 2⁻⁸."""
    import torch

    from repro_torch.core.sparsity import pack_nm
    from repro_torch.kernels import nm_spmm as K2
    from repro_torch.kernels.ref import nm_expand

    tol = {"rtol": 2e-2, "atol": 1e-2}
    worst, n_ok, plans = (0.0, 0.0), 0, set()

    def hold(y_k, x, pk, b, bits, what, equal_nan=False):
        nonlocal worst, n_ok
        y_p = K2.nm_matmul_plain(x, pk.values, pk.indices, 2, 4, b, bits)
        e = errs(y_k, y_p)
        ok = y_k.shape == y_p.shape and torch.allclose(
            y_k.float(), y_p.float(), equal_nan=equal_nan, **tol)
        rel = dense = 0.0
        if not equal_nan:
            w = nm_expand(pk.values, pk.indices, 2, 4, b, bits)
            y32 = x.float() @ w.float().T
            dense = errs(x @ w.T, y32)[1]
            rel = errs(y_k, y32)[1]
            worst = max(worst, e)
        check(ok and rel <= dense + 2 ** -8,
              f"K2 decode {what}: max abs err {e[0]:.3g}, rel err vs fp32 "
              f"{rel:.3g} (dense bf16 {dense:.3g})")
        n_ok += 1

    def direct(x, pk, b, bits, plan, what):
        y_k = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, bits, plan)
        y_2 = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, bits, plan)
        torch.cuda.synchronize()
        check(torch.equal(y_k, y_2), f"K2 decode {what}: two launches of "
              f"{plan} differ")
        hold(y_k, x, pk, b, bits, what)
        plans.add((plan[3], plan[1], K2._k2_dec_nst(plan[2], plan[3],
                                                    plan[4], bits, plan[1])))

    def counted(x, pk, b, bits, what, mode=4):
        dec = K2.nm_sp_dec.launches
        y_k, _, plan = run(x, pk, b, bits, what, mode)
        check(K2.nm_sp_dec.launches == dec + 2 * (mode == 4),
              f"K2 decode {what}: nm_sp_dec counted "
              f"{K2.nm_sp_dec.launches - dec} of 2 launches")
        hold(y_k, x, pk, b, bits, what)
        if mode == 4:
            plans.add((plan[3], plan[1], K2._k2_dec_nst(
                plan[2], plan[3], plan[4], bits, plan[1])))
        return y_k, plan

    n_wrap = 0
    for (c, b), bits in itertools.product(
            [*SERVE_K2, *MOE_ATTN, *K2_RAGGED], (4, 8)):
        pk = pack(c, b, bits)
        for B in K2_DEC_BATCHES:
            x = torch.randn((B, b), generator=gen, device=dev).to(
                torch.bfloat16)
            what = f"({c}, {b}) B={B} idx{bits}"
            if tc_mode(c, b, B, bits) == 4:
                counted(x, pk, b, bits, what)
                n_wrap += 1
            else:
                direct(x, pk, b, bits, K2._k2_dec_plan(c, b, B, bits), what)
        del pk
    # every split and ring depth of the 64-row tile: explicit plans at a
    # ragged shape
    c, b = K2_DEC_TILES
    n_plans = 0
    for bits, B in ((4, 4), (8, 4), (4, 33)):
        pk = pack(c, b, bits)
        x = torch.randn((B, b), generator=gen, device=dev).to(torch.bfloat16)
        N = 8 * -(-B // 8)
        nks = -(-b // (32 * K2._DEC_KS))
        BM = K2._DEC_BM
        for CS in K2._DEC_SPLITS:
            if nks < CS:
                continue
            for d in sorted({2, 3, K2._k2_dec_nst_max(BM, N, bits, CS)}):
                direct(x, pk, b, bits,
                       (4, CS, K2._k2_dec_smem(BM, N, bits, d, CS), BM, N),
                       f"CS {CS} nst {d} ({c}, {b}) B={B} idx{bits}")
                n_plans += 1
    # every pair of kept positions in every row and group slot of the
    # metadata words at N = 8: row r's group j keeps pair (r // 16 + j //
    # 8) % 6; unsplit and split
    pairs = list(itertools.combinations(range(4), 2))
    c, b = 96, 192
    idx = torch.tensor([[pairs[(r // 16 + j // 8) % 6] for j in range(b // 4)]
                        for r in range(c)], device=dev)       # (c, g, 2)
    keep = torch.zeros((c, b // 4, 4), device=dev)
    keep.scatter_(2, idx, 1.0)
    mask = 1.0 - keep.reshape(c, b)
    mag = torch.rand((c, b), generator=gen, device=dev) + 0.5
    sign = torch.randint(0, 2, (c, b), generator=gen, device=dev) * 2 - 1
    w = (mag * sign * (mask < 0.5)).to(torch.bfloat16)
    for bits in (4, 8):
        pk = pack_nm(w, mask, 2, 4, idx_bits=bits)
        x = torch.randn((4, b), generator=gen, device=dev).to(torch.bfloat16)
        for CS in (1, 2):
            direct(x, pk, b, bits,
                   (4, CS, K2._k2_dec_smem(K2._DEC_BM, 8, bits, 2, CS),
                    K2._DEC_BM, 8),
                   f"six pairs CS {CS} idx{bits}")
    # a NaN kept weight: NaN in its column, no skip
    n_nan = 0
    for (c, b, B), bits in itertools.product(((200, 1088, 1), (1000, 576, 4)),
                                             (4, 8)):
        pk = pack(c, b, bits, nan_row=c // 2)
        x = torch.randn((B, b), generator=gen, device=dev).to(torch.bfloat16)
        y_k = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, bits,
                            K2._k2_dec_plan(c, b, B, bits))
        torch.cuda.synchronize()
        check(bool(torch.isnan(y_k[:, c // 2]).all()) and bool(
            torch.isfinite(torch.cat([y_k[:, :c // 2], y_k[:, c // 2 + 1:]],
                                     1)).all()),
              f"K2 decode NaN weight ({c}, {b}) B={B} idx{bits}: NaN column "
              f"{bool(torch.isnan(y_k[:, c // 2]).all())}")
        hold(y_k, x, pk, b, bits, f"NaN weight ({c}, {b}) B={B}",
             equal_nan=True)
        n_nan += 1
    # x strided (copied by the wrapper: its plan, mode 4 on zamba2's
    # (3 584, 3 584) at B = 4) and off alignment (mode 2)
    c, b, B = 3584, 3584, 4
    pk = pack(c, b, 4)
    strided = torch.randn((B, b + 8), generator=gen, device=dev).to(
        torch.bfloat16)[:, 3:3 + b]
    offset = torch.randn((B * b + 1,), generator=gen, device=dev).to(
        torch.bfloat16)[1:].view(B, b)
    counted(strided, pk, b, 4, "strided x")
    counted(offset, pk, b, 4, "x one element off 16 bytes", mode=2)
    # a CUDA-graph replay bitwise the direct call, unsplit and split plans
    n_graph = 0
    for c, b, B in ((2048, 2048, 4), (5632, 2048, 1), (200, 1088, 33)):
        pk = pack(c, b, 4)
        x = torch.randn((B, b), generator=gen, device=dev).to(torch.bfloat16)
        plan = K2._k2_dec_plan(c, b, B, 4)
        y_d = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, 4, plan)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, 4, plan)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y_g = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, 4, plan)
        y_g.zero_()
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(y_g, y_d), f"K2 decode ({c}, {b}) B={B} {plan}: "
              "the graph's replay differs from the direct call")
        n_graph += 1
    print(f"kernels: nm_matmul decode path vs plain and fp32: {n_ok} checks "
          f"ok (B ∈ {K2_DEC_BATCHES} at the path shapes and {K2_RAGGED}, "
          f"{n_wrap} through the wrapper's mode-4 plan; {n_plans} splits × "
          f"depths at {K2_DEC_TILES}; the six position pairs in "
          f"every slot; strided x; an x off alignment on mode 2), max abs/"
          f"rel err {worst[0]:.3g}/{worst[1]:.3g}; {len(plans)} (BM, CS, "
          f"nst) plans run, BM {sorted({p[0] for p in plans})}, CS "
          f"{sorted({p[1] for p in plans})}, nst {min(p[2] for p in plans)}–"
          f"{max(p[2] for p in plans)}; NaN weight {n_nan} ok; {n_graph} "
          "graph replays bitwise the direct call")


def k3_dec_checks(gen, dev) -> None:
    """Phase 2 for K3's decode-occupancy path (plan mode 4,
    nm_stacked_sp_dec_kernel) against its plain version at bf16 rtol 2e-2 /
    atol 1e-2, and against the fp32 product (max rel err at most the dense
    bf16 product's + 2⁻⁸): both full-width qwen3-moe leaves on x from
    moe_ffn's own dispatch at K3_DEC_TOKENS (C = 8), 4- and 8-bit indices,
    through the wrapper (its plan mode 4, counted), and at C = 48; ZERO_K3's
    shapes that mode 4 takes (c % 128 ≠ 0, C ∈ {3, 17}) under every
    cluster size and ring depth (2 and the deepest); an all-zero x (every
    y bitwise +0); −0 rows idle; a NaN weight in a skipped expert (+0) and
    in an active expert's kept weight (NaN in its column); every case two
    launches bitwise equal; a CUDA graph captured on one routing and
    replayed on another, bitwise the direct call on the second, where the
    kernel splits K over its clusters and where it gives each CTA its own
    items.  The mode-2 tensor-core kernel, which the wrapper still
    plans for x off 16-byte alignment, is held to its plain version (idle
    rows +0) at both leaves, at ZERO_K3's 2:4 shapes and through the
    wrapper on such an x."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.sparsity import pack_nm_stacked, unpack_nm_stacked
    from repro_torch.kernels import nm_spmm as K2

    tol = {"rtol": 2e-2, "atol": 1e-2}
    worst, n_ok, plans = (0.0, 0.0), 0, set()

    def stack(E, c, b, bits, nan=None):
        w = (torch.randn((E, c, b), generator=gen, device=dev)
             / math.sqrt(b)).to(torch.bfloat16)
        mask = nm_mask3(w, 2, 4)
        if nan is not None:
            e, r = nan
            w[e, r, int((mask[e, r] < 0.5).nonzero()[0])] = torch.nan
        return pack_nm_stacked(w, mask, 2, 4, idx_bits=bits)

    def routed(E, C, b, active):
        x = torch.zeros((E, C, b), device=dev, dtype=torch.bfloat16)
        for e, grp in active:
            r = slice(8 * grp, min(C, 8 * grp + 8))
            x[e, r] = torch.randn(x[e, r].shape, generator=gen,
                                  device=dev).to(torch.bfloat16)
        return x

    def hold(y, x, pk, bits, what, fp32=True):
        nonlocal worst, n_ok
        b = x.shape[-1]
        idle = ~K2.active_row_groups(x)
        rows = idle.repeat_interleave(MAXB_ROWS, 1)[:, :x.shape[1]]
        y_p = K2.nm_matmul_stacked_plain(x, pk.values, pk.indices, 2, 4, b,
                                         bits)
        e = errs(y, y_p)
        ok = (y.shape == y_p.shape and torch.allclose(
            y.float(), y_p.float(), **tol)
            and bool((y.view(torch.int16)[rows] == 0).all()))
        rel = dense = 0.0
        if fp32:
            w = unpack_nm_stacked(pk)
            y32 = torch.bmm(x.float(), w.float().transpose(1, 2))
            dense = errs(torch.bmm(x, w.transpose(1, 2)), y32)[1]
            rel = errs(y, y32)[1]
        check(ok and rel <= dense + 2 ** -8,
              f"K3 decode {what}: max abs err {e[0]:.3g}, rel err vs fp32 "
              f"{rel:.3g} (dense bf16 {dense:.3g}), idle rows +0 "
              f"{bool((y.view(torch.int16)[rows] == 0).all())}")
        worst = max(worst, e)
        n_ok += 1

    def direct(x, pk, bits, plan, what, fp32=True):
        b = x.shape[-1]
        ys = [K2._launch_k3(x, pk.values, pk.indices, 2, 4, b, bits, plan)
              for _ in range(2)]
        torch.cuda.synchronize()
        check(torch.equal(ys[0].view(torch.int16), ys[1].view(torch.int16)),
              f"K3 decode {what}: two launches of {plan} differ")
        hold(ys[0], x, pk, bits, what, fp32)
        if plan[0] == 4:
            plans.add(plan)
        return ys[0]

    n_mode2 = 0

    def mode2(x, pk, bits, what):
        """The mode-2 kernel on its own plan, where the layout gives it
        one."""
        nonlocal n_mode2
        L, stride = pk.values.shape[-1], pk.indices.shape[-1]
        plan = K2._k3_plan(L, stride, x.shape[-1], 2, True)
        if plan[0] == 2:
            direct(x, pk, bits, plan, f"the mode-2 kernel {what}", fp32=False)
            n_mode2 += 1

    # the two full-width leaves on the dispatch's x, through the wrapper
    cfg = get_config(MOE_ARCH)
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    n_wrap = 0
    for bits in (4, 8):
        gu, dn = stack(E, f, d, bits), stack(E, d, f, bits)
        xs = moe_dispatch_inputs(gen, dev, {(E, 8, f, d): gu,
                                            (E, 8, d, f): dn}, K3_DEC_TOKENS)
        for T in K3_DEC_TOKENS:
            for pk, x in ((gu, xs[d][T]), (dn, xs[f][T])):
                b = x.shape[-1]
                plan = K2._k3_operands(x, pk.values, pk.indices, 2, 4, b,
                                       bits)[3]
                check(plan[0] == 4, f"K3 leaf b={b} T={T} idx{bits}: plan "
                      f"{plan} is not the decode path (mode 4)")
                n0 = K2.nm_stacked_sp_dec.launches
                ys = [K2.nm_matmul_stacked_cuda(x, pk.values, pk.indices,
                                                n=2, m=4, b=b, idx_bits=bits)
                      for _ in range(2)]
                torch.cuda.synchronize()
                check(K2.nm_stacked_sp_dec.launches == n0 + 2 and torch.equal(
                    ys[0].view(torch.int16), ys[1].view(torch.int16)),
                    f"K3 leaf b={b} T={T} idx{bits}: counted "
                    f"{K2.nm_stacked_sp_dec.launches - n0} of 2 launches, or "
                    "two launches differ")
                hold(ys[0], x, pk, bits, f"leaf b={b} T={T} idx{bits}")
                plans.add(plan)
                n_wrap += 1
                mode2(x, pk, bits, f"leaf b={b} T={T} idx{bits}")
        if bits == 4:
            # through the wrapper: C = 48 (mode 4), and the T = 1 x off
            # 16-byte alignment (the mode-2 kernel, not counted as mode 4)
            x48 = routed(E, 48, d, [(e, e % 6) for e in range(0, E, 5)])
            off = torch.zeros((xs[d][1].numel() + 1,), device=dev,
                              dtype=torch.bfloat16)[1:].view(xs[d][1].shape)
            off.copy_(xs[d][1])
            for x, mode in ((x48, 4), (off, 2)):
                plan = K2._k3_operands(x, gu.values, gu.indices, 2, 4, d,
                                       4)[3]
                n0 = (K2.nm_matmul_stacked_cuda.launches,
                      K2.nm_stacked_sp_dec.launches)
                y = K2.nm_matmul_stacked_cuda(x, gu.values, gu.indices, n=2,
                                              m=4, b=d, idx_bits=4)
                torch.cuda.synchronize()
                check(plan[0] == mode and (
                    K2.nm_matmul_stacked_cuda.launches,
                    K2.nm_stacked_sp_dec.launches) == (
                        n0[0] + 1, n0[1] + (mode == 4)),
                      f"K3 wrapper at C={x.shape[1]}, x at "
                      f"{x.data_ptr() % 16} mod 16: plan {plan}, not mode "
                      f"{mode}, or miscounted")
                hold(y, x, gu, 4, f"wrapper C={x.shape[1]} plan {plan}",
                     fp32=mode == 4)
                n_wrap += 1
        del gu, dn, xs
    # ZERO_K3's 2:4 shapes that mode 4 takes, every plan, idle groups
    # mixed; the mode-2 kernel on the same inputs
    n_plans = 0
    for E, C, c, b, n, m in ZERO_K3:
        if (n, m) != (2, 4):
            continue
        G, nks = -(-C // MAXB_ROWS), -(-b // (32 * K2._DEC_KS))
        for bits in (4, 8):
            if (b // 2 * bits // 8) % 16:
                continue                        # index rows not whole 16 B
            pk = stack(E, c, b, bits)
            x = routed(E, C, b, [(e, grp) for e in range(E)
                                 for grp in range(G)
                                 if e % 2 and not (G > 2 and grp == 1)])
            x[0, 0, 0] = -0.0
            mode2(x, pk, bits, f"E={E} C={C} c={c} b={b} idx{bits}")
            for CS in K2._K3D_SPLITS:
                if nks < CS:
                    continue
                top = max(dd for dd in range(2, K2._K3D_MAXST + 1)
                          if K2._k3_dec_fits(dd, CS, E * G, bits))
                for nst in sorted({2, top}):
                    direct(x, pk, bits, (4, CS, nst),
                           f"E={E} C={C} c={c} b={b} idx{bits} CS {CS} nst "
                           f"{nst}")
                    n_plans += 1
    # an all-zero x, −0 entries: every y bitwise +0, each cluster size
    pk = stack(16, 300, 1088, 4)
    x = torch.zeros((16, 8, 1088), device=dev, dtype=torch.bfloat16)
    x[7] = -0.0
    for CS in K2._K3D_SPLITS:
        y = direct(x, pk, 4, (4, CS, 2), f"all-zero x CS {CS}")
        check(bool((y.view(torch.int16) == 0).all()),
              f"K3 decode all-zero x CS {CS}: a y entry is not +0")
    # −0 rows idle beside active ones, against active_row_groups
    pk = stack(8, 128, 256, 4)
    x = routed(8, 17, 256, [(1, 0), (2, 2), (5, 1)])
    x[0] = -0.0
    x[3, 9, 7] = -0.0
    check(K2.active_row_groups(x).nonzero().tolist()
          == [[1, 0], [2, 2], [5, 1]], "K3 decode: −0 rows counted active")
    for CS in (1, 2):                            # 2 stages: a split of 2
        direct(x, pk, 4, (4, CS, 2), f"−0 rows CS {CS}")
    # NaN kept weights: in idle expert 2 (+0), in active expert 3 (row 150)
    n_nan = 0
    for bits in (4, 8):
        pk = stack(6, 200, 512, bits, nan=(2, 37))
        pk3 = stack(6, 200, 512, bits, nan=(3, 150))
        pk.values[3], pk.indices[3] = pk3.values[3], pk3.indices[3]
        x = routed(6, 8, 512, [(0, 0), (3, 0), (5, 0)])
        for plan in (K2._k3_operands(x, pk.values, pk.indices, 2, 4, 512,
                                     bits)[3], (4, 4, 2), (4, 1, 3)):
            y = K2._launch_k3(x, pk.values, pk.indices, 2, 4, 512, bits, plan)
            y_p = K2.nm_matmul_stacked_plain(x, pk.values, pk.indices, 2, 4,
                                             512, bits)
            torch.cuda.synchronize()
            keep = torch.tensor([0, 1, 3, 4, 5], device=dev)
            rest = torch.cat([y[3, :, :150], y[3, :, 151:]], 1)
            check(bool((y[2].view(torch.int16) == 0).all())
                  and bool(torch.isnan(y[3, :, 150]).all())
                  and bool(torch.isfinite(rest).all())
                  and torch.allclose(y[keep].float(), y_p[keep].float(),
                                     equal_nan=True, **tol),
                  f"K3 decode NaN weights idx{bits} {plan}: skipped expert "
                  f"+0 {bool((y[2].view(torch.int16) == 0).all())}, NaN "
                  f"column {bool(torch.isnan(y[3, :, 150]).all())}")
            n_nan += 1
    # a graph captured on one routing, replayed on another: 8 and 9
    # active groups of 6 tiles, split over clusters of CS ≤ 2 (their items
    # × CS fit the grid of 132 CTAs, one an SM at 6 stages), one CTA an
    # item at CS = 4
    n_graph = 0
    pk = stack(E, f, d, 4)
    x1 = routed(E, 8, d, [(e, 0) for e in range(0, E, 16)])
    x2 = routed(E, 8, d, [(e, 0) for e in range(3, E, 14)])
    for CS in K2._K3D_SPLITS:
        if -(-d // (32 * K2._DEC_KS)) < CS:
            continue                             # no stage a CTA
        plan = (4, CS, 6)
        y2 = direct(x2, pk, 4, plan, f"graph's second routing {plan}",
                    fp32=False)
        static = x1.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            K2._launch_k3(static, pk.values, pk.indices, 2, 4, d, 4, plan)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            yg = K2._launch_k3(static, pk.values, pk.indices, 2, 4, d, 4,
                               plan)
        graph.replay()
        torch.cuda.synchronize()
        first = torch.equal(yg.view(torch.int16), K2._launch_k3(
            x1, pk.values, pk.indices, 2, 4, d, 4, plan).view(torch.int16))
        static.copy_(x2)
        yg.fill_(1.0)
        graph.replay()
        torch.cuda.synchronize()
        check(first and torch.equal(yg.view(torch.int16),
                                    y2.view(torch.int16)),
              f"K3 decode graph {plan}: the replay on the first routing "
              f"equal {first}; on the second routing it differs from the "
              "direct call")
        del graph
        n_graph += 1
    print(f"kernels: nm_matmul_stacked decode path vs plain and fp32: {n_ok} "
          f"checks ok ({n_wrap} through the wrapper's mode-4 plan at both "
          f"leaves, T ∈ {K3_DEC_TOKENS}, idx 4/8, C = 48 and an x off "
          f"16-byte alignment; {n_plans} splits × depths at ZERO_K3's 2:4 "
          f"shapes; all-zero and −0 x; {n_mode2} of the mode-2 kernel on "
          f"the same leaves and shapes), max abs/rel err "
          f"{worst[0]:.3g}/{worst[1]:.3g}; {len(plans)} decode plans run, "
          f"CS {sorted({p[1] for p in plans})}, nst "
          f"{sorted({p[2] for p in plans})}; idle groups bitwise +0; NaN "
          f"weights {n_nan} ok (skipped expert +0, active NaN column); "
          f"{n_graph} graphs replayed on a second routing, bitwise its "
          "direct call")


def k2_rows_checks(gen, dev, pack, run) -> None:
    """Phase 2 for K2's many-row path (plan mode 3, nm_sp_rows_kernel):
    ragged (c, b) at B from the threshold to whisper's 6 000 rows, 4- and
    8-bit indices, through the wrapper (plan checked, two launches bitwise
    equal); every tile and split under an explicit plan; every 2:4 position
    pair in every slot of a metadata word; a NaN kept weight; x strided
    (copied: mode 3) and one element off alignment (mode 2).  Each against
    the plain version at rtol 2e-2 / atol 1e-2 and the fp32 product: max
    rel err at most the dense bf16 product's + 2⁻⁸."""
    import torch

    from repro_torch.core.sparsity import pack_nm
    from repro_torch.kernels import nm_spmm as K2
    from repro_torch.kernels.ref import nm_expand

    T = K2._ROWS_MIN_B
    tol = {"rtol": 2e-2, "atol": 1e-2}
    worst, n_ok, tiles = (0.0, 0.0), 0, set()

    def hold(y_k, y_p, x, pk, b, bits, what):
        nonlocal worst, n_ok
        w = nm_expand(pk.values, pk.indices, 2, 4, b, bits)
        y32 = x.float() @ w.float().T
        dense = errs(x @ w.T, y32)[1]
        e = errs(y_k, y_p)
        rel = errs(y_k, y32)[1]
        check(y_k.shape == (x.shape[0], w.shape[0])
              and torch.allclose(y_k.float(), y_p.float(), **tol)
              and rel <= dense + 2 ** -8,
              f"K2 many rows {what}: max abs err {e[0]:.3g}, rel err vs "
              f"fp32 {rel:.3g} (dense bf16 {dense:.3g})")
        worst = max(worst, e)
        n_ok += 1

    def counted(x, pk, b, bits, what, mode=3):
        rows = K2.nm_sp_rows.launches
        y_k, y_p, plan = run(x, pk, b, bits, what, mode)
        check(K2.nm_sp_rows.launches == rows + 2 * (mode == 3),
              f"K2 many rows {what}: nm_sp_rows counted "
              f"{K2.nm_sp_rows.launches - rows} of 2 launches")
        hold(y_k, y_p, x, pk, b, bits, what)
        return plan

    for (c, b), bits in itertools.product(K2_ROWS_RAGGED, (4, 8)):
        pk = pack(c, b, bits)
        for B in (T, T + 1, *K2_ROWS_BATCHES):
            x = torch.randn((B, b), generator=gen, device=dev).to(
                torch.bfloat16)
            plan = counted(x, pk, b, bits, f"({c}, {b}) B={B} idx{bits}")
            tiles.add((plan[3], plan[4], plan[1]))
    c, b, B = K2_ROWS_TILES
    pk = pack(c, b, 4)
    x = torch.randn((B, b), generator=gen, device=dev).to(torch.bfloat16)
    y_p = K2.nm_matmul_plain(x, pk.values, pk.indices, 2, 4, b, 4)
    n_plans = 0
    for BM, BN, CS in [(128, bn, cs) for bn in (128, 64)
                       for cs in (1, 2, 4, 8)] + [(256, 128, 1), (256, 64, 1)]:
        plan = (3, CS, K2._k2_rows_smem(BM, BN, 4), BM, BN)
        y_k = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, 4, plan)
        y_2 = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, 4, plan)
        torch.cuda.synchronize()
        check(torch.equal(y_k, y_2), f"K2 many rows {BM}×{BN} CS {CS}: two "
              "launches differ")
        hold(y_k, y_p, x, pk, b, 4, f"{BM}×{BN} CS {CS} ({c}, {b}) B={B}")
        n_plans += 1
    # every pair of kept positions in every row and group slot of the
    # metadata words: row r's group j keeps pair (r // 16 + j // 8) % 6
    pairs = list(itertools.combinations(range(4), 2))
    c, b = 96, 192
    idx = torch.tensor([[pairs[(r // 16 + j // 8) % 6] for j in range(b // 4)]
                        for r in range(c)], device=dev)       # (c, g, 2)
    keep = torch.zeros((c, b // 4, 4), device=dev)
    keep.scatter_(2, idx, 1.0)
    mask = 1.0 - keep.reshape(c, b)
    mag = torch.rand((c, b), generator=gen, device=dev) + 0.5
    sign = torch.randint(0, 2, (c, b), generator=gen, device=dev) * 2 - 1
    w = (mag * sign * (mask < 0.5)).to(torch.bfloat16)
    for bits, B in itertools.product((4, 8), (T, 129)):
        pk = pack_nm(w, mask, 2, 4, idx_bits=bits)
        x = torch.randn((B, b), generator=gen, device=dev).to(torch.bfloat16)
        counted(x, pk, b, bits, f"six pairs B={B} idx{bits}")
    n_nan = 0
    for bits in (4, 8):
        c, b, B = 200, 1056, T
        pk = pack(c, b, bits, nan_row=c // 2)
        x = torch.randn((B, b), generator=gen, device=dev).to(torch.bfloat16)
        y_k, y_p, _ = run(x, pk, b, bits, f"NaN weight B={B}")
        check(bool(torch.isnan(y_k[:, c // 2]).all()) and torch.allclose(
            y_k.float(), y_p.float(), equal_nan=True, **tol),
            f"K2 many rows NaN weight idx{bits}: NaN column "
            f"{bool(torch.isnan(y_k[:, c // 2]).all())}")
        n_nan += 1
    c, b, B = 300, 512, 129
    pk = pack(c, b, 4)
    strided = torch.randn((B, b + 8), generator=gen, device=dev).to(
        torch.bfloat16)[:, 3:3 + b]
    offset = torch.randn((B * b + 1,), generator=gen, device=dev).to(
        torch.bfloat16)[1:].view(B, b)
    counted(strided, pk, b, 4, "strided x")
    counted(offset, pk, b, 4, "x one element off 16 bytes", mode=2)
    print(f"kernels: nm_matmul many-row path vs plain and fp32: {n_ok} checks "
          f"ok (B ∈ {(T, T + 1, *K2_ROWS_BATCHES)} at {K2_ROWS_RAGGED}, "
          f"{n_plans} tiles × splits at {K2_ROWS_TILES}, the six position "
          f"pairs in every slot, strided x; an x off alignment on mode 2), "
          f"max abs/rel err {worst[0]:.3g}/{worst[1]:.3g}; the plan's "
          f"(BM, BN, CS) {sorted(tiles)}; NaN weight {n_nan} ok")


def moe_phase(dev) -> dict:
    """Phase 4m: prune → stacked compress → serve qwen3-moe-30b-a3b at full
    width, depth cut to MOE_LAYERS, through the functions ``prune_arch``
    composes; exact K1/K2/K3 launch counts over the path."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import PruneConfig
    from repro_torch.core.masks import check_nm
    from repro_torch.core.schedule import prune_model
    from repro_torch.core.sparsity import NmStackedCompressed
    from repro_torch.data.pipeline import calibration_batches, heldout_loss
    from repro_torch.kernels import hessian_accum as K1, nm_spmm as K2
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model_builder import ModelAdapter, build_model
    from repro_torch.serve.compressed import (compress_params,
                                              compressed_bytes,
                                              decompress_params)

    full = get_config(MOE_ARCH)
    cfg = full.replace(num_layers=MOE_LAYERS)
    L = cfg.num_layers
    print(f"phase moe: {MOE_ARCH} at full width (d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV heads, head_dim "
          f"{cfg.head_dim}, {cfg.num_experts} experts top-"
          f"{cfg.num_experts_per_tok}, moe_d_ff {cfg.moe_d_ff}, vocab "
          f"{cfg.vocab_size}, qk_norm {cfg.qk_norm}), {cfg.dtype}; depth cut "
          f"{full.num_layers} → {L} layers")
    kernels = (K1.hessian_update_cuda, K2.nm_matmul_cuda,
               K2.nm_matmul_stacked_cuda, K2.nm_stacked_sp_dec)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    dense_loss = heldout_loss(model, params, cfg)
    batches = calibration_batches(cfg, num_samples=16, seq_len=128, batch=8,
                                  device=dev)
    r0 = torch.cuda.memory_reserved()
    t1 = time.perf_counter()
    pruned, report = prune_model(
        params, ModelAdapter(model), batches,
        PruneConfig("thanos", "nm", n=2, m=4, block_size=64))
    torch.cuda.synchronize()
    t_prune = time.perf_counter() - t1
    graphs_line(cfg.name, report.graphs, t_prune, r0)
    pruned_loss = heldout_loss(model, pruned, cfg)
    t_phase = time.perf_counter() - t0
    del params
    per_block = 4 + 3 * cfg.num_experts
    check(len(report.masks) == per_block * L,
          f"{len(report.masks)} pruned linears, expected {per_block * L}")
    check(all(check_nm(mk.T, 2, 4) for mk in report.masks.values()),
          "a pruned linear breaks 2:4")
    check(all(r.fallback == "" for r in report.layers),
          "a layer fell back to magnitude pruning")
    check(abs(report.mean_sparsity() - 0.5) < 1e-9,
          f"sparsity {report.mean_sparsity()}")
    check(math.isfinite(dense_loss) and math.isfinite(pruned_loss),
          "non-finite held-out loss")
    k1_expect = per_block * len(batches) * L
    check(K1.hessian_update_cuda.launches == k1_expect,
          f"K1 launches {K1.hessian_update_cuda.launches}, expected "
          f"{k1_expect}")
    damp = sum(r.damp_attempts for r in report.layers)
    print(f"phase moe prune: thanos 2:4 B=64 on {len(batches)} × 8 × 128 "
          f"tokens: {len(report.layers)} linears ({3 * cfg.num_experts * L} "
          f"expert slices) in {t_prune:.1f} s (phase {t_phase:.1f} s), "
          f"dense loss {dense_loss:.4f}, pruned loss {pruned_loss:.4f}, "
          f"damping escalations {damp}, K1 launches "
          f"{K1.hessian_update_cuda.launches} (expect {k1_expect})")

    comp = compress_params(pruned, report.masks, 2, 4, strict=True)
    del pruned, report
    stacks = [comp["blocks"][i]["moe"][nm]["w"] for i in range(L)
              for nm in ("gate", "up", "down")]
    check(all(isinstance(s, NmStackedCompressed) and s.E == cfg.num_experts
              and (s.n, s.m, s.idx_bits) == (2, 4, 4) for s in stacks),
          "an expert stack is not one NmStackedCompressed leaf of E = 128")
    cb, db = compressed_bytes(comp)
    check(cb / db == 0.625, f"compressed ratio {cb / db}")
    prompts = request_prompts(cfg.vocab_size)
    done, t_serve, engine = serve_requests(model, comp, prompts)
    launches = {fn.__name__: fn.launches for fn in kernels}
    by_shape = {fn.__name__: dict(fn.by_shape) for fn in kernels}
    st = engine.stats
    steps = st["prefill_tokens"] + st["decode_steps"]
    ntok = sum(len(r.out) for r in done)
    # every serve step's K3 launches are at C = 8 (T ≤ 4 tokens): the
    # decode-occupancy kernel's wherever the plan takes both leaves there
    dec = all(k3_plan_mode(E, 8, c, b) == 4 for E, _, c, b in MOE_LEAVES)
    expect = {"hessian_update_cuda": k1_expect,
              "nm_matmul_cuda": 4 * L * steps,
              "nm_matmul_stacked_cuda": 3 * L * steps,
              "nm_stacked_sp_dec_kernel": 3 * L * steps if dec else 0}
    check(launches == expect, f"MoE launches {launches}, expected {expect}")
    check(launches["nm_stacked_sp_dec_kernel"] > 0,
          "qwen3-moe's serve path launched no nm_stacked_sp_dec_kernel")
    print(f"phase moe serve: {len(stacks)} expert stacks as stacked leaves "
          f"of E = {cfg.num_experts}; compressed {cb / db:.4f} of dense bf16 "
          f"bytes ({cb / 2**20:.1f} MiB vs {db / 2**20:.1f} MiB); 4 "
          f"requests, {ntok} tokens in {t_serve:.2f} s "
          f"({ntok / t_serve:.1f} tok/s, {st['decode_steps']} decode steps, "
          f"{st['prefills']} prefills, {steps} model steps); launches "
          f"{launches} (expect {expect})")
    print(f"  req 0: {done[0].out}")

    # first-step logits, K3/K2 path vs the same params decompressed, with
    # each MoE layer's top-k routing recorded on both paths; then each
    # kernel alone on the card path (the other one plain), to attribute a
    # flipped near-tie to one kernel or to both together
    from repro_torch.kernels import ops

    dense = decompress_params(comp)
    tok = torch.tensor([[int(p[0])] for p in prompts], device=dev)
    route_fn = moe_mod.moe_ffn
    real_k3, real_k2 = ops.nm_matmul_stacked, ops.nm_matmul

    def first_step(params, k3_impl="", k2_impl=""):
        routes: list = []

        def recording(p, x, mcfg, **kw):
            xt = x.reshape(-1, x.shape[-1])
            probs = torch.softmax((xt @ p["router"]["w"]).float(), dim=-1)
            ids = torch.topk(probs, mcfg.num_experts_per_tok, dim=-1).indices
            routes.append(torch.sort(ids, dim=-1).values)
            return route_fn(p, x, mcfg, **kw)

        moe_mod.moe_ffn = recording
        ops.nm_matmul_stacked = lambda x, pk, impl="", cfg=None: real_k3(
            x, pk, impl=k3_impl or impl, cfg=cfg)
        ops.nm_matmul = lambda x, pk, impl="", cfg=None: real_k2(
            x, pk, impl=k2_impl or impl, cfg=cfg)
        try:
            with torch.no_grad():
                lg, _ = model.decode_step(params, model.init_cache(4, 8), tok,
                                          0)
        finally:
            moe_mod.moe_ffn = route_fn
            ops.nm_matmul_stacked, ops.nm_matmul = real_k3, real_k2
        return lg, torch.stack(routes)

    lg_d, rd = first_step(dense)
    top2 = torch.topk(lg_d.float(), 2, dim=-1).values
    gap = float((top2[..., 0] - top2[..., 1]).min())
    compared = {}
    for name, k3_impl, k2_impl in (("K3+K2", "", ""), ("K3 alone", "", "ref"),
                                   ("K2 alone", "ref", "")):
        lg, rk = first_step(comp, k3_impl, k2_impl)
        torch.cuda.synchronize()
        e = errs(lg, lg_d)
        compared[name] = {
            "max_abs_err": e[0], "rel_err": e[1],
            "argmax_agree": float((lg.argmax(-1) == lg_d.argmax(-1)).float()
                                  .mean()),
            "routing_sets_equal": float((rk == rd).all(-1).float().mean()),
            "finite": bool(torch.isfinite(lg).all())}
    for name, c in compared.items():
        print(f"  first-step logits, {name} on the card path vs "
              f"decompressed dense: max abs err {c['max_abs_err']:.4g}, rel "
              f"{c['rel_err']:.4g} (limit 5e-2), argmax agree "
              f"{c['argmax_agree']:.2f}; top-{cfg.num_experts_per_tok} "
              f"expert sets equal in {c['routing_sets_equal']:.3f} of "
              f"(layer, token) routings")
    print(f"  the dense logits' smallest top-1 − top-2 gap over the 4 "
          f"tokens: {gap:.4g}")
    c = compared["K3+K2"]
    # bf16 through MOE_LAYERS layers, summed in another order: max abs
    # error within 5e-2 of the logits' max magnitude
    check(c["finite"] and c["rel_err"] <= 5e-2,
          f"MoE compressed vs dense logits: max abs err "
          f"{c['max_abs_err']:.3g} (rel {c['rel_err']:.3g}); routing sets "
          f"equal {c['routing_sets_equal']:.3f}")
    e = (c["max_abs_err"], c["rel_err"])
    agree, route_sets = c["argmax_agree"], c["routing_sets_equal"]
    graphs = graphs_case(MOE_ARCH, model, comp, prompts)
    return {"layers": L, "layers_full": full.num_layers, "graphs": graphs,
            "dense_loss": dense_loss, "pruned_loss": pruned_loss,
            "prune_seconds": t_prune, "phase_seconds": t_phase,
            "damp_escalations": damp, "ratio": cb / db, "tokens": ntok,
            "serve_seconds": t_serve, "tok_per_s": ntok / t_serve,
            "stats": st, "steps": steps, "launches": launches,
            "by_shape": by_shape, "logits_max_abs_err": e[0],
            "logits_rel_err": e[1], "argmax_agree": agree,
            "routing_sets_equal": route_sets, "logit_gap_min": gap,
            "per_kernel": compared}


def moe_dispatch_inputs(gen, dev, packs3: dict, tokens=(1, 4)) -> dict:
    """K3's inputs at the serving path's occupancy, made by the port's own
    ``moe_ffn`` at full width: a random router over the two phase-2 leaves
    (gate = up = the (128, 768, 2048) leaf, down = the (128, 2048, 768)
    one) on each count of ``tokens`` → {b: {T: x (E, C, b)}}, the gate/up
    input (the dispatch buffer) at b = 2048 and h, the down input, at 768."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_mod

    cfg = get_config(MOE_ARCH)
    d, E = cfg.d_model, cfg.num_experts
    gate_up = packs3[(E, 8, cfg.moe_d_ff, d)]
    down = packs3[(E, 8, d, cfg.moe_d_ff)]
    p = {"router": {"w": (torch.randn((d, E), generator=gen, device=dev)
                          / math.sqrt(d)).to(torch.bfloat16)},
         "gate": {"w": gate_up}, "up": {"w": gate_up}, "down": {"w": down}}
    seen: list = []
    real = ops.nm_matmul_stacked

    def spy(x, packed, **kw):
        seen.append(x.clone())
        return real(x, packed, **kw)

    out: dict = {d: {}, cfg.moe_d_ff: {}}
    ops.nm_matmul_stacked = spy
    try:
        with torch.no_grad():
            for T in tokens:
                seen.clear()
                x = torch.randn((T, 1, d), generator=gen,
                                device=dev).to(torch.bfloat16)
                moe_mod.moe_ffn(p, x, cfg)
                check(len(seen) == 3, f"moe_ffn made {len(seen)} K3 calls")
                out[d][T], out[cfg.moe_d_ff][T] = seen[0], seen[2]
    finally:
        ops.nm_matmul_stacked = real
    return out


def k2_times(gen, dev, packs: dict, err: dict, main: dict,
             path: str, others: "dict | None" = None,
             batches=(1, 4)) -> list:
    """Phase 5 rows of K2 at one path's shapes (bf16 2:4, 4-bit indices,
    B ∈ ``batches``): its plan, the kernel, the warp-per-row kernel (K2's
    design before the tensor-core path, mode 1 of the same source), the plain
    version and ``torch.matmul`` on the dense weight.  The weights rotate
    through copies so that every launch streams them from HBM.  ``others``
    maps another path that runs the same shapes to its launches by shape
    (its row's ``path_launches``)."""
    import torch

    from repro_torch.kernels import nm_spmm as K2

    bf16 = torch.bfloat16
    rows = []
    for (c, b), (pk, wd) in packs.items():
        per = pk.values.numel() * 2 + pk.indices.numel()
        copies = max(1, math.ceil(128 * 2**20 / per))
        vals = [pk.values.clone() for _ in range(copies)]
        idxs = [pk.indices.clone() for _ in range(copies)]
        dens = [wd.clone() for _ in range(max(1, math.ceil(
            128 * 2**20 / (wd.numel() * 2))))]
        reps = copies * max(1, 64 // copies)
        dreps = len(dens) * max(1, 64 // len(dens))
        for B in batches:
            if B > 8:                        # x is large: fewer replays
                reps, dreps = min(reps, 8), min(dreps, 8)
            x = torch.randn((B, b), generator=gen, device=dev).to(bf16)
            plan = K2._k2_operands(x, pk.values, pk.indices, 2, 4, b, 4)[3]
            old = (1, 1, 0, 8, 8)            # warp-per-row, 16-byte loads
            # the 8-row tensor-core plan (what an unaligned x takes)
            tc8 = K2._k2_plan(c, b, pk.values.shape[1], pk.indices.shape[1],
                              B, 2, True, 2, 4, False)
            ring = itertools.cycle(range(copies))
            dring = itertools.cycle(range(len(dens)))

            def kern():
                i = next(ring)
                K2.nm_matmul_cuda(x, vals[i], idxs[i], n=2, m=4, b=b,
                                  idx_bits=4)

            def kern_old():
                i = next(ring)
                K2._launch_k2(x, vals[i], idxs[i], 2, 4, b, 4, old)

            def kern_tc8():
                i = next(ring)
                K2._launch_k2(x, vals[i], idxs[i], 2, 4, b, 4, tc8)

            def plain():
                i = next(ring)
                K2.nm_matmul_plain(x, vals[i], idxs[i], 2, 4, b, 4)

            def lib():
                torch.matmul(x, dens[next(dring)].T)

            nbytes = per + 2 * B * b + 2 * B * c
            ops = 2 * B * c * pk.values.shape[1]
            t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["bfloat16"]
            key = (B, c, b, str(bf16), 4)
            rows.append({
                "name": "nm_matmul", "shape": f"B={B} W ({c}, {b}) 2:4 bf16",
                "kernel": K2_KERNELS[plan[0]],
                "path": path, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/nm_spmm.cu",
                "replaces": "src/repro/kernels/nm_spmm.py:135",
                "launches": main.get(key, 0), "max_abs_err": err[key][0],
                "ms": device_ms(kern, reps),
                "eager_ms": eager_ms(kern, 200),
                "plain_ms": device_ms(plain, reps),
                "bound_ms": 1e3 * max(t_b, t_o),
                "bound_by": "bytes" if t_b >= t_o else "operations",
                "library_ms": device_ms(lib, dreps),
                "library_bf16_ms": None,
                "plan": {"mode": plan[0], "cluster": plan[1],
                         "smem": plan[2], "tile": [plan[3], plan[4]],
                         "ctas": K2._k2_ctas(c, B, plan)},
                "warp_row_ms": device_ms(kern_old, reps),
                "tc8_ms": (device_ms(kern_tc8, reps) if plan[0] in (3, 4)
                           else None)})
            if others:
                rows[-1]["path_launches"] = {
                    name: by.get(key, 0) for name, by in others.items()}
        del vals, idxs, dens
    return rows


def tc_mode(c: int, b: int, B: int, bits: int = 4) -> int:
    """The plan mode K2 takes for bf16 2:4 with aligned operands: the
    plan's own (``nm_spmm._k2_plan``, whose decode rule
    ``tools/k2_dec_rule.py`` fits to the decode sweep's timings) — 3 (many
    rows) from ``_ROWS_MIN_B``, below it 4 (decode) where the rule takes
    it, else 2 (8 rows)."""
    from repro_torch.kernels import nm_spmm as K2

    L = b // 2
    return K2._k2_plan(c, b, L, L * bits // 8, B, 2, True, 2, 4)[0]


def k3_plan_mode(E: int, C: int, c: int, b: int, bits: int = 4) -> int:
    """K3's plan mode for bf16 2:4 (E, C, c, b) with aligned operands."""
    from repro_torch.kernels import nm_spmm as K2

    L = b // 2
    return K2._k3_plan(L, L * bits // 8, b, 2, True, 2, 4, E, C, c)[0]


def k2_mode(row: dict) -> int:
    """The tensor-core plan mode a phase-5 K2 row calls for (tc_mode)."""
    B, c, b = map(int, re.findall(r"\d+", row["shape"])[:3])
    return tc_mode(c, b, B)


def k2_step_line(rows: list, stats: dict, path: str) -> dict:
    """K2's device time per model step of one path — the B=1 (prefill)
    and the B=4 (decode) step — and its launch-weighted total, each beside
    the library call's (``torch.matmul``) at the same launches."""
    steps = {1: stats["prefill_tokens"], 4: stats["decode_steps"]}
    out = {}
    for key in ("ms", "library_ms"):
        tot = {B: sum(r["launches"] * r[key] for r in rows
                      if r["shape"].startswith(f"B={B} ")) for B in (1, 4)}
        out[key] = {"B=1 step": tot[1] / max(1, steps[1]),
                    "B=4 step": tot[4] / max(1, steps[4]),
                    "weighted": tot[1] + tot[4]}
    k, lb = out["ms"], out["library_ms"]
    print(f"  K2 per {path} model step: B=1 {k['B=1 step']:.4f} ms (library "
          f"{lb['B=1 step']:.4f}), B=4 {k['B=4 step']:.4f} ms (library "
          f"{lb['B=4 step']:.4f}); launch-weighted {k['weighted']:.2f} ms "
          f"(library {lb['weighted']:.2f})")
    return out


def moe_times(gen, dev, chk: dict, moe: dict) -> list:
    """Phase 5 rows at the MoE path's shapes (bf16, 4-bit indices): K1 at
    its capacity-buffer and attention shapes, K2 at the attention shapes,
    K3 at the two expert leaves."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.sparsity import unpack_nm_stacked
    from repro_torch.kernels import hessian_accum as K1, nm_spmm as K2

    bf16 = torch.bfloat16
    main = moe["by_shape"]
    rows = []

    def row(name, shape, source, replaces, launches, err, ms, eager, plain,
            lib, nbytes, ops, lib_bf16=None, extra=None):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["bfloat16"]
        rows.append({
            "name": name, "shape": shape, "path": MOE_ARCH, "route": "cuda",
            "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "eager_ms": eager,
            "plain_ms": plain, "bound_ms": 1e3 * max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": lib, "library_bf16_ms": lib_bf16, **(extra or {})})

    for tok, b, masked in MOE_K1:
        x = torch.randn((tok, b), generator=gen, device=dev).to(bf16)
        valid = (torch.rand((tok,), generator=gen, device=dev) < 0.6
                 if masked else None)
        xm = x.float() if valid is None else torch.where(
            valid[:, None], x.float(), 0.0)
        acc = [torch.zeros((b, b), device=dev), torch.zeros((), device=dev),
               torch.zeros((), device=dev)]
        rows_used = tok if valid is None else int(valid.sum())
        key = (tok, b, str(bf16))
        eager = k1_eager_fields(
            lambda: K1.hessian_update_cuda(x, valid, *acc))
        row("hessian_xtx", f"x ({tok}, {b}) bf16"
            + (" + row mask" if valid is not None else ""),
            "src/repro_torch/kernels/csrc/hessian_xtx.cu",
            "src/repro/kernels/hessian_accum.py:66",
            main["hessian_update_cuda"].get(key, 0), chk["k1"][key][0],
            device_ms(lambda: K1.hessian_update_cuda(x, valid, *acc), 10),
            eager.pop("eager_ms"),
            device_ms(lambda: K1.hessian_update_plain(x, valid, *acc), 10),
            device_ms(lambda: torch.addmm(acc[0], xm.T, xm), 10),
            x.numel() * 2 + (tok if valid is not None else 0) + 2 * b * b * 4,
            k1_ops(rows_used, b), addmm_bf16_ms(acc[0], xm.to(bf16), 10),
            {**eager, **k1_plan_fields(x, valid, acc[0])})
    rows += k2_times(gen, dev, chk["packs2"], chk["k2"],
                     main["nm_matmul_cuda"], MOE_ARCH)
    # K3 at full occupancy (every capacity row filled: no main-path step
    # is like that, so no launches), then at the main path's decode
    # occupancy: x from moe_ffn's own dispatch of T = 1 (prefill) and T = 4
    # (decode) tokens, launches split by the engine's step counts.  Each on
    # the wrapper's plan, with the mode-2 kernel on the same inputs
    # as "earlier ms", torch.bmm over the whole dense stack as the library
    # and, for information, over only the active experts' dense weights
    # (gathered before the timing and rotated as the kernel's weights are)
    cfg_d = get_config(MOE_ARCH).d_model             # gate/up leaves' b
    st = moe["stats"]
    per_t = {1: st["prefill_tokens"] * moe["layers"],
             4: st["decode_steps"] * moe["layers"]}
    decode_x = moe_dispatch_inputs(gen, dev, chk["packs3"])
    for (E, C, c, b), pk in chk["packs3"].items():
        wd = unpack_nm_stacked(pk)                       # (E, c, b)
        leaf = 2 if b == cfg_d else 1                    # gate+up, or down
        key = (E, C, c, b, str(bf16), 4)
        check(main["nm_matmul_stacked_cuda"].get(key, 0)
              == leaf * (per_t[1] + per_t[4]),
              f"K3 launches at {key} do not split into T=1 / T=4 steps")
        per = pk.values.numel() * 2 + pk.indices.numel()
        L, stride = pk.values.shape[-1], pk.indices.shape[-1]
        old = K2._k3_plan(L, stride, b, 2, True)         # the mode-2 kernel
        filled = torch.randn((E, C, b), generator=gen, device=dev).to(bf16)
        for T, x in [(0, filled), *decode_x[b].items()]:
            act = K2.active_row_groups(x)
            groups, experts = int(act.sum()), int(act.any(dim=1).sum())
            plan = K2._k3_operands(x, pk.values, pk.indices, 2, 4, b, 4)[3]
            # rotate copies of the leaf so the active experts' weights
            # (16–64 MB at decode) stream from HBM, not from the 50 MB L2;
            # a filled leaf (≥ 250 MB) does without
            copies = 1 if T == 0 else min(8, math.ceil(
                96 * 2**20 / max(1, groups * per // E)) + 1)
            vals = [pk.values] + [pk.values.clone()
                                  for _ in range(copies - 1)]
            idxs = [pk.indices] + [pk.indices.clone()
                                   for _ in range(copies - 1)]
            nxt = itertools.cycle(range(copies))

            def kern(xx=x):
                i = next(nxt)
                K2.nm_matmul_stacked_cuda(xx, vals[i], idxs[i], n=2, m=4,
                                          b=b, idx_bits=4)

            def kern_old(xx=x):
                i = next(nxt)
                K2._launch_k3(xx, vals[i], idxs[i], 2, 4, b, 4, old)

            y_k = K2.nm_matmul_stacked_cuda(x, pk.values, pk.indices, n=2,
                                            m=4, b=b, idx_bits=4)
            y_p = K2.nm_matmul_stacked_plain(x, pk.values, pk.indices, 2,
                                             4, b, 4)
            torch.cuda.synchronize()
            e = errs(y_k, y_p)
            check(torch.allclose(y_k.float(), y_p.float(), rtol=2e-2,
                                 atol=1e-2),
                  f"K3 at T={T} b={b}: err {e[0]:.3g}")
            reps = 20 if T == 0 else copies * 4
            t_old = device_ms(kern_old, reps)
            t_new = device_ms(kern, reps)
            nbytes = K2.stacked_stream_bytes(x, pk.values, pk.indices)
            what = ("every row filled" if T == 0 else
                    f"from moe_ffn T={T}: {experts} active experts")
            print(f"  K3 {what} b={b}: {groups} active row groups, "
                  f"{nbytes} bytes streamed; plan {plan}, the mode-2 kernel "
                  f"{t_old:.4f} ms, this plan {t_new:.4f} ms")
            row("nm_matmul_stacked", f"x ({E}, {C}, {b}) {what}, "
                f"W ({E}, {c}, {b}) 2:4 bf16",
                "src/repro_torch/kernels/csrc/nm_spmm.cu", K3_REPLACES,
                0 if T == 0 else leaf * per_t[T], e[0], t_new,
                eager_ms(kern, 50),
                device_ms(lambda: K2.nm_matmul_stacked_plain(
                    x, pk.values, pk.indices, 2, 4, b, 4), 2),
                device_ms(lambda: torch.bmm(x, wd.transpose(-1, -2)), 20),
                nbytes, 2 * MAXB_ROWS * c * L * groups,
                extra={"kernel": K3_KERNELS[plan[0]], "plan": list(plan),
                       "earlier_ms": t_old,
                       "library_active_ms": bmm_active_ms(x, wd, act),
                       "active_groups": groups, "active_experts": experts})
            del vals, idxs
        del wd, filled
    k3 = [r for r in rows if r["name"] == "nm_matmul_stacked"]
    print(f"  K3 launch-weighted over qwen3-moe's path: "
          f"{sum(r['launches'] * r['ms'] for r in k3):.2f} ms (before the "
          f"decode kernel {K3_BEFORE_MS} ms; the mode-2 kernel in this run "
          f"{sum(r['launches'] * r['earlier_ms'] for r in k3):.2f}), bound "
          f"{sum(r['launches'] * r['bound_ms'] for r in k3):.2f} ms (before "
          f"{K3_BEFORE_BOUND_MS}), torch.bmm "
          f"{sum(r['launches'] * r['library_ms'] for r in k3):.2f} ms, over "
          f"the active experts only "
          f"{sum(r['launches'] * r['library_active_ms'] for r in k3):.2f} ms")
    return rows


def cache_bytes(cache) -> int:
    """Bytes of every tensor field of every layer's cache (a dict of
    caches, nested for the hybrid's {"mamba", "shared"})."""
    if isinstance(cache, dict):
        return sum(cache_bytes(layer) for layer in cache.values())
    return sum(t.numel() * t.element_size() for t in vars(cache).values()
               if hasattr(t, "element_size"))


def request_prompts(vocab: int) -> list:
    """The phase-4 request set's prompts: 4 × 16 tokens from seed 0."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=16) for _ in range(4)]


def run_engine(model, params, specs: list, label: str, *, max_len: int,
               **paged) -> tuple:
    """Serve ``specs`` [(prompt, max_new), …] on 4 slots through the
    continuous-batching engine; ``paged`` holds the ServeConfig's paged
    options, and a paged engine audits its pager after every step
    (``debug_checks``: an audit error fails the run).  Fails unless every
    request completes with its max_new in-vocabulary tokens → (finished
    requests, seconds, engine)."""
    import torch

    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

    engine = ServingEngine(model, params, ServeConfig(
        batch_slots=4, max_len=max_len,
        debug_checks=paged.get("paged", False), **paged))
    for uid, (prompt, new) in enumerate(specs):
        engine.submit(Request(uid, prompt, max_new=new))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    vocab = model.cfg.vocab_size
    check(len(done) == len(specs)
          and all(r.done and len(r.out) == new
                  for r, (_, new) in zip(done, specs))
          and all(0 <= t < vocab for r in done for t in r.out),
          f"{label}: served requests incomplete or out of vocabulary")
    graph_line(engine, label)
    return done, seconds, engine


def graph_line(engine, label: str) -> dict:
    """An engine on the card serves from CUDA graphs: fails unless every
    compiled step it ran was captured and replayed; prints how many →
    ``engine.graph_stats()``."""
    gs = engine.graph_stats()
    check(gs["graphs"] > 0 and gs["graphs"] == len(engine._steps)
          and gs["replays"] > 0,
          f"{label}: not served from captured graphs ({gs})")
    print(f"  {label}: {gs['graphs']} CUDA graphs captured "
          f"({', '.join(engine._steps)}), {gs['replays']} replays of "
          f"{gs['steps']} model steps; warm-up + capture "
          f"{gs['capture_s']:.3f} s, pool {gs['pool_bytes'] / 2**20:.1f} MiB")
    return gs


def serve_requests(model, params, prompts):
    """The phase-4 request set — 4 requests × (16 prompt + 12 new) on 4
    slots — through the continuous-batching engine → (finished requests,
    seconds, engine)."""
    kind = model.cfg.kv_cache_dtype or "model dtype"
    return run_engine(model, params, [(p, 12) for p in prompts],
                      f"{model.cfg.name} ({kind} cache)",
                      max_len=SERVE_MAX_LEN)


def first_step_line(model, comp, prompts) -> tuple:
    """The first decode step's logits on the kernel path against the same
    params decompressed and served dense: finite, max abs error within 5e-2
    of the logits' max magnitude (bf16 through every layer, summed in
    another order) → (max abs err, rel err, argmax agreement)."""
    import torch

    from repro_torch.serve.compressed import decompress_params

    dense = decompress_params(comp)
    tok = torch.tensor([[int(p[0])] for p in prompts], device=model.device)
    with torch.no_grad():
        lg_k, _ = model.decode_step(comp, model.init_cache(4, 8), tok, 0)
        lg_d, _ = model.decode_step(dense, model.init_cache(4, 8), tok, 0)
    torch.cuda.synchronize()
    e = errs(lg_k, lg_d)
    agree = float((lg_k.argmax(-1) == lg_d.argmax(-1)).float().mean())
    check(bool(torch.isfinite(lg_k).all()) and e[1] <= 5e-2,
          f"{model.cfg.name} compressed vs dense logits: max abs err "
          f"{e[0]:.3g} (rel {e[1]:.3g})")
    print(f"  first-step logits, K2 path vs decompressed dense: max abs err "
          f"{e[0]:.4g}, rel {e[1]:.4g} (limit 5e-2), argmax agree "
          f"{agree:.2f}")
    return e[0], e[1], agree


def chain_logits(model, params, prompts):
    """Teacher-forced decode of the 4 prompts side by side (B = 4, one
    position a step) → the logits of the last prompt position: attention
    there reads 16 cached positions."""
    import numpy as np
    import torch

    toks = torch.tensor(np.stack(prompts), device=model.device)
    cache = model.init_cache(toks.shape[0], toks.shape[1] + 1)
    with torch.no_grad():
        for t in range(toks.shape[1]):
            lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
    return lg


def int8_cache_line(name: str, model, model8, params, prompts, engine,
                    engine8, tps: float, tps8: float,
                    rel_limit: "float | None") -> dict:
    """The int8 KV cache against the model-dtype one on the same params:
    both engines' resident cache bytes, and the logits of the same step
    (``chain_logits``): finite, max |Δlogit| < 1.0 (the bound of the
    reference's own int8 test, tests/test_serving_optimizations.py) and,
    where ``rel_limit`` is given, max abs error within that share of the
    logits' max magnitude.  The argmax agreement is printed, not gated
    (random-init logits hold near-ties)."""
    import torch

    from repro_torch.models import attention as A

    kinds = {type(c).__name__ for c in engine8._cache.values()}
    check(kinds <= {"QuantGqaCache", "QuantMlaCache"} and len(kinds) == 1,
          f"{name}: the int8 engine holds {kinds}")
    lg = chain_logits(model, params, prompts)
    lg8 = chain_logits(model8, params, prompts)
    torch.cuda.synchronize()
    e = errs(lg8, lg)
    agree = float((lg8.argmax(-1) == lg.argmax(-1)).float().mean())
    nb, nb8 = cache_bytes(engine._cache), cache_bytes(engine8._cache)
    check(bool(torch.isfinite(lg8).all()) and e[0] < 1.0
          and (rel_limit is None or e[1] <= rel_limit),
          f"{name} int8 vs {model.cfg.dtype} cache logits: max abs err "
          f"{e[0]:.3g} (rel {e[1]:.3g}, limit {rel_limit})")
    limit = "" if rel_limit is None else f", rel limit {rel_limit:g}"
    group = (f", latent scale groups of {A._mla_group(model.cfg.kv_lora_rank)}"
             if model.cfg.uses_mla else "")
    print(f"  int8 KV cache ({sorted(kinds)[0]}{group}): {tps8:.1f} tok/s "
          f"(model-dtype cache {tps:.1f}); resident cache {nb8} B vs {nb} "
          f"B ({nb8 / nb:.4f}); logits after 16 teacher-forced positions, "
          f"int8 vs model-dtype cache: max abs err {e[0]:.4g} (limit 1.0"
          f"{limit}), rel {e[1]:.4g}, argmax agree {agree:.2f} (not "
          "gated)")
    return {"tok_per_s": tps8, "cache_bytes": nb8, "cache_bytes_bf16": nb,
            "logits_max_abs_err": e[0], "logits_rel_err": e[1],
            "argmax_agree": agree}


def path_kernel_checks(gen, dev, label: str, k1_bs: list,
                       k2_shapes: list, batches=(1, 4)) -> dict:
    """Phase 2 at one path's shapes (bf16, the served format): K1 at
    x (1024, b) for every b of ``k1_bs``, K2 at every (c, b) of
    ``k2_shapes`` for B ∈ ``batches`` and 4-/8-bit indices, each launch's
    plan printed and two launches bitwise equal.  Tolerances as above: K1
    rtol 1e-3 / atol 2e-2 (xtx exactly symmetric); K2 rtol 2e-2 / atol
    1e-2.  → errors and operands for phase 5."""
    import torch

    from repro_torch.core.masks import nm_mask
    from repro_torch.core.sparsity import pack_nm
    from repro_torch.kernels import hessian_accum as K1, nm_spmm as K2

    bf16 = torch.bfloat16
    out: dict = {"k1": {}, "k2": {}, "packs2": {}}
    for b in k1_bs:
        x = torch.randn((1024, b), generator=gen, device=dev).to(bf16)
        acc_k = [torch.zeros((b, b), device=dev), torch.zeros((), device=dev),
                 torch.zeros((), device=dev)]
        acc_p = [t.clone() for t in acc_k]
        for _ in range(2):
            K1.hessian_update_cuda(x, None, *acc_k)
            K1.hessian_update_plain(x, None, *acc_p)
        torch.cuda.synchronize()
        e = errs(acc_k[0], acc_p[0])
        check(torch.allclose(acc_k[0], acc_p[0], rtol=1e-3, atol=2e-2)
              and torch.equal(acc_k[0], acc_k[0].T)
              and float(acc_k[1]) == float(acc_p[1]) == 2048.0
              and float(acc_k[2]) == 0.0,
              f"K1 {label} (1024, {b}): err {e[0]:.3g}, count "
              f"{float(acc_k[1])}")
        out["k1"][(1024, b, str(bf16))] = e
        del x, acc_k, acc_p
    for c, b in k2_shapes:
        w = (torch.randn((c, b), generator=gen, device=dev)
             / math.sqrt(b)).to(bf16)
        mask = nm_mask(w.float(), torch.ones((b,), device=dev), 2, 4)
        for bits, B in itertools.product((4, 8), batches):
            pk = pack_nm(w, mask, 2, 4, idx_bits=bits)
            x = torch.randn((B, b), generator=gen, device=dev).to(bf16)
            plan = K2._k2_operands(x, pk.values, pk.indices, 2, 4, b,
                                   bits)[3]
            y_k = K2.nm_matmul_cuda(x, pk.values, pk.indices, n=2, m=4, b=b,
                                    idx_bits=bits)
            y_2 = K2.nm_matmul_cuda(x, pk.values, pk.indices, n=2, m=4, b=b,
                                    idx_bits=bits)
            y_p = K2.nm_matmul_plain(x, pk.values, pk.indices, 2, 4, b, bits)
            torch.cuda.synchronize()
            e = errs(y_k, y_p)
            check(y_k.shape == (B, c) and torch.allclose(
                y_k.float(), y_p.float(), rtol=2e-2, atol=1e-2)
                and torch.equal(y_k, y_2),
                f"K2 {label} ({c}, {b}) B={B} idx{bits}: plan {plan}, max abs "
                f"err {e[0]:.3g}, two launches equal {torch.equal(y_k, y_2)}")
            print(f"  K2 ({c}, {b}) B={B} idx{bits}: plan mode {plan[0]} CS "
                  f"{plan[1]} tile {plan[3]}×{plan[4]} smem {plan[2]} B, "
                  f"{K2._k2_ctas(c, B, plan)} CTAs; max abs/rel err "
                  f"{e[0]:.3g}/{e[1]:.3g}")
            out["k2"][(B, c, b, str(bf16), bits)] = e
            if bits == 4:
                out["packs2"][(c, b)] = (pk, w.masked_fill(mask > 0.5, 0))
        del w, mask
    print(f"kernels: {label} shapes: hessian_xtx {len(out['k1'])} checks ok "
          f"at b ∈ {k1_bs} (rtol 1e-3 / atol 2e-2, xtx exactly symmetric); "
          f"nm_matmul {len(out['k2'])} checks ok (rtol 2e-2 / atol 1e-2)")
    return out


def mla_phase(dev) -> dict:
    """Phase mla: prune → compress → serve deepseek-v3-671b at full width,
    depth cut to its MLA_LAYERS leading dense layers, through the
    functions ``prune_arch`` composes; every wkv_b is pruned but serves
    dense (the absorbed decode reads it raw); the engine serves the
    phase-4 request set with the bf16 latent cache (``MlaCache``) and
    again with the int8 one (``QuantMlaCache``).  Exact K1/K2 launch
    counts over the path.  Then the paged phase's deepseek serves
    (``paged_mla``), counted apart."""
    import warnings

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import PruneConfig
    from repro_torch.core.masks import check_nm
    from repro_torch.core.schedule import prune_model
    from repro_torch.core.sparsity import NmCompressed
    from repro_torch.data.pipeline import calibration_batches, heldout_loss
    from repro_torch.kernels import hessian_accum as K1, nm_spmm as K2
    from repro_torch.models.model_builder import ModelAdapter, build_model
    from repro_torch.serve.compressed import (CompressionDowngrade,
                                              compress_params,
                                              compressed_bytes)

    full = get_config(MLA_ARCH)
    cfg = full.replace(num_layers=MLA_LAYERS)
    L = cfg.num_layers
    check(not any(cfg.layer_is_moe(i) for i in range(L)),
          f"the first {L} layers of {MLA_ARCH} are not all dense")
    print(f"phase mla: {MLA_ARCH} at full width (d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads, MLA q_lora {cfg.q_lora_rank} kv_lora "
          f"{cfg.kv_lora_rank} nope/rope/v {cfg.qk_nope_head_dim}/"
          f"{cfg.qk_rope_head_dim}/{cfg.v_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}), {cfg.dtype}; depth cut {full.num_layers} → "
          f"{L} layers (its {full.num_dense_layers} leading dense layers)")
    kernels = (K1.hessian_update_cuda, K2.nm_matmul_cuda)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    dense_loss = heldout_loss(model, params, cfg)
    batches = calibration_batches(cfg, num_samples=16, seq_len=128, batch=8,
                                  device=dev)
    r0 = torch.cuda.memory_reserved()
    t1 = time.perf_counter()
    pruned, report = prune_model(
        params, ModelAdapter(model), batches,
        PruneConfig("thanos", "nm", n=2, m=4, block_size=64))
    torch.cuda.synchronize()
    t_prune = time.perf_counter() - t1
    graphs_line(cfg.name, report.graphs, t_prune, r0)
    pruned_loss = heldout_loss(model, pruned, cfg)
    t_phase = time.perf_counter() - t0
    del params
    per_block = 5 + 3
    check(len(report.masks) == per_block * L,
          f"{len(report.masks)} pruned linears, expected {per_block * L}")
    check(all(check_nm(mk.T, 2, 4) for mk in report.masks.values()),
          "a pruned linear breaks 2:4")
    check(all(r.fallback == "" for r in report.layers),
          "a layer fell back to magnitude pruning")
    check(abs(report.mean_sparsity() - 0.5) < 1e-9,
          f"sparsity {report.mean_sparsity()}")
    check(math.isfinite(dense_loss) and math.isfinite(pruned_loss),
          "non-finite held-out loss")
    k1_expect = per_block * len(batches) * L
    check(K1.hessian_update_cuda.launches == k1_expect,
          f"K1 launches {K1.hessian_update_cuda.launches}, expected "
          f"{k1_expect}")
    k1_shapes = {b: k for (_, b, _), k in
                 sorted(K1.hessian_update_cuda.by_shape.items())}
    check(set(k1_shapes) == set(MLA_K1), f"K1 shapes {k1_shapes}")
    damp = sum(r.damp_attempts for r in report.layers)
    print(f"phase mla prune: thanos 2:4 B=64 on {len(batches)} × 8 × 128 "
          f"tokens: {len(report.layers)} linears in {t_prune:.1f} s (phase "
          f"{t_phase:.1f} s), dense loss {dense_loss:.4f}, pruned loss "
          f"{pruned_loss:.4f}, damping escalations {damp}, K1 launches "
          f"{K1.hessian_update_cuda.launches} (expect {k1_expect}) at x "
          f"(1024, b), launches by b {k1_shapes}")

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", CompressionDowngrade)
        comp = compress_params(pruned, report.masks, 2, 4)
    del pruned, report
    downs = [str(w.message) for w in caught
             if issubclass(w.category, CompressionDowngrade)]
    check(len(downs) == L and all(f"blocks/{i}/attn/wkv_b/w" in downs[i]
                                  for i in range(L)),
          f"downgrades {downs}, expected one per layer for wkv_b")
    attn = [comp["blocks"][i]["attn"] for i in range(L)]
    check(all(not isinstance(a["wkv_b"]["w"], NmCompressed) for a in attn)
          and all(isinstance(a[n]["w"], NmCompressed) for a in attn
                  for n in ("wq_a", "wq_b", "wkv_a", "wo"))
          and all(isinstance(comp["blocks"][i]["mlp"][n]["w"], NmCompressed)
                  for i in range(L) for n in ("gate", "up", "down")),
          "compressed leaves are not exactly every linear but wkv_b")
    cb, db = compressed_bytes(comp)
    check(cb / db == 0.625, f"compressed ratio {cb / db}")

    prompts = request_prompts(cfg.vocab_size)
    done, t_serve, engine = serve_requests(model, comp, prompts)
    st = engine.stats
    steps = st["prefill_tokens"] + st["decode_steps"]
    k2_expect = (5 - 1 + 3) * L * steps          # wkv_b serves dense
    check(K2.nm_matmul_cuda.launches == k2_expect,
          f"K2 launches {K2.nm_matmul_cuda.launches}, expected {k2_expect}")
    ntok = sum(len(r.out) for r in done)
    by_b = {(B, c, b): k for (B, c, b, _, _), k in
            sorted(K2.nm_matmul_cuda.by_shape.items())}
    print(f"phase mla serve: compressed {cb / db:.4f} of dense bf16 bytes "
          f"on the {len(attn) * 7} compressed linears ({cb / 2**20:.1f} MiB "
          f"vs {db / 2**20:.1f} MiB), {len(downs)} wkv_b dense "
          f"(CompressionDowngrade); bf16 latent cache: 4 requests, {ntok} "
          f"tokens in {t_serve:.2f} s ({ntok / t_serve:.1f} tok/s, "
          f"{st['decode_steps']} decode steps, {st['prefills']} prefills, "
          f"{steps} model steps); K2 launches {K2.nm_matmul_cuda.launches} "
          f"(expect {k2_expect}); by (B, c, b) {by_b}")
    print(f"  req 0: {done[0].out}")

    model8 = build_model(cfg.replace(kv_cache_dtype="int8"), device=dev)
    done8, t_serve8, engine8 = serve_requests(model8, comp, prompts)
    st8 = engine8.stats
    steps8 = st8["prefill_tokens"] + st8["decode_steps"]
    launches = {fn.__name__: fn.launches for fn in kernels}
    by_shape = {fn.__name__: dict(fn.by_shape) for fn in kernels}
    expect = {"hessian_update_cuda": k1_expect,
              "nm_matmul_cuda": (5 - 1 + 3) * L * (steps + steps8)}
    check(launches == expect, f"MLA launches {launches}, expected {expect}")
    ntok8 = sum(len(r.out) for r in done8)
    print(f"phase mla serve int8: {ntok8} tokens in {t_serve8:.2f} s "
          f"({ntok8 / t_serve8:.1f} tok/s, {steps8} model steps); launches "
          f"over the path {launches} (expect {expect})")
    print(f"  req 0: {done8[0].out}")

    e = first_step_line(model, comp, prompts)
    # 3 layers, the int8 rounding of the latent: max abs error within
    # 5e-2 of the logits' max magnitude, as the other logit checks
    q8 = int8_cache_line(MLA_ARCH, model, model8, comp, prompts, engine,
                         engine8, ntok / t_serve, ntok8 / t_serve8, 5e-2)
    paged = paged_mla(model, model8, comp, prompts, done, done8)
    stats = {k: st[k] + st8[k] for k in st}
    return {"layers": L, "layers_full": full.num_layers,
            "dense_loss": dense_loss, "pruned_loss": pruned_loss,
            "prune_seconds": t_prune, "phase_seconds": t_phase,
            "damp_escalations": damp, "ratio": cb / db,
            "downgrades": len(downs), "tokens": ntok,
            "serve_seconds": t_serve, "tok_per_s": ntok / t_serve,
            "stats": st, "stats_both": stats, "steps": steps,
            "launches": launches, "by_shape": by_shape,
            "logits_max_abs_err": e[0], "logits_rel_err": e[1],
            "argmax_agree": e[2], "int8": q8, "paged": paged}


def path_times(gen, dev, chk: dict, main: dict, path: str, k1_bs: list,
               others: "dict | None" = None, batches=(1, 4)) -> list:
    """Phase 5 rows at one path's shapes (bf16): K1 at x (1024, b) for
    every b of ``k1_bs``, K2 at every (c, b) checked in ``chk``
    (``k2_times``); ``main`` is the path's launches by shape, ``others``
    another path's K2 launches at the same shapes."""
    import torch

    from repro_torch.kernels import hessian_accum as K1

    bf16 = torch.bfloat16
    rows = []
    for b in k1_bs:
        x = torch.randn((1024, b), generator=gen, device=dev).to(bf16)
        x32 = x.float()
        acc = [torch.zeros((b, b), device=dev), torch.zeros((), device=dev),
               torch.zeros((), device=dev)]
        nbytes = x.numel() * 2 + 2 * b * b * 4
        t_b, t_o = nbytes / HBM_BYTES_PER_S, k1_ops(1024, b) / PEAK_OPS[
            "bfloat16"]
        key = (1024, b, str(bf16))
        rows.append({
            "name": "hessian_xtx", "shape": f"x (1024, {b}) bf16",
            "path": path, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/hessian_xtx.cu",
            "replaces": "src/repro/kernels/hessian_accum.py:66",
            "launches": main["hessian_update_cuda"].get(key, 0),
            "max_abs_err": chk["k1"][key][0],
            "ms": device_ms(lambda: K1.hessian_update_cuda(x, None, *acc),
                            10),
            **k1_eager_fields(lambda: K1.hessian_update_cuda(x, None, *acc)),
            "plain_ms": device_ms(lambda: K1.hessian_update_plain(
                x, None, *acc), 10),
            "bound_ms": 1e3 * max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": device_ms(lambda: torch.addmm(acc[0], x32.T, x32),
                                    10),
            "library_bf16_ms": addmm_bf16_ms(acc[0], x, 10),
            **k1_plan_fields(x, None, acc[0])})
        del x, x32, acc
        torch.cuda.empty_cache()
    rows += k2_times(gen, dev, chk["packs2"], chk["k2"],
                     main["nm_matmul_cuda"], path, others, batches)
    return rows


def serve_trace(model, params, specs: list, label: str, *, max_len: int,
                **paged) -> tuple:
    """``run_engine``, failing unless K2 launched in this serve, and
    printing tok/s, the model steps, the K2 launches and the paged
    statistics → (tokens by uid, seconds, engine)."""
    from repro_torch.kernels import nm_spmm as K2

    k2 = K2.nm_matmul_cuda.launches
    done, seconds, engine = run_engine(model, params, specs, label,
                                       max_len=max_len, **paged)
    k2 = K2.nm_matmul_cuda.launches - k2
    check(k2 > 0, f"{label}: K2 never launched")
    st = engine.stats
    ntok = sum(len(r.out) for r in done)
    line = ""
    if engine.pager is not None:
        line = (f"; paged: hwm {st['pages_hwm']} of "
                f"{engine.pager.pool.num_pages - 1} pages, "
                f"{st['page_faults']} faults, {st['cow_copies']} COW, "
                f"{st['prefix_hit_tokens']} prefix-hit tokens, "
                f"{st['preemptions']} preemptions, "
                f"{engine.pager.pool.used_pages} pages used after")
    print(f"  {label}: {len(done)} requests, {ntok} tokens in {seconds:.2f} "
          f"s ({ntok / seconds:.1f} tok/s; {st['decode_steps']} decode "
          f"steps, {st['prefill_tokens']} prefill tokens); K2 launches "
          f"{k2}{line}")
    return {r.uid: r.out for r in done}, seconds, engine


def serve_record(got: dict, seconds: float, engine) -> dict:
    """One serve's numbers for the results file."""
    ntok = sum(len(v) for v in got.values())
    return {"tokens": ntok, "seconds": seconds, "tok_per_s": ntok / seconds,
            "stats": dict(engine.stats), "graphs": engine.graph_stats(),
            "cache_bytes": cache_bytes(engine._cache)}


def agreement(a: dict, b: dict) -> float:
    """Share of token positions where two runs of one trace agree."""
    pairs = [(x, y) for uid in a for x, y in zip(a[uid], b[uid])]
    return sum(x == y for x, y in pairs) / len(pairs)


def paged_tinyllama(cfg, model, model8, comp, prompts, done, done8) -> dict:
    """Paged phase, tinyllama-1.1b (phase 4's compressed tree, full width
    and depth, pages of PAGE tokens): (a) the phase-4 request set on an
    auto-sized pool, tokens identical to phase 4's contiguous engine's;
    (b) the prefix trace, on the contiguous and the paged engine, tokens
    identical, prefix hits and copy-on-write required; (c) the phase-4 set
    on a pool of 1 + pages_per_slot pages (the progress floor, prefix reuse
    off): preemptions required, every request complete, the pool drained
    after, the tokens' agreement with (a) printed (a resumed request
    re-prefills at B=1 what it decoded at B=4, which may round otherwise);
    (d) (a) with the int8 pool, tokens identical to phase 4's int8
    contiguous engine's.  Launch counts zeroed before, read after; (b)'s
    contiguous serve is the reference and is not counted."""
    import numpy as np

    zero_counts()
    t0 = time.perf_counter()
    vocab = cfg.vocab_size
    specs = [(p, 12) for p in prompts]
    kw = dict(paged=True, page_size=PAGE)
    want = {r.uid: r.out for r in done}
    out: dict = {}
    print(f"phase paged: tinyllama-1.1b (phase 4's compressed tree), pages "
          f"of {PAGE} tokens, rows of {SERVE_MAX_LEN}")
    got, secs, eng = serve_trace(model, comp, specs, "(a) phase-4 set, paged",
                                 max_len=SERVE_MAX_LEN, **kw)
    check(got == want, f"(a) paged tokens {got} differ from phase 4's "
          f"contiguous engine's {want}")
    kinds = {type(c).__name__ for c in eng._cache.values()}
    check(kinds == {"PagedGqaCache"}, f"(a) the paged engine holds {kinds}")
    pool_b = cache_bytes(eng._cache)
    cont_b = cache_bytes(model.init_cache(4, SERVE_MAX_LEN))
    print(f"    tokens identical to phase 4's; paged pool {pool_b} B vs the "
          f"contiguous cache {cont_b} B ({pool_b / cont_b:.4f}; "
          f"{eng.pager.pool.num_pages} pages of which 1 scratch), hwm "
          f"{eng.stats['pages_hwm']} pages")
    out["a"] = dict(serve_record(got, secs, eng), contiguous_bytes=cont_b)

    rng = np.random.default_rng(1)
    head = rng.integers(0, vocab, size=PREFIX_HEAD)
    trace = [np.concatenate([head, rng.integers(0, vocab, size=PREFIX_TAIL)])
             for _ in range(4)]
    spec_b = [(p, 12) for p in trace + [trace[0].copy()]]
    with uncounted():
        got_c, secs_c, eng_c = serve_trace(model, comp, spec_b,
                                           "(b) prefix trace, contiguous "
                                           "(the reference, not counted)",
                                           max_len=PREFIX_MAX_LEN)
    got_p, secs_p, eng_p = serve_trace(model, comp, spec_b,
                                       "(b) prefix trace, paged",
                                       max_len=PREFIX_MAX_LEN, **kw)
    st = eng_p.stats
    check(got_p == got_c, "(b) paged tokens differ from the contiguous "
          "engine's on the prefix trace")
    check(st["prefix_hit_tokens"] > 0 and st["cow_copies"] > 0,
          f"(b) prefix hits {st['prefix_hit_tokens']}, copies "
          f"{st['cow_copies']}")
    print(f"    tokens identical to the contiguous engine's; prefill tokens "
          f"{st['prefill_tokens']} paged vs "
          f"{eng_c.stats['prefill_tokens']} contiguous")
    out["b"] = {"paged": serve_record(got_p, secs_p, eng_p),
                "contiguous": serve_record(got_c, secs_c, eng_c)}

    floor = 1 + SERVE_MAX_LEN // PAGE
    got_f, secs_f, eng_f = serve_trace(
        model, comp, specs, f"(c) phase-4 set, {floor}-page pool",
        max_len=SERVE_MAX_LEN, num_pages=floor, prefix_reuse=False, **kw)
    st = eng_f.stats
    check(st["preemptions"] > 0, "(c) the constrained pool never preempted")
    check(eng_f.pager.pool.used_pages == 0,
          f"(c) {eng_f.pager.pool.used_pages} pages used after the run")
    agree = agreement(got_f, got)
    print(f"    {st['preemptions']} preemptions, pool drained; tokens agree "
          f"with (a) at {agree:.3f} of positions (not gated)")
    out["c"] = dict(serve_record(got_f, secs_f, eng_f), agree_with_a=agree)

    want8 = {r.uid: r.out for r in done8}
    got8, secs8, eng8 = serve_trace(model8, comp, specs,
                                    "(d) phase-4 set, int8 paged",
                                    max_len=SERVE_MAX_LEN, **kw)
    kinds = {type(c).__name__ for c in eng8._cache.values()}
    check(kinds == {"PagedQuantGqaCache"}, f"(d) the engine holds {kinds}")
    check(got8 == want8, "(d) int8 paged tokens differ from phase 4's int8 "
          "contiguous engine's")
    print(f"    tokens identical to phase 4's int8 engine's; int8 pool "
          f"{cache_bytes(eng8._cache)} B")
    out["d"] = serve_record(got8, secs8, eng8)
    out["counts"] = path_counts()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase paged, tinyllama-1.1b: {out['seconds']:.1f} s")
    return out


def paged_mla(model, model8, comp, prompts, done, done8) -> dict:
    """Paged phase, deepseek-v3-671b (the mla phase's compressed tree):
    the phase-4 request set with ``PagedMlaCache`` and with
    ``PagedQuantMlaCache``, tokens identical to the mla phase's bf16 and
    int8 contiguous engines'.  Launch counts zeroed before, read after."""
    zero_counts()
    t0 = time.perf_counter()
    specs = [(p, 12) for p in prompts]
    out: dict = {}
    print(f"phase paged: {MLA_ARCH} (the mla phase's compressed tree)")
    for key, mdl, ref, kind in (("bf16", model, done, "PagedMlaCache"),
                                ("int8", model8, done8,
                                 "PagedQuantMlaCache")):
        got, secs, eng = serve_trace(mdl, comp, specs,
                                     f"phase-4 set, {kind}",
                                     max_len=SERVE_MAX_LEN, paged=True,
                                     page_size=PAGE)
        kinds = {type(c).__name__ for c in eng._cache.values()}
        check(kinds == {kind}, f"{MLA_ARCH} paged {key}: holds {kinds}")
        want = {r.uid: r.out for r in ref}
        check(got == want, f"{MLA_ARCH} paged {key} tokens differ from the "
              f"contiguous engine's")
        print(f"    tokens identical to the {key} contiguous engine's; pool "
              f"{cache_bytes(eng._cache)} B")
        out[key] = serve_record(got, secs, eng)
    out["counts"] = path_counts()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase paged, {MLA_ARCH}: {out['seconds']:.1f} s")
    return out


def gemma3_phase(dev) -> dict:
    """Paged phase, gemma3-1b at full width (5 local window-512 layers to
    1 global, head_dim 256, one kv head, vocab 262 144, tied embeddings),
    depth cut 26 → GEMMA_LAYERS, bf16 from seed 0: ``prune_arch``'s steps
    (``prune_family``: Thanos 2:4 with its calibration, K1 exactly 2 · 7 ·
    L launches), compress, and serve 4 requests — one of GEMMA_LONG
    tokens, which wraps every local ring, and three phase-4 prompts, 12
    new tokens each — on the contiguous engine and on the paged one in the
    mixed layout (a page pool for each global layer beside a ring for each
    local one, prefix reuse off), tokens identical (K2 for
    every pruned linear).  Then the first-step logits against the
    decompressed params.  Launch counts zeroed before the prune, read
    after the paged serve; the contiguous serve is the reference and is
    not counted."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import hessian_accum as K1

    full = get_config(GEMMA_ARCH)
    cfg = full.replace(num_layers=GEMMA_LAYERS)
    L = cfg.num_layers
    local = sum(not cfg.layer_is_global(i) for i in range(L))
    print(f"phase paged: {GEMMA_ARCH} at full width (d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, kv "
          f"heads {cfg.num_kv_heads}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {L} layers: {local} local window "
          f"{cfg.sliding_window} θ {cfg.rope_theta_local:g}, {L - local} "
          f"global θ {cfg.rope_theta:g}), {cfg.dtype}; depth cut "
          f"{full.num_layers} → {L}")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = prune_family(cfg, dev)
    model, comp, layers = out.pop("model"), out.pop("comp"), out.pop("layers")
    t_prune = time.perf_counter() - t0
    check(len(layers) == 7 * L, f"{len(layers)} pruned linears")
    k1_expect = out["batches"] * 7 * L
    k1 = K1.hessian_update_cuda.launches
    check(k1 == k1_expect, f"K1 launches {k1}, expected {k1_expect}")
    k1_shapes = {b: k for (_, b, _), k in
                 sorted(K1.hessian_update_cuda.by_shape.items())}
    check(set(k1_shapes) == set(GEMMA_K1), f"K1 shapes {k1_shapes}")
    print(f"  K1 launches {k1} (expect {out['batches']} × 7 × {L} = "
          f"{k1_expect}), by b {k1_shapes}")
    rng = np.random.default_rng(2)
    prompts = ([rng.integers(0, cfg.vocab_size, size=GEMMA_LONG)]
               + request_prompts(cfg.vocab_size)[:3])
    specs = [(p, 12) for p in prompts]
    t1 = time.perf_counter()
    with uncounted():
        got_c, secs_c, eng_c = serve_trace(model, comp, specs,
                                           "contiguous engine (the "
                                           "reference, not counted)",
                                           max_len=GEMMA_MAX_LEN)
    got_p, secs_p, eng_p = serve_trace(model, comp, specs,
                                       "paged engine, mixed layout",
                                       max_len=GEMMA_MAX_LEN, paged=True,
                                       page_size=PAGE)
    t_serve = time.perf_counter() - t1
    counts = path_counts()
    kinds = [type(c).__name__ for c in eng_p._cache.values()]
    check(kinds.count("PagedGqaCache") == L - local
          and kinds.count("GqaCache") == local,
          f"paged layout {kinds}")
    check(eng_p.pager.prefix is None, "prefix reuse is on for a windowed "
          "model")
    top = int(eng_c._cache[0].pos_ids.max())
    check(top >= cfg.sliding_window, f"the local rings never wrapped (last "
          f"position {top})")
    check(got_p == got_c, "gemma3 paged tokens differ from the contiguous "
          "engine's")
    pool_b, cont_b = cache_bytes(eng_p._cache), cache_bytes(eng_c._cache)
    print(f"  compressed {out['ratio']:.4f} of dense bf16 bytes on the "
          f"{7 * L} pruned linears; paged tokens identical to the "
          f"contiguous engine's; {L - local} paged layers beside {local} "
          f"rings of {cfg.sliding_window} (last position {top}, every ring wrapped); "
          f"resident cache paged {pool_b} B vs contiguous {cont_b} B; "
          f"K2 launches {counts['nm_matmul_cuda'][0]} in the paged serve")
    e = first_step_line(model, comp, prompts)
    torch.cuda.synchronize()
    t_phase = time.perf_counter() - t0
    print(f"phase paged, {GEMMA_ARCH}: {t_phase:.1f} s")
    return {"layers": L, "dense_loss": out["dense_loss"],
            "seconds": t_phase,
            "pruned_loss": out["pruned_loss"],
            "prune_seconds": out["prune_seconds"],
            "phase_prune_seconds": t_prune, "serve_seconds": t_serve,
            "ratio": out["ratio"], "k1_launches": k1,
            "contiguous": serve_record(got_c, secs_c, eng_c),
            "paged": serve_record(got_p, secs_p, eng_p),
            "last_position": top, "stats": dict(eng_p.stats),
            "by_shape": {name: shapes for name, (_, shapes) in
                         counts.items()},
            "logits_max_abs_err": e[0], "logits_rel_err": e[1],
            "argmax_agree": e[2]}


def graphs_line(label: str, stats: dict, seconds: float,
                reserved: int) -> dict:
    """One prune run's CUDA graphs (``PruneReport.graphs``): captured,
    replayed, eager first calls, capture seconds and the bytes its scope
    returned to the card at its close (pool and static buffers); the
    card's reserve before the run and after it; its seconds.  Gated:
    graphs captured and replayed (every run repeats keys: two calibration
    batches a block)."""
    import torch

    torch.cuda.synchronize()
    after = torch.cuda.memory_reserved()
    check(stats.get("graphs", 0) > 0 and stats.get("replays", 0) > 0,
          f"{label}: the prune captured or replayed no graph ({stats})")
    print(f"  graphs {label}: {stats['graphs']} captured, "
          f"{stats['replays']} replays, {stats['eager']} eager first calls "
          f"of {stats['calls']} keyed calls; capture {stats['capture_s']:.2f}"
          f" s, pool {stats['pool_bytes'] / 2**20:.1f} MiB; reserved "
          f"{reserved / 2**30:.2f} → {after / 2**30:.2f} GiB; prune "
          f"{seconds:.2f} s")
    rec = dict(stats, seconds=seconds, reserved_before=reserved,
               reserved_after=after)
    GRAPH_LINES[label] = rec
    return rec


def prune_family(cfg, dev) -> dict:
    """``prune_arch``'s steps on ``cfg`` (which may cut the registry's
    depth): init from seed 0, held-out loss, Thanos 2:4 B=64 on 2 × 8 × 128
    calibration tokens (K1), held-out loss of the pruned tree, compress →
    the model, the compressed tree, the report's layers and the numbers."""
    import torch

    from repro_torch.core.api import PruneConfig
    from repro_torch.core.masks import check_nm
    from repro_torch.core.schedule import prune_model
    from repro_torch.data.pipeline import calibration_batches, heldout_loss
    from repro_torch.models.model_builder import ModelAdapter, build_model
    from repro_torch.serve.compressed import (compress_params,
                                              compressed_bytes)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    dense_loss = heldout_loss(model, params, cfg)
    batches = calibration_batches(cfg, num_samples=16, seq_len=128, batch=8,
                                  device=dev)
    r0 = torch.cuda.memory_reserved()
    t1 = time.perf_counter()
    pruned, report = prune_model(
        params, ModelAdapter(model), batches,
        PruneConfig("thanos", "nm", n=2, m=4, block_size=64))
    torch.cuda.synchronize()
    t_prune = time.perf_counter() - t1
    graphs_line(cfg.name, report.graphs, t_prune, r0)
    del params
    pruned_loss = heldout_loss(model, pruned, cfg)
    check(all(check_nm(mk.T, 2, 4) for mk in report.masks.values()),
          f"{cfg.name}: a pruned linear breaks 2:4")
    check(all(r.fallback == "" for r in report.layers),
          f"{cfg.name}: a layer fell back to magnitude pruning")
    check(abs(report.mean_sparsity() - 0.5) < 1e-9,
          f"{cfg.name}: sparsity {report.mean_sparsity()}")
    check(math.isfinite(dense_loss) and math.isfinite(pruned_loss),
          f"{cfg.name}: non-finite held-out loss")
    comp = compress_params(pruned, report.masks, 2, 4)
    del pruned
    cb, db = compressed_bytes(comp)
    check(cb / db == 0.625, f"{cfg.name}: compressed ratio {cb / db}")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"  prune: thanos 2:4 B=64 on {len(batches)} × 8 × 128 tokens: "
          f"{len(report.layers)} linears in {t_prune:.1f} s ({secs:.1f} s "
          f"with init, held-out losses and compress), dense loss "
          f"{dense_loss:.4f}, pruned loss {pruned_loss:.4f}; compressed "
          f"{cb / db:.4f} of dense bf16 bytes ({cb / 2**20:.1f} MiB vs "
          f"{db / 2**20:.1f} MiB)")
    return {"model": model, "comp": comp, "layers": report.layers,
            "batches": len(batches), "dense_loss": dense_loss,
            "pruned_loss": pruned_loss, "prune_seconds": t_prune,
            "seconds": secs, "ratio": cb / db}


def stack_rows(rows: list):
    """B = 1 caches (dicts of dataclass caches, nested or not) → one cache
    of B = len(rows), each tensor field concatenated along the batch axis;
    the engine's in-place slot writes, done another way."""
    import dataclasses

    import torch

    if isinstance(rows[0], dict):
        return {k: stack_rows([r[k] for r in rows]) for k in rows[0]}
    return dataclasses.replace(rows[0], **{
        f.name: torch.cat([getattr(r, f.name) for r in rows])
        for f in dataclasses.fields(rows[0])
        if isinstance(getattr(rows[0], f.name), torch.Tensor)})


def eager_trace(model, comp, prompts, new: int):
    """The engine's model steps through an eager ``model.decode_step``
    loop: each prompt prefilled alone at B = 1 from a fresh cache, the
    rows concatenated, then ``new`` − 1 greedy steps of the four side by
    side at B = 4 → (tokens per row, the logits each token was taken
    from, in the engine's order: 4 admissions, then each B = 4 step, and
    each row's B = 1 prefill logits (S, V) in fp32)."""
    import numpy as np
    import torch

    dev = model.device
    seen, rows, first, prefill = [], [], [], []
    for prompt in prompts:
        row = model.init_cache(1, SERVE_MAX_LEN)
        toks = torch.tensor(np.asarray(prompt)[None], device=dev)
        out = []
        for s in range(toks.shape[1]):
            lg, row = model.decode_step(comp, row, toks[:, s:s + 1], s)
            out.append(lg[0, -1].float())
        prefill.append(torch.stack(out))
        seen.append(lg[:, -1].float())
        first.append(int(lg[0, -1].argmax()))
        rows.append(row)
    cache = stack_rows(rows)
    tok = torch.tensor(first, device=dev)[:, None]
    pos = torch.full((len(prompts),), len(prompts[0]), dtype=torch.int64,
                     device=dev)
    got = [tok[:, 0]]
    for _ in range(new - 1):
        lg, cache = model.decode_step(comp, cache, tok, pos)
        seen.append(lg[:, -1].float())
        tok = lg[:, -1].argmax(-1, keepdim=True)
        got.append(tok[:, 0])
        pos = pos + 1
    return torch.stack(got, dim=1).tolist(), seen, prefill


def lockstep_check(model, comp, prompts, done, label: str) -> dict:
    """The engine's tokens against a reference without the engine (not
    counted): each prompt prefilled alone at B = 1 from a fresh cache, as
    the engine prefills, the four row caches concatenated into one B = 4
    cache, then greedy decode of the four rows side by side — the steps
    the engine takes once all four slots are admitted.  The two compute
    the same kernels on the same shapes, so the tokens must be identical:
    this holds the engine's slot writes of every state leaf (GQA, Mamba,
    xLSTM).  Also reported, not gated: ε, the largest |Δlogit| between
    the prompts decoded side by side at B = 4 and alone at B = 1 — the
    card's batch-shaped kernels (cuBLAS, reductions) round a B = 4 row and
    a B = 1 row differently, so free-running B = 1 loops may part from
    the engine at a near-tie."""
    import numpy as np
    import torch

    dev = model.device
    served = {r.uid: r.out for r in done}
    new = len(served[0])
    check(all(len(v) == new for v in served.values())
          and len({len(p) for p in prompts}) == 1,
          f"{label}: the lockstep reference needs equal prompt lengths and "
          "max_new")
    with uncounted(), torch.no_grad():
        got, _, lg1 = eager_trace(model, comp, prompts, new)
        S = len(prompts[0])
        toks = torch.tensor(np.stack(prompts), device=dev)
        c4 = model.init_cache(len(prompts), SERVE_MAX_LEN)
        lg4 = []
        for s in range(S):
            lg, c4 = model.decode_step(comp, c4, toks[:, s:s + 1], s)
            lg4.append(lg[:, -1].float())
        eps = float((torch.stack(lg4, 1) - torch.stack(lg1)).abs().max())
    same = sum(a == b for r in range(len(prompts))
               for a, b in zip(got[r], served[r]))
    check(all(got[r] == served[r] for r in range(len(prompts))),
          f"{label}: engine tokens differ from the lockstep reference's "
          f"({same} of {new * len(prompts)} agree)")
    print(f"  engine tokens identical to B = 1 prefills + a B = 4 lockstep "
          f"decode of the concatenated rows ({same} tokens); ε (B = 4 vs "
          f"B = 1 logits on the prompts) {eps:.4g}")
    return {"tokens": same, "eps": eps}


def step_ms(fn, iters: int = 10) -> float:
    """Host ms of one call of ``fn`` (a model step), over ``iters`` calls
    ending in a synchronize, after one call to warm up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def graphs_case(label: str, model, comp, prompts, **serve_kw) -> dict:
    """Phase graphs, one case (not counted in the path's launches): the
    phase-4 trace served by the engine — captured — against the same
    model steps through an eager ``model.decode_step`` loop
    (``eager_trace``): tokens identical, K2 and K3 launches equal (the
    replays' tallies against the eager wrappers' counts), and the largest
    |Δ| between every logit row the engine sampled from and the eager
    one (a replay runs the eager step's kernels on its shapes: expected
    0).  Then tok/s of each, the capture's seconds, the pool's bytes, and
    one B = 4 and one B = 1 step's ms, replayed and eager, on the
    engine's own buffers."""
    import torch

    from repro_torch.kernels import nm_spmm as K2
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

    t_case = time.perf_counter()
    fns = (K2.nm_matmul_cuda, K2.nm_matmul_stacked_cuda)
    with uncounted(), torch.no_grad():
        eng = ServingEngine(model, comp, ServeConfig(
            batch_slots=len(prompts), max_len=SERVE_MAX_LEN, **serve_kw))
        seen, select = [], eng._select

        def record(logits):
            seen.append(logits.float().clone())
            return select(logits)

        eng._select = record
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid, p, max_new=12))
        c0 = [f.launches for f in fns]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        t_graph = time.perf_counter() - t0
        gs = eng.graph_stats()
        c1 = [f.launches for f in fns]
        want, ref, _ = eager_trace(model, comp, prompts, 12)
        torch.cuda.synchronize()
        t_eager = time.perf_counter() - t0 - t_graph
        c2 = [f.launches for f in fns]
        del eng._select                 # the recorder's reference cycle
        ms = {}
        for B, kind in ((len(prompts), "decode"), (1, "row")):
            st = eng._steps[kind]
            ms[B] = (step_ms(st.run), step_ms(
                lambda: model.decode_step(comp, st.cache, st.tokens,
                                          st.pos)))
    got = [r.out for r in done]
    k_graph = [b - a for a, b in zip(c0, c1)]
    k_eager = [b - a for a, b in zip(c1, c2)]
    diff = max(float((a - b).abs().max()) for a, b in zip(seen, ref))
    ntok = sum(len(t) for t in got)
    check(got == want and len(seen) == len(ref),
          f"graphs {label}: engine tokens differ from the eager loop's")
    check(k_graph == k_eager and k_graph[0] > 0,
          f"graphs {label}: K2, K3 launches {k_graph} captured, {k_eager} "
          f"eager")
    check(gs["graphs"] == 2 and gs["replays"] > 0,
          f"graphs {label}: {gs}")
    print(f"  graphs {label}: tokens identical to the eager loop's ({ntok}),"
          f" logits max |Δ| {diff:.6g} over {len(seen)} sampled rows; K2, K3 "
          f"launches {k_graph[0]}, {k_graph[1]} both ways; captured "
          f"{ntok / t_graph:.1f} tok/s ({t_graph:.3f} s, of which warm-up + "
          f"capture {gs['capture_s']:.3f} s) vs eager {ntok / t_eager:.1f} "
          f"tok/s ({t_eager:.3f} s); pool {gs['pool_bytes'] / 2**20:.1f} MiB;"
          f" one step replayed / eager: B = 4 {ms[4][0]:.3f} / {ms[4][1]:.3f}"
          f" ms, B = 1 {ms[1][0]:.3f} / {ms[1][1]:.3f} ms")
    return {"tokens": ntok, "logits_max_abs_diff": diff,
            "k2": k_graph[0], "k3": k_graph[1],
            "graph_seconds": t_graph, "eager_seconds": t_eager,
            "graph_tok_per_s": ntok / t_graph,
            "eager_tok_per_s": ntok / t_eager, "capture_s": gs["capture_s"],
            "pool_bytes": gs["pool_bytes"], "replays": gs["replays"],
            "step_ms_b4": ms[4], "step_ms_b1": ms[1],
            "seconds": time.perf_counter() - t_case}


@contextlib.contextmanager
def fp32_products():
    """Every dense linear as the fp32 product of its operands rounded once
    to the activation dtype: cuBLAS's bf16 GEMM summed in another order —
    the difference K2's own sums make, and no more."""
    import torch

    from repro_torch.models import layers

    real = layers.dense

    def dense(p, x, tape=None, path=()):
        if not torch.is_tensor(p["w"]):
            return real(p, x, tape, path)
        y = (x.reshape(-1, x.shape[-1]).float() @ p["w"].float()).to(x.dtype)
        if "b" in p:
            y = y + p["b"]
        return y.reshape(*x.shape[:-1], -1)

    layers.dense = dense
    try:
        yield
    finally:
        layers.dense = real


def k2_linear_errors(model, comp, tok) -> list:
    """Every K2 call of one first step of ``model`` over ``comp``: (W's
    shape, K2's and the dense bf16 product's max rel err against the fp32
    product of the same operands)."""
    import torch

    from repro_torch.kernels import ops as kops, ref

    real, rows = kops.nm_matmul, []

    def spy(x, packed, **kw):
        y = real(x, packed, **kw)
        w = ref.nm_expand(packed.values, packed.indices, packed.n, packed.m,
                          packed.b, packed.idx_bits)
        y32 = x.float() @ w.float().T
        rows.append((tuple(w.shape), errs(y, y32)[1],
                     errs(x @ w.to(x.dtype).T, y32)[1]))
        return y

    kops.nm_matmul = spy
    try:
        with uncounted(), torch.no_grad():
            model.decode_step(comp, model.init_cache(tok.shape[0], 8), tok,
                              0)
    finally:
        kops.nm_matmul = real
    return rows


def as_fp32(tree):
    """``tree`` with every floating tensor in fp32, n:m values included
    (indices and integers as they are)."""
    import dataclasses

    import torch

    if isinstance(tree, dict):
        return {k: as_fp32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_fp32(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: as_fp32(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.float()
    return tree


def lane_shifted(comp, block: int):
    """``comp`` with every n:m leaf of ``block`` reading its values one
    lane along (each kept weight at its neighbour's index): a planted K2
    fault for the depth check to find."""
    import dataclasses

    import torch

    from repro_torch.core.sparsity import NmCompressed

    def shift(node):
        if isinstance(node, dict):
            return {k: shift(v) for k, v in node.items()}
        if isinstance(node, NmCompressed):
            return dataclasses.replace(node, values=torch.roll(
                node.values, 1, dims=-1).contiguous())
        return node

    blocks = dict(comp["blocks"])
    blocks[block] = shift(blocks[block])
    return dict(comp, blocks=blocks)


def depth_profile(cfg, comp, prompts, depths, fault_block: int) -> dict:
    """First-step logits of the compressed tree's first d blocks (the
    same leaves, a model of depth d) for each d of ``depths``, the kernel
    path against the decompressed leaves (rel err): in bf16 (``kernel_
    rel``), beside the decompressed leaves' own logits with every linear
    summed in another order (``rounding_rel``: the model's sensitivity to
    the one rounding a K2 product differs by); and with every leaf and
    activation in fp32 (``fp32_rel``), where that rounding is 2⁻²⁴.
    ``fault``: the fp32 error at the deepest depth with block
    ``fault_block``'s leaves lane-shifted (``lane_shifted``)."""
    import torch

    from repro_torch.models.model_builder import build_model
    from repro_torch.serve.compressed import decompress_params

    dense = decompress_params(comp)
    comp32, dense32 = as_fp32(comp), as_fp32(dense)
    tok = torch.tensor([[int(p[0])] for p in prompts], device=comp[
        "embed"]["table"].device)
    out = {}

    def first(m, tree, d):
        cut = dict(tree, blocks={i: tree["blocks"][i] for i in range(d)})
        return m.decode_step(cut, m.init_cache(4, 8), tok, 0)[0]

    with uncounted(), torch.no_grad():
        for d in depths:
            m = build_model(cfg.replace(num_layers=d), device=tok.device)
            m32 = build_model(cfg.replace(num_layers=d, dtype="float32"),
                              device=tok.device)
            lk, ld = first(m, comp, d), first(m, dense, d)
            with fp32_products():
                lr = first(m, dense, d)
            lk32, ld32 = first(m32, comp32, d), first(m32, dense32, d)
            out[d] = {"kernel_rel": errs(lk, ld)[1],
                      "rounding_rel": errs(lr, ld)[1],
                      "fp32_rel": errs(lk32, ld32)[1],
                      "finite": bool(torch.isfinite(lk).all()
                                     and torch.isfinite(lk32).all())}
        lf = first(m32, lane_shifted(comp32, fault_block), depths[-1])
        fault = errs(lf, ld32)[1]
    del dense, comp32, dense32
    return {"depths": out, "fault": fault}


def family_counts(label: str, expect: dict) -> dict:
    """Read the path's launches now and hold them against ``expect``; the
    many-row and decode kernels', unless given, are every bf16 K2 launch
    whose shape calls for them (``tc_mode``)."""
    counts = path_counts()
    for mode in (3, 4):
        n = sum(k for (B, c, b, dt, bits), k in
                counts["nm_matmul_cuda"][1].items()
                if dt == "torch.bfloat16" and tc_mode(c, b, B, bits) == mode)
        if n and K2_KERNELS[mode] not in expect:
            expect = dict(expect, **{K2_KERNELS[mode]: n})
    launches = {name: n for name, (n, _) in counts.items() if n}
    check(launches == expect, f"{label} launches {launches}, expected "
          f"{expect}")
    return {name: shapes for name, (_, shapes) in counts.items()}


def zamba2_part(dev) -> dict:
    """Families (a): zamba2-7b at full width, depth cut to ZAMBA_LAYERS
    (shared sites 5, 11, 17, 23: each shared set runs twice, its Hessian
    accumulated over both sites and pruned once, at the second)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model_builder import build_model

    full = get_config("zamba2-7b")
    cfg = full.replace(num_layers=ZAMBA_LAYERS)
    L = cfg.num_layers
    print(f"phase families: zamba2-7b at full width (d_model {cfg.d_model}, "
          f"d_inner {cfg.ssm_expand * cfg.d_model}, "
          f"{cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} SSM heads of "
          f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, {cfg.ssm_groups} "
          f"groups, conv {cfg.ssm_conv}; {cfg.num_shared_attn} shared sets of "
          f"{cfg.num_heads} heads × {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}), {cfg.dtype}; depth cut {full.num_layers} → "
          f"{L} layers")
    zero_counts()
    t0 = time.perf_counter()
    out = prune_family(cfg, dev)
    model, comp = out.pop("model"), out.pop("comp")
    layers = out.pop("layers")
    sites = model._shared_points()
    order = [r.path for r in layers]
    shared = [p for p in order if p[0] == "shared"]
    last = {s: max(i for i in sites if model._which(i) == s)
            for s in range(cfg.num_shared_attn)}
    at = {s: order.index(("mamba", b, "mixer", "out_proj", "w")) + 1
          for s, b in last.items()}
    check(len(order) == 2 * L + 7 * cfg.num_shared_attn
          and len(shared) == len(set(shared)) == 7 * cfg.num_shared_attn
          and all(order[at[s]:at[s] + 7] == [p for p in shared if p[1] == s]
                  for s in last),
          f"zamba2: shared linears not pruned once each at their last site "
          f"({sites})")
    print(f"  shared sites {sites}: each of the {len(shared)} shared linears "
          f"pruned once, set 0 after block {last[0]}, set 1 after block "
          f"{last[1]} (Hessians over both sites of its set)")
    prompts = request_prompts(cfg.vocab_size)
    done, t_serve, engine = serve_requests(model, comp, prompts)
    model8 = build_model(cfg.replace(kv_cache_dtype="int8"), device=dev)
    done8, t_serve8, engine8 = serve_requests(model8, comp, prompts)
    steps = [e.stats["prefill_tokens"] + e.stats["decode_steps"]
             for e in (engine, engine8)]
    per_step = 2 * L + 7 * len(sites)
    by_shape = family_counts("zamba2", {
        "hessian_update_cuda": out["batches"] * per_step,
        "nm_matmul_cuda": per_step * sum(steps)})
    ntok = sum(len(r.out) for r in done)
    nb, nb8 = cache_bytes(engine._cache), cache_bytes(engine8._cache)
    print(f"  serve: 4 requests, {ntok} tokens in {t_serve:.2f} s "
          f"({ntok / t_serve:.1f} tok/s, {steps[0]} model steps, "
          f"{per_step} K2 launches a step); int8 shared caches "
          f"{ntok / t_serve8:.1f} tok/s; resident cache {nb8} B vs {nb} B")
    print(f"  req 0: {done[0].out}")
    b1 = lockstep_check(model, comp, prompts, done, "zamba2")
    graphs = graphs_case("zamba2-7b", model, comp, prompts)
    with uncounted():
        e = first_step_line(model, comp, prompts)
        lg = chain_logits(model, comp, prompts)
        lg8 = chain_logits(model8, comp, prompts)
    torch.cuda.synchronize()
    kinds = {type(c).__name__ for c in engine8._cache["shared"].values()}
    e8 = errs(lg8, lg)
    check(kinds == {"QuantGqaCache"} and bool(torch.isfinite(lg8).all())
          and e8[0] < 1.0, f"zamba2 int8 shared caches {kinds}: max abs "
          f"err {e8[0]:.3g}")
    agree8 = float((lg8.argmax(-1) == lg.argmax(-1)).float().mean())
    print(f"  int8 shared caches ({sorted(kinds)[0]}): logits after 16 "
          f"teacher-forced positions vs bf16 caches: max abs err "
          f"{e8[0]:.4g} (limit 1.0), rel {e8[1]:.4g}, argmax agree "
          f"{agree8:.2f} (not gated)")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"phase families, zamba2-7b: {secs:.1f} s")
    return dict(out, layers_cut=L, layers_full=full.num_layers,
                sites=sites, seconds_part=secs, by_shape=by_shape, b1=b1,
                graphs=graphs, serve=serve_summary(done, t_serve, steps[0]),
                engine_stats={k: engine.stats[k] + engine8.stats[k]
                              for k in engine.stats},
                int8={"max_abs_err": e8[0], "rel_err": e8[1],
                      "argmax_agree": agree8, "cache_bytes": nb8,
                      "cache_bytes_bf16": nb, "seconds": t_serve8},
                logits_max_abs_err=e[0], logits_rel_err=e[1],
                argmax_agree=e[2])


def serve_summary(done, seconds: float, steps: int) -> dict:
    """One serve's tokens, seconds, tok/s and model steps."""
    ntok = sum(len(r.out) for r in done)
    return {"tokens": ntok, "seconds": seconds, "tok_per_s": ntok / seconds,
            "model_steps": steps}


def xlstm_part(dev) -> dict:
    """Families (b): xlstm-1.3b at full width, depth cut 48 →
    XLSTM_LAYERS (14 mLSTM + 2 sLSTM blocks); then the fp32 against the
    bf16 matrix memory."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model_builder import build_model

    full = get_config("xlstm-1.3b")
    cfg = full.replace(num_layers=XLSTM_LAYERS)
    L = cfg.num_layers
    n_s = sum((i + 1) % cfg.slstm_every == 0 for i in range(L))
    print(f"phase families: xlstm-1.3b at full width ({L} blocks: "
          f"{L - n_s} mLSTM, {n_s} sLSTM; d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads, proj factor {cfg.xlstm_proj_factor}, "
          f"vocab {cfg.vocab_size}), {cfg.dtype}; depth cut "
          f"{full.num_layers} → {L}")
    zero_counts()
    t0 = time.perf_counter()
    out = prune_family(cfg, dev)
    model, comp = out.pop("model"), out.pop("comp")
    layers = out.pop("layers")
    per_step = 7 * (L - n_s) + 6 * n_s
    check(len(layers) == per_step and all(
        r.path[3] not in ("ri", "rf", "rz", "ro") for r in layers),
        f"xlstm: {len(layers)} pruned linears")
    prompts = request_prompts(cfg.vocab_size)
    done, t_serve, engine = serve_requests(model, comp, prompts)
    steps = engine.stats["prefill_tokens"] + engine.stats["decode_steps"]
    by_shape = family_counts("xlstm", {
        "hessian_update_cuda": out["batches"] * per_step,
        "nm_matmul_cuda": per_step * steps})
    ntok = sum(len(r.out) for r in done)
    print(f"  serve: 4 requests, {ntok} tokens in {t_serve:.2f} s "
          f"({ntok / t_serve:.1f} tok/s, {steps} model steps, {per_step} K2 "
          f"launches a step; wi/wf (4, 4096) among them); resident state "
          f"{cache_bytes(engine._cache)} B")
    print(f"  req 0: {done[0].out}")
    b1 = lockstep_check(model, comp, prompts, done, "xlstm")
    graphs = graphs_case("xlstm-1.3b", model, comp, prompts)
    # a random-init xLSTM in bf16 amplifies rounding block after block:
    # the dense tree summed in another order reads rel ~0.75 at 8 blocks
    # and ~1 at 16 (PERF.md §6, PR 24), what a zero output reads, so the
    # bf16 logits are held at one block only.  At every depth the kernel
    # path is held in fp32 (leaves and activations), where rounding is
    # 2⁻²⁴; a lane shift planted in the first block only the deepest
    # depth runs must fail that check.  Each bf16 K2 product of the
    # first step is held to the dense bf16 product's own error against
    # the fp32 product, plus one bf16 step.
    prof = depth_profile(cfg, comp, prompts, XLSTM_DEPTHS,
                         XLSTM_DEPTHS[-2])
    by_d = prof["depths"]
    check(all(v["finite"] for v in by_d.values())
          and by_d[1]["kernel_rel"] <= 5e-2
          and all(v["fp32_rel"] <= 5e-2 for v in by_d.values()),
          f"xlstm compressed vs dense first-step logits: {prof}")
    check(prof["fault"] > 5e-2, f"xlstm: the fp32 depth check misses a "
          f"lane shift planted in block {XLSTM_DEPTHS[-2]}: {prof}")
    lin = k2_linear_errors(model, comp, torch.tensor(
        [[int(p[0])] for p in prompts], device=dev))
    check(len(lin) == per_step and all(k <= d + 2 ** -8 for _, k, d in lin),
          f"xlstm: a K2 product strays from the fp32 product beyond the "
          f"dense bf16 product's error: {lin}")
    print(f"  first-step logits, K2 path vs decompressed dense, rel err by "
          f"depth, fp32: " + ", ".join(f"{d}: {v['fp32_rel']:.4g}" for d, v
                                       in by_d.items())
          + f" (limit 5e-2; block {XLSTM_DEPTHS[-2]} lane-shifted reads "
          f"{prof['fault']:.4g} at {XLSTM_DEPTHS[-1]}); bf16: "
          + ", ".join(f"{d}: {v['kernel_rel']:.4g}" for d, v in by_d.items())
          + " (limit 5e-2 at depth 1); the bf16 dense tree's own, every "
          "linear summed in another order: "
          + ", ".join(f"{d}: {v['rounding_rel']:.4g}"
                      for d, v in by_d.items())
          + f"; {len(lin)} K2 products of the first step against the fp32 "
          f"product: max rel {max(k for _, k, _ in lin):.4g} (the dense bf16 "
          f"product's {max(d for _, _, d in lin):.4g})")
    modelb = build_model(cfg.replace(kv_cache_dtype="bf16"), device=dev)
    with uncounted():
        lg = chain_logits(model, comp, prompts)
        lgb = chain_logits(modelb, comp, prompts)
    torch.cuda.synchronize()
    eb = errs(lgb, lg)
    agree = float((lgb.argmax(-1) == lg.argmax(-1)).float().mean())
    check(bool(torch.isfinite(lgb).all()), "xlstm: non-finite logits with "
          "the bf16 matrix memory")
    print(f"  matrix memory bf16 vs fp32 (C, n), logits after 16 "
          f"teacher-forced positions: max abs err {eb[0]:.4g}, rel "
          f"{eb[1]:.4g}, argmax agree {agree:.2f} (reported)")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"phase families, xlstm-1.3b: {secs:.1f} s")
    return dict(out, layers_cut=L, layers_full=full.num_layers,
                seconds_part=secs, by_shape=by_shape, b1=b1, graphs=graphs,
                serve=serve_summary(done, t_serve, steps),
                engine_stats=dict(engine.stats),
                bf16_state={"max_abs_err": eb[0], "rel_err": eb[1],
                            "argmax_agree": agree},
                depth_profile=prof,
                logits_rel_err=by_d[cfg.num_layers]["fp32_rel"])


def whisper_decode(model, params, frames, starts, kv_cached: bool):
    """Encode ``frames``, then WHISPER_NEW greedy tokens at B = 4 from the
    start tokens, cross-attending through precomputed k/v or (not
    ``kv_cached``) the encoded source → (tokens (B, new), first logits)."""
    import torch

    with torch.no_grad():
        enc = model.encode(params, frames)
        src = model.precompute_cross_kv(params, enc) if kv_cached else enc
        cache = model.init_cache(frames.shape[0], WHISPER_NEW + 4)
        tok, toks, first = starts, [], None
        for s in range(WHISPER_NEW):
            lg, cache = model.decode_step(params, cache, tok, s, src)
            first = lg if first is None else first
            tok = lg[:, -1].argmax(-1, keepdim=True)
            toks.append(tok)
    return torch.cat(toks, dim=1), first


def whisper_part(dev, gen) -> dict:
    """Families (c): whisper-medium at full width, depth cut to
    WHISPER_LAYERS encoder and decoder layers: prune on the
    frames stub, compress; encode 4 sources of WHISPER_FRAMES frames (the
    30 s window), precompute the cross k/v once, decode WHISPER_NEW greedy
    tokens at B = 4; the kernel path's first logits against the
    decompressed tree's, the cross-k/v tokens against the uncached
    decode's."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.serve.compressed import decompress_params

    full = get_config("whisper-medium")
    cfg = full.replace(encoder_layers=WHISPER_LAYERS,
                       decoder_layers=WHISPER_LAYERS)
    E, D = cfg.encoder_layers, cfg.decoder_layers
    print(f"phase families: whisper-medium at full width ({E} + {D} "
          f"layers, d_model {cfg.d_model}, {cfg.num_heads} heads, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}), {cfg.dtype}; depth cut "
          f"{full.encoder_layers} + {full.decoder_layers} → {E} + {D}")
    zero_counts()
    t0 = time.perf_counter()
    out = prune_family(cfg, dev)
    model, comp = out.pop("model"), out.pop("comp")
    layers = out.pop("layers")
    check(len(layers) == 6 * E + 10 * D, f"whisper: {len(layers)} linears")
    frames = torch.randn((4, WHISPER_FRAMES, cfg.d_model), generator=gen,
                         device=dev).to(cfg.torch_dtype)
    starts = torch.tensor([[int(p[0])] for p in request_prompts(
        cfg.vocab_size)], device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks, first = whisper_decode(model, comp, frames, starts, True)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t1
    rows = 4 * WHISPER_FRAMES
    per_step = 8 * D
    by_shape = family_counts("whisper", {
        "hessian_update_cuda": out["batches"] * (6 * E + 10 * D),
        "nm_matmul_cuda": 6 * E + 2 * D + per_step * WHISPER_NEW,
        "nm_sp_rows_kernel": 6 * E + 2 * D})
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "whisper: tokens out of the vocabulary")
    print(f"  encode 4 × {WHISPER_FRAMES} frames (K2 at x ({rows}, b): "
          f"{6 * E + 2 * D} launches of the many-row kernel), cross k/v "
          f"once, {WHISPER_NEW} greedy tokens at B = 4 in {t_dec:.2f} s "
          f"({per_step} K2 launches a step)")
    print(f"  req 0: {toks[0].tolist()}")
    with uncounted():
        toks_u, first_u = whisper_decode(model, comp, frames, starts, False)
        dense = decompress_params(comp)
        _, first_d = whisper_decode(model, dense, frames, starts, True)
    torch.cuda.synchronize()
    del dense
    check(torch.equal(toks_u, toks), "whisper: cross-k/v tokens differ "
          "from the uncached decode's")
    e = errs(first, first_d)
    agree = float((first.argmax(-1) == first_d.argmax(-1)).float().mean())
    check(bool(torch.isfinite(first).all()) and e[1] <= 5e-2,
          f"whisper compressed vs dense logits: max abs err {e[0]:.3g} "
          f"(rel {e[1]:.3g})")
    print(f"  cross-k/v tokens identical to the uncached decode's; "
          f"first-step logits, K2 path vs decompressed dense: max abs err "
          f"{e[0]:.4g}, rel {e[1]:.4g} (limit 5e-2), argmax agree "
          f"{agree:.2f}")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"phase families, whisper-medium: {secs:.1f} s")
    return dict(out, layers_cut=(E, D), seconds_part=secs,
                by_shape=by_shape, decode_seconds=t_dec, encode_rows=rows,
                logits_max_abs_err=e[0], logits_rel_err=e[1],
                argmax_agree=agree)


def families_phase(dev, gen) -> dict:
    """Phase families: the recurrent and encoder–decoder families, each
    pruned (K1), compressed and decoded compressed-resident (K2); launch
    counts zeroed before each part and read after its serve."""
    import torch

    t0 = time.perf_counter()
    out = {"zamba2-7b": zamba2_part(dev)}
    torch.cuda.empty_cache()
    out["xlstm-1.3b"] = xlstm_part(dev)
    torch.cuda.empty_cache()
    out["whisper-medium"] = whisper_part(dev, gen)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase families: {out['seconds']:.1f} s over its three parts")
    return out


def zero_counts() -> None:
    """Set every kernel wrapper's launch counts to 0."""
    from repro_torch.kernels import hessian_accum as K1, nm_spmm as K2

    for fn in (K1.hessian_update_cuda, K2.nm_matmul_cuda,
               K2.nm_matmul_stacked_cuda, K2.nm_sp_rows, K2.nm_sp_dec,
               K2.nm_stacked_sp_dec):
        fn.launches = 0
        fn.by_shape.clear()


@contextlib.contextmanager
def uncounted():
    """Run a comparison outside the path's launch counts: every wrapper's
    counts are saved on entry and put back on exit."""
    from repro_torch.kernels import hessian_accum as K1, nm_spmm as K2

    fns = (K1.hessian_update_cuda, K2.nm_matmul_cuda,
           K2.nm_matmul_stacked_cuda, K2.nm_sp_rows, K2.nm_sp_dec,
           K2.nm_stacked_sp_dec)
    saved = [(fn.launches, dict(fn.by_shape)) for fn in fns]
    try:
        yield
    finally:
        for fn, (n, shapes) in zip(fns, saved):
            fn.launches = n
            fn.by_shape.clear()
            fn.by_shape.update(shapes)


def path_counts() -> dict:
    """Each wrapper's launches and launches by shape, read now."""
    from repro_torch.kernels import hessian_accum as K1, nm_spmm as K2

    return {fn.__name__: (fn.launches, dict(fn.by_shape))
            for fn in (K1.hessian_update_cuda, K2.nm_matmul_cuda,
                       K2.nm_matmul_stacked_cuda, K2.nm_sp_rows,
                       K2.nm_sp_dec, K2.nm_stacked_sp_dec)}


def add_counts(total: dict, counts: dict) -> None:
    """Add one ``path_counts()`` reading into ``total`` (the same form)."""
    for name, (n, shapes) in counts.items():
        n0, s0 = total.get(name, (0, {}))
        s0 = dict(s0)
        for key, v in shapes.items():
            s0[key] = s0.get(key, 0) + v
        total[name] = (n0 + n, s0)


def gate_hessian(model, dense, batches):
    """Layer 0's gate in the paper's (out, in) layout and its Hessian
    H = 2XᵀX/T, accumulated by K1 from the calibration batches."""
    import torch

    from repro_torch.core.hessian import HessianAccumulator
    from repro_torch.models.model_builder import ModelAdapter

    path = ("blocks", 0, "mlp", "gate", "w")
    adapter = ModelAdapter(model)
    acc = None
    with torch.no_grad():
        for batch in batches:
            _, caps = adapter.block_apply(
                dense, 0, adapter.prepare(dense, batch), capture=True)
            x = caps[path]
            if acc is None:
                acc = HessianAccumulator.init(x.shape[-1], x.device)
            acc.update(x)
    return dense["blocks"][0]["mlp"]["gate"]["w"].T.contiguous(), \
        acc.finalize()


def baselines_phase(dev, dense, dense_loss: float) -> dict:
    """Phase baselines: the paper's comparison methods on tinyllama-1.1b at
    full width and depth on phase 3's dense tree (Thanos is phase 3, whose
    held-out loss of that tree is ``dense_loss``): SparseGPT (block 64),
    Wanda and magnitude each prune 2:4 through ``prune_model`` (K1 carries
    every Hessian), compress and serve the phase-4 request set (K2); then
    the four methods prune layer 0's gate, (5632, 2048), unstructured
    p = 0.5 on the Hessian K1 captured, and SparseGPT 2:4 on that (w, H)
    runs on the card and on the CPU.  The path's launch counts are each
    method's prune → compress → serve, zeroed before and read after it:
    neither the first-step comparison nor the gate's launches are in them."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import (PruneConfig, prune_layer,
                                      reconstruction_error)
    from repro_torch.core.masks import check_nm
    from repro_torch.core.schedule import prune_model
    from repro_torch.data.pipeline import calibration_batches, heldout_loss
    from repro_torch.models.model_builder import ModelAdapter, build_model
    from repro_torch.serve.compressed import compress_params, compressed_bytes

    cfg = get_config("tinyllama-1.1b")
    model = build_model(cfg, device=dev)
    adapter = ModelAdapter(model)
    # phase 3's calibration: 2 batches × 8 × 128 tokens (prune_arch's)
    batches = calibration_batches(cfg, num_samples=16, seq_len=128, batch=8,
                                  device=dev)
    prompts = request_prompts(cfg.vocab_size)
    out: dict = {"methods": {}}
    counts: dict = {}
    t_path = time.perf_counter()
    for method in BASELINES:
        zero_counts()
        torch.cuda.synchronize()
        r0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        pruned, report = prune_model(
            dense, adapter, batches,
            PruneConfig(method, "nm", n=2, m=4, block_size=64))
        torch.cuda.synchronize()
        t_prune = time.perf_counter() - t0
        graphs_line(method, report.graphs, t_prune, r0)
        k1 = path_counts()["hessian_update_cuda"][0]
        pruned_loss = heldout_loss(model, pruned, cfg)
        check(len(report.masks) == 7 * cfg.num_layers and
              all(check_nm(mk.T, 2, 4) for mk in report.masks.values()),
              f"{method}: a pruned linear breaks 2:4")
        check(math.isfinite(pruned_loss),
              f"{method}: non-finite held-out loss")
        check(k1 == 2 * 7 * cfg.num_layers, f"{method}: K1 launches {k1}")
        solve = sum(r.seconds for r in report.layers)
        comp = compress_params(pruned, report.masks, 2, 4)
        cb, db = compressed_bytes(comp)
        check(cb / db == 0.625, f"{method}: compressed ratio {cb / db}")
        done, t_serve, engine = serve_requests(model, comp, prompts)
        got = path_counts()
        add_counts(counts, got)
        st = engine.stats
        steps = st["prefill_tokens"] + st["decode_steps"]
        k2 = got["nm_matmul_cuda"][0]
        check(k2 == 7 * cfg.num_layers * steps,
              f"{method}: K2 launches {k2}, expected "
              f"{7 * cfg.num_layers * steps}")
        ntok = sum(len(r.out) for r in done)
        print(f"phase baselines {method} 2:4: prune_model "
              f"{report.seconds:.1f} s (per-layer solves {solve:.1f} s; "
              f"with the sync {t_prune:.1f} s), held-out loss dense "
              f"{dense_loss:.4f} (phase 3) → pruned {pruned_loss:.4f}, every "
              f"mask 2:4, K1 launches {k1}; compressed {cb / db:.4f}; {ntok} "
              f"tokens in {t_serve:.2f} s ({ntok / t_serve:.1f} tok/s), K2 "
              f"launches {k2} ({7 * cfg.num_layers} a model step × {steps})")
        e = first_step_line(model, comp, prompts)
        out["methods"][method] = dict(
            dense_loss=dense_loss, pruned_loss=pruned_loss,
            prune_seconds=report.seconds, solve_seconds=solve,
            prune_sync_seconds=t_prune,
            k1_launches=k1, k2_launches=k2, ratio=cb / db,
            tok_per_s=ntok / t_serve, serve_seconds=t_serve, stats=st,
            logits_max_abs_err=e[0], logits_rel_err=e[1], argmax_agree=e[2])
        del pruned, comp, engine, report
        torch.cuda.empty_cache()

    # ---- one full-width linear, the four methods --------------------------
    w, h = gate_hessian(model, dense, batches)
    errs_ = {}
    for method in ("thanos",) + BASELINES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = prune_layer(w, h, PruneConfig(method, "unstructured", p=0.5,
                                            block_size=64))
        torch.cuda.synchronize()
        errs_[method] = (float(reconstruction_error(w, res.weights, h)),
                         time.perf_counter() - t0)
    line = ", ".join(f"{k} {v[0]:.6g} ({v[1]:.2f} s)"
                     for k, v in errs_.items())
    print(f"phase baselines: layer 0 gate {tuple(w.shape)} bf16, "
          f"unstructured p 0.5 B 64, reconstruction error ‖ΔX‖²: {line}")
    e = {k: v[0] for k, v in errs_.items()}
    check(e["thanos"] < e["magnitude"] and e["sparsegpt"] < e["magnitude"],
          f"reconstruction errors: Thanos or SparseGPT not below magnitude "
          f"({e})")
    print(f"  gated: Thanos < magnitude {e['thanos'] < e['magnitude']}, "
          f"SparseGPT < magnitude {e['sparsegpt'] < e['magnitude']}; not "
          f"gated: Thanos < Wanda {e['thanos'] < e['wanda']}, Thanos ≤ 1.05 "
          f"× SparseGPT {e['thanos'] <= 1.05 * e['sparsegpt']} (ratio "
          f"{e['thanos'] / e['sparsegpt']:.4f})")
    sg = {}
    for where in ("cuda", "cpu"):
        wd, hd = (w, h) if where == "cuda" else (w.cpu(), h.cpu())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = prune_layer(wd, hd, PruneConfig("sparsegpt", "nm", n=2, m=4,
                                              block_size=64))
        torch.cuda.synchronize()
        sg[where] = (res, float(reconstruction_error(wd, res.weights, hd)),
                     time.perf_counter() - t0)
    agree = float((sg["cuda"][0].mask.cpu() == sg["cpu"][0].mask).float()
                  .mean())
    rel = abs(sg["cuda"][1] - sg["cpu"][1]) / sg["cpu"][1]
    check(rel <= 0.01 and agree >= 0.99,
          f"SparseGPT 2:4 card vs CPU: errors {sg['cuda'][1]:.6g} / "
          f"{sg['cpu'][1]:.6g} (rel {rel:.3g}), masks agree {agree:.4f}")
    print(f"  SparseGPT 2:4 B 64 on that (w, H): card error "
          f"{sg['cuda'][1]:.6g} in {sg['cuda'][2]:.2f} s, CPU error "
          f"{sg['cpu'][1]:.6g} in {sg['cpu'][2]:.2f} s (rel {rel:.3g}, limit "
          f"0.01); mask entries agreeing {agree:.6f} (limit 0.99)")
    out.update(gate_errors={k: v[0] for k, v in errs_.items()},
               gate_seconds={k: v[1] for k, v in errs_.items()},
               sparsegpt_card_vs_cpu={
                   "card_error": sg["cuda"][1], "cpu_error": sg["cpu"][1],
                   "card_seconds": sg["cuda"][2],
                   "cpu_seconds": sg["cpu"][2], "rel": rel,
                   "mask_agree": agree})
    for name in ("hessian_update_cuda", "nm_matmul_cuda"):
        check(counts[name][0] > 0, f"baselines path: {name} never launched")
    out["counts"] = counts
    out["seconds"] = time.perf_counter() - t_path
    print(f"phase baselines: {out['seconds']:.1f} s; path launches K1 "
          f"{counts['hessian_update_cuda'][0]}, K2 "
          f"{counts['nm_matmul_cuda'][0]}")
    return out


def plan_phase(dev, dense, dense_loss: float) -> dict:
    """Phase plan: tinyllama-1.1b at full width under the recipe
    ``examples/recipes/mixed_2to4_serve.json`` (MLP 2:4, attention
    unstructured p = 0.5, embeddings and head dense): ``prune_model`` with
    the plan on phase 3's dense tree (``dense_loss``: phase 3's held-out
    loss of it), ``compress_params(plan=report.plan)`` — MLP leaves packed,
    attention dense — and the phase-4 request set served with mixed
    residency (K2 for the MLP, ``x @ W`` for attention); then the sparsity
    allocation of ``besa_trace_budget.json`` over the stats of one dense
    capture pass (K1), without a prune."""
    import json as json_

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.masks import check_nm
    from repro_torch.core.plan import PrunePlan
    from repro_torch.core.schedule import (collect_hessian_stats, get_path,
                                           prune_model)
    from repro_torch.core.sparsity import NmCompressed
    from repro_torch.data.pipeline import calibration_batches, heldout_loss
    from repro_torch.models.model_builder import ModelAdapter, build_model
    from repro_torch.serve.compressed import compress_params, compressed_bytes
    from repro_torch.util import graphs

    cfg = get_config("tinyllama-1.1b")
    L = cfg.num_layers
    model = build_model(cfg, device=dev)
    adapter = ModelAdapter(model)
    # phase 3's calibration: 2 batches × 8 × 128 tokens (prune_arch's)
    batches = calibration_batches(cfg, num_samples=16, seq_len=128, batch=8,
                                  device=dev)
    recipe = ROOT / "examples" / "recipes" / "mixed_2to4_serve.json"
    plan = PrunePlan.load(str(recipe))
    zero_counts()
    torch.cuda.synchronize()
    r0 = torch.cuda.memory_reserved()
    t_path = time.perf_counter()
    pruned, report = prune_model(dense, adapter, batches, plan)
    graphs_line("plan", report.graphs, time.perf_counter() - t_path, r0)
    pruned_loss = heldout_loss(model, pruned, cfg)
    attn = [r for r in report.layers if "attn" in r.path]
    mlp = [r for r in report.layers if "mlp" in r.path]
    check(len(attn) == 4 * L and len(mlp) == 3 * L
          and not any(r.skipped for r in report.layers),
          f"plan: {len(attn)} attention and {len(mlp)} MLP layers pruned")
    check(all(check_nm(report.masks[r.path].T, 2, 4) for r in mlp)
          and all(r.tag == "thanos_2:4" for r in mlp),
          "plan: an MLP linear is not exactly 2:4")
    a_ones = sum(float(report.masks[r.path].sum()) for r in attn)
    a_all = sum(report.masks[r.path].numel() for r in attn)
    check(all(r.tag == "thanos_p0.5" for r in attn)
          and abs(a_ones / a_all - 0.5) < 1e-9,
          f"plan: attention mean sparsity {a_ones / a_all}")
    check(math.isfinite(pruned_loss), "plan: non-finite held-out loss")
    comp = compress_params(pruned, report.masks, plan=report.plan,
                           strict=True)
    check(all(isinstance(get_path(comp, r.path), NmCompressed) for r in mlp)
          and all(torch.is_tensor(get_path(comp, r.path)) for r in attn),
          "plan: the serve tree is not MLP compressed, attention dense")
    cb, db = compressed_bytes(comp)
    attn_bytes = sum(get_path(comp, r.path).numel() * 2 for r in attn)
    mlp_params = 3 * L * cfg.d_model * cfg.d_ff
    attn_params = sum(r.params for r in attn)
    want = (0.625 * mlp_params + attn_params) / (mlp_params + attn_params)
    ratio_all = (cb + attn_bytes) / (db + attn_bytes)
    check(cb / db == 0.625 and db == 2 * mlp_params
          and attn_bytes == 2 * attn_params
          and abs(ratio_all - want) < 1e-12,
          f"plan: bytes ratio {cb / db} on the compressed kernels, "
          f"{ratio_all} over all prunable linears (expected {want})")
    prompts = request_prompts(cfg.vocab_size)
    done, t_serve, engine = serve_requests(model, comp, prompts)
    st = engine.stats
    steps = st["prefill_tokens"] + st["decode_steps"]
    counts = path_counts()
    k1, k2 = counts["hessian_update_cuda"][0], counts["nm_matmul_cuda"][0]
    check(k1 == 2 * 7 * L, f"plan: K1 launches {k1}")
    check(k2 == 3 * L * steps,
          f"plan: K2 launches {k2}, expected {3 * L * steps}")
    ntok = sum(len(r.out) for r in done)
    rollup = json_.loads(report.to_json())["rules"]
    check([(r["match"], r["layers"]) for r in rollup]
          == [("*/mlp/*", 3 * L), ("*/attn/*", 4 * L)]
          and all(report.plan.rules[r["rule"]].match == r["match"]
                  for r in rollup),
          f"plan: report rollup {rollup}")
    print(f"phase plan: {recipe.name} ({len(plan.rules)} rules): "
          f"prune_model {report.seconds:.1f} s, held-out loss dense "
          f"{dense_loss:.4f} (phase 3) → pruned {pruned_loss:.4f}; MLP {len(mlp)} linears 2:4, "
          f"attention {len(attn)} linears unstructured at mean sparsity "
          f"{a_ones / a_all:.4f}; compressed {cb / db:.4f} of dense bf16 "
          f"bytes on the compressed kernels ({mlp_params} params), "
          f"{ratio_all:.4f} over all prunable linears (attention "
          f"{attn_params} params dense); {ntok} tokens in {t_serve:.2f} s "
          f"({ntok / t_serve:.1f} tok/s), K2 launches {k2} ({3 * L} a "
          f"model step × {steps}, against {7 * L} in phase 4), K1 {k1}")
    for r in rollup:
        print(f"  rule {r['rule']} {r['match']:10s} {r['tag']:12s} layers "
              f"{r['layers']:3d} params {r['params']} sparsity "
              f"{r['mean_sparsity']:.4f} solve {r['seconds']:.2f} s")
    e = first_step_line(model, comp, prompts)
    plan_counts, report_seconds = counts, report.seconds
    del pruned, comp, engine, report
    torch.cuda.empty_cache()

    # ---- the sparsity allocation over one dense capture pass --------------
    besa = PrunePlan.load(str(ROOT / "examples" / "recipes" /
                              "besa_trace_budget.json"))
    zero_counts()
    torch.cuda.synchronize()
    r0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    with graphs.scope() as sc:           # the pass's own: one pool
        stats = collect_hessian_stats(dense, adapter, batches)
    torch.cuda.synchronize()
    t_stats = time.perf_counter() - t0
    graphs_line("allocation", sc.stats(), t_stats, r0)
    k1_stats = path_counts()["hessian_update_cuda"][0]
    alloc = besa.allocate_sparsity(stats)
    ps = [alloc.cfg_for(k).p for k in stats]
    sizes = [stats[k].size for k in stats]
    mean_p = sum(p * s for p, s in zip(ps, sizes)) / sum(sizes)
    check(len(stats) == 7 * L and abs(mean_p - 0.5) <= 1e-6
          and all(besa.allocation.p_min <= p <= besa.allocation.p_max
                  for p in ps),
          f"allocation: {len(stats)} layers, size-weighted mean p {mean_p}, "
          f"p in [{min(ps)}, {max(ps)}]")
    check(k1_stats == 2 * 7 * L, f"allocation: K1 launches {k1_stats}")
    print(f"phase plan allocation: besa_trace_budget.json "
          f"(hessian_trace, budget {besa.allocation.budget}) over "
          f"{len(stats)} layers' stats ({t_stats:.2f} s, K1 launches "
          f"{k1_stats}, expect {2 * 7 * L}): size-weighted mean p "
          f"{mean_p:.8f}, p in [{min(ps):.4f}, {max(ps):.4f}]")
    seconds = time.perf_counter() - t_path
    print(f"phase plan: {seconds:.1f} s")
    return {"dense_loss": dense_loss, "pruned_loss": pruned_loss,
            "prune_seconds": report_seconds, "ratio": cb / db,
            "ratio_all": ratio_all,
            "attn_sparsity": a_ones / a_all, "tok_per_s": ntok / t_serve,
            "serve_seconds": t_serve, "stats": st, "k1_launches": k1,
            "k2_launches": k2, "rules": rollup, "counts": plan_counts,
            "logits_max_abs_err": e[0], "logits_rel_err": e[1],
            "argmax_agree": e[2], "alloc_mean_p": mean_p,
            "alloc_p_range": [min(ps), max(ps)],
            "alloc_k1_launches": k1_stats, "stats_seconds": t_stats,
            "seconds": seconds}


def vlm_prefix_check(model, comp, dev) -> dict:
    """internvl's image path on the compressed tree: VLM_IMAGE patch
    embeddings fed through decode_step(embeds=) and then VLM_TEXT tokens,
    one position a step from an empty cache (K2 at B = 1, counted); the
    last logits against ``forward`` on the same batch over the
    decompressed tree (not counted): finite, max abs error within 5e-2 of
    the logits' max magnitude."""
    import torch

    from repro_torch.serve.compressed import decompress_params

    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(2)
    pe = torch.randn((1, VLM_IMAGE, cfg.d_model), generator=gen,
                     device=dev).to(cfg.torch_dtype)
    toks = torch.randint(0, cfg.vocab_size, (1, VLM_TEXT), generator=gen,
                         device=dev)
    blank = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    cache = model.init_cache(1, VLM_IMAGE + VLM_TEXT)
    with torch.no_grad():
        for s in range(VLM_IMAGE):
            lg, cache = model.decode_step(comp, cache, blank, s,
                                          embeds=pe[:, s:s + 1])
        for j in range(VLM_TEXT):
            lg, cache = model.decode_step(comp, cache, toks[:, j:j + 1],
                                          VLM_IMAGE + j)
        with uncounted():
            dense = decompress_params(comp)
            ref = model.forward(dense, {"tokens": toks, "patch_embeds": pe})
            del dense
    torch.cuda.synchronize()
    e = errs(lg[:, -1], ref[:, -1])
    check(bool(torch.isfinite(lg).all()) and e[1] <= 5e-2,
          f"internvl image prefix: decode_step(embeds=) vs forward max abs "
          f"err {e[0]:.3g} (rel {e[1]:.3g})")
    agree = int(lg[0, -1].argmax()) == int(ref[0, -1].argmax())
    print(f"  image prefix: {VLM_IMAGE} patch embeddings through "
          f"decode_step(embeds=) then {VLM_TEXT} tokens from an empty cache "
          f"(K2 path) vs forward on the decompressed tree: max abs err "
          f"{e[0]:.4g}, rel {e[1]:.4g} (limit 5e-2), argmax agree {agree}")
    return {"max_abs_err": e[0], "rel_err": e[1], "argmax_agree": agree,
            "steps": VLM_IMAGE + VLM_TEXT}


def dense2_part(arch: str, dev) -> dict:
    """One model of the dense2 phase: bf16 from seed 0 at full width and
    DENSE2_LAYERS[arch] layers, pruned with Thanos 2:4 (K1), compressed,
    the phase-4 request set served compressed-resident (K2; danube also
    paged — every layer a ring — with tokens identical to the contiguous
    engine's; internvl also its image prefix), exact launch counts and the
    first-step logits against the decompressed tree."""
    import torch

    from repro_torch.configs.registry import get_config

    full = get_config(arch)
    cfg = full.replace(num_layers=DENSE2_LAYERS[arch])
    L = cfg.num_layers
    print(f"phase dense2: {arch} at full width (d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, window "
          f"{cfg.sliding_window or 'none'}, family {cfg.family}), "
          f"{cfg.dtype}; depth {L} of {full.num_layers} layers")
    zero_counts()
    t0 = time.perf_counter()
    out = prune_family(cfg, dev)
    model, comp = out.pop("model"), out.pop("comp")
    out.pop("layers")
    prompts = request_prompts(cfg.vocab_size)
    done, t_serve, engine = serve_requests(model, comp, prompts)
    stats = dict(engine.stats)
    steps = stats["prefill_tokens"] + stats["decode_steps"]
    ntok = sum(len(r.out) for r in done)
    print(f"  serve: 4 requests, {ntok} tokens in {t_serve:.2f} s "
          f"({ntok / t_serve:.1f} tok/s, {steps} model steps, {7 * L} K2 "
          f"launches a step)")
    print(f"  req 0: {done[0].out}")
    extra = {}
    if cfg.sliding_window:
        pdone, t_paged, peng = run_engine(
            model, comp, [(p, 12) for p in prompts], f"{arch} paged",
            max_len=SERVE_MAX_LEN, paged=True, page_size=PAGE)
        kinds = {type(c).__name__ for c in peng._cache.values()}
        same = all(a.out == b.out for a, b in zip(pdone, done))
        check(kinds == {"GqaCache"} and peng.pager.prefix is None and same,
              f"{arch} paged: caches {kinds}, prefix reuse "
              f"{peng.pager.prefix is not None}, tokens identical {same}")
        for k, v in peng.stats.items():
            stats[k] += v
        steps += peng.stats["prefill_tokens"] + peng.stats["decode_steps"]
        print(f"  paged: every layer a ring of {SERVE_MAX_LEN} (window "
              f"{cfg.sliding_window}), no page pool, prefix reuse off; "
              f"tokens identical to the contiguous engine's; "
              f"{sum(len(r.out) for r in pdone) / t_paged:.1f} tok/s")
        extra["paged"] = {"seconds": t_paged, "identical": same}
    if cfg.family == "vlm":
        extra["vlm"] = vlm_prefix_check(model, comp, dev)
        steps += extra["vlm"]["steps"]
        stats["prefill_tokens"] += extra["vlm"]["steps"]     # B = 1 steps
    by_shape = family_counts(arch, {
        "hessian_update_cuda": out["batches"] * 7 * L,
        "nm_matmul_cuda": 7 * L * steps})
    with uncounted():
        e = first_step_line(model, comp, prompts)
    del model, comp, engine
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"phase dense2, {arch}: {secs:.1f} s")
    return dict(out, **extra, layers_cut=L, layers_full=full.num_layers,
                seconds_part=secs, by_shape=by_shape, engine_stats=stats,
                serve=serve_summary(done, t_serve, steps),
                logits_max_abs_err=e[0], logits_rel_err=e[1],
                argmax_agree=e[2])


def dense2_phase(dev) -> dict:
    """Phase dense2: h2o-danube-1.8b, mistral-large-123b and internvl2-76b,
    launch counts zeroed before each part and read after its serves."""
    t0 = time.perf_counter()
    out = {arch: dense2_part(arch, dev) for arch in DENSE2_LAYERS}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase dense2: {out['seconds']:.1f} s over its three parts")
    return out


def supervised_serve(model, comp, prompts, want: dict, plan_text: str,
                     label: str, *, deadline: float = 0.0,
                     paged: bool = False, snapshot_dir: str = "") -> dict:
    """The phase-4 request set through a supervised continuous engine
    (contiguous, or paged with its pager audited after every step) under
    the fault plan ``plan_text``: every request completes, no quarantine,
    tokens identical to ``want`` (phase 4's), and — with a plan — at least
    one recovery, every site of the plan fired, the pager audit clean.
    → the run's numbers, its longest pump (also printed: the longest of
    the supervisor's deadline-exempt warm-up pumps, where the engine
    captures its graphs, and the longest after them) and the engine's
    model steps (eager or replayed; rolled-back ones too)."""
    import torch

    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.supervisor import Supervisor, SupervisorConfig

    eng = ServingEngine(model, comp, ServeConfig(
        batch_slots=4, max_len=SERVE_MAX_LEN, paged=paged, page_size=PAGE,
        debug_checks=paged))
    plan = FaultPlan.parse(plan_text) if plan_text else None
    # a decode fault implicates every resident request: 3 faults would
    # spend the default budget of 3 and quarantine a healthy request
    sup = Supervisor(eng, SupervisorConfig(step_deadline_s=deadline,
                                           retry_budget=8,
                                           snapshot_dir=snapshot_dir),
                     faults=plan)
    for uid, p in enumerate(prompts):
        sup.submit(Request(uid, p, max_new=12))
    pumps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        busy = sup.pump()
        pumps.append(time.perf_counter() - t)
        if not busy:
            break
        check(len(pumps) < 2000, f"{label}: the supervisor never drained")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = {r.uid: r.out for r in sup.results()}
    errors = {r.uid: r.error for r in sup.results() if r.error}
    st = sup.stats
    fired = plan.fired_by_site() if plan is not None else {}
    sites = {s.site for s in plan.specs} if plan is not None else set()
    if paged:
        eng.pager.check()
    gs = graph_line(eng, label)
    warm = sup.cfg.warmup_pumps
    same = got == want
    check(len(got) == len(want) and not errors and not sup.quarantined
          and same and (plan is None or (st["recoveries"] > 0
                                         and set(fired) == sites)),
          f"{label}: {len(got)} of {len(want)} requests, errors {errors}, "
          f"quarantined {sup.quarantined}, tokens identical {same}, "
          f"recoveries {st['recoveries']}, fired {fired}")
    print(f"  {label}: plan '{plan_text or 'none'}'"
          + (f", step deadline {deadline:.2f} s" if deadline else "")
          + f": 4 requests complete in {secs:.2f} s, tokens identical to "
          f"phase 4's; recoveries {st['recoveries']}, faults {st['faults']}, "
          f"fired {fired}, snapshots {st['snapshots']}, replayed "
          f"{st['replayed_requests']}, rolled-back decode steps "
          f"{st['rollback_decode_steps']}; state {sup.state}; longest "
          f"pump {max(pumps[:warm]):.3f} s in the {warm} warm-up pumps, "
          f"{max(pumps[warm:]):.3f} s after"
          + ("; pager audit clean" if paged else ""))
    return {"seconds": secs, "recoveries": st["recoveries"],
            "faults": dict(st["faults"]), "fired": fired,
            "snapshots": st["snapshots"],
            "replayed": st["replayed_requests"],
            "rollback_decode_steps": st["rollback_decode_steps"],
            "max_pump_s": max(pumps),
            "max_warmup_pump_s": max(pumps[:warm]), "pumps": len(pumps),
            "model_steps": gs["steps"]}


def snapshot_restore(model, comp, prompts, want: dict, path: Path) -> dict:
    """One snapshot of an engine mid-run (after its admissions and 5
    decode steps), pickled and written atomically, read back and restored
    into a fresh engine: both engines run on to the end with tokens
    identical to ``want``; the snapshot holds host tensors only."""
    import pickle

    import torch

    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine
    from repro_torch.util.io import atomic_write_bytes

    def engine():
        return ServingEngine(model, comp, ServeConfig(
            batch_slots=4, max_len=SERVE_MAX_LEN))

    e1 = engine()
    for uid, p in enumerate(prompts):
        e1.submit(Request(uid, p, max_new=12))
    for _ in range(6):
        e1.pump()
    snap = e1.snapshot()
    devs = {t.device.type for c in snap["device"]["cache"].values()
            for t in vars(c).values() if isinstance(t, torch.Tensor)}
    atomic_write_bytes(str(path), pickle.dumps(snap))
    nbytes = path.stat().st_size
    e2 = engine()
    e2.restore(pickle.loads(path.read_bytes()))
    path.unlink()
    got1 = {r.uid: r.out for r in e1.run()}
    got2 = {r.uid: r.out for r in e2.run()}
    steps = sum(graph_line(e, f"snapshot engine {i}")["steps"]
                for i, e in ((1, e1), (2, e2)))
    check(devs == {"cpu"} and got2 == got1 == want,
          f"snapshot/restore: cache on {devs}, restored tokens identical "
          f"{got2 == want}, original {got1 == want}")
    print(f"  snapshot after 6 pumps ({len(snap['queue'])} queued, "
          f"{sum(s is not None for s in snap['slots'])} in slots): host "
          f"tensors only, {nbytes} B pickled and written atomically, "
          f"restored into a fresh engine; both run on with tokens identical "
          f"to phase 4's")
    return {"bytes": nbytes, "model_steps": steps}


def tree_equal(a, b) -> bool:
    """Two param trees (nested dicts of tensors) bitwise equal."""
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(a[k], b[k])
                                            for k in a)
    return isinstance(a, torch.Tensor) and torch.equal(a, b)


def prune_job_checks(cfg, dev, root: Path) -> dict:
    """A PruneJob on tinyllama at full width, JOB_LAYERS layers: one
    uninterrupted run, one killed by ``journal_write@JOB_KILL`` and
    resumed — its pruned tree and masks bitwise those of the uninterrupted
    run; then ``cholesky@0`` (one escalation in layer 0's report) and
    ``hessian_accum@0`` (layer 0's calib_skipped = 1: K1 skipped the NaN
    batch) on SITE_LAYERS layers.  → the K1 launches expected."""
    import torch

    from repro_torch.core.api import PruneConfig
    from repro_torch.core.jobs import PruneJob, PruneJournal
    from repro_torch.core.schedule import prune_model
    from repro_torch.data.pipeline import calibration_batches
    from repro_torch.faults import FaultPlan, JournalWriteError
    from repro_torch.models.model_builder import ModelAdapter, build_model

    cell = PruneConfig("thanos", "nm", n=2, m=4, block_size=64)

    def setup(layers):
        c = cfg.replace(num_layers=layers)
        model = build_model(c, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        batches = calibration_batches(c, num_samples=16, seq_len=128,
                                      batch=8, device=dev)
        return ModelAdapter(model), params, batches

    adapter, params, batches = setup(JOB_LAYERS)
    r0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    ref, ref_rep = PruneJob(str(root / "ref")).run(params, adapter, batches,
                                                   cell)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    graphs_line("job", ref_rep.graphs, t_ref, r0)
    job = str(root / "job")
    try:
        PruneJob(job, faults=FaultPlan.parse(f"journal_write@{JOB_KILL}")
                 ).run(params, adapter, batches, cell)
        fail("the prune job was not killed by journal_write")
    except JournalWriteError:
        pass
    done_before = PruneJournal(job).completed
    res, rep = PruneJob(job).run(params, adapter, batches, cell, resume=True)
    same = tree_equal(res, ref) and all(
        torch.equal(rep.masks[p], ref_rep.masks[p]) for p in ref_rep.masks)
    check(done_before == JOB_KILL and same
          and [r.path for r in rep.layers] == [r.path for r in ref_rep.layers],
          f"prune job: {done_before} layers journaled at the kill (want "
          f"{JOB_KILL}), resumed tree bitwise equal {same}")
    nblk = (JOB_KILL // 7) + 1             # blocks captured before the kill
    k1 = len(batches) * 7 * (2 * JOB_LAYERS + nblk)
    print(f"  prune job: tinyllama full width, {JOB_LAYERS} layers, "
          f"{len(rep.layers)} linears ({t_ref:.1f} s uninterrupted); killed "
          f"by journal_write@{JOB_KILL} with {done_before} layers journaled, "
          f"resumed: pruned tree and masks bitwise equal to the "
          f"uninterrupted run")
    del res, ref, params
    adapter, params, batches = setup(SITE_LAYERS)
    sites = {}
    for text in ("cholesky@0", "hessian_accum@0"):
        _, r = prune_model(params, adapter, batches, cell,
                           faults=FaultPlan.parse(text))
        sites[text] = r.layers[0]
        k1 += len(batches) * 7 * SITE_LAYERS
    l0c, l0h = sites["cholesky@0"], sites["hessian_accum@0"]
    check(l0c.damp_attempts == 1 and abs(l0c.percdamp_used - 0.1) < 1e-12
          and l0h.calib_skipped == 1 and l0h.damp_attempts == 0,
          f"prune sites: cholesky@0 layer 0 damp_attempts "
          f"{l0c.damp_attempts} percdamp {l0c.percdamp_used}; "
          f"hessian_accum@0 calib_skipped {l0h.calib_skipped}")
    print(f"  prune sites on {SITE_LAYERS} layer: cholesky@0 → layer 0 "
          f"escalated once (damp_attempts {l0c.damp_attempts}, percdamp "
          f"{l0c.percdamp_used:g}); hessian_accum@0 → layer 0 calib_skipped "
          f"{l0h.calib_skipped} (K1 dropped the NaN batch)")
    return {"k1": k1, "seconds_uninterrupted": t_ref,
            "journaled_at_kill": done_before}


def http_checks(model, comp, prompts, want: dict) -> dict:
    """The SSE front end on 127.0.0.1 (an ephemeral port): two requests
    streamed over HTTP with tokens identical to phase 4's, /healthz
    answering; then one slot and a queue of one: a third request gets
    503 with Retry-After while the resident and queued ones finish."""
    import asyncio

    from repro_torch.serve.engine import ServeConfig, ServingEngine
    from repro_torch.serve.frontend import (HttpFrontend, drive_http_trace,
                                            fetch_json, sse_generate)

    async def stream():
        fe = HttpFrontend(ServingEngine(model, comp, ServeConfig(
            batch_slots=4, max_len=SERVE_MAX_LEN)))
        await fe.start()
        try:
            res = await drive_http_trace(
                "127.0.0.1", fe.port,
                [{"uid": i, "t": 0.02 * i, "prompt": prompts[i],
                  "max_new": 12} for i in range(2)])
            health = await fetch_json("127.0.0.1", fe.port, "/healthz")
        finally:
            drained = await fe.stop(drain_timeout_s=10.0)
        engines.append(fe.engine)
        return res, health, drained

    async def shed():
        fe = HttpFrontend(ServingEngine(model, comp, ServeConfig(
            batch_slots=1, max_len=SERVE_MAX_LEN, max_queued=1)))
        await fe.start()
        try:
            a = asyncio.ensure_future(sse_generate(
                "127.0.0.1", fe.port, prompts[2], max_new=12))
            while fe.engine._slots[0] is None:
                await asyncio.sleep(0.005)
            b = asyncio.ensure_future(sse_generate(
                "127.0.0.1", fe.port, prompts[3], max_new=12))
            while not fe.engine.queue:
                await asyncio.sleep(0.005)
            rejected = await sse_generate("127.0.0.1", fe.port, prompts[0],
                                          max_new=12)
            finished = await asyncio.gather(a, b)
        finally:
            await fe.stop()
        engines.append(fe.engine)
        return rejected, finished

    engines: list = []
    t0 = time.perf_counter()
    res, health, drained = asyncio.run(stream())
    got = {r["uid"]: r["tokens"] for r in res}
    check(got == {0: want[0], 1: want[1]} and health.get("ok") and drained
          and all(not r["final"].get("error") for r in res),
          f"http: streamed tokens identical {got == {0: want[0], 1: want[1]}}"
          f", /healthz {health}, drained {drained}")
    (rtoks, rfinal), finished = asyncio.run(shed())
    check(rtoks == [] and rfinal.get("status") == 503
          and rfinal.get("retry_after_s", 0) >= 1.0
          and all(len(t) == 12 and not f.get("error") for t, f in finished),
          f"http: bounded queue answered {rfinal}, resident and queued "
          f"requests {[(len(t), f.get('error')) for t, f in finished]}")
    secs = time.perf_counter() - t0
    print(f"  http: 2 SSE streams on 127.0.0.1 with tokens identical to "
          f"phase 4's, /healthz {health}; 1 slot + a queue of 1: the third "
          f"request answered 503 (Retry-After {rfinal['retry_after_s']:g} s), "
          f"the other two finished ({secs:.1f} s)")
    steps = sum(graph_line(e, f"http engine {i}")["steps"]
                for i, e in enumerate(engines, 1))
    return {"seconds": secs, "retry_after_s": rfinal["retry_after_s"],
            "model_steps": steps}


def leaf_bytes(tree) -> tuple[int, int]:
    """(elements, bytes) of every tensor leaf of a nested-dict tree."""
    if isinstance(tree, dict):
        parts = [leaf_bytes(v) for v in tree.values()]
        return sum(p[0] for p in parts), sum(p[1] for p in parts)
    return tree.numel(), tree.numel() * tree.element_size()


def train_cli_part(pruned, root: Path) -> dict:
    """(a) ``python -m repro_torch.launch.train`` on tinyllama at full width
    and depth: 4 steps saving at step 4, then a second run to step 6 that
    must restore from step 4; the free disk must hold twice the
    checkpoint (bf16 params, fp32 moments) before anything is written."""
    import os
    import shutil

    ckdir = root / "cli"
    shutil.rmtree(ckdir, ignore_errors=True)
    ckdir.mkdir(parents=True)
    elems, pbytes = leaf_bytes(pruned)
    need = pbytes + 2 * 4 * elems
    free = shutil.disk_usage(ckdir).free
    check(free >= 2 * need, f"train CLI: {free / 1e9:.1f} GB free under "
          f"{ckdir}, the checkpoint needs {need / 1e9:.1f} GB and the check "
          f"asks for twice that")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "tinyllama-1.1b", "--full", "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--save-every", "4", "--ckpt-dir", str(ckdir)]
    runs = []
    for steps in (4, 6):
        t0 = time.perf_counter()
        r = subprocess.run(base + ["--steps", str(steps)], env=env,
                           capture_output=True, text=True, timeout=400)
        runs.append((r, time.perf_counter() - t0))
        check(r.returncode == 0, f"train CLI --steps {steps} exited "
              f"{r.returncode}: {r.stderr[-2000:]}")
    (r1, s1), (r2, s2) = runs
    check(r2.stdout.splitlines()[0] == "restored checkpoint at step 4",
          f"train CLI resume: {r2.stdout[:300]!r}")
    g_re = (r"graphs: (\d+) graphs, (\d+) replays, capture (\S+) s, pool "
            r"(\d+) bytes")
    g1, g2 = re.search(g_re, r1.stdout), re.search(g_re, r2.stdout)
    check(None not in (g1, g2), "train CLI: no graphs line")
    # run 1: steps 0–3 (eager, capture, 2 replays); run 2 restores into
    # new storage: a new key (eager, capture)
    check(g1.group(1, 2) == ("1", "3") and g2.group(1, 2) == ("1", "1"),
          f"train CLI graphs: {g1.group(0)} / {g2.group(0)}")
    loss_re = r"done: first loss (\S+) → last (\S+)"
    ck_re = (r"checkpoint: step (\d+), (\d+) bytes, last save (\S+) s, "
             r"restore (\S+) s")
    l1, l2 = re.search(loss_re, r1.stdout), re.search(loss_re, r2.stdout)
    c1, c2 = re.search(ck_re, r1.stdout), re.search(ck_re, r2.stdout)
    check(None not in (l1, l2, c1, c2), "train CLI: no done/checkpoint line")
    losses = [float(x) for m in (l1, l2) for x in m.groups()]
    check(all(math.isfinite(x) for x in losses),
          f"train CLI: non-finite loss {losses}")
    nbytes, save_s, restore_s = int(c1.group(2)), float(c1.group(3)), \
        float(c2.group(4))
    check(int(c1.group(1)) == 4 and nbytes > pbytes + 2 * 4 * elems * 0.99,
          f"train CLI: checkpoint step {c1.group(1)}, {nbytes} bytes")
    shutil.rmtree(ckdir)
    print(f"  (a) CLI, full width and depth, batch {TRAIN_BATCH} × "
          f"{TRAIN_SEQ}: run 1 (4 steps) {s1:.1f} s, losses {losses[0]:.4f} "
          f"→ {losses[1]:.4f}; run 2 resumed at step 4 (2 steps) {s2:.1f} s,"
          f" losses {losses[2]:.4f} → {losses[3]:.4f}; checkpoint "
          f"{nbytes} bytes ({nbytes / 1e9:.2f} GB), save {save_s:.2f} s, "
          f"restore {restore_s:.2f} s; {g1.group(0)} / {g2.group(0)}")
    graphs = [{"graphs": int(g.group(1)), "replays": int(g.group(2)),
               "capture_s": float(g.group(3)), "pool_bytes": int(g.group(4))}
              for g in (g1, g2)]
    return {"run_seconds": [s1, s2], "losses": losses, "ckpt_bytes": nbytes,
            "save_seconds": save_s, "restore_seconds": restore_s,
            "graphs": graphs}


def train_restart_part(cfg, dev, root: Path) -> dict:
    """(b) ``Trainer`` on tinyllama at full width cut to TRAIN_RESTART_LAYERS
    layers, remat 'block': an uninterrupted 8-step run against one stopped
    at step 4 and resumed — params, both moments and the losses of steps
    4–7 bitwise equal, with deterministic algorithms on for this check.
    The steps run from graphs: step 4 is a replay in the first run and the
    eager warm-up of the restored tree in the second."""
    import torch

    from repro_torch.data.pipeline import SyntheticCorpus, TrainStream
    from repro_torch.models.model_builder import build_model
    from repro_torch.optim import AdamW, cosine_warmup
    from repro_torch.train import Trainer, TrainerConfig

    model = build_model(cfg.replace(num_layers=TRAIN_RESTART_LAYERS),
                        device=dev)

    def trainer(total: int, d: Path):
        stream = TrainStream(SyntheticCorpus(vocab_size=cfg.vocab_size),
                             global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                             device=dev)
        return Trainer(model, AdamW(weight_decay=0.1, clip_norm=1.0),
                       cosine_warmup(1e-3, 1, 8), stream,
                       TrainerConfig(total_steps=total, ckpt_dir=str(d),
                                     save_every=4, log_every=100,
                                     remat="block"))

    gen = lambda: torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        full = trainer(8, root / "full")
        p_full, o_full = full.run(gen())
        trainer(4, root / "resume").run(gen())
        logs: list = []
        res = trainer(8, root / "resume")
        p_res, o_res = res.run(gen(), log=logs.append)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    seconds = time.perf_counter() - t0
    check(logs[:1] == ["restored checkpoint at step 4"],
          f"restart: {logs[:1]}")
    want = [h["loss"] for h in full.history[4:]]
    got = [h["loss"] for h in res.history]
    check(got == want, f"restart: losses of steps 4–7 {got} vs {want}")
    same = {"params": tree_equal(p_full, p_res),
            "mu": tree_equal(o_full.mu, o_res.mu),
            "nu": tree_equal(o_full.nu, o_res.nu)}
    check(all(same.values()) and int(o_res.step) == 8,
          f"restart not bitwise: {same}, step {int(o_res.step)}")
    ck = res.ckpt
    print(f"  (b) restart, full width × {TRAIN_RESTART_LAYERS} layers: "
          f"8 steps against 4 + resume, params / mu / nu / losses of steps "
          f"4–7 bitwise equal; checkpoint save {ck.save_seconds:.2f} s, "
          f"restore {ck.restore_seconds:.2f} s; {seconds:.1f} s in all")
    return {"bitwise": True, "losses": got, "seconds": seconds,
            "save_seconds": ck.save_seconds,
            "restore_seconds": ck.restore_seconds}


def replay_ms(fn, args: tuple, replays: int = TIMED_REPLAYS) -> tuple:
    """``fn`` (a ``graphed`` callable) in a scope of its own: a call (eager),
    a call (capture), then ``replays`` replays timed by CUDA events around
    them → (ms a replay, the scope's stats); the scope is released."""
    import torch

    from repro_torch.util import graphs

    sc = graphs.Scope(measure=True)
    with graphs.scope(sc):
        fn(*args)
        fn(*args)
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(replays):
            fn(*args)
        b.record()
        b.synchronize()
    stats = sc.stats()
    sc.close()
    return a.elapsed_time(b) / replays, stats


def finetune_part(cfg, model, pruned, report, prompts, dev,
                  pruned_loss: float) -> dict:
    """(c) the paper's sparse finetune at full size: FINETUNE_STEPS steps
    of the sparsity-preserving AdamW on a clone of phase 3's pruned tree
    from ``make_train_step``'s graph (step 1 eager, step 2 captured, the
    rest replayed), then held-out loss, the pruned coordinates, strict 2:4
    compression and the phase-4 request set served through K2; then where
    a step's time goes, eager and replayed: the loss alone, loss + grads
    without and with remat, and the update alone as a graphed call of its
    own (a capture holds no timing event)."""
    import statistics

    import torch

    from repro_torch.core.schedule import get_path
    from repro_torch.data.pipeline import (SyntheticCorpus, TrainStream,
                                           _stream_seed, heldout_loss,
                                           sample_torch)
    from repro_torch.optim import (AdamW, AdamWState, cosine_warmup,
                                   sparsity_preserving)
    from repro_torch.serve.compressed import compress_params, compressed_bytes
    from repro_torch.train.step import (_loss_with_remat, make_train_step,
                                        value_and_grad)
    from repro_torch.util import graphs
    from repro_torch.util.tree import map_tree

    # compress_params shares phase 4's unpruned leaves with this tree: the
    # in-place steps run on a clone
    ft = map_tree(lambda x: x.clone(), pruned)
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    opt = sparsity_preserving(AdamW(weight_decay=0.01, clip_norm=1.0),
                              report.masks)
    sched = cosine_warmup(5e-4, 2, FINETUNE_STEPS)
    step = make_train_step(model, opt, sched, remat="block")
    stream = TrainStream(SyntheticCorpus(vocab_size=cfg.vocab_size),
                         global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                         device=dev)
    state = opt.init(ft)
    step_ms, draw_ms, losses, drawn = [], [], [], []
    for i in range(FINETUNE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = stream.batch_at(1000 + i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ft, state, m = step(ft, state, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        draw_ms.append(1e3 * (t1 - t0))
        step_ms.append(1e3 * (t2 - t1))
        losses.append(float(m["loss"]))
        drawn.append(batch["tokens"])
    peak = torch.cuda.max_memory_allocated()
    gst, dst = step.stats(), stream.stats()
    check(gst["graphs"] == 1 and gst["replays"] == FINETUNE_STEPS - 1,
          f"finetune: the step's graphs {gst}")
    check(dst["graphs"] == 1 and dst["replays"] == FINETUNE_STEPS - 1,
          f"finetune: the stream's sampler graphs {dst}")
    step.release()
    stream.release()
    # the stream's replayed draws against the eager chain on the same
    # seeds, outside any scope (one call each, timed alone)
    eager_draw, same = [], True
    for i, toks in enumerate(drawn):
        gen = torch.Generator(device=dev).manual_seed(_stream_seed(
            stream.seed, stream.host_id, 1000 + i))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = sample_torch(stream.corpus, gen, TRAIN_BATCH, TRAIN_SEQ)
        torch.cuda.synchronize()
        eager_draw.append(1e3 * (time.perf_counter() - t0))
        same = same and torch.equal(toks, want)
    check(same, "finetune: the stream's replayed draws differ from the "
          "eager sample_torch draws")
    del drawn
    del m
    torch.cuda.empty_cache()
    check(all(math.isfinite(x) for x in losses),
          f"finetune: non-finite loss {losses}")
    bad = sum(int(get_path(ft, p)[mk > 0.5].count_nonzero())
              for p, mk in report.masks.items())
    check(len(report.masks) == 7 * cfg.num_layers and bad == 0,
          f"finetune: {bad} pruned coordinates moved off 0 "
          f"({len(report.masks)} masked linears)")
    ft_loss = heldout_loss(model, ft, cfg)
    check(ft_loss < pruned_loss, f"finetune: held-out loss {ft_loss:.4f} "
          f"not below the pruned {pruned_loss:.4f}")
    comp = compress_params(ft, report.masks, 2, 4, strict=True)
    cb, db = compressed_bytes(comp)
    check(cb / db == 0.625, f"finetune: compressed ratio {cb / db}")
    zero_counts()
    done, t_serve, _ = serve_requests(model, comp, prompts)
    counts = path_counts()
    k2 = counts["nm_matmul_cuda"][0]
    check(k2 > 0, "finetune: the finetuned tree served without K2")
    with uncounted():
        e = first_step_line(model, comp, prompts)
    del comp

    # where a step's time goes, on the last batch: eager (``eager_ms``, 3
    # calls) and replayed (CUDA events over TIMED_REPLAYS replays of its
    # own graph); ft is not read after this
    remat = _loss_with_remat(model, "block")
    parts = {"forward": lambda p, b: model.loss(p, b),
             "grad": lambda p, b: value_and_grad(model.loss, p, b)[0],
             "grad_remat": lambda p, b: value_and_grad(remat, p, b)[0]}
    split, split_replay = {}, {}
    for name, fn in parts.items():
        with torch.set_grad_enabled(name != "forward"):
            split[name] = eager_ms(lambda: fn(ft, batch), 3)
            split_replay[name], _ = replay_ms(
                graphs.graphed(fn, donate=("p",)), (ft, batch))
    grads = value_and_grad(remat, ft, batch)[1]
    count = state.step.to(dev)

    def update_only(params, mu, nu, grads, count):
        new_p, new = opt.update(grads, AdamWState(step=count, mu=mu, nu=nu),
                                params, sched(count), inplace=True)
        return new.step

    args = (ft, state.mu, state.nu, grads, count)
    upd_eager = eager_ms(lambda: update_only(*args), 3)
    upd_replay, ust = replay_ms(graphs.graphed(
        update_only, donate=("params", "mu", "nu", "grads")), args)
    del grads, args
    torch.cuda.empty_cache()

    first, capture = step_ms[0], step_ms[1]
    med = statistics.median(step_ms[2:])
    share = upd_replay / med
    ntok = sum(len(r.out) for r in done)
    print(f"  (c) sparse finetune, full width and depth, {FINETUNE_STEPS} "
          f"steps of batch {TRAIN_BATCH} × {TRAIN_SEQ} from step 1000 from "
          f"the step's graph: losses {losses[0]:.4f} → {losses[-1]:.4f}; "
          f"step 1 (eager warm-up) {first:.1f} ms, step 2 (capture) "
          f"{capture:.1f} ms, replayed median {med:.1f} ms over steps 3–"
          f"{FINETUNE_STEPS} (min {min(step_ms[2:]):.1f}, max "
          f"{max(step_ms[2:]):.1f}), "
          f"{TRAIN_BATCH * TRAIN_SEQ / med * 1e3:.0f} training tokens/s; "
          f"{gst['graphs']} graph, {gst['replays']} replays, capture "
          f"{gst['capture_s']:.2f} s, pool {gst['pool_bytes'] / 2**30:.2f} "
          f"GiB; peak memory {peak / 2**30:.2f} GiB (held before "
          f"{base_mem / 2**30:.2f} GiB)")
    print(f"      stream draw a batch of {TRAIN_BATCH} × {TRAIN_SEQ}: batch 1 "
          f"(eager warm-up) {draw_ms[0]:.1f} ms, batch 2 (capture) "
          f"{draw_ms[1]:.1f} ms, replayed median "
          f"{statistics.median(draw_ms[2:]):.1f} ms over batches 3–"
          f"{FINETUNE_STEPS}; eager sample_torch median "
          f"{statistics.median(eager_draw):.1f} ms (PR 25's eager draw: "
          f"54.1 ms); all {FINETUNE_STEPS} replayed draws bitwise the "
          f"eager ones; the sampler's graph: capture "
          f"{dst['capture_s']:.2f} s, pool {dst['pool_bytes'] / 2**20:.1f} "
          f"MiB")
    print(f"      one batch, eager / replayed ms: loss alone "
          f"{split['forward']:.1f} / {split_replay['forward']:.1f}, loss + "
          f"grads {split['grad']:.1f} / {split_replay['grad']:.1f}, with "
          f"remat 'block' {split['grad_remat']:.1f} / "
          f"{split_replay['grad_remat']:.1f}; the update alone (masked "
          f"AdamW, clip) {upd_eager:.1f} / {upd_replay:.1f} ms = "
          f"{share:.3f} of the replayed step (its graph's pool "
          f"{ust['pool_bytes'] / 2**30:.2f} GiB)")
    print(f"      held-out loss pruned {pruned_loss:.4f} → finetuned "
          f"{ft_loss:.4f}; all {len(report.masks)} masked linears' pruned "
          f"coordinates exactly 0; strict 2:4 compression {cb / db:.4f}; "
          f"phase-4 set served, {ntok} tokens in {t_serve:.2f} s, K2 "
          f"launches {k2}")
    return {"losses": losses, "step_ms": step_ms, "eager_ms": first,
            "capture_ms": capture, "step_ms_median": med,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med * 1e3,
            "graphs": gst, "update_ms": {"eager": upd_eager,
                                         "replayed": upd_replay},
            "update_share": share, "update_pool_bytes": ust["pool_bytes"],
            "draw_ms": draw_ms, "eager_draw_ms": eager_draw,
            "draw_graphs": dst, "peak_bytes": peak, "held_bytes": base_mem,
            "split_ms": split, "split_replayed_ms": split_replay,
            "pruned_loss": pruned_loss, "finetuned_loss": ft_loss,
            "ratio": cb / db, "k2_launches": k2, "serve_seconds": t_serve,
            "logits_max_abs_err": e[0], "logits_rel_err": e[1],
            "argmax_agree": e[2], "counts": counts}


class _CaptureTimeLr:
    """(c′)'s planted fault: an update that takes lr as a host number,
    from a Python count of its calls — right when every step runs its
    Python, wrong from a graph: the capture bakes its own lr in and every
    replay repeats it."""

    def __init__(self, opt, sched):
        self.opt, self.sched, self.calls = opt, sched, 0

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, lr, *, inplace=False):
        import torch

        lr = float(self.sched(torch.tensor(self.calls, dtype=torch.int32)))
        self.calls += 1
        return self.opt.update(grads, state, params, lr, inplace=inplace)


def replay_check(cfg, model, pruned, report, dev) -> dict:
    """(c′) replayed vs eager: REPLAY_STEPS finetune steps (the masked
    AdamW, a cosine schedule whose lr changes at every step) on a fresh
    clone of phase 3's pruned tree through the step's direct function
    (``__wrapped__``, no graph), and on another from its graph (eager,
    capture, replays) — params, both moments, losses, grad norms and lrs
    bitwise equal, with deterministic algorithms on for this check; then
    the same pair with ``_CaptureTimeLr`` planted, which must differ."""
    import torch

    from repro_torch.data.pipeline import SyntheticCorpus, TrainStream
    from repro_torch.optim import AdamW, cosine_warmup, sparsity_preserving
    from repro_torch.train.step import make_train_step
    from repro_torch.util.tree import map_tree

    sched = cosine_warmup(5e-4, 2, REPLAY_STEPS)
    stream = TrainStream(SyntheticCorpus(vocab_size=cfg.vocab_size),
                         global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                         device=dev)
    batches = [stream.batch_at(2000 + i) for i in range(REPLAY_STEPS)]

    def optimizer(fault: bool):
        opt = sparsity_preserving(AdamW(weight_decay=0.01, clip_norm=1.0),
                                  report.masks)
        return _CaptureTimeLr(opt, sched) if fault else opt

    def trajectory(fault: bool, graphed: bool) -> tuple:
        opt = optimizer(fault)
        step = make_train_step(model, opt, sched, remat="block")
        run = step if graphed else step.__wrapped__
        p = map_tree(torch.clone, pruned)
        st, rec = opt.init(p), []
        for b in batches:
            p, st, m = run(p, st, b)
            rec.append([m[k].clone() for k in ("loss", "grad_norm", "lr")])
        torch.cuda.synchronize()
        stats = step.stats()
        step.release()
        return p, st, rec, stats

    def same(a, b) -> dict:
        return {"params": tree_equal(a[0], b[0]),
                "mu": tree_equal(a[1].mu, b[1].mu),
                "nu": tree_equal(a[1].nu, b[1].nu),
                "metrics": all(torch.equal(x, y) for r, q in zip(a[2], b[2])
                               for x, y in zip(r, q))}

    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        want = trajectory(False, False)
        got = trajectory(False, True)
        ok = same(want, got)
        lrs = [float(r[2]) for r in got[2]]
        gst = got[3]
        del want, got
        torch.cuda.empty_cache()
        bad = same(trajectory(True, False), trajectory(True, True))
        torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    seconds = time.perf_counter() - t0
    check(all(ok.values()), f"(c′) replayed steps not bitwise the eager "
          f"ones: {ok}")
    check(len(set(lrs)) == REPLAY_STEPS, f"(c′) lrs {lrs}")
    check(gst["graphs"] == 1 and gst["replays"] == REPLAY_STEPS - 1,
          f"(c′) graphs {gst}")
    check(not all(bad.values()), "(c′) the planted capture-time lr passed "
          "the check")
    lr_list = ", ".join(f"{x:.3g}" for x in lrs)
    print(f"  (c′) replayed vs eager, {REPLAY_STEPS} finetune steps on a "
          f"fresh clone of the pruned tree, lr {lr_list}: params / mu / nu "
          f"/ losses / grad norms / lrs bitwise equal "
          f"(deterministic algorithms on), {gst['replays']} replays of one "
          f"graph; with the update reading the capture's lr planted: "
          f"{', '.join(k for k, v in bad.items() if not v)} differ; "
          f"{seconds:.1f} s")
    return {"bitwise": ok, "lrs": lrs, "graphs": gst, "fault": bad,
            "seconds": seconds}


def train_phase(cfg, model, pruned, report, prompts, dev,
                pruned_loss: float) -> dict:
    """The train phase, right after phase 4 (its three parts' docstrings
    say what each holds)."""
    import shutil

    import torch

    t0 = time.perf_counter()
    root = ROOT / "build" / "train_phase"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = {"cli": train_cli_part(pruned, root)}
    out["restart"] = train_restart_part(cfg, dev, root)
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    out["finetune"] = finetune_part(cfg, model, pruned, report, prompts, dev,
                                    pruned_loss)
    torch.cuda.empty_cache()
    out["replay"] = replay_check(cfg, model, pruned, report, dev)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase train: {out['seconds']:.1f} s")
    return out


def robust_phase(cfg, model, comp, prompts, done, dev) -> dict:
    """Phase robust on phase 4's compressed tinyllama tree: (a) the
    supervised continuous engine without faults (its longest pump sets the
    step deadline: 2 × it, at least 0.5 s; the stall is 1 s longer), then
    under ``decode_logits@5;prefill@2;decode_stall@9+<stall>`` contiguous
    and, with ``pager_fault_in@7x6`` added, paged; (b) a snapshot persisted
    and restored into a fresh engine; (c) the prune job killed and
    resumed, and the cholesky / hessian_accum sites; (d) the HTTP front
    end.  Launch counts are zeroed before it and read after it: K2 154 a
    model step (each engine's ``graph_stats()`` counts its steps, eager or
    replayed), K1 those of (c)."""
    import shutil

    import torch

    want = {r.uid: r.out for r in done}
    root = ROOT / "chiprun_out" / "robust"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    zero_counts()
    t0 = time.perf_counter()
    out = {"clean": supervised_serve(model, comp, prompts, want, "",
                                     "supervised, no faults")}
    deadline = max(0.5, 2 * out["clean"]["max_pump_s"])
    stall = deadline + 1.0
    plan = f"decode_logits@5;prefill@2;decode_stall@9+{stall:.2f}"
    out["contiguous"] = supervised_serve(
        model, comp, prompts, want, plan, "supervised contiguous",
        deadline=deadline, snapshot_dir=str(root / "snap"))
    check((root / "snap" / "snapshot.pkl").is_file(),
          "the supervisor persisted no snapshot")
    out["paged"] = supervised_serve(
        model, comp, prompts, want, plan + ";pager_fault_in@7x6",
        "supervised paged", deadline=deadline, paged=True)
    out["snapshot"] = snapshot_restore(model, comp, prompts, want,
                                       root / "snapshot_b.pkl")
    out["http"] = http_checks(model, comp, prompts, want)
    steps = sum(out[k]["model_steps"] for k in ("clean", "contiguous",
                                                 "paged", "snapshot", "http"))
    out["job"] = prune_job_checks(cfg, dev, root)
    out["counts"] = family_counts("robust", {
        "hessian_update_cuda": out["job"]["k1"],
        "nm_matmul_cuda": 7 * cfg.num_layers * steps})
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase robust: {out['seconds']:.1f} s; {steps} model steps "
          f"served ({7 * cfg.num_layers * steps} K2 launches), K1 "
          f"launches {out['job']['k1']}")
    return out


def dist_rank(rank: int, tmp: str, device: str, ref: dict, setup) -> None:
    """One of the dist phase's two ranks, spawned: a gloo group over a
    FileStore in ``tmp`` and a (2, 1) ("data", "model") mesh on ``device``;
    its results go to ``tmp/rank<rank>.pt``.  ``setup`` (a top-level
    function, or None) runs first: a CPU rehearsal installs its kernel
    fakes there."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if setup is not None:
        setup()
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)           # both ranks share the one card
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{tmp}/store", 2), rank=rank,
        world_size=2, timeout=datetime.timedelta(seconds=DIST_PG_TIMEOUT))
    try:
        mesh = init_device_mesh(torch.device(device).type, (2, 1),
                                mesh_dim_names=("data", "model"))
        out = dist_rank_body(rank, mesh, device, ref)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def dist_calibration(model, params, batches, mesh, rank: int) -> tuple:
    """Dist (c): each rank accumulates its own calibration batch into layer
    0's seven accumulators (K1) and ``all_reduce`` sums them over the data
    axis; the sum is held against ``combine`` of both batches' partials
    (bitwise: gloo adds the two fp32 partials once) and against one
    accumulator over both batches (bitwise, or rtol 1e-6 where K1's own
    sum order differs).  → (summary, {path: that accumulator's H})."""
    import torch

    from repro_torch.core.hessian import HessianAccumulator
    from repro_torch.models.model_builder import ModelAdapter

    adapter = ModelAdapter(model)
    with torch.no_grad():
        caps = [adapter.block_apply(params, 0, adapter.prepare(params, b),
                                    capture=True)[1] for b in batches]
    combine_equal, mono_equal, worst, hs = True, True, 0.0, {}
    for path, x0 in caps[0].items():
        b = x0.shape[-1]
        parts = [HessianAccumulator.init(b, x0.device).update(c[path])
                 for c in caps]
        mono = HessianAccumulator.init(b, x0.device).update(caps[0][path])
        mono.update(caps[1][path])
        mine = HessianAccumulator.init(b, x0.device).update(caps[rank][path])
        red = mine.all_reduce(mesh, ("data",))
        comb = HessianAccumulator.combine(*parts)
        combine_equal &= all(torch.equal(u, v) for u, v in zip(
            (red.xtx, red.count, red.skipped),
            (comb.xtx, comb.count, comb.skipped)))
        mono_equal &= torch.equal(red.xtx, mono.xtx)
        close = torch.allclose(red.xtx, mono.xtx, rtol=1e-6, atol=0.0)
        check(close, f"dist (c) {path}: the all-reduced sum is not within "
              f"rtol 1e-6 of one accumulator over both batches")
        d = (red.xtx - mono.xtx).abs() / mono.xtx.abs().clamp(min=1e-30)
        worst = max(worst, float(d.max()))
        hs[path] = mono.finalize()
    check(combine_equal, "dist (c): all_reduce is not bitwise combine")
    return {"paths": len(caps[0]), "combine_bitwise": combine_equal,
            "mono_bitwise": mono_equal, "mono_max_rel": worst}, hs


def dist_rank_body(rank: int, mesh, device: str, ref: dict) -> dict:
    """Dist (a), (c), (d), (e) on one rank (``dist_phase`` says what each
    holds); ``ref`` holds phase 3's masks, pruned linears and packed
    indices (rank 0 only, shared from the parent's card memory)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core import PruneConfig, prune_layer, prune_model
    from repro_torch.core.schedule import get_path
    from repro_torch.data.pipeline import (SyntheticCorpus, TrainStream,
                                           calibration_batches)
    from repro_torch.device import resolve_device
    from repro_torch.dist.prune import prune_layer_sharded
    from repro_torch.kernels import hessian_accum as K1, nm_spmm as K2
    from repro_torch.models.model_builder import ModelAdapter, build_model
    from repro_torch.serve.compressed import compress_params

    dev = resolve_device(device)
    cfg = get_config("tinyllama-1.1b")
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    batches = calibration_batches(cfg, num_samples=16, seq_len=128,
                                  batch=8, device=dev)
    cell = PruneConfig("thanos", "nm", n=2, m=4, block_size=64)
    out: dict = {"rank": rank}

    # ---- (c), and the fp32 solve of layer 0's up and down ------------------
    t0 = time.perf_counter()
    with uncounted():
        out["calib"], hs = dist_calibration(model, params, batches, mesh,
                                            rank)
        solves = {}
        for name in ("up", "down"):
            path = ("blocks", 0, "mlp", name, "w")
            w = get_path(params, path).T.float()       # (out, in), fp32
            loc = prune_layer(w, hs[path], cell)
            sh = prune_layer_sharded(w, hs[path], cell, mesh)
            bf = torch.bfloat16
            solves[name] = {
                "shape": tuple(w.shape),
                "fp32_max_abs": float((sh.weights - loc.weights).abs().max()),
                "bf16_max_abs": float((sh.weights.to(bf).float()
                                       - loc.weights.to(bf).float())
                                      .abs().max()),
                "mask_equal": torch.equal(sh.mask, loc.mask),
                "loss_rel": abs(float(sh.loss) - float(loc.loss))
                / max(abs(float(loc.loss)), 1e-30)}
        up = ("blocks", 0, "mlp", "up", "w")
        if rank == 0:      # (b)'s layer, for the parent's one-rank group
            out["up_h"] = hs[up].cpu()
            out["up_w"] = get_path(params, up).T.contiguous().cpu()
        del hs
    out["solves"] = solves
    out["calib"]["seconds"] = time.perf_counter() - t0

    # ---- (a) the row-parallel prune at full depth --------------------------
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pruned, report = prune_model(params, ModelAdapter(model), batches, cell,
                                 mesh=mesh, keep_masks=rank == 0)
    torch.cuda.synchronize()
    out["prune_seconds"] = time.perf_counter() - t0
    out["graphs"] = report.graphs
    out["losses"] = [r.obs_loss for r in report.layers]
    if rank == 0:
        diff, dmax = {}, 0.0
        for p, mk in report.masks.items():
            diff[p] = int((mk != ref["masks"][p]).sum())
            dmax = max(dmax, float((get_path(pruned, p).float()
                                    - ref["linears"][p].float()).abs()
                                   .max()))
        comp = compress_params(pruned, report.masks, 2, 4)
        out["mask_diff"] = diff
        out["weights_bf16_max_abs"] = dmax
        out["indices_equal"] = all(
            torch.equal(get_path(comp, p).indices, ref["indices"][p])
            for p in report.masks)
        out["linears"] = len(report.masks)
        out["first_step"] = first_step_line(
            model, comp, request_prompts(cfg.vocab_size))
        del comp, ref
    out["counts"] = path_counts()
    del pruned, report
    torch.cuda.empty_cache()

    # ---- (d) the sharded train step, then (e) on its gradients ------------
    batch = TrainStream(SyntheticCorpus(cfg.vocab_size), TRAIN_BATCH,
                        TRAIN_SEQ, device=dev).batch_at(0)
    out["train"] = dist_train(model, params, batch, mesh, rank)
    return out


def dist_train(model, params, batch, mesh, rank: int) -> dict:
    """Dist (d): DIST_STEPS steps of ``make_sharded_train_step`` on the
    (TRAIN_BATCH, TRAIN_SEQ) batch, each rank on its half, params and
    moments as DTensors in ``param_pspecs``' layout; each step's wall time
    (both ranks share the card) and one ``all_reduce_mean`` of a
    gradient-shaped tree timed alone.  Then rank 0 runs ``make_train_step``
    on the whole batch from the same params and holds losses and params to
    DIST_LOSS_TOL and |Δp| ≤ 6·lr + 3·2⁻⁷·|p|; rank 1 runs (e)."""
    import torch

    from repro_torch.dist.prune import axis_group
    from repro_torch.dist.sharding import shard_params
    from repro_torch.optim import AdamW, AdamWState, constant
    from repro_torch.train.step import (all_reduce_mean,
                                        make_sharded_train_step,
                                        make_train_step)
    from repro_torch.util.tree import leaves, map_tree

    opt = AdamW()
    # rank 0's reference start waits on the host: the two ranks' graphed
    # steps share the card with this process's parent
    start = (map_tree(lambda x: x.to("cpu", copy=True), params) if rank == 0
             else None)
    st = opt.init(params)
    st = AdamWState(st.step, shard_params(st.mu, mesh, fsdp=False),
                    shard_params(st.nu, mesh, fsdp=False))
    sp = shard_params(params, mesh, fsdp=False)
    step = make_sharded_train_step(model, opt, constant(DIST_LR), mesh,
                                   batch, params)
    del params
    losses, secs = [], []
    for _ in range(DIST_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp, st, m = step(sp, st, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    check(all(math.isfinite(x) for x in losses), f"dist (d) losses {losses}")
    gst = step.stats()
    step.release()
    del step
    full = map_tree(lambda d: d.full_tensor(), sp)
    del st
    torch.cuda.empty_cache()
    grads = [torch.zeros_like(x) for x in leaves(full)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    all_reduce_mean(grads, axis_group(mesh, ("data",)).group, 2)
    torch.cuda.synchronize()
    out = {"losses": losses, "step_s": secs, "graphs": gst,
           "collective_s": time.perf_counter() - t0,
           "grad_bytes": sum(g.numel() * g.element_size() for g in grads)}
    del grads
    if rank == 1:
        out["compress"] = dist_compression(model, full, batch)
        return out
    ref = make_train_step(model, opt, constant(DIST_LR), remat="block")
    rp = map_tree(lambda x: x.to(model.device), start)
    rs = opt.init(rp)
    ref_losses = []
    for _ in range(DIST_STEPS):
        rp, rs, rm = ref(rp, rs, batch)
        ref_losses.append(float(rm["loss"]))
    ref.release()
    del rs
    worst, over, differ, total = 0.0, 0, 0, 0
    for a, b in zip(leaves(full), leaves(rp)):
        d = (a.float() - b.float()).abs()
        bound = 6 * DIST_LR + 3 * 2.0 ** -7 * b.float().abs()
        worst = max(worst, float(d.max()))
        over += int((d > bound).sum())
        differ += int((d > 0).sum())
        total += d.numel()
    out.update(ref_losses=ref_losses, params_max_abs=worst,
               params_over=over, params_differ=differ / total)
    return out


def dist_compression(model, params, batch) -> dict:
    """Dist (e) on rank 1: the gradient tree of ``params`` on this rank's
    rows, ``compress_grads`` from a zero residual on the card and on the
    host: the payloads and residuals bitwise equal, the int8 payload a
    quarter of the fp32 bytes, every residual ≤ 4 × its leaf's scale, and
    ``decompress_grads`` within a scale of the gradient."""
    import torch

    from repro_torch.dist.compression import (ErrorFeedback, compress_grads,
                                              decompress_grads)
    from repro_torch.train.step import value_and_grad
    from repro_torch.util.tree import leaves, map_tree

    rows = {k: v[v.shape[0] // 2:] for k, v in batch.items()}
    _, grads = value_and_grad(model.loss, params, rows)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pay, ef = compress_grads(grads, ErrorFeedback.init(grads))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    host = map_tree(lambda g: g.cpu(), grads)
    t0 = time.perf_counter()
    hpay, hef = compress_grads(host, ErrorFeedback.init(host))
    host_s = time.perf_counter() - t0
    same = {"q": True, "scale": True, "residual": True}
    q_bytes, f32_bytes, worst_res, worst_deq = 0, 0, 0.0, 0.0
    deq = decompress_grads(pay)
    for (q, s), (hq, hs), r, hr, g, dq in zip(
            leaves(pay), leaves(hpay), leaves(ef.residual),
            leaves(hef.residual), leaves(grads), leaves(deq)):
        same["q"] &= torch.equal(q.cpu(), hq)
        same["scale"] &= s.cpu().numpy().tobytes() == hs.numpy().tobytes()
        same["residual"] &= torch.equal(r.cpu(), hr)
        q_bytes += q.numel() * q.element_size()
        f32_bytes += q.numel() * 4
        worst_res = max(worst_res, float(r.abs().max() / s))
        worst_deq = max(worst_deq, float((dq - g.float()).abs().max() / s))
    bitwise = all(same.values())
    check(bitwise, f"dist (e): the card's payload is not the host's "
          f"(bitwise: {same})")
    check(4 * q_bytes == f32_bytes, "dist (e): int8 payload bytes")
    check(worst_res <= 4.0 and worst_deq <= 1.0,
          f"dist (e): residual {worst_res:.3g} or dequantized error "
          f"{worst_deq:.3g} scales")
    return {"leaves": len(leaves(grads)), "int8_bytes": q_bytes,
            "fp32_bytes": f32_bytes, "scale_bytes": 4 * len(leaves(grads)),
            "bitwise_host": bitwise, "residual_scales": worst_res,
            "dequant_scales": worst_deq, "card_s": card_s, "host_s": host_s}


def nccl_probe_rank(rank: int, tmp: str) -> None:
    """Two NCCL ranks on the one card: record what NCCL answers (the dist
    phase expects a refusal) in ``tmp/nccl<rank>.txt``, then leave without
    NCCL's teardown."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    try:
        dist.init_process_group(
            "nccl", store=dist.FileStore(f"{tmp}/nccl_store", 2), rank=rank,
            world_size=2, device_id=torch.device("cuda", 0),
            timeout=datetime.timedelta(seconds=60))
        t = torch.ones(1, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        msg = f"accepted: all_reduce gave {float(t)}"
    except Exception as e:        # the answer under test
        msg = f"{type(e).__name__}: {e}"
    Path(f"{tmp}/nccl{rank}.txt").write_text(msg)
    sys.stdout.flush()
    os._exit(0)


def join_ranks(procs: list, timeout: float, label: str) -> None:
    """Join spawned ranks; fail on one still running after ``timeout`` s
    (killed first) or exiting non-zero."""
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    check(not hung, f"{label}: ranks {hung} still running after {timeout} s")
    codes = [p.exitcode for p in procs]
    check(codes == [0] * len(procs), f"{label}: rank exit codes {codes}")


def nccl_refusal(tmp: Path) -> str:
    """Spawn two NCCL ranks on the one card → NCCL's answer, once."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=nccl_probe_rank, args=(r, str(tmp)))
             for r in (0, 1)]
    for p in procs:
        p.start()
    join_ranks(procs, 120, "NCCL probe")
    answers = [(tmp / f"nccl{r}.txt").read_text() for r in (0, 1)]
    refused = ["accepted" not in a for a in answers]
    return answers[0] if refused[0] == refused[1] else " | ".join(answers)


def nccl_one_rank(tmp: Path, h, w, dev) -> dict:
    """Dist (b): a one-rank NCCL group in this process; on its 1 × 1 mesh
    ``prune_layer_sharded`` of layer 0's up (5632, 2048) is bitwise
    ``prune_layer`` for each pattern (JAX's 1 × 1 contract)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import PruneConfig, prune_layer
    from repro_torch.dist.prune import prune_layer_sharded

    h, w = h.to(dev), w.to(dev)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp / "nccl1_store"), 1), rank=0,
        world_size=1, device_id=torch.device("cuda",
                                              torch.cuda.current_device()))
    out = {}
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        for cfg in (PruneConfig("thanos", "unstructured", p=0.5,
                                block_size=64),
                    PruneConfig("thanos", "nm", n=2, m=4, block_size=64),
                    PruneConfig("thanos", "structured", p=0.5)):
            with uncounted():
                a = prune_layer_sharded(w, h, cfg, mesh)
                b = prune_layer(w, h, cfg)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            check(same, f"dist (b) {cfg.tag()}: one-rank NCCL "
                  f"prune_layer_sharded is not bitwise prune_layer")
            out[cfg.tag()] = same
    finally:
        dist.destroy_process_group()
    return out


def dist_phase(cfg, pruned, report, comp, dev, setup=None) -> dict:
    """Phase dist on phase 3's tree, over two ranks on the one card: NCCL
    refuses two ranks on one device (its answer is printed once), so the
    ranks share a gloo group (FileStore in a temp dir under build/) on a
    (2, 1) ("data", "model") mesh, spawned after phase 1 built the kernels.
    (a) ``prune_model(mesh=)``: tinyllama at full width and depth, Thanos
    2:4 B=64 on phase 3's calibration, every solve split over both ranks —
    masks equal phase 3's exactly (the count of differing entries printed),
    index bytes equal, the bf16 weights' max |Δ| against phase 3's and the
    fp32 one of layer 0's up and down against their local solve, the
    summed OBS losses against phase 3's, K1 launches per rank, and the tree
    compressed and served one step through K2 (rel ≤ 5e-2); (b) a one-rank
    NCCL group in this process: ``prune_layer_sharded`` bitwise
    ``prune_layer``; (c) data-parallel calibration (``dist_calibration``);
    (d) the sharded train step (``dist_train``); (e) int8 gradient
    compression (``dist_compression``).  Launch counts: each rank zeroes
    them before (a) and reads them after its serve."""
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from repro_torch.core.schedule import get_path

    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="dist_phase-", dir=ROOT / "build"))
    ref = {"masks": report.masks,
           "linears": {p: get_path(pruned, p) for p in report.masks},
           "indices": {p: get_path(comp, p).indices for p in report.masks}}
    if torch.device(dev).type == "cuda":
        # the ranks share the card with this process: hand back the blocks
        # its allocator still caches from the earlier phases
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"  dist: this process holds "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved "
              f"beside the ranks")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dist_rank, args=(
        r, str(tmp), str(dev), ref if r == 0 else {}, setup))
        for r in (0, 1)]
    for p in procs:
        p.start()
    join_ranks(procs, DIST_JOIN_TIMEOUT, "dist")
    ranks = []
    for r in (0, 1):
        f = tmp / f"rank{r}.pt"
        check(f.is_file(), f"dist: rank {r} left no result")
        ranks.append(torch.load(f, weights_only=False))
    t_ranks = time.perf_counter() - t0
    a, b = ranks
    out = nccl_parts(tmp, a, dev)
    shutil.rmtree(tmp, ignore_errors=True)

    # (a)
    ndiff = sum(a["mask_diff"].values())
    if ndiff:
        print(f"  dist (a) differing mask entries by layer: "
              f"{ {str(k): v for k, v in a['mask_diff'].items() if v} }")
    local = [r.obs_loss for r in report.layers]
    loss_rel = max(abs(x - y) / max(abs(y), 1e-30)
                   for x, y in zip(a["losses"], local))
    k1 = [r["counts"]["hessian_update_cuda"][0] for r in ranks]
    check(ndiff == 0 and a["linears"] == 7 * cfg.num_layers,
          f"dist (a): {ndiff} mask entries differ from phase 3's")
    check(a["indices_equal"], "dist (a): packed index bytes differ")
    check(k1 == [2 * 7 * cfg.num_layers] * 2, f"dist (a): K1 launches {k1}")
    check(a["losses"] == b["losses"], "dist (a): the ranks' losses differ")
    for r in ranks:
        check(r["graphs"]["graphs"] > 0 and r["graphs"]["replays"] > 0,
              f"dist (a): a rank captured or replayed no graph "
              f"({r['graphs']})")
    g = a["graphs"]
    GRAPH_LINES["dist"] = dict(g, seconds=a["prune_seconds"])
    print(f"  graphs dist (rank 0): {g['graphs']} captured, {g['replays']} "
          f"replays, {g['eager']} eager first calls of {g['calls']} keyed "
          f"calls; capture {g['capture_s']:.2f} s, pool "
          f"{g['pool_bytes'] / 2**20:.1f} MiB; prune "
          f"{a['prune_seconds']:.2f} s; "
          f"the all_gather / all_reduce stay eager")
    print(f"phase dist: 2 gloo ranks on one card, (2, 1) mesh; (a) "
          f"prune_model(mesh=) {a['prune_seconds']:.1f} s / "
          f"{b['prune_seconds']:.1f} s a rank: {a['linears']} linears, "
          f"{ndiff} mask entries differ from phase 3's, index bytes equal "
          f"{a['indices_equal']}, bf16 weights max |Δ| "
          f"{a['weights_bf16_max_abs']:.4g}, SUM-reduced OBS losses max rel "
          f"{loss_rel:.3g} of phase 3's, K1 launches a rank {k1}; layer 0 "
          f"fp32 solves sharded vs local: "
          + ", ".join(f"{k} {v['shape']} max |Δ| {v['fp32_max_abs']:.4g} "
                      f"(bf16 {v['bf16_max_abs']:.4g}), masks equal "
                      f"{v['mask_equal']}, loss rel {v['loss_rel']:.3g}"
                      for k, v in a["solves"].items()))
    # (c)
    c = a["calib"]
    print(f"  dist (c) data-parallel calibration, layer 0's {c['paths']} "
          f"accumulators: all_reduce bitwise combine {c['combine_bitwise']}"
          f", bitwise one accumulator over both batches "
          f"{c['mono_bitwise']} (max rel {c['mono_max_rel']:.3g}, rtol "
          f"1e-6)")
    # (d)
    ta, tb = a["train"], b["train"]
    dl = [abs(x - y) for x, y in zip(ta["losses"], ta["ref_losses"])]
    check(ta["losses"] == tb["losses"], "dist (d): the ranks' losses differ")
    check(max(dl) <= DIST_LOSS_TOL and ta["params_over"] == 0,
          f"dist (d): loss |Δ| {dl} (limit {DIST_LOSS_TOL}), "
          f"{ta['params_over']} params beyond 6·lr + 3·2⁻⁷·|p|")
    # by role, as train (c): step 1 the eager warm-up, step 2 the capture,
    # the rest replays
    eager_s, capture_s = ta["step_s"][0], ta["step_s"][1]
    step_s = statistics.median(ta["step_s"][2:])
    share = ta["collective_s"] / step_s
    print(f"  dist (d) sharded train step, {TRAIN_BATCH} × {TRAIN_SEQ} "
          f"tokens over 2 ranks, lr {DIST_LR}: losses {ta['losses']} vs "
          f"make_train_step {ta['ref_losses']} (max |Δ| {max(dl):.3g}, "
          f"limit {DIST_LOSS_TOL}); params max |Δ| "
          f"{ta['params_max_abs']:.3g}, {ta['params_differ']:.4f} of them "
          f"differ, none beyond the bound; step 1 (eager warm-up) "
          f"{1e3 * eager_s:.1f} ms, step 2 (capture) {1e3 * capture_s:.1f} "
          f"ms, replayed median {1e3 * step_s:.1f} ms over steps 3–"
          f"{DIST_STEPS} ({', '.join(f'{1e3 * s:.1f}' for s in ta['step_s'][2:])}"
          f"); one gradient all_reduce ({ta['grad_bytes'] / 1e9:.2f} GB "
          f"bf16, gloo) {1e3 * ta['collective_s']:.1f} ms = {share:.2f} of "
          f"a replayed step; rank 0's two graphed segments: "
          f"{ta['graphs']['graphs']} graphs, {ta['graphs']['replays']} "
          f"replays, capture {ta['graphs']['capture_s']:.2f} s, pool "
          f"{ta['graphs']['pool_bytes'] / 2**30:.2f} GiB")
    check(all(t["graphs"]["graphs"] == 2 and t["graphs"]["replays"] ==
              2 * (DIST_STEPS - 1) for t in (ta, tb)),
          f"dist (d): the sharded step's graphs {ta['graphs']} / "
          f"{tb['graphs']}")
    # (e)
    e = tb["compress"]
    print(f"  dist (e) int8 compression of {e['leaves']} gradient leaves: "
          f"payload {e['int8_bytes'] / 1e9:.3f} GB = "
          f"{e['int8_bytes'] / e['fp32_bytes']:.4f} of fp32 "
          f"(+{e['scale_bytes']} B of scales), card bitwise the host "
          f"{e['bitwise_host']}, residual ≤ {e['residual_scales']:.3f} "
          f"scales (limit 4), card {1e3 * e['card_s']:.1f} ms, host "
          f"{e['host_s']:.2f} s")
    out.update(a=dict(prune_seconds=[r["prune_seconds"] for r in ranks],
                      mask_diff=ndiff, indices_equal=a["indices_equal"],
                      weights_bf16_max_abs=a["weights_bf16_max_abs"],
                      loss_rel=loss_rel, k1=k1, solves=a["solves"],
                      first_step=a["first_step"]),
               c=c, d=dict(ta, step_ms=1e3 * step_s, eager_ms=1e3 * eager_s,
                           capture_ms=1e3 * capture_s, share=share,
                           rank1_losses=tb["losses"]), e=e,
               ranks_seconds=t_ranks)
    out["counts"] = {}
    for r in ranks:
        add_counts(out["counts"], r["counts"])
    out["seconds"] = time.perf_counter() - t0
    print(f"  dist: {out['seconds']:.1f} s ({t_ranks:.1f} s the ranks)")
    return out


def nccl_parts(tmp: Path, a: dict, dev) -> dict:
    """NCCL's answer to two ranks on one card, then dist (b)."""
    t0 = time.perf_counter()
    answer = nccl_refusal(tmp)
    print(f"  NCCL, two ranks on one card: {answer[:600]}")
    one = nccl_one_rank(tmp, a["up_h"], a["up_w"], dev)
    print(f"  dist (b) one-rank NCCL mesh, layer 0 up {tuple(a['up_w'].shape)}"
          f": prune_layer_sharded bitwise prune_layer {one} "
          f"({time.perf_counter() - t0:.1f} s with the probe)")
    return {"nccl_two_ranks": answer, "b": one}


def tooling_sweep() -> list:
    """Tooling (a): the dry run's abstract sweep over all 40 (arch, cell)
    pairs, skipped ones too, on the single-pod 16 × 16 mesh (meta device,
    no card)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh()
    out = []
    for arch in registry.ARCHS:
        cfg = registry.get_config(arch)
        for cell in SHAPES.values():
            rec = dryrun.run_cell(arch, cell, mesh, "pod16x16", 256)
            rec["supported"] = registry.cell_supported(cfg, cell)
            check(rec["roofline_step_s"] > 0 and
                  all(k not in rec for k in dryrun.LEFT_OUT),
                  f"dry run {arch} {cell.name}: {rec['roofline']}")
            print(f"  sweep {arch:19s} {cell.name:12s} "
                  f"{'' if rec['supported'] else '(skipped cell) '}fits "
                  f"{rec['fits']} (one card: {rec['fits_one_card']}, "
                  f"{rec['argument_bytes']['whole']['total'] / 1e9:.1f} GB) "
                  f"{rec['bottleneck']} roofline "
                  f"{rec['roofline_step_s'] * 1e3:.4f} ms (256 cards)")
            out.append(rec)
    check(len(out) == 40, f"{len(out)} dry-run cells")
    return out


def graph_fields(label: str, r: dict, ms: float, bound_ms: float) -> str:
    """A measured step's eager, capture and replayed ms, pool bytes and
    replayed / eager over the bound (``dryrun.run_fields``), checked: one
    graph, replayed, bitwise the direct call from the same state."""
    check(r["graphs"] == 1 and r["replays"] >= 1 and r["replay_bitwise"],
          f"{label}: graphs {r['graphs']}, replays {r['replays']}, replay "
          f"bitwise the direct call {r['replay_bitwise']}")
    return (f"eager {r['eager_ms']:.3f} ms, capture {r['capture_ms']:.1f} "
            f"ms, replayed {ms:.3f} ms (bound {bound_ms:.3f} ms; "
            f"measured/bound replayed {ms / bound_ms:.2f}, eager "
            f"{r['eager_ms'] / bound_ms:.2f}), pool "
            f"{r['pool_bytes'] / 1e9:.2f} GB, replay bitwise the direct "
            f"call")


def tooling_measure(sweep: list) -> list:
    """Tooling (b): ``dryrun --measure`` on every supported decode cell
    whose arguments fit one card at full depth: its step on random-init
    weights, 5 direct calls after a warm-up, then the step's graph (warm-up,
    capture, 5 replays; ``dryrun.timed_runs``), peak bytes above the
    arguments."""
    import torch

    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun

    out = []
    for rec in sweep:
        if not (rec["supported"] and rec["fits_one_card"]
                and SHAPES[rec["cell"]].kind == "decode"):
            continue
        m = dryrun.measure_cell(rec["arch"], SHAPES[rec["cell"]],
                                device="cuda")
        torch.cuda.empty_cache()
        label = f"measure {rec['arch']} {rec['cell']}"
        check(m["finite"] and m["logits_shape"][0] ==
              SHAPES[rec["cell"]].global_batch,
              f"{label}: {m['logits_shape']}, finite {m['finite']}")
        print(f"  measure {rec['arch']:19s} {rec['cell']:12s} full depth: "
              + graph_fields(label, m, m["step_ms"],
                             m["roofline_step_s"] * 1e3)
              + f"; {m['bottleneck']}, arguments "
              f"{m['argument_bytes'] / 1e9:.2f} GB, temporaries "
              f"{m['temp_bytes'] / 1e9:.2f} GB")
        out.append(m)
    check(len(out) > 0, "no decode cell fits one card")
    return out


def tooling_ladders() -> dict:
    """Tooling (c): the three perf ladders on the card at full width, B =
    128, each at its ladder's depth (whisper's cache448 rungs again at full
    depth), K2 launches counted over the nm rungs.  Gates: an nm rung's
    first-step logits against its decompressed tree from a fresh cache at
    rel ≤ NM_REL (xlstm on the rung's leaves and inputs cut to its first
    NM_GATE_BLOCKS blocks, as phase families holds it: random-init bf16
    blocks amplify rounding block after block); an int8 rung's logits
    against the same model's over a bf16 cache, both filled with the same
    random k/v (perf.int8_cache_check), at max |Δ| < INT8_TOL and below
    INT8_SHARE of what the filled cache itself moves them."""
    import dataclasses

    import torch

    from repro_torch.configs.base import ShapeCell
    from repro_torch.dist.sharding import MeshShape
    from repro_torch.launch import perf
    from repro_torch.launch import steps as S
    from repro_torch.models.model_builder import build_model
    from repro_torch.serve.compressed import decompress_params

    gates: list = []

    def gate(key):
        def on_rung(tag, opts, entry, keep):
            first = keep["logits"]
            check(entry["finite"] and bool(torch.isfinite(first).all()),
                  f"{key} [{tag}]: non-finite logits")
            step, args = keep["step"], keep["args"]
            B, depth = entry["batch"], entry["cache_len"]
            if opts.nm:
                d = NM_GATE_BLOCKS.get(key)
                if d is None:
                    # the rung's replayed step ran from a fresh cache: the
                    # decompressed tree from a fresh one again
                    model, comp, kern = step.model, args[0], first
                    step.reset_cache(args[1])
                    cache = args[1]
                else:
                    # the rung's leaves cut to d blocks, their own step
                    # replayed from a fresh cache
                    model = build_model(step.model.cfg.replace(num_layers=d),
                                        device=args[2].device)
                    comp = dict(args[0], blocks={i: args[0]["blocks"][i]
                                                 for i in range(d)})
                    sub, _ = S.make_decode_step(
                        model, MeshShape(("data", "model"), (1, 1)),
                        ShapeCell(step.cell.name, depth, B, "decode"),
                        dataclasses.replace(opts, cache_len=depth))
                    cache = model.init_cache(B, depth)
                    with uncounted():
                        kern = sub.replay(comp, cache, *args[2:],
                                          fresh=True)[0].float().cpu()
                    sub.release()
                    sub.reset_cache(cache)
                dense = decompress_params(comp)
                with uncounted(), torch.no_grad():
                    ref = model.decode_step(dense, cache, *args[2:])[0]
                    ref = ref.float().cpu()
                del dense, cache
                e = errs(kern, ref)
                where = f"{d} block" if d else f"depth {entry['depth']}"
                check(e[1] <= NM_REL, f"{key} [{tag}] compressed vs dense "
                      f"first-step logits at {where}: rel {e[1]:.4g} (limit "
                      f"{NM_REL:g})")
                gates.append((key, tag, f"nm rel at {where}", e[1], NM_REL))
            if opts.kv_dtype == "int8" and not opts.nm:
                with uncounted():
                    r = perf.int8_cache_check(step, args)
                lim = min(INT8_TOL, INT8_SHARE * r["content"])
                check(r["max_abs"] < lim, f"{key} [{tag}] int8 vs bf16 "
                      f"filled-cache logits: max abs err {r['max_abs']:.4g} "
                      f"(limit {lim:.4g}: {INT8_TOL:g}, and {INT8_SHARE:g} × "
                      f"the cache content's {r['content']:.4g})")
                gates.append((key, tag, f"int8 max|Δ|, filled cache (content "
                              f"{r['content']:.4g})", r["max_abs"], lim))
        return on_rung

    zero_counts()
    out: dict = {}
    for key in perf.LADDERS:
        t0 = time.perf_counter()
        recs = perf.run_ladder(key, device="cuda", on_rung=gate(key))
        torch.cuda.synchronize()
        for r in recs:
            sp = ("" if "measured_speedup_vs_prev" not in r else
                  f"; ×{r['measured_speedup_vs_prev']:.2f} vs the previous "
                  f"rung, ×{r['measured_speedup_vs_baseline']:.2f} vs "
                  f"baseline (bound: ×{r['speedup_vs_prev']:.2f}, "
                  f"×{r['speedup_vs_baseline']:.2f})")
            label = f"ladder {key} [{r['tag']}]"
            print(f"  {label} depth {r['depth']}"
                  f"{' (' + ', '.join(r['cuts']) + ')' if r['cuts'] else ''}"
                  f", B {r['batch']}, cache {r['cache_len']}: "
                  + graph_fields(label, r, r["measured_ms"],
                                 r["step_s"] * 1e3)
                  + f", peak {r['peak_bytes'] / 1e9:.2f} GB; bound "
                  f"{r['bottleneck']} (memory_s "
                  f"{r['terms']['memory_s'] * 1e3:.3f}, compute_s "
                  f"{r['terms']['compute_s'] * 1e3:.3f}){sp}; predicted "
                  f"{r['prediction']}"
                  f"{'; ' + r['note'] if r['note'] else ''}")
        out[key] = {"records": recs, "seconds": time.perf_counter() - t0}
    counts = path_counts()
    out["by_shape"] = counts["nm_matmul_cuda"][1]
    out["rows_by_shape"] = counts["nm_sp_rows_kernel"][1]
    out["gates"] = gates
    for key, tag, what, val, lim in gates:
        print(f"  gate {key} [{tag}]: {what} {val:.4g} (limit {lim:g})")
    return out


def tooling_phase(gen, dev) -> dict:
    """Phase tooling: the dry run's sweep, its --measure, the perf ladders
    (the K2 launches of their nm rungs are this path's), then K2 checked
    and timed at the ladders' B = 128 shapes."""
    import torch

    t0 = time.perf_counter()
    print(f"phase tooling on {gpu_line()} (name, power limit); "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before it")
    sweep = tooling_sweep()
    t_sweep = time.perf_counter() - t0
    measured = tooling_measure(sweep)
    t_meas = time.perf_counter() - t0 - t_sweep
    ladders = tooling_ladders()
    by_shape = ladders.pop("by_shape")
    rows_by_shape = ladders.pop("rows_by_shape")
    t_prefill = time.perf_counter()
    prefill = tooling_prefill()
    t_prefill = time.perf_counter() - t_prefill
    rows, chk = [], {}
    for arch, shapes in TOOLING_K2.items():
        want = [(TOOLING_B, c, b, str(torch.bfloat16), 4) for c, b in shapes]
        check(all(by_shape.get(k, 0) > 0 for k in want),
              f"tooling: K2 not launched at {arch}'s B = {TOOLING_B} shapes: "
              f"{ {k: by_shape.get(k, 0) for k in want} }")
        # every one of those launches whose shape calls for the many-row
        # kernel ran it, and no other one did
        ran = [(k, rows_by_shape.get(k, 0), by_shape[k]) for k in want]
        check(all(n == (m if tc_mode(k[1], k[2], k[0]) == 3 else 0)
                  for k, n, m in ran),
              f"tooling: {arch}'s B = {TOOLING_B} K2 launches not on their "
              f"kernel (shape, many-row launches, launches): {ran}")
        chk[arch] = path_kernel_checks(gen, dev, f"{arch} B={TOOLING_B}", [],
                                       shapes, (TOOLING_B,))
    for arch in TOOLING_K2:
        rows += k2_times(gen, dev, chk[arch]["packs2"], chk[arch]["k2"],
                         by_shape, f"{arch} ladder", None, (TOOLING_B,))
        del chk[arch]["packs2"]
        torch.cuda.empty_cache()
    for r in rows:
        key = (TOOLING_B, *map(int, re.findall(r"\d+", r["shape"])[1:3]),
               "torch.bfloat16", 4)
        p = r["plan"]
        print(f"  K2 {r['path']} {r['shape']}: launches {r['launches']} "
              f"({rows_by_shape.get(key, 0)} on nm_sp_rows_kernel; plan mode "
              f"{p['mode']} ({r['kernel']}), tile {p['tile'][0]}×"
              f"{p['tile'][1]}, CS {p['cluster']}, {p['ctas']} CTAs), kernel "
              f"{r['ms']:.4f} ms, "
              + ("" if r["tc8_ms"] is None else
                 f"8-row kernel {r['tc8_ms']:.4f} ms, ")
              + f"torch.matmul "
              f"{r['library_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), err "
              f"{r['max_abs_err']:.3g}")
    secs = time.perf_counter() - t0
    print(f"phase tooling: {secs:.1f} s (sweep {t_sweep:.1f} s, measure "
          f"{t_meas:.1f} s, ladders "
          + ", ".join(f"{k.split('/')[0]} {v['seconds']:.1f} s"
                      for k, v in ladders.items() if k != "gates")
          + f", prefill {t_prefill:.1f} s)")
    return {"sweep": sweep, "measured": measured, "ladders": ladders,
            "prefill": prefill, "rows": rows, "seconds": secs}


def tooling_prefill() -> dict:
    """Tooling (d): ``make_prefill_step`` (JAX's jitted prefill) at
    tinyllama-1.1b's full width and depth on prefill_32k cut to B = 1 and
    PREFILL_SEQ tokens (``dryrun.timed_runs``): direct calls, then the
    step's graph (warm-up, capture, replays), the replay's last-token
    logits bitwise the direct call's."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES, ShapeCell
    from repro_torch.dist.sharding import MeshShape
    from repro_torch.launch import costmodel as CM
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as S
    from repro_torch.models.model_builder import build_model

    cfg = registry.get_config("tinyllama-1.1b")
    full = SHAPES["prefill_32k"]
    cell = ShapeCell(full.name, PREFILL_SEQ, 1, "prefill")
    model = build_model(cfg, device="cuda")
    step, a_args = S.make_prefill_step(
        model, MeshShape(("data", "model"), (1, 1)), cell)
    run = dryrun.timed_runs(step, 0, PREFILL_RUNS)
    ac = CM.step_cost(cfg, cell, a_args[0])
    line = dryrun.roofline(ac.flops, ac.hbm_bytes, dryrun.model_flops(
        cfg, a_args[0], cell)["model_flops"], 1)
    rec = dict(dryrun.run_fields(run), **line,
               step_ms=statistics.median(run["times"]),
               step_ms_all=run["times"], peak_bytes=run["peak"],
               logits_shape=list(run["first"].shape),
               finite=bool(torch.isfinite(run["first"].float()).all()))
    label = f"prefill tinyllama-1.1b {full.name} cut to B 1, {cell.seq_len}"
    check(rec["finite"] and rec["logits_shape"] == [1, 1, cfg.vocab_size],
          f"{label}: logits {rec['logits_shape']}, finite {rec['finite']}")
    print(f"  {label} tokens (of {full.global_batch} × {full.seq_len}), "
          f"full width and depth: "
          + graph_fields(label, rec, rec["step_ms"],
                         line["roofline_step_s"] * 1e3)
          + f"; {line['bottleneck']}, peak {run['peak'] / 1e9:.2f} GB")
    del run
    torch.cuda.empty_cache()
    return rec


def host_draw(tag: str, vocab: int, seed: int, index: int, batch: int,
              seq: int, tmp: str) -> None:
    """Batch ``index`` of the stream ``seed`` by numpy on the host
    (``SyntheticCorpus.sample``, the law's definition), saved with its
    seconds to ``tmp`` under ``tag``."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data.pipeline import SyntheticCorpus

    t0 = time.perf_counter()
    toks = SyntheticCorpus(vocab_size=vocab).sample(
        np.random.default_rng([seed, index]), batch, seq)
    np.save(f"{tmp}/{tag}_{index}.npy", toks)
    Path(f"{tmp}/{tag}_{index}.s").write_text(
        repr(time.perf_counter() - t0))


def start_host_draws(tmp: str) -> list:
    """One spawned process a batch of DRAWS, each on one host thread."""
    import os

    import torch.multiprocessing as mp

    from repro_torch.configs import registry

    ctx = mp.get_context("spawn")
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",
                                            "OPENBLAS_NUM_THREADS",
                                            "MKL_NUM_THREADS")}
    os.environ.update({k: "1" for k in saved})
    try:
        procs = [ctx.Process(target=host_draw, args=(
            name.replace(" ", "_"), registry.get_config(arch).vocab_size,
            seed, i, batch, seq, tmp), daemon=True)
                 for name, (arch, seed, n, batch, seq) in DRAWS.items()
                 for i in range(n)]
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return procs


def draws_check(procs: list, tmp: str, t_start: float, dev) -> dict:
    """The draws check: each of DRAWS drawn on the card through the float64
    chain (``calibration_batches``: its draws stay in the process's cache,
    so the later phases draw them no more) against numpy's host draw from
    ``start_host_draws``, token for token; the seconds of both."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import calibration_batches

    join_ranks(procs, max(1.0, DRAWS_TIMEOUT - (time.monotonic() - t_start)),
               "host draws")
    out = {}
    for name, (arch, seed, n, batch, seq) in DRAWS.items():
        cfg = registry.get_config(arch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = calibration_batches(cfg, num_samples=n * batch, seq_len=seq,
                                  batch=batch, seed=seed, device=dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        tag = name.replace(" ", "_")
        host_s = [float(Path(f"{tmp}/{tag}_{i}.s").read_text())
                  for i in range(n)]
        differ = sum(int((b["tokens"].cpu().numpy() != np.load(
            f"{tmp}/{tag}_{i}.npy")).sum()) for i, b in enumerate(got))
        check(differ == 0, f"draws {name}: {differ} tokens of the card's "
              f"draw differ from numpy's host draw")
        print(f"  draws {name} (vocab {cfg.vocab_size}, {n} × {batch} × "
              f"{seq} tokens): drawn on the card in {card_s:.3f} s (float64 "
              f"chain), numpy on the host {sum(host_s):.2f} s in all "
              f"({', '.join(f'{x:.2f}' for x in host_s)} s a batch, each in "
              f"a process of its own, nothing timed beside them); token for "
              f"token equal")
        out[name] = {"card_s": card_s, "host_s": host_s, "differ": differ}
    return out


def heldout_timing(model, params, cfg) -> dict:
    """JAX's ``jax.jit(model.loss)`` in ``heldout_loss``, measured: one
    4-batch call of the loss graphed in a scope of its own (capture
    included, as JAX compiles once a call) against the eager loss, in turns
    (eager, graphed, graphed, eager), on the slice ``heldout_loss`` scores;
    the losses bitwise equal.  ``heldout_loss`` runs the eager one: the
    graphed call was the slower (PERF.md, PR 26)."""
    import torch

    from repro_torch.data.pipeline import calibration_batches
    from repro_torch.util import graphs

    batches = calibration_batches(cfg, num_samples=32, seq_len=256, batch=8,
                                  seed=9999, device=model.device)

    def eager():
        return [float(model.loss(params, b)) for b in batches]

    def graphed():
        loss = graphs.graphed(model.loss, donate=("params",))
        with graphs.scope() as sc:
            got = [float(loss(params, b)) for b in batches]
            stats.append(sc.stats())
        return got

    stats: list = []
    times = {"eager": [], "graphed": []}
    losses = {}
    with torch.no_grad():
        for kind in ("eager", "graphed", "graphed", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses[kind] = eager() if kind == "eager" else graphed()
            torch.cuda.synchronize()
            times[kind].append(1e3 * (time.perf_counter() - t0))
    check(losses["eager"] == losses["graphed"] and
          all(st["graphs"] == 1 and st["replays"] == len(batches) - 1
              for st in stats),
          f"held-out loss: graphed {losses['graphed']} vs eager "
          f"{losses['eager']}, graphs {stats}")
    e, g = (statistics.mean(times[k]) for k in ("eager", "graphed"))
    print(f"  held-out loss, {len(batches)} batches of 8 × 256 on "
          f"tinyllama-1.1b at full width: eager "
          f"{', '.join(f'{x:.1f}' for x in times['eager'])} ms, graphed "
          f"(capture included) "
          f"{', '.join(f'{x:.1f}' for x in times['graphed'])} ms — mean "
          f"{e:.1f} / {g:.1f} ms; capture {stats[0]['capture_s']:.3f} s; "
          f"losses bitwise equal")
    return {"eager_ms": times["eager"], "graphed_ms": times["graphed"],
            "graphs": stats[0]}


def tooling_child(tmp: str) -> None:
    """The tooling phase in a spawned process on the still-empty card, its
    result saved to ``tmp/tooling.pt``: what its B = 128 ladders leave
    behind (cached segments, workspaces, their place in the allocator's
    history) leaves with the process, and the later phases find the card
    as they would without it."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    dev = resolve_device("cuda")
    for name in _build.SOURCES:
        _build.load(name)                  # built by phase 1
    out = tooling_phase(torch.Generator(device=dev).manual_seed(22), dev)
    torch.save(out, f"{tmp}/tooling.pt")


def pg_solves() -> dict:
    """The twelve method × pattern solves at phase 3's and the baselines
    phase's settings (Thanos unstructured B = 128, 2:4 B = 64; SparseGPT
    blocks of 64; p = 0.5)."""
    from repro_torch.core import magnitude, sparsegpt, thanos, wanda

    return {
        "thanos unstructured": (thanos.prune_unstructured,
                                {"p": 0.5, "block_size": 128}),
        "thanos 2:4": (thanos.prune_nm, {"n": 2, "m": 4, "block_size": 64}),
        "thanos structured": (thanos.prune_structured,
                              {"p": 0.5, "alpha": 0.1}),
        "sparsegpt unstructured": (sparsegpt.prune_unstructured,
                                   {"p": 0.5, "mask_blocksize": 64}),
        "sparsegpt 2:4": (sparsegpt.prune_nm,
                          {"n": 2, "m": 4, "blocksize": 64}),
        "sparsegpt structured": (sparsegpt.prune_structured,
                                 {"p": 0.5, "blocksize": 64}),
        "wanda unstructured": (wanda.prune_unstructured, {"p": 0.5}),
        "wanda 2:4": (wanda.prune_nm, {"n": 2, "m": 4}),
        "wanda structured": (wanda.prune_structured, {"p": 0.5}),
        "magnitude unstructured": (magnitude.prune_unstructured,
                                   {"p": 0.5}),
        "magnitude 2:4": (magnitude.prune_nm, {"n": 2, "m": 4}),
        "magnitude structured": (magnitude.prune_structured, {"p": 0.5}),
    }


def same_tree(a, b) -> bool:
    """Every leaf bitwise equal (tensors by ``torch.equal``)."""
    import torch
    from torch.utils import _pytree as pytree

    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def eager_blocks(adapter, params, batches, blocks: int, cell) -> tuple:
    """Alg. 3's first ``blocks`` blocks as a loop of eager public pieces,
    outside any graph scope: ``block_apply`` (pass 1 and 2),
    ``HessianAccumulator`` (K1) and the method's solver called directly
    (``__wrapped__``) → (params, masks (in, out) by path)."""
    import torch

    from repro_torch.core import thanos
    from repro_torch.core.hessian import HessianAccumulator
    from repro_torch.core.schedule import get_path, set_path

    carries = [adapter.prepare(params, b) for b in batches]
    masks = {}
    with torch.no_grad():
        for i in range(blocks):
            accs = {}
            for c in carries:
                for path, x in adapter.block_apply(params, i, c,
                                                   capture=True)[1].items():
                    if path not in accs:
                        accs[path] = HessianAccumulator.init(x.shape[-1],
                                                             x.device)
                    accs[path].update(x)
            for path in adapter.block_linear_paths(params, i):
                kernel = get_path(params, path)
                res = thanos.prune_nm.__wrapped__(
                    kernel.T, accs.pop(path).finalize(), n=cell.n, m=cell.m,
                    block_size=cell.block_size, percdamp=cell.percdamp,
                    row_chunk=cell.row_chunk, alpha=cell.alpha)
                params = set_path(params, path, res.weights.T.contiguous()
                                  .to(kernel.dtype))
                masks[path] = res.mask.T.contiguous()
            carries = [adapter.block_apply(params, i, c, capture=False)[0]
                       for c in carries]
    return params, masks


def prune_graphs_phase(gen, dev, pruned, report) -> dict:
    """prune-graphs: (a) the twelve solves at tinyllama's four full-width
    shapes, each key replayed against its direct eager call on two (W, H)
    pairs in turn, bitwise (weights, mask, loss), the direct call's and a
    replay's ms, the capture's seconds and its pool's bytes; (b) the first
    PG_BLOCKS blocks of phase 3's graphed prune against ``eager_blocks``
    from the same init and calibration: 0 differing mask entries, bf16
    weights max |Δ| 0.  Its launches are not the path's (``uncounted``)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import PruneConfig
    from repro_torch.core.schedule import get_path
    from repro_torch.data.pipeline import calibration_batches
    from repro_torch.models.model_builder import ModelAdapter, build_model
    from repro_torch.util import graphs

    t_phase = time.perf_counter()
    rows = []
    solves = pg_solves()
    for c, b in PG_SHAPES:
        pairs = []
        for _ in range(2):
            w = (torch.randn((c, b), generator=gen, device=dev)
                 / math.sqrt(b)).to(torch.bfloat16)
            x = torch.randn((1024, b), generator=gen, device=dev)
            pairs.append((w, 2.0 * (x.T @ x) / x.shape[0]))
        torch.cuda.synchronize()
        r0 = peak = torch.cuda.memory_reserved()
        for name, (fn, kw) in solves.items():
            want, eager, replay = [], [], []
            for p in pairs:
                t0 = time.perf_counter()
                want.append(fn.__wrapped__(*p, **kw))
                torch.cuda.synchronize()
                eager.append(time.perf_counter() - t0)
            # a scope a solve: its close reads the solve's pool bytes
            with graphs.scope() as sc:
                for k, s in enumerate((0, 1, 0, 1)):
                    t0 = time.perf_counter()
                    got = fn(*pairs[s], **kw)
                    torch.cuda.synchronize()
                    if k >= 2:
                        replay.append(time.perf_counter() - t0)
                    check(same_tree(got, want[s]),
                          f"prune-graphs (a): {name} at W ({c}, {b}), call "
                          f"{k}: not bitwise the direct call")
                peak = max(peak, torch.cuda.memory_reserved())
            st = sc.stats()
            check(st["graphs"] == 1 and st["replays"] == 3,
                  f"prune-graphs (a): {name} at W ({c}, {b}): {st}")
            rows.append({"solve": name, "shape": (c, b),
                         "eager_ms": 1e3 * min(eager),
                         "replay_ms": 1e3 * min(replay),
                         "capture_s": st["capture_s"],
                         "pool_bytes": st["pool_bytes"]})
        torch.cuda.synchronize()
        shape = [r for r in rows if r["shape"] == (c, b)]
        print(f"prune-graphs (a) W ({c}, {b}) bf16, H fp32: 12 solves "
              f"replayed bitwise the direct call (weights, mask, loss) on 2 "
              f"pairs in turn; reserved {r0 / 2**30:.2f} → "
              f"{peak / 2**30:.2f} GiB in the scopes → "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} after; direct / "
              f"replayed ms, capture s, pool MiB: " + "; ".join(
                  f"{r['solve']} {r['eager_ms']:.2f} / {r['replay_ms']:.2f}"
                  f", {r['capture_s']:.2f}, {r['pool_bytes'] / 2**20:.0f}"
                  for r in shape))
        del pairs, want, got

    cfg = get_config("tinyllama-1.1b")
    cell = PruneConfig("thanos", "nm", n=2, m=4, block_size=64)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    batches = calibration_batches(cfg, num_samples=16, seq_len=128, batch=8,
                                  device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager_p, eager_m = eager_blocks(ModelAdapter(model), params, batches,
                                    PG_BLOCKS, cell)
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    ndiff = sum(int((eager_m[p] != report.masks[p]).sum()) for p in eager_m)
    nall = sum(m.numel() for m in eager_m.values())
    dmax = max(float((get_path(eager_p, p).float()
                      - get_path(pruned, p).float()).abs().max())
               for p in eager_m)
    graphed_s = sum(r.seconds for r in report.layers
                    if r.path in eager_m)
    check(len(eager_m) == 7 * PG_BLOCKS and ndiff == 0 and dmax == 0.0,
          f"prune-graphs (b): {len(eager_m)} linears, {ndiff} mask entries "
          f"differ, bf16 weights max |Δ| {dmax}")
    print(f"prune-graphs (b) phase 3's first {PG_BLOCKS} blocks "
          f"({len(eager_m)} linears) against the eager loop (block_apply, "
          f"HessianAccumulator, thanos.prune_nm called directly): {ndiff} of "
          f"{nall} mask entries differ, bf16 weights max |Δ| {dmax:g}; "
          f"eager loop {t_eager:.2f} s, the graphed run's solves of those "
          f"linears {graphed_s:.2f} s")
    secs = time.perf_counter() - t_phase
    print(f"phase prune-graphs: {secs:.1f} s")
    return {"solves": rows, "blocks": {"linears": len(eager_m),
                                       "mask_diff": ndiff, "masks": nall,
                                       "weights_max_abs": dmax,
                                       "eager_s": t_eager,
                                       "graphed_solves_s": graphed_s},
            "seconds": secs}


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        fail(f"the port's sources are not beside this script ({src})")
    sys.path.insert(0, str(src))

    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import PruneConfig
    from repro_torch.core.masks import check_nm, nm_mask
    from repro_torch.core.sparsity import pack_nm
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, hessian_accum as K1, nm_spmm as K2
    from repro_torch.launch.prune import prune_arch
    from repro_torch.models.model_builder import build_model
    from repro_torch.serve.compressed import compress_params, compressed_bytes

    dev = resolve_device("cuda")          # also turns TF32 off
    gen = torch.Generator(device=dev).manual_seed(0)
    results: dict = {"gpu": gpu_line(), "device": torch.cuda.get_device_name(0)}
    t_all = time.perf_counter()

    # ---- 1. build ---------------------------------------------------------
    secs = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
        log = _build.BUILD_LOG.get(name, "")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill", log))
        if regs:
            print(f"  ptxas {name}: {len(regs)} kernels, {min(regs)}–"
                  f"{max(regs)} registers a thread, {spills} bytes of "
                  f"spill loads and stores")
        for kern, info in ptxas_entries(log, "xtx_wg_kernel"):
            print(f"  ptxas K1 wgmma <BM, BK, NST, MASK> {kern}: {info}")
        for kern, info in ptxas_entries(log, "nm_tc_kernel"):
            print(f"  ptxas K2 tensor-core {kern}: {info}")
        for kern, info in ptxas_entries(log, "nm_sp_rows_kernel"):
            print(f"  ptxas K2 many-row <idx_bits, BM, BN> {kern}: {info}")
        for kern, info in ptxas_entries(log, "nm_stacked_sp_dec_kernel"):
            name = f"nm_stacked_sp_dec_kernelILi{kern.strip('<>')}E"
            serial = any("C7520" in ln and name in ln
                         for ln in log.splitlines())
            print(f"  ptxas K3 decode <idx_bits> {kern}: {info}; wgmma "
                  f"serialized by ptxas (C7520): {serial}")
        dec = ptxas_entries(log, "nm_sp_dec_kernel")
        if dec:
            regs = [int(re.search(r"Used (\d+) registers", i)[1])
                    for _, i in dec]
            print(f"  ptxas K2 decode: {len(dec)} variants <idx_bits, N>, "
                  f"{min(regs)}–{max(regs)} registers a thread; "
                  + "; ".join(f"{k} {i}" for k, i in dec
                              if k in ("<4, 8>", "<8, 64>")))
    print(f"phase build: {len(_build.SOURCES)} kernels in {secs:.2f} s")
    results["build_seconds"] = secs

    # ---- tooling: dry run, --measure, the perf ladders, K2 at B = 128 -----
    # first, on an empty card: the ladders' B = 128 caches and int8-kv's
    # 16 GiB dequant temporaries need it nearly whole and unfragmented (by
    # phase 5 the script holds ~20 GiB); in a child process of its own
    # generator, so the later phases draw what they drew before it and
    # find the card's memory as they would without it
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tooling-", dir=ROOT / "build"))
    child = mp.get_context("spawn").Process(target=tooling_child,
                                            args=(str(tmp),))
    sys.stdout.flush()                     # the child writes to it too
    child.start()
    join_ranks([child], TOOLING_TIMEOUT, "tooling")
    tooling = torch.load(tmp / "tooling.pt", weights_only=False)
    shutil.rmtree(tmp, ignore_errors=True)
    results["tooling"] = {k: v for k, v in tooling.items() if k != "rows"}
    torch.cuda.empty_cache()

    # ---- draws: the held-out and calibration slices drawn on the card ----
    # numpy's host draws, after the tooling phase: its B = 1 cells are
    # launch-bound, and host processes beside them would slow them
    draws_tmp = tempfile.mkdtemp(prefix="draws-", dir=ROOT / "build")
    t_draws = time.monotonic()
    draw_procs = start_host_draws(draws_tmp)
    results["draws"] = draws_check(draw_procs, draws_tmp, t_draws, dev)
    shutil.rmtree(draws_tmp, ignore_errors=True)

    # ---- 2. kernels vs plain ---------------------------------------------
    k1_err: dict = {}
    n1, worst1 = 0, (0.0, 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        for b in (2048, 5632):
            x = torch.randn((1024, b), generator=gen, device=dev).to(dtype)
            acc_k = [torch.zeros((b, b), device=dev), torch.zeros((), device=dev),
                     torch.zeros((), device=dev)]
            acc_p = [t.clone() for t in acc_k]
            for _ in range(2):                    # twice: the sum accumulates
                K1.hessian_update_cuda(x, None, *acc_k)
                K1.hessian_update_plain(x, None, *acc_p)
            torch.cuda.synchronize()
            e = errs(acc_k[0], acc_p[0])
            # fp32 sums in another order: rtol 1e-3 / atol 2e-2
            check(torch.allclose(acc_k[0], acc_p[0], rtol=1e-3, atol=2e-2)
                  and torch.equal(acc_k[0], acc_k[0].T),
                  f"K1 {dtype} b={b}: max abs err {e[0]:.3g} or asymmetric")
            check(float(acc_k[1]) == float(acc_p[1]) == 2048.0,
                  f"K1 {dtype} b={b}: count {float(acc_k[1])}")
            k1_err[(1024, b, str(dtype))] = e
            n1 += 1
            worst1 = max(worst1, e)
    for dtype in (torch.float32, torch.bfloat16):
        b = 2048
        x = torch.randn((1024, b), generator=gen, device=dev).to(dtype)
        valid = torch.rand((1024,), generator=gen, device=dev) < 0.5
        x[~valid] = torch.nan                     # garbage in invalid rows
        acc_k = [torch.zeros((b, b), device=dev), torch.zeros((), device=dev),
                 torch.zeros((), device=dev)]
        acc_p = [t.clone() for t in acc_k]
        K1.hessian_update_cuda(x, valid, *acc_k)
        K1.hessian_update_plain(x, valid, *acc_p)
        torch.cuda.synchronize()
        e = errs(acc_k[0], acc_p[0])
        check(torch.allclose(acc_k[0], acc_p[0], rtol=1e-3, atol=2e-2)
              and torch.equal(acc_k[0], acc_k[0].T)
              and float(acc_k[1]) == float(valid.sum())
              and float(acc_k[2]) == 0.0,
              f"K1 masked rows {dtype}: err {e[0]:.3g}, count "
              f"{float(acc_k[1])} vs {int(valid.sum())}")
        x = torch.randn((1024, b), generator=gen, device=dev).to(dtype)
        x[7, 11] = torch.nan                      # a poisoned valid row
        acc_k = [torch.zeros((b, b), device=dev), torch.zeros((), device=dev),
                 torch.zeros((), device=dev)]
        K1.hessian_update_cuda(x, None, *acc_k)
        torch.cuda.synchronize()
        check(float(acc_k[0].abs().max()) == 0.0 and float(acc_k[1]) == 0.0
              and float(acc_k[2]) == 1.0, f"K1 NaN batch {dtype} not skipped")
        n1 += 2
        worst1 = max(worst1, e)
    print(f"kernels: hessian_xtx (cuda) vs plain: {n1} checks ok, max abs err "
          f"{worst1[0]:.3g}, max rel err {worst1[1]:.3g} "
          f"(rtol 1e-3 / atol 2e-2; xtx exactly symmetric; masked rows and "
          f"NaN skip exact)")

    packs: dict = {}
    k2_err: dict = {}
    n2, worst2 = 0, {torch.float32: (0.0, 0.0), torch.bfloat16: (0.0, 0.0)}
    cases = [(c, b, B, 2, 4) for c, b in SERVE_K2 for B in (1, 4)]
    cases += [(37, 96, 3, 2, 4), (37, 96, 3, 5, 8)]
    for (c, b, B, n, m) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            w = (torch.randn((c, b), generator=gen, device=dev)
                 / math.sqrt(b)).to(dtype)
            xn = torch.rand((b,), generator=gen, device=dev) + 0.5
            mask = nm_mask(w.float(), xn, n, m)
            x = torch.randn((B, b), generator=gen, device=dev).to(dtype)
            for bits in (4, 8):
                pk = pack_nm(w, mask, n, m, idx_bits=bits)
                y_k = K2.nm_matmul_cuda(x, pk.values, pk.indices, n=n, m=m,
                                        b=b, idx_bits=bits)
                y_p = K2.nm_matmul_plain(x, pk.values, pk.indices, n, m, b,
                                         bits)
                torch.cuda.synchronize()
                e = errs(y_k, y_p)
                # fp32: sum order only (1e-4); bf16: one output rounding
                # each side (rtol 2e-2 / atol 1e-2)
                tol = ((1e-4, 1e-4) if dtype == torch.float32
                       else (2e-2, 1e-2))
                check(y_k.shape == (B, c) and y_k.dtype == dtype and
                      torch.allclose(y_k.float(), y_p.float(), rtol=tol[0],
                                     atol=tol[1]),
                      f"K2 c={c} b={b} B={B} {n}:{m} {dtype} idx{bits}: "
                      f"max abs err {e[0]:.3g}")
                k2_err[(B, c, b, str(dtype), bits)] = e
                worst2[dtype] = max(worst2[dtype], e)
                n2 += 1
                if dtype == torch.bfloat16 and bits == 4 and (c, b) in \
                        SERVE_K2:
                    packs[(c, b)] = (pk, w.masked_fill(mask > 0.5, 0))
    print(f"kernels: nm_matmul (cuda) vs plain: {n2} checks ok; max abs/rel "
          f"err fp32 {worst2[torch.float32][0]:.3g}/"
          f"{worst2[torch.float32][1]:.3g} (rtol 1e-4 / atol 1e-4), bf16 "
          f"{worst2[torch.bfloat16][0]:.3g}/{worst2[torch.bfloat16][1]:.3g} "
          f"(rtol 2e-2 / atol 1e-2)")
    moe_chk = moe_kernel_checks(gen, dev)
    redesign_checks(gen, dev)
    k2_tc_checks(gen, dev)
    k3_dec_checks(gen, dev)
    mla_chk = path_kernel_checks(gen, dev, "MLA", MLA_K1, MLA_K2)
    gemma_chk = path_kernel_checks(gen, dev, "gemma3", GEMMA_K1, GEMMA_K2)
    fam_chk = {"zamba2-7b": path_kernel_checks(gen, dev, "zamba2", ZAMBA_K1,
                                               ZAMBA_K2),
               "xlstm-1.3b": path_kernel_checks(gen, dev, "xlstm", XLSTM_K1,
                                                XLSTM_K2),
               "whisper-medium": path_kernel_checks(
                   gen, dev, "whisper", WHISPER_K1, WHISPER_K2, WHISPER_B)}
    dense2_chk = {arch: path_kernel_checks(gen, dev, arch, DENSE2_K1[arch],
                                           DENSE2_K2[arch])
                  for arch in DENSE2_LAYERS}

    # ---- 3. main path: prune ----------------------------------------------
    zero_counts()
    torch.cuda.synchronize()
    r0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    pruned, report, out = prune_arch(
        "tinyllama-1.1b",
        PruneConfig("thanos", "nm", n=2, m=4, block_size=64),
        reduced=False, device="cuda", log=None)
    torch.cuda.synchronize()
    t_prune = time.perf_counter() - t0
    cfg = get_config("tinyllama-1.1b")
    check(all(check_nm(mk.T, 2, 4) for mk in report.masks.values()),
          "a pruned linear breaks 2:4")
    check(len(report.masks) == 7 * cfg.num_layers,
          f"{len(report.masks)} pruned linears")
    check(abs(out["mean_sparsity"] - 0.5) < 1e-9,
          f"sparsity {out['mean_sparsity']}")
    check(math.isfinite(out["dense_loss"]) and
          math.isfinite(out["pruned_loss"]), "non-finite held-out loss")
    check(all(r.fallback == "" for r in report.layers),
          "a layer fell back to magnitude pruning")
    print(f"phase prune: tinyllama-1.1b full width (d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, {cfg.num_layers} layers), thanos 2:4 B=64: "
          f"dense loss {out['dense_loss']:.4f}, pruned loss "
          f"{out['pruned_loss']:.4f}, sparsity {out['mean_sparsity']:.4f}, "
          f"prune {out['prune_seconds']:.1f} s (phase {t_prune:.1f} s), "
          f"K1 launches {K1.hessian_update_cuda.launches} (expect "
          f"{2 * 7 * cfg.num_layers})")
    results["prune"] = dict(out, phase_seconds=t_prune)
    graphs_line("tinyllama-1.1b", out["graphs"], out["prune_seconds"], r0)

    # ---- prune-graphs: the solves and phase 3's blocks against eager -----
    with uncounted():
        results["prune_graphs"] = prune_graphs_phase(gen, dev, pruned,
                                                     report)
    torch.cuda.empty_cache()

    # ---- 4. compress + serve ------------------------------------------
    comp = compress_params(pruned, report.masks, 2, 4)
    cb, db = compressed_bytes(comp)
    check(abs(cb / db - 0.625) < 1e-6, f"compressed ratio {cb / db}")
    model = build_model(cfg, device="cuda")
    prompts = request_prompts(cfg.vocab_size)
    done, t_serve, engine = serve_requests(model, comp, prompts)
    k1_launches = K1.hessian_update_cuda.launches
    k2_launches = K2.nm_matmul_cuda.launches
    k1_main = dict(K1.hessian_update_cuda.by_shape)
    k2_main = dict(K2.nm_matmul_cuda.by_shape)
    ntok = sum(len(r.out) for r in done)
    check(k1_launches > 0 and k2_launches > 0,
          f"main path launches K1 {k1_launches} K2 {k2_launches}")
    # the decode kernel ran every launch whose shape calls for it, and no
    # other one (none here: at tinyllama's widths the 8-row kernel ran as
    # fast in the decode sweep; its own path is the dense2 phase's)
    dec_want = sum(n for (B, c, b, dt, bits), n in k2_main.items()
                   if tc_mode(c, b, B, bits) == 4)
    check(K2.nm_sp_dec.launches == dec_want,
          f"main path: nm_sp_dec_kernel launched {K2.nm_sp_dec.launches} "
          f"times, {dec_want} of the serve's K2 launches call for it")
    st = engine.stats
    print(f"phase serve: compressed {cb / db:.4f} of dense bf16 bytes on "
          f"the pruned linears ({cb / 2**20:.1f} MiB vs "
          f"{db / 2**20:.1f} MiB); 4 requests, {ntok} tokens in "
          f"{t_serve:.2f} s ({ntok / t_serve:.1f} tok/s, "
          f"{st['decode_steps']} decode steps, {st['prefills']} prefills)"
          f"; K2 launches {k2_launches} (154 per decode step; "
          f"{K2.nm_sp_dec.launches} on nm_sp_dec_kernel)")
    print(f"  req 0: {done[0].out}")

    e = first_step_line(model, comp, prompts)
    agree = e[2]
    results["heldout_loss"] = heldout_timing(model, pruned, cfg)
    model8 = build_model(cfg.replace(kv_cache_dtype="int8"), device="cuda")
    done8, t_serve8, engine8 = serve_requests(model8, comp, prompts)
    # 22 random-init layers amplify the int8 rounding as they amplify the
    # summation order (first-step rel above): held to the reference's
    # absolute bound only
    int8 = int8_cache_line("tinyllama-1.1b", model, model8, comp, prompts,
                           engine, engine8, ntok / t_serve,
                           sum(len(r.out) for r in done8) / t_serve8, None)

    # ---- graphs: the engine's captured steps against the eager loop ------
    graphs = {
        "tinyllama-1.1b bf16": graphs_case("tinyllama-1.1b bf16", model, comp,
                                           prompts),
        "tinyllama-1.1b int8": graphs_case("tinyllama-1.1b int8", model8,
                                           comp, prompts),
        "tinyllama-1.1b paged": graphs_case(
            "tinyllama-1.1b paged", model, comp, prompts, paged=True,
            page_size=PAGE)}

    # ---- train: the CLI, a bitwise restart, the sparse finetune ----------
    train = train_phase(cfg, model, pruned, report, prompts, dev,
                        out["pruned_loss"])
    results["train"] = {k: ({kk: vv for kk, vv in v.items()
                             if kk != "counts"} if isinstance(v, dict)
                            else v) for k, v in train.items()}

    # ---- paged: the paged KV cache on phase 4's tree ----------------------
    paged = paged_tinyllama(cfg, model, model8, comp, prompts, done, done8)
    results["paged"] = {"tinyllama": {k: v for k, v in paged.items()
                                      if k != "counts"}}

    # ---- robust: supervised serving, snapshots, prune jobs, HTTP ---------
    robust = robust_phase(cfg, model, comp, prompts, done, dev)
    results["robust"] = {k: v for k, v in robust.items() if k != "counts"}
    del engine8, model8
    results["serve"] = {"ratio": cb / db, "tokens": ntok,
                        "seconds": t_serve, "tok_per_s": ntok / t_serve,
                        "stats": st, "logits_max_abs_err": e[0],
                        "logits_rel_err": e[1], "argmax_agree": agree,
                        "k1_launches": k1_launches,
                        "k2_launches": k2_launches, "int8": int8}

    # ---- dist: phase 3's prune and the train step over two ranks ---------
    dph = dist_phase(cfg, pruned, report, comp, dev)
    results["dist"] = {k: v for k, v in dph.items() if k != "counts"}
    del pruned, comp, engine, model
    torch.cuda.empty_cache()

    # ---- baselines: SparseGPT, Wanda, magnitude on phase 3's dense tree ---
    # prune_arch's dense tree: the same seed-0 init, so phase 3's held-out
    # loss of it holds
    dense = build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    base = baselines_phase(dev, dense, out["dense_loss"])
    results["baselines"] = {k: v for k, v in base.items() if k != "counts"}
    torch.cuda.empty_cache()

    # ---- plan: the mixed recipe, then the sparsity allocation -------------
    plan = plan_phase(dev, dense, out["dense_loss"])
    results["plan"] = {k: v for k, v in plan.items() if k != "counts"}
    del dense
    torch.cuda.empty_cache()

    # ---- 4m. MoE path: prune → stacked compress → serve --------------------
    moe = moe_phase(dev)
    results["moe"] = {k: v for k, v in moe.items() if k != "by_shape"}
    torch.cuda.empty_cache()

    # ---- mla. MLA path: prune → compress → serve, bf16 and int8 caches ---
    mla = mla_phase(dev)
    mla_paged = mla.pop("paged")
    results["mla"] = {k: v for k, v in mla.items() if k != "by_shape"}
    results["paged"][MLA_ARCH] = {k: v for k, v in mla_paged.items()
                                  if k != "counts"}
    torch.cuda.empty_cache()

    # ---- paged: gemma3-1b prune → compress → serve, the mixed layout -----
    gemma = gemma3_phase(dev)
    results["paged"][GEMMA_ARCH] = {k: v for k, v in gemma.items()
                                    if k != "by_shape"}
    torch.cuda.empty_cache()
    t_paged = paged["seconds"] + mla_paged["seconds"] + gemma["seconds"]
    results["paged"]["seconds"] = t_paged
    print(f"phase paged: {t_paged:.1f} s over its three parts")

    # ---- families: zamba2, xlstm, whisper prune → compress → decode --------
    fams = families_phase(dev, gen)
    results["families"] = {k: ({kk: vv for kk, vv in v.items()
                                if kk != "by_shape"}
                               if isinstance(v, dict) else v)
                           for k, v in fams.items()}

    graphs[MOE_ARCH] = moe["graphs"]
    for arch in ("zamba2-7b", "xlstm-1.3b"):
        graphs[arch] = fams[arch]["graphs"]
    t_graphs = sum(g["seconds"] for g in graphs.values())
    results["graphs"] = dict(graphs, seconds=t_graphs)
    print(f"phase graphs: {len(graphs)} cases in {t_graphs:.1f} s, tokens "
          f"identical to the eager loop in each; logits max |Δ| "
          + ", ".join(f"{k} {g['logits_max_abs_diff']:.6g}"
                      for k, g in graphs.items())
          + "; captured / eager tok/s "
          + ", ".join(f"{k} {g['graph_tok_per_s']:.1f} / "
                      f"{g['eager_tok_per_s']:.1f}"
                      for k, g in graphs.items()))

    # ---- dense2: danube, mistral, internvl prune → compress → serve -------
    dense2 = dense2_phase(dev)
    results["dense2"] = {k: ({kk: vv for kk, vv in v.items()
                              if kk != "by_shape"}
                             if isinstance(v, dict) else v)
                         for k, v in dense2.items()}
    # the decode kernel's path: mistral-large-123b served at full width, its
    # counts set to 0 before the arch and read after it (family_counts held
    # every one of its launches against the plan)
    dec_shapes = dense2["mistral-large-123b"]["by_shape"]["nm_sp_dec_kernel"]
    check(sum(dec_shapes.values()) > 0,
          "dense2 mistral-large-123b: nm_sp_dec_kernel never launched")
    print(f"  decode kernel's path (mistral-large-123b serve): "
          f"{sum(dec_shapes.values())} nm_sp_dec_kernel launches, by (B, c, "
          f"b) {dict(sorted((k[:3], n) for k, n in dec_shapes.items()))}")

    # ---- 5. times at the main-path shapes ---------------------------------
    results["k1_trace"] = k1_trace(dev)
    entries = []
    for tok, b in [(1024, 2048), (1024, 5632)] + K1_LONG:
        x = torch.randn((tok, b), generator=gen, device=dev).to(torch.bfloat16)
        x32 = x.float()
        acc = [torch.zeros((b, b), device=dev), torch.zeros((), device=dev),
               torch.zeros((), device=dev)]
        key = (tok, b, str(torch.bfloat16))
        if tok != 1024:                # held against the plain version here
            acc_p = [t.clone() for t in acc]
            K1.hessian_update_cuda(x, None, *acc)
            K1.hessian_update_plain(x, None, *acc_p)
            torch.cuda.synchronize()
            k1_err[key] = errs(acc[0], acc_p[0])
            check(torch.allclose(acc[0], acc_p[0], rtol=1e-3, atol=2e-2)
                  and torch.equal(acc[0], acc[0].T)
                  and float(acc[1]) == float(acc_p[1]) == tok,
                  f"K1 ({tok}, {b}): err {k1_err[key][0]:.3g}")
            del acc_p
        ms = device_ms(lambda: K1.hessian_update_cuda(x, None, *acc), 10)
        eager = k1_eager_fields(lambda: K1.hessian_update_cuda(x, None, *acc))
        plain = device_ms(lambda: K1.hessian_update_plain(x, None, *acc), 10)
        lib = device_ms(lambda: torch.addmm(acc[0], x32.T, x32), 10)
        lib_bf16 = addmm_bf16_ms(acc[0], x, 10)
        nbytes = x.numel() * 2 + 2 * b * b * 4
        t_b, t_o = nbytes / HBM_BYTES_PER_S, k1_ops(tok, b) / PEAK_OPS[
            "bfloat16"]
        path_launches = {name: ph["counts"]["hessian_update_cuda"][1].get(
            key, 0) for name, ph in (("baselines", base), ("plan", plan))}
        path_launches["robust"] = robust["counts"][
            "hessian_update_cuda"].get(key, 0)
        path_launches["dist"] = dph["counts"]["hessian_update_cuda"][
            1].get(key, 0)
        entries.append({
            "name": "hessian_xtx", "shape": f"x ({tok}, {b}) bf16",
            "route": "cuda",
            "path": ("tinyllama-1.1b" if tok == 1024
                     else "none: calibration batches of 8 × 2 048"),
            "source": "src/repro_torch/kernels/csrc/hessian_xtx.cu",
            "replaces": "src/repro/kernels/hessian_accum.py:66",
            "launches": k1_main.get(key, 0),
            "max_abs_err": k1_err[key][0], "ms": ms, **eager,
            "plain_ms": plain,
            "bound_ms": 1e3 * max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": lib, "library_bf16_ms": lib_bf16,
            "path_launches": path_launches,
            **k1_plan_fields(x, None, acc[0])})
        del x, x32, acc
        torch.cuda.empty_cache()
    entries += k2_times(gen, dev, packs, k2_err, k2_main, "tinyllama-1.1b",
                        {**{name: ph["counts"]["nm_matmul_cuda"][1]
                            for name, ph in (("baselines", base),
                                             ("plan", plan),
                                             ("paged", paged))},
                         "robust": robust["counts"]["nm_matmul_cuda"],
                         "dist": dph["counts"]["nm_matmul_cuda"][1]})
    entries += moe_times(gen, dev, moe_chk, moe)
    entries += path_times(gen, dev, mla_chk, mla["by_shape"], MLA_ARCH,
                          MLA_K1,
                          {"paged": mla_paged["counts"]["nm_matmul_cuda"][1]})
    entries += path_times(gen, dev, gemma_chk, gemma["by_shape"], GEMMA_ARCH,
                          GEMMA_K1)
    for arch, k1_bs in (("zamba2-7b", ZAMBA_K1), ("xlstm-1.3b", XLSTM_K1),
                        ("whisper-medium", WHISPER_K1)):
        entries += path_times(gen, dev, fam_chk[arch],
                              fams[arch]["by_shape"], arch, k1_bs,
                              batches=(WHISPER_B if arch == "whisper-medium"
                                       else (1, 4)))
    for arch in DENSE2_LAYERS:
        entries += path_times(gen, dev, dense2_chk[arch],
                              dense2[arch]["by_shape"], arch,
                              DENSE2_K1[arch])

    entries += tooling["rows"]
    torch.cuda.synchronize()
    print(f"phase times on {results['gpu']} (name, power limit):")
    for e in entries:
        tc = e["library_bf16_ms"]
        tc = "" if tc is None else (f" (bf16 {tc:.4f})"
                                    if isinstance(tc, float) else f" ({tc})")
        print(f"  {e['name']:17s} {e['shape']:40s} launches "
              f"{e['launches']:6d}"
              f"  kernel {e['ms']:.4f} ms (eager {e['eager_ms']:.4f})  "
              f"plain {e['plain_ms']:.4f} ms  "
              f"library {e['library_ms']:.4f} ms{tc}  bound "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']})  err vs plain "
              f"{e['max_abs_err']:.3g}")
        if e["name"] == "hessian_xtx":
            p = e["plan"]
            before = K1_EARLIER_MS.get(e["shape"])
            print(f"      plan {p['variant']} BM {p['tile']} CS "
                  f"{p['cluster']} prefetch {p['prefetch_eighths']}/8, smem "
                  f"{p['smem']} B; mma.sync kernel recorded "
                  + ("none" if before is None else f"{before:.4f} ms")
                  + f"; {e['bound_ms'] / e['ms']:.0%} of the bound; eager "
                  f"over replay {1e3 * (e['eager_ms'] - e['ms']):+.1f} µs "
                  f"(median of five runs "
                  f"{1e3 * (e['eager_median_ms'] - e['ms']):+.1f} µs)")
        if e["name"] == "nm_matmul_stacked":
            print(f"      plan {tuple(e['plan'])} ({e['kernel']}); the "
                  f"mode-2 kernel now {e['earlier_ms']:.4f} ms; torch.bmm over "
                  f"the "
                  f"{e['active_experts']} active experts only "
                  f"{e['library_active_ms']:.4f} ms; "
                  f"{e['bound_ms'] / e['ms']:.0%} of the bound")
        if e["name"] == "nm_matmul":
            p = e["plan"]
            shape = re.sub(r" 2:4 bf16$", "", e["shape"])
            before = WARP_ROW_K2_MS.get(shape)
            before = "none" if before is None else f"{before:.4f}"
            tc8 = ""
            if e["tc8_ms"] is not None:
                rec = MODE2_K2_MS.get(shape, TC8_K2_MS.get(shape))
                tc8 = (f"; 8-row kernel now {e['tc8_ms']:.4f} ms (recorded "
                       f"{'none' if rec is None else f'{rec:.4f}'})")
            print(f"      plan mode {p['mode']} ({e['kernel']}) CS "
                  f"{p['cluster']} tile {p['tile'][0]}×{p['tile'][1]} smem "
                  f"{p['smem']} B, {p['ctas']} CTAs; warp-per-row kernel "
                  f"now {e['warp_row_ms']:.4f} ms (recorded {before}){tc8}")
    steps = {}
    for path, st in (("tinyllama-1.1b", results["serve"]["stats"]),
                     (MOE_ARCH, moe["stats"]),
                     (MLA_ARCH, mla["stats_both"]),
                     (GEMMA_ARCH, gemma["stats"]),
                     ("zamba2-7b", fams["zamba2-7b"]["engine_stats"]),
                     ("xlstm-1.3b", fams["xlstm-1.3b"]["engine_stats"]),
                     *((arch, dense2[arch]["engine_stats"])
                       for arch in DENSE2_LAYERS)):
        steps[path] = k2_step_line(
            [e for e in entries if e["name"] == "nm_matmul"
             and e["path"] == path], st, path)
    k1 = [e for e in entries if e["name"] == "hessian_xtx"]
    lib1 = [e["launches"] * e["library_bf16_ms"] for e in k1
            if isinstance(e["library_bf16_ms"], float)]
    wg = {K1.K1_WG, K1.K1_WG_TIGHT, K1.K1_WG_DEEP}
    earlier = sum(e["launches"] * K1_EARLIER_MS.get(e["shape"], 0.0)
                  for e in k1)
    print(f"  K1 launch-weighted over every path: "
          f"{sum(e['launches'] * e['ms'] for e in k1):.2f} ms, bf16 addmm "
          + (f"{sum(lib1):.2f} ms" if len(lib1) == len(k1)
             else "not available")
          + f", bound {sum(e['launches'] * e['bound_ms'] for e in k1):.2f} "
          f"ms, mma.sync kernel recorded {earlier:.2f} ms; every path row "
          f"on the wgmma kernel: "
          f"{all(e['plan']['code'] in wg for e in k1)}")
    long_cs = {e["plan"]["cluster"] for e in k1
               if e["shape"].startswith(f"x ({K1_LONG[0][0]},")}
    check(1 in long_cs and len(long_cs) > 1,
          f"K1's {K1_LONG[0][0]}-token rows must time both a split and an "
          f"unsplit plan; they planned CS {sorted(long_cs)}")
    check(all(e["plan"]["code"] in wg for e in k1),
          "a K1 path row (bf16, b % 8 == 0) is not planned on the wgmma "
          "kernel: " + str([(e["shape"], e["plan"]) for e in k1
                            if e["plan"]["code"] not in wg]))
    k2 = [e for e in entries if e["name"] == "nm_matmul"]
    results["k2_steps"] = steps
    print(f"  K2 launch-weighted over every path: "
          f"{sum(e['launches'] * e['ms'] for e in k2):.2f} ms, library "
          f"{sum(e['launches'] * e['library_ms'] for e in k2):.2f} ms, "
          f"bound {sum(e['launches'] * e['bound_ms'] for e in k2):.2f} ms, "
          f"warp-per-row kernel "
          f"{sum(e['launches'] * e['warp_row_ms'] for e in k2):.2f}"
          f" ms; every path launch on its tensor-core plan (mode 3 from B = "
          f"{K2._ROWS_MIN_B}, mode 4 below it where the plan's rule takes "
          f"it, else 2): {all(e['plan']['mode'] == k2_mode(e) for e in k2)}")
    moved = [e for e in k2
             if re.sub(r" 2:4 bf16$", "", e["shape"]) in MODE2_K2_MS]
    now = sum(e["launches"] * e["ms"] for e in moved)
    rec = sum(e["launches"] * MODE2_K2_MS[re.sub(r" 2:4 bf16$", "",
                                                 e["shape"])]
              for e in moved)
    tc8 = sum(e["launches"] * (e["ms"] if e["tc8_ms"] is None
                               else e["tc8_ms"]) for e in moved)
    results["k2_totals"] = {
        "all_ms": sum(e["launches"] * e["ms"] for e in k2),
        "before_ms": K2_BEFORE_MS, "mode2_rows": len(moved),
        "mode2_rows_ms": now, "mode2_rows_recorded_ms": rec,
        "mode2_rows_mode2_now_ms": tc8, "mode2_rows_before_ms": MODE2_ROWS_MS}
    print(f"  K2 launch-weighted {results['k2_totals']['all_ms']:.2f} ms "
          f"against {K2_BEFORE_MS} ms before the decode kernel; the "
          f"{len(moved)} rows that ran "
          f"mode 2 in PERF.md's table: {now:.2f} ms against its "
          f"{MODE2_ROWS_MS} ms (its recorded times at this run's launches "
          f"{rec:.2f} ms; the 8-row kernel timed now {tc8:.2f} ms); on the "
          f"decode kernel (mode 4): "
          f"{sum(e['plan']['mode'] == 4 for e in moved)} of them")
    check(all(e["plan"]["mode"] == k2_mode(e) for e in k2),
          "a K2 path shape is not planned on its tensor-core path: "
          + str([(e["shape"], e["plan"]) for e in k2
                 if e["plan"]["mode"] != k2_mode(e)]))
    results["kernels"] = entries
    results["prune_graphs"]["prunes"] = GRAPH_LINES
    print("  prune seconds with graphs: " + ", ".join(
        f"{k} {v['seconds']:.2f}" for k, v in GRAPH_LINES.items()))
    results["seconds"] = time.perf_counter() - t_all
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1,
                                                        default=str))
    print(f"total {results['seconds']:.1f} s")
    print(f"gpu: {results['gpu']}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
