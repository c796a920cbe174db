// K1: fused calibration-Hessian update for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/hessian_accum.py::hessian_xtx
// (body _hess_kernel), and fuses in what HessianAccumulator.update does
// around its matmul (repro/core/hessian.py):
//   * rows whose `valid` byte is 0 count as zero rows (masked BEFORE the
//     finiteness check, so garbage in an invalid row cannot poison a batch);
//   * a batch holding any non-finite value in a valid row is skipped whole;
//   * xtx += XᵀX in place, fp32 sums whatever the input type (NOT 2·XᵀX:
//     the accumulator stores XᵀX and finalize doubles it);
//   * count += valid rows, or skipped += 1 — on device, no host sync.
//
// Two launches on the caller's stream.  scan_kernel reduces the batch's
// finiteness and valid-row count into stats[0..1]: one block for small x,
// else up to 264 blocks whose last folds in the others' parts (no memset:
// the stream's scratch keeps its ticket at zero).  The product kernel is
// launched as a programmatic dependent of the scan (griddepcontrol): it
// computes its tile while the scan runs and waits for the scan's verdict
// only before its epilogue, where one thread updates count/skipped and a
// skipped batch returns without writing.  The scan's 264 blocks leave every
// SM room for product blocks, so the two overlap.
//
// Bound on the H100: tokens·b² operations on the symmetric half against a
// read of X and a read + write of the (b, b) fp32 xtx.  At the main-path
// shape (tokens 1024, b 5632) that is 32.5 GFLOP and 265 MB: at the bf16
// tensor-core peak (989 TFLOP/s; bf16×bf16 products are exact in fp32) the
// operations take 0.033 ms and the bytes 0.079 ms at 3.35 TB/s, so the work
// is bytes-bound; chip_smoke.py reports that bound.  Two things stand
// between a launch and it: below b ≈ 2 560, latency — the scan → product
// launch and one block's walk through the tokens; above, the column slices
// of x that every tile reads again (L2 → shared memory) and the
// reductions into xtx waiting on its HBM reads.
//
// bf16 x with b % 8 == 0 (every launch of the card paths) runs
// xtx_wg_kernel, the host's plan (kernels/hessian_accum.py::_k1_plan,
// measured with tools/k1_plan_sweep.py) choosing its ring configuration,
// tile edge, token split and xtx prefetch point:
//   * Symmetry: only output tiles with j ≥ i are computed.  The epilogue
//     adds each tile into xtx[i, j] and its transpose into xtx[j, i]; a
//     diagonal tile takes its upper half to both sides.  H stays exactly
//     symmetric and the products halve.
//   * Products: wgmma.mma_async m64nBMk16 bf16 → fp32, one consumer
//     warpgroup per 64 tile rows.  Both operands are column slices of the
//     token-major x, so in shared memory they are MN-major (A = X_iᵀ
//     M-major, B = X_j N-major): wgmma takes them transposed (16-bit types
//     only), through descriptors of 128-byte-swizzled boxes of 64 features
//     × BK tokens — 8-token groups 1 024 bytes apart, the next 64 features
//     one box further.
//   * The ring: 3–4 stages of BK = 64 or 128 tokens, filled by TMA (one
//     tensor map over x, zeros past the tokens and b) from one producer
//     warp on mbarriers; a consumer releases a stage as soon as its
//     products are done (wait_group 1).  Tiles of 64 in 4 stages (3 blocks
//     an SM), 3 stages (4 an SM) or 3 stages of 128 tokens (2 an SM, half
//     the barrier round trips); tiles of 128 in 3 (2 an SM, half the re-reads
//     of x).  A row mask is applied in shared memory: once a stage lands, the
//     masked token rows of every box are zeroed (masked rows may hold NaN,
//     both operands come from them, and 0 · NaN is not 0) before wgmma
//     reads it through the async proxy.
//   * A long batch over few tiles: a cluster of CS ≤ 8 CTAs (the portable
//     size) shares one output tile and each walks tokens/CS; the non-owners leave their fp32
//     partial tiles in shared memory and the owner (rank 0) adds them to
//     its own through distributed shared memory, in rank order — no
//     atomics: two launches on the same inputs give bitwise the same xtx.
//     (At 1 024 tokens one CTA's walk beat every split.)
//   * The update: the owner stages its tile (symmetrised on a diagonal
//     tile) in the ring, 128-byte-swizzled sub-tiles of 32 columns, and
//     adds it into xtx with cp.reduce.async.bulk.tensor (.add.f32): a
//     tensor map over xtx and one thread issuing the reductions, the
//     transpose staged beside the tile (or after it, where the ring cannot
//     hold both).  Each element of xtx gets exactly one addend a launch, so
//     the sum is the read-modify-write's, bit for bit, and no thread reads
//     xtx.  The scan's verdict is read before it.  From b ≈ 3 584 the
//     producer asks L2 for the tile's xtx boxes 7/8 of the way through its
//     stages, so the reductions do not wait on HBM.
//   * Tile order: bands of 16 tile rows, column by column, so that the
//     blocks in flight read few column slices of x — L2 keeps them where x
//     alone would not fit (x is 58 MB at b = 28 672).
// Tried on the card and dropped: a persistent grid (one block an SM, its
// tile's reductions draining during the next tile's products; half the
// loads in flight lost more than the overlap gained), L2 eviction hints on
// x and xtx, and a cp.async fill of the ring (TMA with the mask applied in
// shared memory was faster everywhere).
//
// bf16 x with b % 8 ≠ 0, or not 16-byte aligned, keeps the mma.sync kernel
// (xtx_tc_kernel): mma.sync m16n8k16 from ldmatrix.trans, plain
// loads into a 3-stage ring, the update a register read-modify-write.
//
// fp32 x keeps the first, CUDA-core kernel (xtx_f32_kernel): TF32 tensor cores
// would not compute the same sums, and fp32 is not the card paths' dtype.
// It runs fp32 FMAs from 64×64 shared-memory tiles (4×4 outputs a thread)
// over the full square; each (i, j) and (j, i) sum the same products in the
// same order, so its xtx is symmetric too.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int TILE = 64;    // fp32: output tile edge
constexpr int TK = 16;      // fp32: tokens staged per shared-memory step
constexpr int TPB = 16;     // fp32: threads per block edge, 4×4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// stats[0] = "a valid row holds a non-finite value", stats[1] = valid rows.
// Block k scans rows k, k + gridDim.x, ...  One block writes stats
// outright; several leave their parts in stats[SCAN_PARTS + 2k …] and the
// last of them to finish (stats[2], a ticket zero before and after each
// launch) folds them in.  So stats needs no zeroing: the caller keeps one
// scratch a stream, zero at its first use.  The scan lets the product
// kernel launch at once (griddepcontrol), and takes at most SCAN_BLOCKS
// blocks of 256 threads, which leaves every SM room for product blocks.
constexpr int SCAN_BLOCKS = 264;  // two an SM
constexpr int SCAN_PARTS = 4;     // stats[4 …]: the blocks' parts

template <typename T>
__global__ void scan_kernel(const T* __restrict__ x,
                            const uint8_t* __restrict__ valid,
                            int64_t tokens, int64_t b, int* __restrict__ stats) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int64_t mine = (tokens - blockIdx.x + gridDim.x - 1) / gridDim.x;
  int bad = 0;
  if (sizeof(T) == 2 && b % 8 == 0 &&
      (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    // 16-byte loads: 8 bf16, non-finite iff the exponent bits are all set
    const uint32_t per_row = static_cast<uint32_t>(b / 8);
    const uint4* xv = reinterpret_cast<const uint4*>(x);
#pragma unroll 4
    for (int64_t l = threadIdx.x; l < mine * per_row; l += blockDim.x) {
      const uint32_t k = static_cast<uint32_t>(l) / per_row;
      const int64_t t = blockIdx.x + static_cast<int64_t>(k) * gridDim.x;
      const uint4 v = __ldg(xv + t * per_row + (l - static_cast<int64_t>(k) * per_row));
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      int nf = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        nf |= ((w[q] & 0x7F80u) == 0x7F80u) |
              ((w[q] & 0x7F800000u) == 0x7F800000u);
      bad |= nf && (valid == nullptr || valid[t] != 0);
    }
  } else {
    for (int64_t k = 0; k < mine; ++k) {
      const int64_t t = blockIdx.x + k * gridDim.x;
      if (valid != nullptr && valid[t] == 0) continue;
      const T* xr = x + t * b;
      for (int64_t j = threadIdx.x; j < b; j += blockDim.x)
        if (!isfinite(to_f32(xr[j]))) bad = 1;
    }
  }
  int rows = 0;
  for (int64_t k0 = 0; k0 < mine; k0 += blockDim.x) {
    const int64_t k = k0 + threadIdx.x;
    rows += __syncthreads_count(
        k < mine &&
        (valid == nullptr || valid[blockIdx.x + k * gridDim.x] != 0));
  }
  bad = __syncthreads_or(bad);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) {
      stats[0] = bad;
      stats[1] = rows;
    }
    return;
  }
  // this block's part, then the last block to finish (a ticket that resets
  // itself) folds the parts into stats[0..1]
  __shared__ int last;
  if (threadIdx.x == 0) {
    stats[SCAN_PARTS + 2 * blockIdx.x] = bad;
    stats[SCAN_PARTS + 2 * blockIdx.x + 1] = rows;
    __threadfence();
    last = atomicAdd(&stats[2], 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x >= 32) return;
  int any = 0, sum = 0;
  for (int q = threadIdx.x; q < static_cast<int>(gridDim.x); q += 32) {
    any |= __ldcg(stats + SCAN_PARTS + 2 * q);
    sum += __ldcg(stats + SCAN_PARTS + 2 * q + 1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    any |= __shfl_xor_sync(0xFFFFFFFFu, any, o);
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, o);
  }
  if (threadIdx.x == 0) {
    stats[0] = any != 0;
    stats[1] = sum;
    stats[2] = 0;
  }
}

// ---- fp32 on the CUDA cores ----------------------------------------------
__global__ void xtx_f32_kernel(const float* __restrict__ x,
                               const uint8_t* __restrict__ valid,
                               int64_t tokens, int64_t b,
                               const int* __restrict__ stats,
                               float* __restrict__ xtx,
                               float* __restrict__ count,
                               float* __restrict__ skipped) {
  const int bad = stats[0];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TPB + tx;
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) {
    if (bad) {
      *skipped += 1.0f;
    } else {
      *count += static_cast<float>(stats[1]);
    }
  }
  if (bad) return;

  __shared__ float As[TK][TILE];   // x[t, i0 + ii]
  __shared__ float Bs[TK][TILE];   // x[t, j0 + jj]
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * TILE;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * TILE;

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;

  for (int64_t t0 = 0; t0 < tokens; t0 += TK) {
    for (int l = tid; l < TK * TILE; l += TPB * TPB) {
      const int r = l / TILE;
      const int cc = l % TILE;
      const int64_t t = t0 + r;
      const bool ok = t < tokens && (valid == nullptr || valid[t] != 0);
      const int64_t ci = i0 + cc;
      const int64_t cj = j0 + cc;
      As[r][cc] = (ok && ci < b) ? to_f32(x[t * b + ci]) : 0.0f;
      Bs[r][cc] = (ok && cj < b) ? to_f32(x[t * b + cj]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float a[4], c[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = As[k][ty + TPB * q];
        c[q] = Bs[k][tx + TPB * q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], c[q], acc[p][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int64_t i = i0 + ty + TPB * p;
    if (i >= b) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t j = j0 + tx + TPB * q;
      if (j < b) xtx[i * b + j] += acc[p][q];
    }
  }
}

// ---- bf16 on the tensor cores ---------------------------------------------
constexpr int TC_BK = 64;             // tokens per ring stage
constexpr int TC_NST = 3;             // ring stages
constexpr int TC_THREADS = 256;       // 8 warps: 2 (rows) × 4 (columns)

// Shapes for an output tile of edge BM (128, or 64 when b is small enough
// that 128-wide tiles would leave most SMs idle).
template <int BM>
struct Tile {
  static constexpr int LD = BM + 8;             // smem row, padded 16 bytes
  static constexpr int STAGE = 2 * TC_BK * LD;  // bf16 elements: A and B
  static constexpr int SMEM = TC_NST * STAGE * 2;  // bytes
  static constexpr int CLD = BM + 4;            // fp32 row of the epilogue
  static constexpr int WM = BM / 2, WN = BM / 4;  // a warp's tile
  static constexpr int MI = WM / 16, NI = WN / 8;  // its mma tiles
  static constexpr int PER = BM * (BM / 4) / TC_THREADS;  // epilogue float4s
  static constexpr int RMW = PER < 8 ? PER : 8;  // of them in flight at once
  static_assert(BM * CLD * 4 <= SMEM, "the epilogue tile reuses the ring");
  static_assert(PER % RMW == 0 && NI % 2 == 0, "whole batches and pairs");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Tokens t0..t0+TC_BK of columns c0..c0+BM into a token-major tile,
// zeros for masked / ragged tokens and columns past b.
template <int BM>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* __restrict__ x,
                                          const uint8_t* __restrict__ valid,
                                          int64_t tokens, int64_t b,
                                          int64_t t0, int64_t c0) {
  for (int q = threadIdx.x; q < TC_BK * BM; q += TC_THREADS) {
    const int r = q / BM;
    const int cc = q % BM;
    const int64_t t = t0 + r;
    const int64_t col = c0 + cc;
    const bool ok = t < tokens && col < b &&
                    (valid == nullptr || valid[t] != 0);
    dst[r * Tile<BM>::LD + cc] = ok ? x[t * b + col] : __ushort_as_bfloat16(0);
  }
}

template <int BM>
__global__ void __launch_bounds__(TC_THREADS, 2)
xtx_tc_kernel(const __nv_bfloat16* __restrict__ x,
              const uint8_t* __restrict__ valid, int64_t tokens, int64_t b,
              const int* __restrict__ stats, float* __restrict__ xtx,
              float* __restrict__ count, float* __restrict__ skipped) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  using TL = Tile<BM>;
  const int tid = threadIdx.x;

  // upper-triangle tile (bi ≤ bj) of this block
  const int nt = static_cast<int>((b + BM - 1) / BM);
  int bi = 0;
  int rem = static_cast<int>(blockIdx.x);
  while (rem >= nt - bi) {
    rem -= nt - bi;
    ++bi;
  }
  const int bj = bi + rem;
  const bool diag = bi == bj;
  const int64_t i0 = static_cast<int64_t>(bi) * BM;
  const int64_t j0 = static_cast<int64_t>(bj) * BM;

  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // WM-row × WN-column warp tile
  float acc[TL::MI][TL::NI][4];
#pragma unroll
  for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0f;

  const int nk = static_cast<int>((tokens + TC_BK - 1) / TC_BK);
  auto load = [&](int slot, int kt) {
    __nv_bfloat16* a = sm + slot * TL::STAGE;
    const int64_t t0 = static_cast<int64_t>(kt) * TC_BK;
    load_tile<BM>(a, x, valid, tokens, b, t0, i0);
    load_tile<BM>(a + TC_BK * TL::LD, x, valid, tokens, b, t0, j0);
  };
#pragma unroll
  for (int s = 0; s < TC_NST - 1; ++s) {
    if (s < nk) load(s, s);
  }
  // ldmatrix row offsets of this lane: matrix q = lane / 8, row lane % 8
  const int lr = lane & 7;
  const int q1 = (lane >> 3) & 1, q2 = (lane >> 4) & 1;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // tile kt landed; every warp is done with kt - 1
    if (kt + TC_NST - 1 < nk) load((kt + TC_NST - 1) % TC_NST, kt + TC_NST - 1);
    const __nv_bfloat16* As = sm + (kt % TC_NST) * TL::STAGE;
    const __nv_bfloat16* Bs = As + TC_BK * TL::LD;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      uint32_t a[TL::MI][4];
      uint32_t bq[TL::NI][2];
#pragma unroll
      for (int mi = 0; mi < TL::MI; ++mi)  // a0..a3: (m, k) 0-7/0-7, 8-15/0-7, …
        ldsm_x4_t(a[mi], As + (kk + lr + q2 * 8) * TL::LD + wm * TL::WM +
                             mi * 16 + q1 * 8);
#pragma unroll
      for (int nj = 0; nj < TL::NI / 2; ++nj) {  // b0, b1 of two 8-column tiles
        uint32_t r[4];
        ldsm_x4_t(r, Bs + (kk + lr + q1 * 8) * TL::LD + wn * TL::WN +
                         nj * 16 + q2 * 8);
        bq[2 * nj][0] = r[0];
        bq[2 * nj][1] = r[1];
        bq[2 * nj + 1][0] = r[2];
        bq[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < TL::NI; ++ni)
          mma_bf16(acc[mi][ni], a[mi], bq[ni][0], bq[ni][1]);
    }
  }

  // the scan kernel's verdict (launched ahead of this grid, which may have
  // started early: programmatic dependent launch)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int bad = stats[0];
  if (blockIdx.x == 0 && tid == 0) {
    if (bad) {
      *skipped += 1.0f;
    } else {
      *count += static_cast<float>(stats[1]);
    }
  }
  if (bad) return;  // the whole block: no barrier follows for anyone

  // epilogue, through shared memory so every global access is a coalesced
  // float4 read-modify-write of a tile row: pass 0 adds the tile into
  // xtx[i0.., j0..]; off the diagonal pass 1 adds its transpose into
  // xtx[j0.., i0..].  A diagonal tile is made symmetric from its upper half
  // (both sides of the diagonal get the same value) and added once.
  __syncthreads();  // the ring is free: reuse it for the tile
  float* ct = reinterpret_cast<float*>(tc_smem);  // [BM][TL::CLD]
  const int g = lane >> 2, tg = lane & 3;
  for (int pass = 0; pass < (diag ? 1 : 2); ++pass) {
    if (pass == 1) __syncthreads();  // pass 0's reads of ct are done
#pragma unroll
    for (int mi = 0; mi < TL::MI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int li = wm * TL::WM + mi * 16 + g + h * 8;
#pragma unroll
        for (int ni = 0; ni < TL::NI; ++ni) {
          const int lj = wn * TL::WN + ni * 8 + 2 * tg;
          const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
          if (diag) {
            if (li <= lj) {
              ct[li * TL::CLD + lj] = v0;
              ct[lj * TL::CLD + li] = v0;
            }
            if (li <= lj + 1) {
              ct[li * TL::CLD + lj + 1] = v1;
              ct[(lj + 1) * TL::CLD + li] = v1;
            }
          } else if (pass == 0) {
            *reinterpret_cast<float2*>(ct + li * TL::CLD + lj) =
                make_float2(v0, v1);
          } else {
            ct[lj * TL::CLD + li] = v0;
            ct[(lj + 1) * TL::CLD + li] = v1;
          }
        }
      }
    }
    __syncthreads();
    const int64_t rb = pass == 0 ? i0 : j0, cb = pass == 0 ? j0 : i0;
    // TL::RMW rows a thread at once: all loads, then all stores
    constexpr int PER = TL::PER, RMW = TL::RMW;
    const int q = tid % (BM / 4);
    const int64_t gc = cb + 4 * q;
#pragma unroll
    for (int k0 = 0; k0 < PER; k0 += RMW) {
      float4 o[RMW];
#pragma unroll
      for (int k = 0; k < RMW; ++k) {
        const int r = (k0 + k) * (TC_THREADS / (BM / 4)) + tid / (BM / 4);
        const int64_t gr = rb + r;
        o[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (gr < b && gc < b) {
          const float* src = xtx + gr * b + gc;
          if ((b & 3) == 0) {  // gc + 3 < b: b and gc are multiples of 4
            o[k] = *reinterpret_cast<const float4*>(src);
          } else {
            o[k].x = src[0];
            if (gc + 1 < b) o[k].y = src[1];
            if (gc + 2 < b) o[k].z = src[2];
            if (gc + 3 < b) o[k].w = src[3];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < RMW; ++k) {
        const int r = (k0 + k) * (TC_THREADS / (BM / 4)) + tid / (BM / 4);
        const int64_t gr = rb + r;
        if (gr >= b || gc >= b) continue;
        const float4 v = *reinterpret_cast<const float4*>(ct + r * TL::CLD + 4 * q);
        o[k].x += v.x; o[k].y += v.y; o[k].z += v.z; o[k].w += v.w;
        float* dst = xtx + gr * b + gc;
        if ((b & 3) == 0) {
          *reinterpret_cast<float4*>(dst) = o[k];
        } else {
          dst[0] = o[k].x;
          if (gc + 1 < b) dst[1] = o[k].y;
          if (gc + 2 < b) dst[2] = o[k].z;
          if (gc + 3 < b) dst[3] = o[k].w;
        }
      }
    }
  }
}

int launch_f32(const float* x, const uint8_t* valid, int64_t tokens,
               int64_t b, int* stats, float* xtx, float* count,
               float* skipped, cudaStream_t stream) {
  const unsigned tiles = static_cast<unsigned>((b + TILE - 1) / TILE);
  xtx_f32_kernel<<<dim3(tiles, tiles), dim3(TPB, TPB), 0, stream>>>(
      x, valid, tokens, b, stats, xtx, count, skipped);
  return 0;
}

template <int BM>
int launch_tc(const __nv_bfloat16* x, const uint8_t* valid, int64_t tokens,
              int64_t b, int* stats, float* xtx, float* count,
              float* skipped, cudaStream_t stream) {
  static bool smem_set = false;  // once per process and variant
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        xtx_tc_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile<BM>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int64_t nt = (b + BM - 1) / BM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nt * (nt + 1) / 2));
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = Tile<BM>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, xtx_tc_kernel<BM>, x,
                                             valid, tokens, b,
                                             static_cast<const int*>(stats),
                                             xtx, count, skipped));
}


// ---- bf16 on Hopper: wgmma on TMA-fed tiles ---------------------------------
constexpr int SMEM_MAX = 232448;      // shared memory a block may use
constexpr int SMEM_SM = 233472;       // an SM's, for its blocks and 1 KB each
// Tiles are walked in bands of TILE_GROUP tile rows, column by column, so
// that the blocks in flight share few column slices of x (L2 holds them
// where x alone would not fit).
constexpr int TILE_GROUP = 16;

// A ring configuration: BM × BM output tiles (BM = 64 or 128), BM / 64
// consumer warpgroups of 64 tile rows each and one producer warp; NST stages
// of BK tokens (boxes of BK tokens × 64 features).  Once the tile's products
// are done the ring takes the staged tile and its transpose (both at once
// where they fit).
template <int BM, int BK, int NST>
struct Wg {
  static constexpr int NCONS = BM / 64 * 128;       // consumer threads
  static constexpr int THREADS = NCONS + 32;        // and the producer warp
  static constexpr int BOXES = BM / 64;             // boxes of an operand a stage
  static constexpr int BOX = BK * 128;              // bytes of a box
  static constexpr int STAGE = 2 * BOXES * BOX;     // A's boxes, then B's
  static constexpr int RING = NST * STAGE;
  static constexpr int TILE = BM * BM * 4;          // the staged fp32 tile
  static constexpr bool TWO = 2 * TILE <= RING;     // it and the transpose at once
  static constexpr int ACC = BM / 2;                // accumulators a consumer thread
  static constexpr int SMEM = RING + 1024;          // and 1 024 bytes to align it
  static constexpr int MINB = SMEM_SM / (SMEM + 1024);  // blocks an SM
  static_assert(SMEM + 64 <= SMEM_MAX && TILE <= RING && MINB >= 1,
                "the ring and the barriers fit; the tile fits the ring");
};
// _k1_plan's wgmma variants: 2 = BM 64 in 4 stages of 64 tokens (3 blocks an
// SM) or BM 128 in 3 (2 an SM); 3 = BM 64 in 3 stages of 64 (4 an SM); 4 =
// BM 64 in 3 stages of 128 (2 an SM).
using WgBase64 = Wg<64, 64, 4>;
using WgBase128 = Wg<128, 64, 3>;
using WgTight = Wg<64, 64, 3>;
using WgDeep = Wg<64, 128, 3>;

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// Fetch the 2-D box at (c0 = column, c1 = row) into L2.
__device__ __forceinline__ void tma_prefetch_2d(const CUtensorMap* map, int c0,
                                                int c1) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.2d.L2.global.tile [%0, {%1, %2}];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1)
      : "memory");
}
// One TMA load of a 2-D box at (c0 = column, c1 = row), completing on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
// global[box at (c0 = column, c1 = row)] += the staged box at src (fp32).
__device__ __forceinline__ void tma_reduce_add_2d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
// Matrix descriptor of an MN-major operand in 128-byte-swizzled boxes of 64
// elements × tokens: 8-token groups 1 024 bytes apart (stride offset), the
// next 64 elements `lbo` bytes further (leading offset).
__device__ __forceinline__ uint64_t gmma_desc_mn(const void* p, uint32_t lbo) {
  return ((smem_u32(p) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Operand fence: the accumulators stay where they are up to here (a wgmma
// still in flight writes them; the compiler must not move them).
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }
// The consumer warpgroups' own barrier (the producer warp is not in it).
template <int N>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(N) : "memory");
}

// d (64 × N fp32, the warpgroup's fragment) += A · B, both operands MN-major
// in shared memory (transposed: imm-trans-a = imm-trans-b = 1).
__device__ __forceinline__ void wgmma_tt_n64(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_tt_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
template <int BM>
__device__ __forceinline__ void wgmma_tt(float (&d)[BM / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BM == 128)
    wgmma_tt_n128(d, da, db);
  else
    wgmma_tt_n64(d, da, db);
}

// Address of element (r, c) of a staged fp32 tile: sub-tiles of 32 columns
// (BM rows of 128 bytes), the 16-byte chunks of a row swizzled as TMA's
// 128-byte pattern (chunk XOR row & 7).
template <int BM>
__device__ __forceinline__ float* staged(unsigned char* base, int r, int c) {
  return reinterpret_cast<float*>(base + (c >> 5) * (BM * 128) + r * 128 +
                                  ((((c & 31) >> 2) ^ (r & 7)) << 4) +
                                  (c & 3) * 4);
}

// The upper-triangle tile `tile` (bi ≤ bj) → (i0, j0): bands of G tile
// rows in turn; in a band, its triangle (bi ≤ bj < band end) column by
// column, then the columns past it, G tiles each.
template <int BM>
__device__ __forceinline__ void tile_origin(int tile, int nt, int& i0, int& j0) {
  constexpr int G = TILE_GROUP;
  int r0 = 0;  // the band's first tile row
  for (;;) {
    const int g = nt - r0 < G ? nt - r0 : G;  // its rows
    const int size = g * (nt - r0) - g * (g - 1) / 2;
    if (tile < size) {
      const int tri = g * (g + 1) / 2;
      int bi, bj;
      if (tile < tri) {
        int k = static_cast<int>((sqrtf(8.0f * tile + 1.0f) - 1.0f) * 0.5f);
        while (k * (k + 1) / 2 > tile) --k;  // float rounding, either way
        while ((k + 1) * (k + 2) / 2 <= tile) ++k;
        bi = r0 + tile - k * (k + 1) / 2;
        bj = r0 + k;
      } else {
        bi = r0 + (tile - tri) % g;
        bj = r0 + g + (tile - tri) / g;
      }
      i0 = bi * BM;
      j0 = bj * BM;
      return;
    }
    tile -= size;
    r0 += g;
  }
}

// Stage a tile's fragment at ct — symmetrised from its upper half on a
// diagonal tile — or its transpose at tt.  Fragment (r, c) = (64·(warp / 4)
// + 16·(warp % 4) + lane / 4 + 8h, 8i + 2·(lane % 4) + e) is acc[4i + 2h + e].
template <int BM>
__device__ __forceinline__ void stage_tile(const float (&acc)[BM / 2],
                                           unsigned char* ct, bool diag,
                                           int warp, int lane) {
  const int r0 = 64 * (warp >> 2) + 16 * (warp & 3) + (lane >> 2);
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < BM / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, c = 8 * i + c0;
      if (diag) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (r <= c + e) {  // the upper half, to both sides
            *staged<BM>(ct, r, c + e) = acc[4 * i + 2 * h + e];
            *staged<BM>(ct, c + e, r) = acc[4 * i + 2 * h + e];
          }
      } else {
        *reinterpret_cast<float2*>(staged<BM>(ct, r, c)) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    }
}
template <int BM>
__device__ __forceinline__ void stage_transpose(const float (&acc)[BM / 2],
                                                unsigned char* tt, int warp,
                                                int lane) {
  const int r0 = 64 * (warp >> 2) + 16 * (warp & 3) + (lane >> 2);
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < BM / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *staged<BM>(tt, 8 * i + c0 + e, r0 + 8 * h) = acc[4 * i + 2 * h + e];
}
// xtx[r0 + …, c0 + …] += the staged tile at src: BM / 32 boxes of 32 columns.
template <int BM>
__device__ __forceinline__ void reduce_tile(const CUtensorMap* map,
                                            const unsigned char* src, int r0,
                                            int c0) {
  for (int s = 0; s < BM / 32; ++s)
    tma_reduce_add_2d(map, src + s * (BM * 128), c0 + 32 * s, r0);
}

// One cluster of CS CTAs a tile (bi ≤ bj, upper triangle, in tile_origin's
// order), CTA `rank` walking its share of the token stages.  MASK: the
// masked token rows of each stage are zeroed in shared memory once it has
// landed.  pf: after pf eighths of its stages (0: never) the owner's
// producer asks L2 for the tile's xtx boxes, so that the reduction finds
// them there.  tm_x: x's tensor map, tm_h: xtx's.
template <int BM, int BK, int NST, bool MASK>
__global__ void __launch_bounds__(Wg<BM, BK, NST>::THREADS,
                                  Wg<BM, BK, NST>::MINB)
xtx_wg_kernel(const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ CUtensorMap tm_h,
              const uint8_t* __restrict__ valid, int tokens, int b, int CS,
              int pf, const int* __restrict__ stats, float* __restrict__ count,
              float* __restrict__ skipped) {
  using W = Wg<BM, BK, NST>;
  extern __shared__ unsigned char wg_raw[];
  __shared__ __align__(8) uint64_t full[NST], empty[NST];
  // the ring on a 1 024-byte boundary, as the 128-byte swizzle needs
  unsigned char* ring = wg_raw + ((1024u - (smem_u32(wg_raw) & 1023u)) & 1023u);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool producer = warp == W::NCONS / 32;
  const int rank = static_cast<int>(blockIdx.x) % CS;  // == its cluster rank
  int i0, j0;
  tile_origin<BM>(static_cast<int>(blockIdx.x) / CS, (b + BM - 1) / BM, i0, j0);
  const bool diag = i0 == j0;
  const int nbox = (diag ? 1 : 2) * W::BOXES;  // a diagonal tile: A is B
  const int nk = (tokens + BK - 1) / BK;       // stages of the whole batch
  const int k0 = static_cast<int>(static_cast<int64_t>(rank) * nk / CS);
  const int ns = static_cast<int>(static_cast<int64_t>(rank + 1) * nk / CS) - k0;

  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);               // the producer's expect_tx
      mbar_init(&empty[s], W::NCONS / 32);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float acc[W::ACC];
#pragma unroll
  for (int i = 0; i < W::ACC; ++i) acc[i] = 0.0f;
  if (producer) {
    // stage s into slot s % NST once the slot's last use is done
    if (lane == 0) {
      for (int s = 0; s < ns; ++s) {
        const int slot = s % NST;
        if (pf > 0 && rank == 0 && s == ns * pf / 8) {
          for (int q = 0; q < BM / 32; ++q) {
            tma_prefetch_2d(&tm_h, j0 + 32 * q, i0);
            if (!diag) tma_prefetch_2d(&tm_h, i0 + 32 * q, j0);
          }
        }
        if (s >= NST) mbar_wait(&empty[slot], ((s / NST) - 1) & 1);
        unsigned char* st = ring + slot * W::STAGE;
        mbar_expect_tx(&full[slot], static_cast<uint32_t>(nbox * W::BOX));
        for (int q = 0; q < nbox; ++q)
          tma_load_2d(st + q * W::BOX, &tm_x,
                      (q < W::BOXES ? i0 : j0 - BM) + 64 * q, (k0 + s) * BK,
                      &full[slot]);
      }
    }
  } else {
    // the consumers: warpgroup warp / 4 takes tile rows 64·(warp / 4) …
    const unsigned char* a_off = ring + (warp >> 2) * W::BOX;
    const unsigned char* b_off = ring + (diag ? 0 : W::BOXES * W::BOX);
    for (int s = 0; s < ns; ++s) {
      const int slot = s % NST;
      if constexpr (MASK) {
        // this thread's share of one token row of the stage (read before the
        // stage lands): zeroed in every box if the row is masked — masked
        // rows may hold NaN, and 0 · NaN is not 0
        constexpr int PER = W::NCONS / BK;  // threads a row
        const int r = tid / PER;
        const int t = (k0 + s) * BK + r;
        const bool zero = t < tokens && valid[t] == 0;
        mbar_wait(&full[slot], (s / NST) & 1);
        if (zero) {
          unsigned char* row = ring + slot * W::STAGE + r * 128;
          for (int q = 0; q < nbox; ++q)
#pragma unroll
            for (int c = tid % PER; c < 8; c += PER)
              *reinterpret_cast<uint4*>(row + q * W::BOX + c * 16) =
                  make_uint4(0u, 0u, 0u, 0u);
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        consumer_sync<W::NCONS>();
      } else {
        mbar_wait(&full[slot], (s / NST) & 1);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_tt<BM>(acc, gmma_desc_mn(a_off + slot * W::STAGE + kk * 2048, W::BOX),
                     gmma_desc_mn(b_off + slot * W::STAGE + kk * 2048, W::BOX));
      wgmma_commit();
      wgmma_wait<1>();  // stage s − 1's products are done: its slot is free
#pragma unroll
      for (int i = 0; i < W::ACC; ++i) keep(acc[i]);
      if (s > 0 && lane == 0) mbar_arrive(&empty[(s - 1) % NST]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < W::ACC; ++i) keep(acc[i]);
  }

  // a split: the non-owners' partial tiles, in fragment order, summed by
  // the owner in rank order
  if (CS > 1) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    float4* part = reinterpret_cast<float4*>(ring);
    if (!producer) {
      consumer_sync<W::NCONS>();  // every warpgroup is done with the ring
      if (rank != 0) {
#pragma unroll
        for (int k = 0; k < W::ACC / 4; ++k)
          part[k * W::NCONS + tid] = make_float4(acc[4 * k], acc[4 * k + 1],
                                                 acc[4 * k + 2], acc[4 * k + 3]);
      }
    }
    cluster.sync();
    if (rank == 0 && !producer) {
      for (int q = 1; q < CS; ++q) {
        const float4* rp = cluster.map_shared_rank(part, q);
#pragma unroll
        for (int k = 0; k < W::ACC / 4; ++k) {
          const float4 v = rp[k * W::NCONS + tid];
          acc[4 * k] += v.x;
          acc[4 * k + 1] += v.y;
          acc[4 * k + 2] += v.z;
          acc[4 * k + 3] += v.w;
        }
      }
    }
    cluster.sync();  // no CTA leaves while its partial tile may be read
    if (rank != 0) return;
  }
  if (producer) return;

  // the scan kernel's verdict (launched ahead of this grid, which may have
  // started early: programmatic dependent launch), before any write
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int bad = stats[0];
  if (blockIdx.x == 0 && tid == 0) {
    if (bad) {
      *skipped += 1.0f;
    } else {
      *count += static_cast<float>(stats[1]);
    }
  }
  if (bad) return;  // every consumer: no barrier follows for anyone

  // stage the tile and its transpose in the ring, then add them into xtx by
  // TMA; where the ring cannot hold both, the transpose after the tile
  unsigned char* ct = ring;
  unsigned char* tt = W::TWO ? ring + W::TILE : ring;
  consumer_sync<W::NCONS>();  // every warpgroup is done with the ring
  stage_tile<BM>(acc, ct, diag, warp, lane);
  if (!diag && W::TWO) stage_transpose<BM>(acc, tt, warp, lane);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // for TMA
  consumer_sync<W::NCONS>();
  if (tid == 0) {
    reduce_tile<BM>(&tm_h, ct, i0, j0);
    if (!diag && W::TWO) reduce_tile<BM>(&tm_h, tt, j0, i0);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  }
  if (!diag && !W::TWO) {
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    consumer_sync<W::NCONS>();
    stage_transpose<BM>(acc, tt, warp, lane);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    consumer_sync<W::NCONS>();
    if (tid == 0) {
      reduce_tile<BM>(&tm_h, tt, j0, i0);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  // the reductions have read the staged tiles before the block leaves
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// cuTensorMapEncodeTiled from the CUDA driver API, found at run time (the
// library links only the runtime).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major matrix (rows × cols of `type`, rows `row_bytes` apart) as
// boxes of box_rows × box_cols (128 bytes, swizzled), zero past its edges.
bool tmap_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
             int64_t rows, int64_t cols, int64_t row_bytes, int box_cols,
             int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// tmap_2d, cached: a map is a function of its arguments alone, so one
// encoded for the same address and shape is the same map.  Encoding costs
// host time on every eager call; xtx is the same accumulator for a whole
// capture pass, and the caching allocator hands a batch's x the address of
// the last one of its shape.
bool cached_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                int64_t rows, int64_t cols, int box_cols, int box_rows) {
  struct Entry {
    const void* p;
    int64_t rows, cols;
    int type, box_cols, box_rows;
    CUtensorMap map;
  };
  constexpr int N = 32;
  static Entry cache[N];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int k = 0; k < used; ++k) {
    const Entry& e = cache[k];
    if (e.p == base && e.rows == rows && e.cols == cols &&
        e.type == static_cast<int>(type) && e.box_cols == box_cols &&
        e.box_rows == box_rows) {
      *map = e.map;
      return true;
    }
  }
  const int64_t esize = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  if (!tmap_2d(map, type, base, rows, cols, cols * esize, box_cols, box_rows))
    return false;
  cache[next] = Entry{base, rows, cols, static_cast<int>(type), box_cols,
                      box_rows, *map};
  next = (next + 1) % N;
  if (used < N) ++used;
  return true;
}

template <int BM, int BK, int NST, bool MASK>
int launch_wg(const void* x, const uint8_t* valid, int64_t tokens, int64_t b,
              int* stats, float* xtx, float* count, float* skipped, int CS,
              int pf, cudaStream_t stream) {
  using W = Wg<BM, BK, NST>;
  auto kern = xtx_wg_kernel<BM, BK, NST, MASK>;
  static bool attrs_set = false;  // once per process and variant
  if (!attrs_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, W::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attrs_set = true;
  }
  CUtensorMap tm_x, tm_h;  // x: boxes of BK tokens × 64; xtx: BM rows × 32
  if (!cached_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, tokens, b, 64,
                  BK) ||
      !cached_map(&tm_h, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, xtx, b, b, 32, BM))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nt = (b + BM - 1) / BM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nt * (nt + 1) / 2 * CS));
  cfg.blockDim = dim3(W::THREADS);
  cfg.dynamicSmemBytes = W::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = static_cast<unsigned>(CS);
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CS > 1 ? 2 : 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kern, tm_x, tm_h, valid, static_cast<int>(tokens),
      static_cast<int>(b), CS, pf, static_cast<const int*>(stats), count,
      skipped));
}

// The wgmma kernel's checks: bf16 x with b % 8 == 0 and 16-byte aligned x
// and xtx (TMA's rows and bases), tokens and b in int, the variant's tile
// edge and shared memory, CS ∈ {1, 2, 4, 8} (_k1_plan's splits), pf in
// eighths.
bool wg_plan_ok(const void* x, int64_t tokens, int64_t b, const void* xtx,
                int variant, int BM, int CS, int smem, int pf) {
  const bool al = (reinterpret_cast<uintptr_t>(x) |
                   reinterpret_cast<uintptr_t>(xtx)) % 16 == 0;
  const bool cs_ok = CS == 1 || CS == 2 || CS == 4 || CS == 8;
  int want = -1;
  if (variant == 2) want = BM == 64 ? WgBase64::SMEM : BM == 128 ? WgBase128::SMEM : -1;
  if (variant == 3 && BM == 64) want = WgTight::SMEM;
  if (variant == 4 && BM == 64) want = WgDeep::SMEM;
  return b % 8 == 0 && al && tokens > 0 && tokens < (1ll << 31) &&
         b < (1 << 30) && cs_ok && smem == want && pf >= 0 && pf < 8;
}

int launch_wg_any(const void* x, const uint8_t* valid, int64_t tokens,
                  int64_t b, int* stats, float* xtx, float* count,
                  float* skipped, int variant, int BM, int CS, int pf,
                  cudaStream_t s) {
#define WG_ARGS x, valid, tokens, b, stats, xtx, count, skipped, CS, pf, s
  const bool m = valid != nullptr;
  if (variant == 3)
    return m ? launch_wg<64, 64, 3, true>(WG_ARGS) : launch_wg<64, 64, 3, false>(WG_ARGS);
  if (variant == 4)
    return m ? launch_wg<64, 128, 3, true>(WG_ARGS) : launch_wg<64, 128, 3, false>(WG_ARGS);
  if (BM == 64)
    return m ? launch_wg<64, 64, 4, true>(WG_ARGS) : launch_wg<64, 64, 4, false>(WG_ARGS);
  return m ? launch_wg<128, 64, 3, true>(WG_ARGS) : launch_wg<128, 64, 3, false>(WG_ARGS);
#undef WG_ARGS
}

// Up to this many elements x is scanned by one block of 1024 threads,
// which writes stats itself; above, by up to SCAN_BLOCKS blocks of 256.
constexpr int64_t ONE_BLOCK_SCAN = 1 << 16;

template <typename T>
int launch_scan(const T* x, const uint8_t* valid, int64_t tokens, int64_t b,
                int* stats, cudaStream_t stream) {
  if (tokens * b <= ONE_BLOCK_SCAN) {
    scan_kernel<T><<<1, 1024, 0, stream>>>(x, valid, tokens, b, stats);
    return 0;
  }
  const int blocks = static_cast<int>(tokens < SCAN_BLOCKS ? tokens : SCAN_BLOCKS);
  scan_kernel<T><<<blocks, 256, 0, stream>>>(x, valid, tokens, b, stats);
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  valid may be NULL (every row valid).
// stats: int32[SCAN_PARTS + 2·SCAN_BLOCKS] scratch of the stream, zero at
// its first use (each launch leaves its ticket at zero).  The caller's plan
// (kernels/hessian_accum.py::_k1_plan): variant 0 = fp32 x on the CUDA
// cores; 1 = bf16 on the mma.sync kernel with scalar loads (any b, any
// alignment); 2–4 = the wgmma kernel in the ring configurations named at
// WgBase64 … WgDeep.  BM is the tile edge (64 or
// 128; not read for fp32), CS the CTAs of a cluster that split the tokens
// (1 but on variants 2–4), smem the plan's dynamic shared memory, checked;
// pf the wgmma kernel's xtx prefetch point in eighths of a CTA's stages (0:
// none; 0 elsewhere).
// Returns the launch's error, else cudaGetLastError().
extern "C" int hessian_xtx_update(const void* x, int dtype, const void* valid,
                                  int64_t tokens, int64_t b, void* stats,
                                  void* xtx, void* count, void* skipped,
                                  int variant, int BM, int CS, int smem,
                                  int pf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* vp = static_cast<const uint8_t*>(valid);
  int* sp = static_cast<int*>(stats);
  float* hp = static_cast<float*>(xtx);
  float* cp = static_cast<float*>(count);
  float* kp = static_cast<float*>(skipped);
  bool ok = (dtype == 0 || dtype == 1) && (dtype == 0) == (variant == 0);
  if (variant == 0) {
    ok = ok && CS == 1;
  } else if (variant == 1) {
    ok = ok && CS == 1 &&
         ((BM == 64 && smem == Tile<64>::SMEM) ||
          (BM == 128 && smem == Tile<128>::SMEM));
  } else if (variant >= 2 && variant <= 4) {
    ok = ok && wg_plan_ok(x, tokens, b, xtx, variant, BM, CS, smem, pf);
  } else {
    ok = false;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if (dtype == 0) {
    const float* xp = static_cast<const float*>(x);
    err = launch_scan(xp, vp, tokens, b, sp, s);
    if (err == 0) err = launch_f32(xp, vp, tokens, b, sp, hp, cp, kp, s);
  } else {
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    err = launch_scan(xp, vp, tokens, b, sp, s);
    if (err == 0) {
      if (variant >= 2)
        err = launch_wg_any(xp, vp, tokens, b, sp, hp, cp, kp, variant, BM, CS,
                            pf, s);
      else
        err = BM == 64 ? launch_tc<64>(xp, vp, tokens, b, sp, hp, cp, kp, s)
                       : launch_tc<128>(xp, vp, tokens, b, sp, hp, cp, kp, s);
    }
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
