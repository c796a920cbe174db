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
// finiteness and valid-row count into stats[0..1]: one block for small x
// (it writes stats outright), else zeroed stats and up to 1024 blocks.  The
// product kernel is launched as a programmatic dependent of the scan
// (griddepcontrol): it computes its tile while the scan runs and waits for
// the scan's verdict only before its epilogue, where one thread updates
// count/skipped and a skipped batch returns without writing.
//
// Bound on the H100: tokens·b² operations on the symmetric half against a
// read of X and a read + write of the (b, b) fp32 xtx.  At the main-path
// shape (tokens 1024, b 5632) that is 32.5 GFLOP and 265 MB: at the bf16
// tensor-core peak (989 TFLOP/s; bf16×bf16 products are exact in fp32) the
// operations take 0.033 ms and the bytes 0.079 ms at 3.35 TB/s, so the work
// is bytes-bound; chip_smoke.py reports that bound.
//
// bf16 x (every launch of the serving paths' prunes) runs on the tensor
// cores: xtx_tc_kernel, mma.sync m16n8k16 bf16 → fp32.  Both operands are
// column slices of x (tokens, b), so in shared memory they are token-major
// (feature-contiguous, MN-major for the product); ldmatrix.trans turns them
// into the A (Xᵀ, row) and B (X, col) fragments.  A block owns one BM×BM
// output tile (BM = 128, or 64 for b ≤ 2048 so the small expert Hessians
// fill the card), 8 warps of BM/2 × BM/4, and walks the tokens through a
// 3-stage cp.async ring of 64-token stages (16-byte chunks, rows padded by
// 16 bytes so ldmatrix is bank-conflict free).  The row mask is applied in
// the copy: an invalid or ragged token row, or a column chunk past b, is
// zero-filled (src-size 0).  Symmetry: only tiles with j ≥ i are computed;
// the epilogue adds each tile into xtx[i, j] in place and its transpose
// into xtx[j, i], and a diagonal tile adds its upper half to both sides —
// H stays exactly symmetric and the operations halve.  The epilogue stages
// the tile (and then its transpose) in shared memory, so both read-modify-
// writes of xtx are whole rows of float4s, 8 in flight a thread.  mma.sync
// rather than wgmma: the fp32 read-modify-write of xtx, not the products,
// bounds the work, and mma.sync with ldmatrix.trans takes the MN-major
// operands without descriptor layouts.  bf16 x with b % 8 ≠ 0 (rows not
// 16-byte aligned) takes the same kernel with plain loads into the ring.
//
// fp32 x keeps the first, CUDA-core kernel (xtx_f32_kernel): TF32 tensor cores
// would not compute the same sums, and fp32 is not the card paths' dtype.
// It runs fp32 FMAs from 64×64 shared-memory tiles (4×4 outputs a thread)
// over the full square; each (i, j) and (j, i) sum the same products in the
// same order, so its xtx is symmetric too.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;    // fp32: output tile edge
constexpr int TK = 16;      // fp32: tokens staged per shared-memory step
constexpr int TPB = 16;     // fp32: threads per block edge, 4×4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// stats[0] |= "a valid row holds a non-finite value", stats[1] += valid
// rows, over the rows blockIdx.x, +gridDim.x, ...  One block writes stats
// outright (no zeroing needed); several add atomically into zeroed stats.
// It lets the product kernel launch at once (griddepcontrol).
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
  if (threadIdx.x == 0) {
    if (gridDim.x == 1) {
      stats[0] = bad;
      stats[1] = rows;
    } else {
      if (bad) atomicOr(&stats[0], 1);
      if (rows) atomicAdd(&stats[1], rows);
    }
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
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
template <int BM, bool VEC>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* __restrict__ x,
                                          const uint8_t* __restrict__ valid,
                                          int64_t tokens, int64_t b,
                                          int64_t t0, int64_t c0) {
  if constexpr (VEC) {
    for (int q = threadIdx.x; q < TC_BK * (BM / 8); q += TC_THREADS) {
      const int r = q / (BM / 8);
      const int ch = q % (BM / 8);
      const int64_t t = t0 + r;
      const int64_t col = c0 + ch * 8;
      const bool ok = t < tokens && col < b &&
                      (valid == nullptr || valid[t] != 0);
      cp_async16(dst + r * Tile<BM>::LD + ch * 8, ok ? x + t * b + col : x,
                 ok ? 16 : 0);
    }
  } else {
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
}

template <int BM, bool VEC>
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
    load_tile<BM, VEC>(a, x, valid, tokens, b, t0, i0);
    load_tile<BM, VEC>(a + TC_BK * TL::LD, x, valid, tokens, b, t0, j0);
  };
#pragma unroll
  for (int s = 0; s < TC_NST - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  // ldmatrix row offsets of this lane: matrix q = lane / 8, row lane % 8
  const int lr = lane & 7;
  const int q1 = (lane >> 3) & 1, q2 = (lane >> 4) & 1;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<TC_NST - 2>();
    __syncthreads();  // tile kt landed; every warp is done with kt - 1
    if (kt + TC_NST - 1 < nk) load((kt + TC_NST - 1) % TC_NST, kt + TC_NST - 1);
    cp_async_commit();
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
  cp_async_wait<0>();

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

template <int BM, bool VEC>
int launch_tc(const __nv_bfloat16* x, const uint8_t* valid, int64_t tokens,
              int64_t b, int* stats, float* xtx, float* count,
              float* skipped, cudaStream_t stream) {
  static bool smem_set = false;  // once per process and variant
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        xtx_tc_kernel<BM, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  return static_cast<int>(cudaLaunchKernelEx(&cfg, xtx_tc_kernel<BM, VEC>, x,
                                             valid, tokens, b,
                                             static_cast<const int*>(stats),
                                             xtx, count, skipped));
}

// 64-wide tiles up to this b (≤ 528 blocks), 128-wide above.
constexpr int64_t SMALL_TILE_B = 2048;

template <bool VEC>
int launch_tc_any(const __nv_bfloat16* x, const uint8_t* valid,
                  int64_t tokens, int64_t b, int* stats, float* xtx,
                  float* count, float* skipped, cudaStream_t stream) {
  return b <= SMALL_TILE_B
             ? launch_tc<64, VEC>(x, valid, tokens, b, stats, xtx, count,
                                  skipped, stream)
             : launch_tc<128, VEC>(x, valid, tokens, b, stats, xtx, count,
                                   skipped, stream);
}

// Up to this many elements x is scanned by one block of 1024 threads,
// which writes stats itself; above, stats is zeroed and up to 1024 blocks
// (a row each at a time) add into it.
constexpr int64_t ONE_BLOCK_SCAN = 1 << 16;

template <typename T>
int launch_scan(const T* x, const uint8_t* valid, int64_t tokens, int64_t b,
                int* stats, cudaStream_t stream) {
  if (tokens * b <= ONE_BLOCK_SCAN) {
    scan_kernel<T><<<1, 1024, 0, stream>>>(x, valid, tokens, b, stats);
    return 0;
  }
  const cudaError_t err = cudaMemsetAsync(stats, 0, 2 * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>(tokens < 1024 ? tokens : 1024);
  scan_kernel<T><<<blocks, 256, 0, stream>>>(x, valid, tokens, b, stats);
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  valid may be NULL (every row valid).
// stats: int32[2] scratch, any contents.  Returns cudaGetLastError().
extern "C" int hessian_xtx_update(const void* x, int dtype, const void* valid,
                                  int64_t tokens, int64_t b, void* stats,
                                  void* xtx, void* count, void* skipped,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* vp = static_cast<const uint8_t*>(valid);
  int* sp = static_cast<int*>(stats);
  float* hp = static_cast<float*>(xtx);
  float* cp = static_cast<float*>(count);
  float* kp = static_cast<float*>(skipped);
  int err;
  if (dtype == 0) {
    const float* xp = static_cast<const float*>(x);
    err = launch_scan(xp, vp, tokens, b, sp, s);
    if (err == 0) err = launch_f32(xp, vp, tokens, b, sp, hp, cp, kp, s);
  } else if (dtype == 1) {
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    const bool vec = b % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    err = launch_scan(xp, vp, tokens, b, sp, s);
    if (err == 0)
      err = vec ? launch_tc_any<true>(xp, vp, tokens, b, sp, hp, cp, kp, s)
                : launch_tc_any<false>(xp, vp, tokens, b, sp, hp, cp, kp, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
