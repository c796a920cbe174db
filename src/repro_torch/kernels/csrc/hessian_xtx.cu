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
// finiteness and valid-row count into stats[0..1] (zeroed by the caller);
// xtx_kernel reads that flag, updates count/skipped from one thread, and
// either returns at once (skipped batch) or adds its 64×64 output tile.
//
// Bound on the H100: 2·tokens·b² operations against a read of X and a
// read+write of the (b, b) fp32 xtx.  At the main-path shape (tokens 1024,
// b 5632) that is 65 GFLOP and 265 MB.  At the bf16 tensor-core peak
// (989 TFLOP/s, products exact in fp32) the operations take 0.066 ms and
// the bytes 0.079 ms at 3.35 TB/s, so the work is bytes-bound; that is the
// bound chip_smoke.py reports.  This first version runs the products on the
// CUDA cores in fp32 (67 TFLOP/s, ~0.97 ms of operations), where it is
// compute-bound, from a shared-memory tile (4×4 outputs per thread);
// symmetry is not exploited.  Tensor cores (wgmma on bf16 input) are the
// later redesign that closes that gap.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;    // output tile edge
constexpr int TK = 16;      // tokens staged per shared-memory step
constexpr int TPB = 16;     // threads per block edge (16×16), 4×4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void scan_kernel(const T* __restrict__ x,
                            const uint8_t* __restrict__ valid,
                            int64_t tokens, int64_t b, int* __restrict__ stats) {
  int bad = 0;
  int rows = 0;
  for (int64_t t = blockIdx.x; t < tokens; t += gridDim.x) {
    if (valid != nullptr && valid[t] == 0) continue;
    if (threadIdx.x == 0) rows += 1;
    const T* xr = x + t * b;
    for (int64_t j = threadIdx.x; j < b; j += blockDim.x) {
      if (!isfinite(to_f32(xr[j]))) bad = 1;
    }
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    if (bad) atomicOr(&stats[0], 1);
    if (rows) atomicAdd(&stats[1], rows);
  }
}

template <typename T>
__global__ void xtx_kernel(const T* __restrict__ x,
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

template <typename T>
void launch(const void* x, const void* valid, int64_t tokens, int64_t b,
            void* stats, void* xtx, void* count, void* skipped,
            cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const uint8_t* vp = static_cast<const uint8_t*>(valid);
  int* sp = static_cast<int*>(stats);
  const int scan_blocks =
      static_cast<int>(tokens < 1 ? 1 : (tokens < 1024 ? tokens : 1024));
  scan_kernel<T><<<scan_blocks, 256, 0, stream>>>(xp, vp, tokens, b, sp);
  const unsigned tiles = static_cast<unsigned>((b + TILE - 1) / TILE);
  dim3 grid(tiles, tiles);
  dim3 block(TPB, TPB);
  xtx_kernel<T><<<grid, block, 0, stream>>>(
      xp, vp, tokens, b, sp, static_cast<float*>(xtx),
      static_cast<float*>(count), static_cast<float*>(skipped));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  valid may be NULL (every row valid).
// stats: int32[2], zeroed by the caller.  Returns cudaGetLastError().
extern "C" int hessian_xtx_update(const void* x, int dtype, const void* valid,
                                  int64_t tokens, int64_t b, void* stats,
                                  void* xtx, void* count, void* skipped,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, valid, tokens, b, stats, xtx, count, skipped, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, valid, tokens, b, stats, xtx, count, skipped, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
