// K2: n:m compressed-weight matmul y = x · Wᵀ for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/nm_spmm.py::nm_matmul (body
// _nm_kernel).  W is (c, b) in group-major n:m storage: `values` (c, L) with
// L = (b/m)·keep kept weights per row in x's dtype, and their in-group
// positions as bytes, one per byte (idx_bits 8) or two per byte, low nibble
// first (idx_bits 4).  The kernel streams only those bytes, expands each
// kept value in registers to its column (group·m + position), multiplies by
// x with fp32 sums and writes y (B, c) in x's dtype.  Index bytes are read
// unsigned, so no sign extension has to be masked away.
//
// Bound on the H100: the serving shapes are GEMV-like (B = 1 in prefill,
// B = slots in decode), so the kernel is bound by the bytes it streams —
// values + indices + x + y — over 3.35 TB/s; its operations (2·B·c·L) are
// far below the tensor-core line.  The design therefore only has to keep
// the weight stream coalesced and in flight: one warp per output row, each
// lane loading 16 bytes of values and the matching 4 (or 8) index bytes per
// step when the row is 16-byte aligned (a scalar path otherwise), x read
// through the read-only cache (it is small and shared by every row), and
// up to MAXB activation rows accumulated per pass over the weights.  The
// ragged edges (c not a multiple of the rows per block, B not a multiple
// of MAXB) are masked here; nothing is padded by the caller.
//
// K3: the stacked expert matmul y[e] = x[e] · W_eᵀ over one stacked leaf
// (entry point nm_matmul_stacked, kernel nm_stacked_kernel).  Replaces
// repro/kernels/ops.py::nm_matmul_stacked, whose Pallas branch launches
// _nm_kernel once per expert; here it is ONE launch with the expert on
// blockIdx.z.  values (E, c, L), indices (E, c, idx_stride) and x (E, C, b)
// are addressed by expert stride; y is (E, C, c).
//
// Bound on the H100: the MoE decode streams every expert of the leaf (128
// experts at 2048×768, ≈ 252 MB of values + indices) for at most a few
// routed rows, so K3 is bound by those bytes over 3.35 TB/s (≈ 75 µs).  At
// C = 8 capacity rows K2's per-weight gather of B activations from global
// memory would issue 8 scattered loads per kept weight, which costs more
// than the weight stream itself.  So each block first stages its expert's
// MAXB activation rows in shared memory, column-major (the MAXB values of
// one column side by side, rows ≥ C zero-filled), so ONE 16-byte (bf16) or
// two (fp32) shared loads give a kept weight's activations for all rows.
// Column slots are XOR-swizzled by the column's 16-block so the lanes of a
// warp, which read 16 columns apart, fall in different banks.  The weight
// stream is K2's: a warp per output row (RPW rows per warp), 16-byte value
// loads with their index bytes, fp32 sums, ragged rows masked here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // output rows per block, one warp each
constexpr int MAXB = 8;   // activation rows accumulated per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch casts
}

// P consecutive kept values of one row from j0 on, as fp32, with their
// in-group positions.  P == 8 needs j0 % 8 == 0 and 16-byte aligned rows.
template <typename T, int IDX_BITS, int P>
__device__ __forceinline__ void load_chunk(const T* vrow, const uint8_t* irow,
                                           int j0, float (&w)[P],
                                           int (&pos)[P]) {
  if constexpr (P == 1) {
    w[0] = to_f32(vrow[j0]);
    if constexpr (IDX_BITS == 4) {
      const unsigned byte = irow[j0 >> 1];
      pos[0] = (j0 & 1) ? (byte >> 4) : (byte & 0xF);
    } else {
      pos[0] = irow[j0];
    }
  } else {
    static_assert(P == 8, "vector path loads 8 values");
    if constexpr (sizeof(T) == 2) {
      const uint4 raw = *reinterpret_cast<const uint4*>(vrow + j0);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int p = 0; p < 8; ++p) w[p] = __bfloat162float(h[p]);
    } else {
      const float4 a = *reinterpret_cast<const float4*>(vrow + j0);
      const float4 b = *reinterpret_cast<const float4*>(vrow + j0 + 4);
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
      w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    }
    if constexpr (IDX_BITS == 4) {
      // bytes j0/2 .. j0/2+3, little endian: nibble p is entry j0 + p
      const uint32_t bits = *reinterpret_cast<const uint32_t*>(irow + (j0 >> 1));
#pragma unroll
      for (int p = 0; p < 8; ++p) pos[p] = (bits >> (4 * p)) & 0xF;
    } else {
      const uint2 bits = *reinterpret_cast<const uint2*>(irow + j0);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        pos[p] = (bits.x >> (8 * p)) & 0xFF;
        pos[p + 4] = (bits.y >> (8 * p)) & 0xFF;
      }
    }
  }
}

template <typename T, int IDX_BITS, int P>
__global__ void __launch_bounds__(WARPS * 32)
nm_kernel(const T* __restrict__ x, const T* __restrict__ vals,
          const uint8_t* __restrict__ idx, T* __restrict__ y, int B, int c,
          int b, int m, int keep, int L, int idx_stride) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= c) return;  // whole warp: a row belongs to one warp
  const int b0 = blockIdx.y * MAXB;
  const int nb = min(MAXB, B - b0);
  const T* vrow = vals + static_cast<int64_t>(row) * L;
  const uint8_t* irow = idx + static_cast<int64_t>(row) * idx_stride;
  const T* xb = x + static_cast<int64_t>(b0) * b;

  float acc[MAXB];
#pragma unroll
  for (int i = 0; i < MAXB; ++i) acc[i] = 0.0f;

  for (int j0 = lane * P; j0 < L; j0 += 32 * P) {
    float w[P];
    int pos[P];
    load_chunk<T, IDX_BITS, P>(vrow, irow, j0, w, pos);
    int grp = j0 / keep;
    int r = j0 - grp * keep;
    int col[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const bool ok = pos[p] < m;  // a position outside its group adds 0
      col[p] = ok ? grp * m + pos[p] : 0;
      w[p] = ok ? w[p] : 0.0f;
      if (++r == keep) {
        r = 0;
        ++grp;
      }
    }
#pragma unroll
    for (int i = 0; i < MAXB; ++i) {
      if (i < nb) {
        const T* xr = xb + static_cast<int64_t>(i) * b;
#pragma unroll
        for (int p = 0; p < P; ++p) acc[i] = fmaf(w[p], to_f32(xr[col[p]]), acc[i]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MAXB; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < MAXB; ++i)
      if (i < nb) store(y + static_cast<int64_t>(b0 + i) * c + row, acc[i]);
  }
}

template <typename T, int IDX_BITS>
void launch(const void* x, const void* vals, const void* idx, void* y, int vec,
            int B, int c, int b, int m, int keep, int L, int idx_stride,
            cudaStream_t s) {
  const dim3 grid((c + WARPS - 1) / WARPS, (B + MAXB - 1) / MAXB);
  const dim3 block(WARPS * 32);
  const T* xp = static_cast<const T*>(x);
  const T* vp = static_cast<const T*>(vals);
  const uint8_t* ip = static_cast<const uint8_t*>(idx);
  T* yp = static_cast<T*>(y);
  if (vec) {
    nm_kernel<T, IDX_BITS, 8><<<grid, block, 0, s>>>(xp, vp, ip, yp, B, c, b, m,
                                                     keep, L, idx_stride);
  } else {
    nm_kernel<T, IDX_BITS, 1><<<grid, block, 0, s>>>(xp, vp, ip, yp, B, c, b, m,
                                                     keep, L, idx_stride);
  }
}

// ---- K3 -------------------------------------------------------------------
constexpr int RPW = 4;  // output rows per warp in K3: WARPS·RPW rows a block

__device__ __forceinline__ int xslot(int col) { return col ^ ((col >> 4) & 7); }

// The MAXB activations of one staged column, as fp32.
__device__ __forceinline__ void load_xcol(const __nv_bfloat16* xs, int slot,
                                          float (&xv)[MAXB]) {
  static_assert(MAXB == 8, "one 16-byte load holds 8 bf16 rows");
  const uint4 raw = *reinterpret_cast<const uint4*>(xs + slot * MAXB);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < MAXB; ++i) xv[i] = __bfloat162float(h[i]);
}
__device__ __forceinline__ void load_xcol(const float* xs, int slot,
                                          float (&xv)[MAXB]) {
  const float4 a = *reinterpret_cast<const float4*>(xs + slot * MAXB);
  const float4 b = *reinterpret_cast<const float4*>(xs + slot * MAXB + 4);
  xv[0] = a.x; xv[1] = a.y; xv[2] = a.z; xv[3] = a.w;
  xv[4] = b.x; xv[5] = b.y; xv[6] = b.z; xv[7] = b.w;
}

template <typename T, int IDX_BITS, int P>
__global__ void __launch_bounds__(WARPS * 32)
nm_stacked_kernel(const T* __restrict__ x, const T* __restrict__ vals,
                  const uint8_t* __restrict__ idx, T* __restrict__ y, int C,
                  int c, int b, int m, int keep, int L, int idx_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // [slot(col)][MAXB]
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * MAXB;
  const int nr = min(MAXB, C - r0);
  const int bp = (b + 7) & ~7;  // the swizzle stays inside 8-column groups

  // stage x[e, r0:r0+nr, :] (coalesced along b), zeros past nr and b
  const T* xe = x + (static_cast<int64_t>(e) * C + r0) * b;
  for (int r = 0; r < MAXB; ++r) {
    for (int col = threadIdx.x; col < bp; col += blockDim.x) {
      T* dst = xs + xslot(col) * MAXB + r;
      if (r < nr && col < b) {
        *dst = xe[static_cast<int64_t>(r) * b + col];
      } else {
        store(dst, 0.0f);
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* ve = vals + static_cast<int64_t>(e) * c * L;
  const uint8_t* ie = idx + static_cast<int64_t>(e) * c * idx_stride;
  T* ye = y + (static_cast<int64_t>(e) * C + r0) * c;
  const int row0 = static_cast<int>(blockIdx.x) * WARPS * RPW;
  const int row_end = min(c, row0 + WARPS * RPW);
  for (int row = row0 + warp; row < row_end; row += WARPS) {
    const T* vrow = ve + static_cast<int64_t>(row) * L;
    const uint8_t* irow = ie + static_cast<int64_t>(row) * idx_stride;
    float acc[MAXB];
#pragma unroll
    for (int i = 0; i < MAXB; ++i) acc[i] = 0.0f;

    for (int j0 = lane * P; j0 < L; j0 += 32 * P) {
      float w[P];
      int pos[P];
      load_chunk<T, IDX_BITS, P>(vrow, irow, j0, w, pos);
      int grp = j0 / keep;
      int r = j0 - grp * keep;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const bool ok = pos[p] < m;  // a position outside its group adds 0
        const int col = ok ? grp * m + pos[p] : 0;
        const float wp = ok ? w[p] : 0.0f;
        float xv[MAXB];
        load_xcol(xs, xslot(col), xv);
#pragma unroll
        for (int i = 0; i < MAXB; ++i) acc[i] = fmaf(wp, xv[i], acc[i]);
        if (++r == keep) {
          r = 0;
          ++grp;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MAXB; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
    }
    // every lane holds every sum: lane i writes row r0 + i
#pragma unroll
    for (int i = 0; i < MAXB; ++i)
      if (lane == i && i < nr) store(ye + static_cast<int64_t>(i) * c + row, acc[i]);
  }
}

template <typename T, int IDX_BITS, int P>
int launch_stacked_p(const void* x, const void* vals, const void* idx, void* y,
                     int E, int C, int c, int b, int m, int keep, int L,
                     int idx_stride, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(MAXB) * ((b + 7) & ~7) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nm_stacked_kernel<T, IDX_BITS, P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((c + WARPS * RPW - 1) / (WARPS * RPW), (C + MAXB - 1) / MAXB,
                  E);
  nm_stacked_kernel<T, IDX_BITS, P><<<grid, WARPS * 32, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(vals),
      static_cast<const uint8_t*>(idx), static_cast<T*>(y), C, c, b, m, keep,
      L, idx_stride);
  return 0;
}

template <typename T, int IDX_BITS>
int launch_stacked(const void* x, const void* vals, const void* idx, void* y,
                   int vec, int E, int C, int c, int b, int m, int keep, int L,
                   int idx_stride, cudaStream_t s) {
  return vec ? launch_stacked_p<T, IDX_BITS, 8>(x, vals, idx, y, E, C, c, b, m,
                                                keep, L, idx_stride, s)
             : launch_stacked_p<T, IDX_BITS, 1>(x, vals, idx, y, E, C, c, b, m,
                                                keep, L, idx_stride, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, values and y share it).
// vec: 1 = the 16-byte vector path (caller checked L % 8 == 0 and 16-byte
// aligned base pointers).  Returns cudaGetLastError().
extern "C" int nm_matmul(const void* x, const void* vals, const void* idx,
                         void* y, int dtype, int idx_bits, int vec, int B,
                         int c, int b, int m, int keep, int L, int idx_stride,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || c <= 0) return static_cast<int>(cudaGetLastError());
  if (dtype == 0 && idx_bits == 4) {
    launch<float, 4>(x, vals, idx, y, vec, B, c, b, m, keep, L, idx_stride, s);
  } else if (dtype == 0 && idx_bits == 8) {
    launch<float, 8>(x, vals, idx, y, vec, B, c, b, m, keep, L, idx_stride, s);
  } else if (dtype == 1 && idx_bits == 4) {
    launch<__nv_bfloat16, 4>(x, vals, idx, y, vec, B, c, b, m, keep, L,
                             idx_stride, s);
  } else if (dtype == 1 && idx_bits == 8) {
    launch<__nv_bfloat16, 8>(x, vals, idx, y, vec, B, c, b, m, keep, L,
                             idx_stride, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3.  dtype / idx_bits / vec as for nm_matmul (vec also needs the expert
// strides c·L and c·idx_stride to keep 16-byte alignment, which L % 8 == 0
// gives).  Shared memory: MAXB·⌈b/8⌉·8 elements of x's dtype a block; the
// caller keeps it within 227 KB.  Returns cudaGetLastError().
extern "C" int nm_matmul_stacked(const void* x, const void* vals,
                                 const void* idx, void* y, int dtype,
                                 int idx_bits, int vec, int E, int C, int c,
                                 int b, int m, int keep, int L, int idx_stride,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0 || C <= 0 || c <= 0) return static_cast<int>(cudaGetLastError());
  if (E > 65535 || (C + MAXB - 1) / MAXB > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if (dtype == 0 && idx_bits == 4) {
    err = launch_stacked<float, 4>(x, vals, idx, y, vec, E, C, c, b, m, keep,
                                   L, idx_stride, s);
  } else if (dtype == 0 && idx_bits == 8) {
    err = launch_stacked<float, 8>(x, vals, idx, y, vec, E, C, c, b, m, keep,
                                   L, idx_stride, s);
  } else if (dtype == 1 && idx_bits == 4) {
    err = launch_stacked<__nv_bfloat16, 4>(x, vals, idx, y, vec, E, C, c, b, m,
                                           keep, L, idx_stride, s);
  } else if (dtype == 1 && idx_bits == 8) {
    err = launch_stacked<__nv_bfloat16, 8>(x, vals, idx, y, vec, E, C, c, b, m,
                                           keep, L, idx_stride, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
