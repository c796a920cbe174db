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
// far below the tensor-core line.  bf16 2:4 (the served format) takes the
// tensor-core path (nm_tc_kernel, mode 2; see its note), whose design
// answers what held the warp-per-row kernel (nm_kernel) back:
//   * x is staged once per block in shared memory (only the nr rows that
//     exist, K3's padded layout), so no kept weight gathers from global
//     memory and B = 4 costs about what B = 1 does;
//   * every weight byte of a block (8 output rows: 20–56 KB at the path
//     shapes) is requested at once by TMA bulk copies before the x
//     staging, instead of a chain of dependent loads;
//   * one 2:4 group per lane is expanded by a byte permute into the B
//     registers of an mma.sync m16n8k16 whose A is the staged x rows
//     (K3's tc_window), so a kept weight costs a fraction of an
//     instruction at every B ≤ 8;
//   * 8-row blocks give 256–704 blocks at the large path shapes; rows too
//     wide for one block's shared memory are split over a cluster of CTAs
//     that sums its partial tiles through distributed shared memory in a
//     fixed order (one launch, the same y every run).
// From B = _ROWS_MIN_B activation rows on (nm_spmm.py), bf16 2:4 takes the
// many-row kernel instead (nm_sp_rows_kernel, mode 3; see its note).  There
// the 8-row blocks would stream every weight byte ⌈B/8⌉ times — 16 times at
// decode's B = 128, 750 times at whisper's encoder (B = 6 000) — where the
// work is bound by the weight bytes read once (B = 128: 0.625 of the dense
// bytes) and, by B = 6 000, by the tensor-core rate.  Its blocks hold 128
// or 256 output rows × 64 or 128 activation rows, so each weight tile is
// read once for all of them; the products run on Hopper's 2:4 sparse
// tensor cores (wgmma.mma_async.sp, x read from shared memory), fed by TMA,
// with the hardware's metadata built in registers from the stored
// positions.
// Below B = _ROWS_MIN_B, bf16 2:4 with 16-byte index rows takes the decode
// kernel (nm_sp_dec_kernel, mode 4; see its note) where the plan measured
// it faster than the 8-row kernel, and rows too wide for an 8-row block up
// to B = 8 (the many-row kernel past it): the same sparse tensor cores on 64-row
// tiles of weights streamed through a TMA ring, N = 8·⌈B/8⌉ activation
// rows, the K range split over a cluster so that the grid covers the card.
// The 8-row kernel keeps the rows where its lower fixed cost wins and an x
// that is not 16-byte aligned.
// The tiles, cluster split and shared memory come from the host's plan
// (kernels/nm_spmm.py::_k2_plan).  fp32, n:m other than 2:4 and rows that
// are not 16-byte aligned (on no served path) keep nm_kernel:
// one warp per output row, 16-byte value loads with the matching index
// bytes (a scalar path for unaligned rows), x read through the read-only
// cache, up to MAXB activation rows per pass.  The ragged
// edges (c not a multiple of the rows per block, B not a multiple of MAXB)
// are masked here; nothing is padded by the caller.
//
// K3: the stacked expert matmul y[e] = x[e] · W_eᵀ over one stacked leaf
// (entry point nm_matmul_stacked).  Replaces repro/kernels/ops.py::
// nm_matmul_stacked, whose Pallas branch launches _nm_kernel once per
// expert; here it is ONE launch.  values (E, c, L), indices (E, c,
// idx_stride) and x (E, C, b) are addressed by expert stride; y is
// (E, C, c).  A block owns one expert (blockIdx.z), one group of MAXB
// capacity rows (blockIdx.y) and BLOCK_ROWS = 128 output rows (blockIdx.x),
// so an expert's x rows are staged 6 (gate/up) or 16 (down) times at full
// width, not 24 / 64 as with 32-row blocks.
//
// Bound on the H100: K3 is bound by the bytes it moves — the weights of
// the row groups it computes (values + indices, ≈ 252 MB for a full
// 128-expert leaf, 75 µs at 3.35 TB/s), x and y.  Its operations (2 per
// kept weight and capacity row) are far below the tensor-core line.  The
// design keeps that stream full and streams only what the data needs:
//   * Skip.  Each block first reduces "is any of its x rows ≠ 0" with
//     __syncthreads_or.  A row group that is all zero (every unrouted
//     expert at decode: the dispatch zero-fills capacity rows no token was
//     routed to, and the down leaf's input act(0)·0 is zero there too)
//     writes its y rows as +0 and exits before any weight load.  The
//     decision is per (expert, row group), on the device, with no host sync
//     and no extra input.  For finite weights y is bitwise what the full
//     computation gives (sums of ±0 products starting from +0 stay +0).
//     CAVEAT: a non-finite weight in a skipped expert gives 0 where the
//     plain version gives NaN; the prune guards (solution_finite) keep
//     served weights finite.
//   * A pipelined weight stream.  The block's rows of values and indices
//     stream through a ring of NST shared-memory stages, filled by TMA bulk
//     copies (cp.async.bulk, completion on one mbarrier per stage).  The
//     first stages are issued right after the skip vote, ahead of the x
//     staging and its barrier; a stage is refilled as soon as every warp is
//     done with it.  Stages hold ~16–20 KB, so 2–3 stages of every resident
//     block (≥ 40 KB a SM) are in flight.
//   * bf16 2:4 (the served format) runs on the tensor cores (mode 2,
//     nm_stacked_tc_kernel; see its note): each lane expands ONE 2:4 group
//     into its two B registers of an mma.sync m16n8k16 whose A is the 8
//     staged x rows, so a kept weight costs a fraction of an instruction.
//     Stages hold 8 or 16 output rows (two bulk copies, values and
//     indices); the 8 warps split the columns and sum their partial tiles
//     in shared memory.
//   * Other n:m and fp32 (mode 1, nm_stacked_kernel) run on the CUDA cores
//     from the same ring: x staged column-major (the MAXB values of a
//     column in one 16-byte slot, XOR-swizzled by 16-column block), so one
//     or two shared loads give a kept weight's activations for all rows;
//     G lanes share a row, G = 32 when the row's 8-value chunks fill whole
//     warp steps, else 16 (L = 384 is 48 chunks: three steps of a
//     half-warp, two rows a warp), fp32 sums and one log2(G)-step shuffle
//     reduction per row.
// Rows whose value or index bytes are not 16-byte aligned (L % 8 ≠ 0,
// idx_stride % 16 ≠ 0, or unaligned bases) take the scalar path (mode 0):
// the same blocks, skip and x staging, each lane loading one kept value at
// a time straight from global memory.  Ragged c and C are masked here.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

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
constexpr int K3_THREADS = 256;
constexpr int BLOCK_ROWS = 128;  // output rows of one expert per block
constexpr int NST = 3;           // stages in the weight ring
constexpr int SMEM_MAX = 232448;  // 227 KB: shared memory a block may use

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

// Magnitude bits of the values packed in a 32-bit word: a value is ≠ 0
// iff one of its magnitude bits is set (−0 counts as zero, NaN as not).
__device__ __forceinline__ uint32_t magnitude_bits(float) { return 0x7fffffffu; }
__device__ __forceinline__ uint32_t magnitude_bits(__nv_bfloat16) {
  return 0x7fff7fffu;
}

// Whether any of p[0..n) is ≠ 0, for this thread's share (16-byte loads
// between a scalar head and tail).
template <typename T>
__device__ __forceinline__ int any_nonzero(const T* p, int64_t n) {
  int nz = 0;
  const int64_t mis = static_cast<int64_t>(reinterpret_cast<uintptr_t>(p) & 15);
  int64_t head = ((16 - mis) & 15) / static_cast<int64_t>(sizeof(T));
  if (head > n) head = n;
  for (int64_t i = threadIdx.x; i < head; i += blockDim.x)
    nz |= to_f32(p[i]) != 0.0f;
  const int64_t nvec = (n - head) * static_cast<int64_t>(sizeof(T)) / 16;
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  const uint32_t mag = magnitude_bits(T{});
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < nvec; i += blockDim.x) {
    const uint4 w = __ldg(v + i);
    nz |= ((w.x | w.y | w.z | w.w) & mag) != 0u;
  }
  const int64_t tail = head + nvec * (16 / static_cast<int64_t>(sizeof(T)));
  for (int64_t i = tail + threadIdx.x; i < n; i += blockDim.x)
    nz |= to_f32(p[i]) != 0.0f;
  return nz;
}

__device__ __forceinline__ uint32_t raw_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t raw_bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// x[e, r0:r0+nr, :] into its column-major slots, one thread per column,
// zeros past nr and b.
template <typename T>
__device__ __forceinline__ void stage_x(T* xs, const T* xe, int nr, int b) {
  constexpr int PER = static_cast<int>(4 / sizeof(T));  // values per word
  constexpr int WORDS = MAXB / PER;
  const int bp = (b + 7) & ~7;  // the swizzle stays inside 8-column groups
  for (int col = threadIdx.x; col < bp; col += blockDim.x) {
    uint32_t wd[WORDS];
#pragma unroll
    for (int q = 0; q < WORDS; ++q) wd[q] = 0u;
#pragma unroll
    for (int r = 0; r < MAXB; ++r) {
      if (r < nr && col < b)
        wd[r / PER] |= raw_bits(xe[static_cast<int64_t>(r) * b + col])
                       << (32 / PER * (r % PER));
    }
    uint4* dst = reinterpret_cast<uint4*>(xs + xslot(col) * MAXB);
#pragma unroll
    for (int q = 0; q < WORDS / 4; ++q)
      dst[q] = make_uint4(wd[4 * q], wd[4 * q + 1], wd[4 * q + 2],
                          wd[4 * q + 3]);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  uint64_t state;  // the arrival's phase token, not needed here
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
               : "=l"(state)
               : "r"(smem_u32(bar)), "r"(bytes)
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
// One TMA bulk copy global → shared, completing `bytes` on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// acc[i] += Σ_p w[p] · x[i, col(p)] for P consecutive kept values from j0.
template <typename T, int P>
__device__ __forceinline__ void fma_chunk(const T* xs, int j0, int m, int keep,
                                          const float (&w)[P],
                                          const int (&pos)[P],
                                          float (&acc)[MAXB]) {
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

// Sum acc over the G lanes of a row (G a power of two, groups aligned), then
// lane i < nr of the group writes capacity row i.  Warp-uniform: every lane
// of the warp calls it, `live` says whether this lane's row exists.
template <typename T>
__device__ __forceinline__ void reduce_store(float (&acc)[MAXB], int G, int lg,
                                             bool live, int nr, T* yrow,
                                             int64_t c) {
#pragma unroll
  for (int i = 0; i < MAXB; ++i) {
    for (int off = G >> 1; off > 0; off >>= 1)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
#pragma unroll
  for (int i = 0; i < MAXB; ++i)
    if (live && lg == i && i < nr) store(yrow + i * c, acc[i]);
}

// PIPE: the ring path (16-byte aligned rows, G and SR from the host);
// otherwise the scalar path (G = 32, SR unused).
template <typename T, int IDX_BITS, bool PIPE>
__global__ void __launch_bounds__(K3_THREADS, 2)
nm_stacked_kernel(const T* __restrict__ x, const T* __restrict__ vals,
                  const uint8_t* __restrict__ idx, T* __restrict__ y, int C,
                  int c, int b, int m, int keep, int L, int idx_stride, int G,
                  int SR) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[NST];
  const int tid = threadIdx.x;
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * MAXB;
  const int nr = min(MAXB, C - r0);
  const int row0 = blockIdx.x * BLOCK_ROWS;
  const int nrows = min(c - row0, BLOCK_ROWS);
  const T* xe = x + (static_cast<int64_t>(e) * C + r0) * b;
  T* ye = y + (static_cast<int64_t>(e) * C + r0) * c + row0;

  // 1. skip: an all-zero row group gives y = +0 without a weight byte read
  if (!__syncthreads_or(any_nonzero(xe, static_cast<int64_t>(nr) * b))) {
    for (int l = tid; l < nr * nrows; l += K3_THREADS) {
      const int i = l / nrows;
      store(ye + static_cast<int64_t>(i) * c + (l - i * nrows), 0.0f);
    }
    return;
  }

  const int vbytes = L * static_cast<int>(sizeof(T));
  const int row_bytes = vbytes + idx_stride;
  const int nstages = PIPE ? (nrows + SR - 1) / SR : 0;
  unsigned char* ring = smem;
  T* xs = reinterpret_cast<T*>(smem + (PIPE ? NST * SR * row_bytes : 0));
  const T* ve = vals + (static_cast<int64_t>(e) * c + row0) * L;
  const uint8_t* ie = idx + (static_cast<int64_t>(e) * c + row0) * idx_stride;

  // 2. start the weight stream (thread 0), ahead of the x staging
  auto issue = [&](int s) {
    const int slot = s % NST;
    const int rows = min(SR, nrows - s * SR);
    unsigned char* dv = ring + slot * SR * row_bytes;
    const uint32_t bv = static_cast<uint32_t>(rows * vbytes);
    const uint32_t bi = static_cast<uint32_t>(rows * idx_stride);
    mbar_expect_tx(&full[slot], bv + bi);
    bulk_load(dv, ve + static_cast<int64_t>(s) * SR * L, bv, &full[slot]);
    bulk_load(dv + SR * vbytes, ie + static_cast<int64_t>(s) * SR * idx_stride,
              bi, &full[slot]);
  };
  if (PIPE && tid == 0) {
    for (int s = 0; s < NST; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < min(NST, nstages); ++s) issue(s);
  }

  // 3. stage x, then stream the rows
  stage_x(xs, xe, nr, b);
  __syncthreads();

  const int lane = tid & 31;
  const int lg = lane & (G - 1);          // lane within its row group
  const int gpw = 32 / G;                 // rows a warp takes at once
  const int ng = K3_THREADS / G;          // rows the block takes at once
  const int rfirst = (tid >> 5) * gpw;    // warp-uniform row base
  const int sub = lane / G;

  if constexpr (PIPE) {
    const int chunks = L / 8;
    for (int s = 0; s < nstages; ++s) {
      const int slot = s % NST;
      mbar_wait(&full[slot], static_cast<uint32_t>((s / NST) & 1));
      const int rows = min(SR, nrows - s * SR);
      const T* sv = reinterpret_cast<const T*>(ring + slot * SR * row_bytes);
      const uint8_t* si = ring + slot * SR * row_bytes + SR * vbytes;
      for (int rb = rfirst; rb < rows; rb += ng) {
        const int rr = rb + sub;
        const bool live = rr < rows;
        float acc[MAXB];
#pragma unroll
        for (int i = 0; i < MAXB; ++i) acc[i] = 0.0f;
        if (live) {
          const T* vrow = sv + rr * L;
          const uint8_t* irow = si + rr * idx_stride;
          for (int ch = lg; ch < chunks; ch += G) {
            float w[8];
            int pos[8];
            load_chunk<T, IDX_BITS, 8>(vrow, irow, ch * 8, w, pos);
            fma_chunk<T, 8>(xs, ch * 8, m, keep, w, pos, acc);
          }
        }
        reduce_store(acc, G, lg, live, nr, ye + s * SR + rr, c);
      }
      __syncthreads();  // every warp is done with this slot: refill it
      if (tid == 0 && s + NST < nstages) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        issue(s + NST);
      }
    }
  } else {
    for (int rb = rfirst; rb < nrows; rb += ng) {
      const int rr = rb + sub;
      const bool live = rr < nrows;
      float acc[MAXB];
#pragma unroll
      for (int i = 0; i < MAXB; ++i) acc[i] = 0.0f;
      if (live) {
        const T* vrow = ve + static_cast<int64_t>(rr) * L;
        const uint8_t* irow = ie + static_cast<int64_t>(rr) * idx_stride;
        for (int j0 = lg; j0 < L; j0 += G) {
          float w[1];
          int pos[1];
          load_chunk<T, IDX_BITS, 1>(vrow, irow, j0, w, pos);
          fma_chunk<T, 1>(xs, j0, m, keep, w, pos, acc);
        }
      }
      reduce_store(acc, G, lg, live, nr, ye + rr, c);
    }
  }
}

// ---- K3 on the tensor cores: bf16, 2:4 ---------------------------------------
// y[i, o] = Σ_k x[i, k] · W[o, k] as mma.sync m16n8k16 (bf16 → fp32) with
// A = the block's 8 capacity rows of x (rows 8–15 of the tile are zero) and
// B = Wᵀ for 8 output rows, expanded from the compressed form in registers.
// The k labels of the mma are free to permute as long as A and B agree:
// the lanes with tig t take labels {2t, 2t+1, 2t+8, 2t+9} ↔ the 4 columns of
// ONE 2:4 group, so a lane expands one group (2 kept values, 2 positions)
// into its two B registers and reads the 4 matching x values as its two A
// registers.  A stage holds 8·RT output rows (RT row tiles of n = 8, RT = 2
// when rows are short, so a stage stays ~16 KB); the 8 warps split the
// columns in macro windows of 16·NW columns (each lane NW consecutive
// groups: one 4·NW-byte load of values and one load of index bytes per row
// tile, one 8·NW-byte load of x shared by the RT tiles) and sum their
// partial tiles in shared memory.
constexpr int TC_WARPS = K3_THREADS / 32;

// Padded shared-memory stride of the x rows: ≡ 16 (mod 128) bytes, so the
// 8 rows a warp reads at once hit different banks.  (The weight rows keep
// their global layout: two bulk copies a stage measured faster than one
// copy per padded row.)
__host__ __device__ constexpr int pad_to(int bytes, int rem) {
  return ((bytes + 127 - rem) / 128) * 128 + rem;
}

template <int NBYTES>
__device__ __forceinline__ void lds_words(const unsigned char* p,
                                          uint32_t (&w)[(NBYTES + 3) / 4]) {
  if constexpr (NBYTES == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (NBYTES == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else if constexpr (NBYTES == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    static_assert(NBYTES == 2, "2, 4, 8 or 16 bytes");
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  }
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0,
                                               uint32_t a2, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// x << s with PTX's clamp: 0 once s ≥ 32 (C++ leaves that undefined).
__device__ __forceinline__ uint32_t shl_clamped(uint32_t x, uint32_t s) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(s));
  return r;
}

// One 2:4 group from its two kept values v (raw bf16 bits, the first in
// the low half) at in-group positions p0 ≠ p1, given as 8·p0 and 8·p1, to
// the dense group (lo = positions 0, 1; hi = 2, 3) by one byte
// permutation of {v, 0}: selector nibble j picks byte j of the dense
// group, 4 (a zero byte) by default, 1 0 for the first value at 2·p0 and
// 3 2 for the second at 2·p1.  A position ≥ 4 shifts out and adds 0.
__device__ __forceinline__ void expand_group(uint32_t v, uint32_t p0x8,
                                             uint32_t p1x8, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t sel = 0x44444444u ^ shl_clamped(0x54u, p0x8) ^
                       shl_clamped(0x76u, p1x8);
  lo = __byte_perm(v, 0u, sel);
  hi = __byte_perm(v, 0u, sel >> 16);
}

// One macro window of the tensor-core paths (K2 and K3): the lane's NW
// consecutive 2:4 groups from group q0 on, for RT row tiles of 8 output
// rows.  xrow is the lane's staged x row (A row g), read only when xlive
// (else A is zero); vrow / irow are the lane's weight row (B column g) of
// tile 0 in shared memory, with row strides sv / si bytes.
template <int IDX_BITS, int NW, int RT>
__device__ __forceinline__ void tc_window(const unsigned char* xrow, bool xlive,
                                          const unsigned char* vrow, int sv,
                                          const unsigned char* irow, int si,
                                          int q0, float (&d)[RT][4]) {
  constexpr int IB = NW * IDX_BITS / 4;  // index bytes a lane reads
  uint32_t xw[2 * NW];  // x[g, 4 columns of each group]: a0, a2 pairs
#pragma unroll
  for (int h = 0; h < NW / 2; ++h) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (xlive) v = *reinterpret_cast<const uint4*>(xrow + q0 * 8 + 16 * h);
    xw[4 * h] = v.x; xw[4 * h + 1] = v.y;
    xw[4 * h + 2] = v.z; xw[4 * h + 3] = v.w;
  }
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) {
    uint32_t vw[NW];
    uint32_t iw[(IB + 3) / 4];
    lds_words<4 * NW>(vrow + rt * 8 * sv + q0 * 4, vw);
    lds_words<IB>(irow + rt * 8 * si + q0 * IDX_BITS / 4, iw);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      uint32_t p0x8, p1x8;  // 8 × the two in-group positions
      if constexpr (IDX_BITS == 4) {
        p0x8 = (iw[0] << 3 >> (8 * w)) & 0x78u;
        p1x8 = (iw[0] >> (8 * w + 1)) & 0x78u;
      } else {
        const uint32_t half = iw[w >> 1] >> (16 * (w & 1));
        p0x8 = (half & 0xFFu) << 3;
        p1x8 = (half >> 5) & 0x7F8u;
      }
      uint32_t lo, hi;
      expand_group(vw[w], p0x8, p1x8, lo, hi);
      mma_bf16_16816(d[rt], xw[2 * w], xw[2 * w + 1], lo, hi);
    }
  }
}

template <int IDX_BITS, int NW, int RT>
__global__ void __launch_bounds__(K3_THREADS, 2)
nm_stacked_tc_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ vals,
                     const uint8_t* __restrict__ idx,
                     __nv_bfloat16* __restrict__ y, int C, int c, int b,
                     int L, int idx_stride) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[NST];
  const int tid = threadIdx.x;
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * MAXB;
  const int nr = min(MAXB, C - r0);
  const int row0 = blockIdx.x * BLOCK_ROWS;
  const int nrows = min(c - row0, BLOCK_ROWS);
  const __nv_bfloat16* xe = x + (static_cast<int64_t>(e) * C + r0) * b;
  __nv_bfloat16* ye = y + (static_cast<int64_t>(e) * C + r0) * c + row0;

  if (!__syncthreads_or(any_nonzero(xe, static_cast<int64_t>(nr) * b))) {
    for (int l = tid; l < nr * nrows; l += K3_THREADS) {
      const int i = l / nrows;
      store(ye + static_cast<int64_t>(i) * c + (l - i * nrows), 0.0f);
    }
    return;
  }

  const int vbytes = L * 2;
  const int sv = vbytes, si = idx_stride;  // stage rows as in global memory
  const int sx = pad_to(2 * b, 16);
  constexpr int SR = 8 * RT;  // output rows of a stage
  const int stage = SR * (sv + si);
  const int nstages = (nrows + SR - 1) / SR;
  unsigned char* ring = smem;
  unsigned char* xs = smem + NST * stage;
  float* red = reinterpret_cast<float*>(xs + MAXB * sx);  // [2][warps][RT·64]
  const __nv_bfloat16* ve = vals + (static_cast<int64_t>(e) * c + row0) * L;
  const uint8_t* ie = idx + (static_cast<int64_t>(e) * c + row0) * idx_stride;

  // two bulk copies a stage, the stage's rows of values and of indices
  // (contiguous in global memory), from lane 0 of warp 0
  auto issue = [&](int s, int lane) {
    if (lane != 0) return;
    const int slot = s % NST;
    const int rows = min(SR, nrows - s * SR);
    const uint32_t bv = static_cast<uint32_t>(rows * vbytes);
    const uint32_t bi = static_cast<uint32_t>(rows * idx_stride);
    unsigned char* d = ring + slot * stage;
    mbar_expect_tx(&full[slot], bv + bi);
    bulk_load(d, ve + static_cast<int64_t>(s) * SR * L, bv, &full[slot]);
    bulk_load(d + SR * sv, ie + static_cast<int64_t>(s) * SR * idx_stride, bi,
              &full[slot]);
  };
  const int lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 0)
    for (int s = 0; s < min(NST, nstages); ++s) issue(s, lane);

  // x rows in natural layout (zeros past nr): 16-byte loads, four in
  // flight a thread, where the rows are aligned
  const int per_row = b / 8;  // b % 32 == 0
  if ((reinterpret_cast<uintptr_t>(xe) & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(xe);
    for (int l0 = tid; l0 < MAXB * per_row; l0 += 4 * K3_THREADS) {
      uint4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int l = l0 + k * K3_THREADS;
        const int r = l / per_row;
        v[k] = make_uint4(0u, 0u, 0u, 0u);
        if (l < MAXB * per_row && r < nr) v[k] = __ldg(src + l);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int l = l0 + k * K3_THREADS;
        const int r = l / per_row;
        if (l < MAXB * per_row)
          reinterpret_cast<uint4*>(xs + r * sx)[l - r * per_row] = v[k];
      }
    }
  } else {
    for (int l = tid; l < MAXB * b; l += K3_THREADS) {
      const int r = l / b;
      __nv_bfloat16 v;
      store(&v, 0.0f);
      if (r < nr) v = xe[l];
      reinterpret_cast<__nv_bfloat16*>(xs + r * sx)[l - r * b] = v;
    }
  }
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  constexpr int MW = 16 * NW;              // columns of a macro window
  const int nmac = b / MW;
  for (int s = 0; s < nstages; ++s) {
    const int slot = s % NST;
    mbar_wait(&full[slot], static_cast<uint32_t>((s / NST) & 1));
    const unsigned char* vrow = ring + slot * stage + g * sv;
    const unsigned char* irow = ring + slot * stage + SR * sv + g * si;
    const unsigned char* xrow = xs + g * sx;
    float d[RT][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
      d[rt][0] = d[rt][1] = d[rt][2] = d[rt][3] = 0.0f;
    for (int mac = warp; mac < nmac; mac += TC_WARPS)
      tc_window<IDX_BITS, NW, RT>(xrow, true, vrow, sv, irow, si,
                                  mac * 4 * NW + NW * t, d);
    // d[rt][0..1]: capacity row g, output rows 8·rt + 2t, +1 of the stage
    float* rb = red + ((s & 1) * TC_WARPS + warp) * RT * 64;
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
      *reinterpret_cast<float2*>(rb + rt * 64 + g * 8 + 2 * t) =
          make_float2(d[rt][0], d[rt][1]);
    __syncthreads();  // slot consumed, partial tiles written
    if (warp == 0 && s + NST < nstages) {
      if (lane == 0) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      issue(s + NST, lane);
    }
    if (tid < RT * 64) {
      const int i = (tid & 63) >> 3;
      const int rr = s * SR + (tid >> 6) * 8 + (tid & 7);
      const float* rs = red + (s & 1) * TC_WARPS * RT * 64 + tid;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < TC_WARPS; ++w) sum += rs[w * RT * 64];
      if (i < nr && rr < nrows) store(ye + static_cast<int64_t>(i) * c + rr, sum);
    }
  }
}

template <int IDX_BITS, int NW, int RT>
int launch_tc(const void* x, const void* vals, const void* idx, void* y,
              int E, int C, int c, int b, int L, int idx_stride, size_t smem,
              cudaStream_t s) {
  auto kern = nm_stacked_tc_kernel<IDX_BITS, NW, RT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((c + BLOCK_ROWS - 1) / BLOCK_ROWS, (C + MAXB - 1) / MAXB, E);
  kern<<<grid, K3_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(vals),
      static_cast<const uint8_t*>(idx), static_cast<__nv_bfloat16*>(y), C, c,
      b, L, idx_stride);
  return 0;
}

// NW = 4 when the 64-column windows split evenly over the 8 warps, else 2;
// SR = 8·RT output rows a stage.
template <int IDX_BITS>
int launch_stacked_tc(const void* x, const void* vals, const void* idx,
                      void* y, int E, int C, int c, int b, int L,
                      int idx_stride, int SR, cudaStream_t s) {
  const size_t smem =
      static_cast<size_t>(NST) * SR * (2 * L + idx_stride) +
      static_cast<size_t>(MAXB) * pad_to(2 * b, 16) + 2 * TC_WARPS * SR * 8 * 4;
  if (smem + NST * sizeof(uint64_t) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool nw4 = b % 64 == 0 && (b / 64) % TC_WARPS == 0;
  if (SR == 8)
    return nw4 ? launch_tc<IDX_BITS, 4, 1>(x, vals, idx, y, E, C, c, b, L, idx_stride, smem, s)
               : launch_tc<IDX_BITS, 2, 1>(x, vals, idx, y, E, C, c, b, L, idx_stride, smem, s);
  return nw4 ? launch_tc<IDX_BITS, 4, 2>(x, vals, idx, y, E, C, c, b, L, idx_stride, smem, s)
             : launch_tc<IDX_BITS, 2, 2>(x, vals, idx, y, E, C, c, b, L, idx_stride, smem, s);
}

template <typename T, int IDX_BITS, bool PIPE>
int launch_stacked_p(const void* x, const void* vals, const void* idx, void* y,
                     int E, int C, int c, int b, int m, int keep, int L,
                     int idx_stride, int G, int SR, cudaStream_t s) {
  size_t smem = static_cast<size_t>(MAXB) * ((b + 7) & ~7) * sizeof(T);
  if (PIPE) smem += static_cast<size_t>(NST) * SR * (L * sizeof(T) + idx_stride);
  if (smem + NST * sizeof(uint64_t) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nm_stacked_kernel<T, IDX_BITS, PIPE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((c + BLOCK_ROWS - 1) / BLOCK_ROWS, (C + MAXB - 1) / MAXB, E);
  nm_stacked_kernel<T, IDX_BITS, PIPE><<<grid, K3_THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(vals),
      static_cast<const uint8_t*>(idx), static_cast<T*>(y), C, c, b, m, keep,
      L, idx_stride, G, SR);
  return 0;
}

template <typename T, int IDX_BITS>
int launch_stacked(const void* x, const void* vals, const void* idx, void* y,
                   int mode, int E, int C, int c, int b, int m, int keep,
                   int L, int idx_stride, int G, int SR, cudaStream_t s) {
  const bool ring_ok = L % 8 == 0 && (L * sizeof(T)) % 16 == 0 &&
                       idx_stride % 16 == 0;
  if (mode == 2) {
    if (sizeof(T) != 2 || m != 4 || keep != 2 || !ring_ok || b % 32 != 0 ||
        (SR != 8 && SR != 16))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_stacked_tc<IDX_BITS>(x, vals, idx, y, E, C, c, b, L,
                                       idx_stride, SR, s);
  }
  if (mode == 1) {
    if ((G != 16 && G != 32) || SR < 1 || SR > BLOCK_ROWS || !ring_ok)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_stacked_p<T, IDX_BITS, true>(x, vals, idx, y, E, C, c, b, m,
                                               keep, L, idx_stride, G, SR, s);
  }
  return launch_stacked_p<T, IDX_BITS, false>(x, vals, idx, y, E, C, c, b, m,
                                              keep, L, idx_stride, 32, 0, s);
}

// ---- K2 on the tensor cores: bf16, 2:4 ---------------------------------------
// A block (K2_WARPS warps) owns 8 output rows — the n = 8 of one mma tile —
// one group of MAXB activation rows (blockIdx.y) and, in a cluster of CS
// CTAs along x, the CTA's 1/CS slice of the columns.  Every weight byte of
// the block is requested at once: warp 0 sets one mbarrier and issues its
// rows of values and of indices as bulk copies (two copies when CS = 1,
// where the rows are contiguous; one per row and array otherwise) before
// it stages its nr ≤ 8 x rows in K3's padded layout; lanes whose A row is
// ≥ nr use zero registers.  The
// warps split the columns in macro windows (tc_window, as K3) and sum
// their partial tiles in shared memory, warp by warp; a cluster then sums
// its CTAs' tiles through distributed shared memory, CTA by CTA, so y does
// not depend on timing.  Nothing is skipped: a non-finite weight gives NaN
// in y, as in the plain version.
//
// Chosen on the card (PERF.md): 8 warps, not 4 — once a block's bytes
// land, its windows finish sooner, and the grid's last blocks set the
// time; 8-row blocks, not 16; no cluster split at the path shapes, where
// every split measures slower (tools/k2_plan_sweep.py: the small shapes
// are latency-bound, and a CTA's fixed cost outweighs its share of the
// bytes).  The split stays for wide rows: the least CS whose slices fit
// in 227 KB of shared memory.  More, smaller bulk copies (a stage per 512
// columns, so compute starts before a block's last byte) and a
// programmatic dependent launch (the weight copies issued before the
// previous kernel ends) were both tried: the first measured slower at
// every path shape, the second gained only between back-to-back K2
// launches and lost after a torch op, as most of the path's launches are.
constexpr int K2_WARPS = 8;
constexpr int K2_THREADS = 32 * K2_WARPS;

template <int IDX_BITS, int NW>
__global__ void __launch_bounds__(K2_THREADS)
nm_tc_kernel(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ vals,
             const uint8_t* __restrict__ idx, __nv_bfloat16* __restrict__ y,
             int B, int c, int b, int L, int idx_stride, int CS) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x % CS;  // == the CTA's rank in its cluster
  const int row0 = blockIdx.x / CS * 8;
  const int rows = min(8, c - row0);
  const int r0 = blockIdx.y * MAXB;
  const int nr = min(MAXB, B - r0);
  const int bc = b / CS;             // columns of this CTA
  const int Lc = L / CS;             // kept values of a row in this CTA
  const int sv = 2 * Lc, si = idx_stride / CS;  // bytes of a row's slice
  const int sx = pad_to(2 * bc, 16);
  unsigned char* tile = smem;                    // [8][sv], then [8][si]
  unsigned char* xs = smem + 8 * (sv + si);      // [min(B, 8)][sx]
  float* red = reinterpret_cast<float*>(xs + min(MAXB, B) * sx);  // [W][64]
  float* tot = red + K2_WARPS * 64;                               // [64]

  if (tid == 0) {
    mbar_init(&full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) mbar_expect_tx(&full, static_cast<uint32_t>(rows * (sv + si)));
    __syncwarp();
    if (CS == 1) {
      if (lane == 0) {
        bulk_load(tile, vals + static_cast<int64_t>(row0) * L, rows * sv, &full);
        bulk_load(tile + 8 * sv, idx + static_cast<int64_t>(row0) * idx_stride,
                  rows * si, &full);
      }
    } else if (lane < 2 * rows) {
      const int r = lane >> 1;
      const int64_t o = row0 + r;
      if (lane & 1)
        bulk_load(tile + 8 * sv + r * si, idx + o * idx_stride + rank * si, si,
                  &full);
      else
        bulk_load(tile + r * sv, vals + o * L + rank * Lc, sv, &full);
    }
  }

  // this CTA's column slice of the nr x rows: 16-byte loads, four in
  // flight a thread, where the rows are aligned
  const __nv_bfloat16* xe = x + static_cast<int64_t>(r0) * b + rank * bc;
  const int per_row = bc / 8;
  if ((reinterpret_cast<uintptr_t>(xe) & 15) == 0) {
    for (int l0 = tid; l0 < nr * per_row; l0 += 4 * K2_THREADS) {
      uint4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int l = l0 + k * K2_THREADS;
        const int r = l / per_row;
        if (l < nr * per_row)
          v[k] = __ldg(reinterpret_cast<const uint4*>(
                           xe + static_cast<int64_t>(r) * b) + (l - r * per_row));
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int l = l0 + k * K2_THREADS;
        const int r = l / per_row;
        if (l < nr * per_row)
          reinterpret_cast<uint4*>(xs + r * sx)[l - r * per_row] = v[k];
      }
    }
  } else {
    for (int l = tid; l < nr * bc; l += K2_THREADS) {
      const int r = l / bc;
      reinterpret_cast<__nv_bfloat16*>(xs + r * sx)[l - r * bc] =
          xe[static_cast<int64_t>(r) * b + (l - r * bc)];
    }
  }
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  const int nmac = bc / (16 * NW);
  mbar_wait(&full, 0u);
  float d[1][4] = {{0.0f, 0.0f, 0.0f, 0.0f}};
  for (int mac = warp; mac < nmac; mac += K2_WARPS)
    tc_window<IDX_BITS, NW, 1>(xs + g * sx, g < nr, tile + g * sv, sv,
                               tile + 8 * sv + g * si, si,
                               mac * 4 * NW + NW * t, d);
  // d[0][0..1]: activation row g, output rows 2t, 2t + 1
  *reinterpret_cast<float2*>(red + warp * 64 + g * 8 + 2 * t) =
      make_float2(d[0][0], d[0][1]);
  __syncthreads();

  // tid → (activation row i, output row rr): warps summed in order
  const int i = tid >> 3, rr = tid & 7;
  const bool out = tid < 64 && i < nr && rr < rows;
  float sum = 0.0f;
  if (tid < 64) {
#pragma unroll
    for (int w = 0; w < K2_WARPS; ++w) sum += red[w * 64 + tid];
  }
  __nv_bfloat16* yo = y + static_cast<int64_t>(r0 + i) * c + row0 + rr;
  if (CS == 1) {
    if (out) store(yo, sum);
    return;
  }
  // the cluster's CTAs in rank order, each output summed by one CTA
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  if (tid < 64) tot[tid] = sum;
  cluster.sync();
  if (out && tid % CS == rank) {
    float acc = 0.0f;
    for (int q = 0; q < CS; ++q) acc += *cluster.map_shared_rank(tot + tid, q);
    store(yo, acc);
  }
  cluster.sync();  // no CTA leaves while its tile may still be read
}

// Dynamic shared memory of nm_tc_kernel, as _k2_smem computes it.
size_t tc_smem(int B, int b, int L, int idx_stride, int CS) {
  return static_cast<size_t>(8) * (2 * (L / CS) + idx_stride / CS) +
         static_cast<size_t>(min(MAXB, B)) * pad_to(2 * (b / CS), 16) +
         static_cast<size_t>(K2_WARPS + 1) * 64 * 4;
}

template <int IDX_BITS, int NW>
int launch_k2_tc(const void* x, const void* vals, const void* idx, void* y,
                 int B, int c, int b, int L, int idx_stride, int CS,
                 size_t smem, cudaStream_t s) {
  auto kern = nm_tc_kernel<IDX_BITS, NW>;
  static size_t smem_set = 48 * 1024;  // the variant's limit so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((c + 7) / 8 * CS),
                     static_cast<unsigned>((B + MAXB - 1) / MAXB));
  cfg.blockDim = dim3(K2_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = static_cast<unsigned>(CS);
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = CS > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kern, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(vals),
      static_cast<const uint8_t*>(idx), static_cast<__nv_bfloat16*>(y), B, c,
      b, L, idx_stride, CS));
}

// The checks of _k2_plan's tensor-core path, then NW = 4 when a CTA's
// columns split into 64-column windows, else 2.
int launch_k2_tc_checked(const void* x, const void* vals, const void* idx,
                         void* y, int idx_bits, int B, int c, int b, int m,
                         int keep, int L, int idx_stride, int CS, int smem,
                         cudaStream_t s) {
  const bool cs_ok = CS == 1 || CS == 2 || CS == 4 || CS == 8;
  if (m != 4 || keep != 2 || L * 2 != b || !cs_ok || b % (32 * CS) != 0 ||
      idx_stride != L * idx_bits / 8 || (idx_stride / CS) % 16 != 0 ||
      (B + MAXB - 1) / MAXB > 65535 ||
      static_cast<size_t>(smem) != tc_smem(B, b, L, idx_stride, CS) ||
      smem + sizeof(uint64_t) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool nw4 = (b / CS) % 64 == 0;
  if (idx_bits == 4)
    return nw4 ? launch_k2_tc<4, 4>(x, vals, idx, y, B, c, b, L, idx_stride, CS, smem, s)
               : launch_k2_tc<4, 2>(x, vals, idx, y, B, c, b, L, idx_stride, CS, smem, s);
  return nw4 ? launch_k2_tc<8, 4>(x, vals, idx, y, B, c, b, L, idx_stride, CS, smem, s)
             : launch_k2_tc<8, 2>(x, vals, idx, y, B, c, b, L, idx_stride, CS, smem, s);
}

// ---- K2 for many activation rows: bf16 2:4 on the sparse tensor cores -------
// mode 3, nm_sp_rows_kernel.  The transposed tile yᵀ = W · xᵀ, so that W is
// the sparse A operand of wgmma.mma_async.sp m64nNk32 (M = output rows,
// K = b, 2:4 along K as the hardware takes it) and x (B, b) row-major is
// the K-major B operand as it lies in memory (N = activation rows).  A
// block of two warpgroups owns BM = 128 or 256 output rows (one or two
// 64-row slices a warpgroup) × BN = 64 or 128 activation rows and reads its
// weight tile once for all of them (the mode-2 block re-streams it for
// every 8 rows).  256-row blocks serve each x tile to twice the weight
// rows: at B = 6 000 the x tiles, read from L2 by every block, are what the
// 128-row blocks waited on.
//
// Its K range walks a ring of 3–4 shared-memory stages of SP_KS · 32
// columns: the value tile and the two x sub-tiles come by TMA (2-D tensor
// maps, 128-byte swizzle, zero fill past c, B and b) and the index bytes by
// cp.async (their rows need not be 16-byte strided), all completing on one
// mbarrier a stage (cp.async.mbarrier.arrive).  x stays in shared memory, where the tensor cores read it
// through a matrix descriptor; each warp takes its 16 rows of values from
// the swizzled tile into registers with ldmatrix (conflict-free), the A
// fragment of the instruction.  The wgmmas of a stage stay in flight while
// the next stage's fragments are read (two register sets, one wait_group
// behind), and the stage refilled is the one two stages back; the ring is
// filled whole at the start, so a short K range (a split CTA) waits on one
// latency.
//
// Metadata is built in registers from the stored positions, not stored: a
// group's nibble is p0 | p1 << 2 (the two kept positions, ascending, as
// _pack writes them).  The metadata of a warp's 16 × 32 slice is 16 rows ×
// 32 bits, given by two threads of each quad (selector 0: lanes 4g, 4g + 1;
// selector 1: 4g + 2, 4g + 3): the thread of half h holds groups 4h … 4h + 3
// of row g in bits 0–15 and of row g + 8 in bits 16–31 (the layout of
// mma.sp m16n8k32, checked on the card).  So a thread builds one word per
// two 32-column steps: the even step with selector 0, the odd one with 1.
// Rows past c get positions (0, 1) with zero values.
//
// Where the blocks do not fill the card, the host's plan splits K over a
// cluster of CS CTAs; each stages its fp32 tile in shared memory, sends the
// other CTAs their rows of it by bulk copies into their shared memory, and
// sums the CS partial tiles of its own rows in rank order — no atomics,
// the same y every run.  Unsplit, the tile is staged in bf16.  The epilogue
// writes y row-major from the staged tile, 16-byte stores where c % 8 == 0.
//
// Bound: at B = 128 the weight bytes (0.625 of the dense bytes, read once)
// over 3.35 TB/s; by B = 6 000 the tensor-core rate.  In practice both
// meet the rate at which the SMs fill their shared memory from L2 (each
// block reads the x tiles again): wgmma reads x once a warpgroup from
// shared memory with no register copy, TMA spends no thread on the copies,
// and 256-row blocks halve the x reads where the grid is large.
constexpr int SP_THREADS = 256;              // two warpgroups
constexpr int SP_MAXST = 4;                  // ring stages at most
constexpr int SP_KS = 4;                     // 32-column steps a stage
constexpr int SP_VROW = SP_KS * 32;          // bytes of a staged value row
__host__ __device__ constexpr int sp_irow(int idx_bits) {
  return SP_KS * (idx_bits == 4 ? 8 : 16);   // bytes of a staged index row
}
// x (two sub-tiles of BN rows × 128 bytes), values, index bytes
__host__ __device__ constexpr int sp_stage(int BM, int BN, int idx_bits) {
  return 2 * BN * 128 + BM * SP_VROW + BM * sp_irow(idx_bits);
}
// Stages of the ring: as many as fit beside 1 024 bytes of alignment and
// the mbarriers, at most SP_MAXST; the pipeline needs 3.
__host__ __device__ constexpr int sp_nst(int BM, int BN, int idx_bits) {
  return (SMEM_MAX - 1024 - 64) / sp_stage(BM, BN, idx_bits) < SP_MAXST
             ? (SMEM_MAX - 1024 - 64) / sp_stage(BM, BN, idx_bits)
             : SP_MAXST;
}
// Dynamic shared memory: the ring and 1 024 bytes to align it for the
// swizzle (the fp32 tile of the epilogue, BN rows of BM + 4 floats, reuses
// it); as _k2_rows_smem.
size_t sp_smem(int BM, int BN, int idx_bits) {
  return static_cast<size_t>(sp_nst(BM, BN, idx_bits)) *
             sp_stage(BM, BN, idx_bits) + 1024;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
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
// Matrix descriptor of a K-major operand in 128-byte-swizzled rows of 128
// bytes, 8-row groups 1 024 bytes apart (the leading offset is unused).
__device__ __forceinline__ uint64_t gmma_desc_sw128(const void* p) {
  return ((smem_u32(p) & 0x3FFFFu) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// d (64 × N fp32, the warpgroup's fragment) += A · B: A the warp's 16 rows
// of compressed weights in registers with their metadata, B from shared
// memory through desc_b; SEL picks the threads that give the metadata.
template <int SEL>
__device__ __forceinline__ void wgmma_sp_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b, uint32_t meta) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %71, 0;\n"
      "wgmma.mma_async.sp.sync.aligned.m64n128k32.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "{%64,%65,%66,%67}, %68, %69, %70, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(meta),
        "n"(SEL), "r"(1));
}
template <int SEL>
__device__ __forceinline__ void wgmma_sp_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, uint32_t meta) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %39, 0;\n"
      "wgmma.mma_async.sp.sync.aligned.m64n64k32.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, %37, %38, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(meta),
        "n"(SEL), "r"(1));
}
template <int BN, int SEL>
__device__ __forceinline__ void wgmma_sp(float (&d)[BN / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, uint32_t meta) {
  if constexpr (BN == 128)
    wgmma_sp_n128<SEL>(d, a, desc_b, meta);
  else
    wgmma_sp_n64<SEL>(d, a, desc_b, meta);
}

// The 16 metadata bits of 4 consecutive 2:4 groups of one row (group j in
// bits 4j … 4j + 3: p0 | p1 << 2) from their stored positions.
template <int IDX_BITS>
__device__ __forceinline__ uint32_t meta16(const unsigned char* p) {
  if constexpr (IDX_BITS == 4) {
    uint32_t w = *reinterpret_cast<const uint32_t*>(p);  // byte j: p0 | p1 << 4
    w = (w & 0x03030303u) | ((w >> 2) & 0x0C0C0C0Cu);
    w = (w | (w >> 4)) & 0x00FF00FFu;
    return (w | (w >> 8)) & 0x0000FFFFu;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);  // p0, p1, p0, p1, …
    auto two = [](uint32_t u) {
      u = (u & 0x00030003u) | ((u >> 6) & 0x000C000Cu);
      return (u & 0xFu) | ((u >> 12) & 0xF0u);
    };
    return two(v.x) | (two(v.y) << 8);
  }
}

// Operand fence: the registers stay as they are up to here (a wgmma still
// in flight reads them; the compiler must not reuse them).
__device__ __forceinline__ void keep(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// MW 64-row slices a warpgroup: BM = 128 · MW output rows a block.
template <int IDX_BITS, int MW, int BN>
__global__ void __launch_bounds__(SP_THREADS, 1)
nm_sp_rows_kernel(const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_x,
                  const uint8_t* __restrict__ idx, __nv_bfloat16* __restrict__ y,
                  int B, int c, int b, int idx_stride, int CS, int vec_y) {
  constexpr int BM = 128 * MW;
  constexpr int KS = SP_KS, VROW = SP_VROW;
  constexpr int IROW = sp_irow(IDX_BITS), IK = IROW / KS;
  constexpr int STAGE = sp_stage(BM, BN, IDX_BITS);
  constexpr int NST = sp_nst(BM, BN, IDX_BITS);
  constexpr int TS = BM + 4;     // floats of a staged output row
  constexpr int XS = BN * 128;   // bytes of an x sub-tile (two a stage)
  static_assert(NST >= 3, "the pipeline keeps a stage in flight");
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[NST], red;
  // the ring on a 1 024-byte boundary, as the 128-byte swizzle needs
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = (warp >> 2) * 64 + (warp & 3) * 16;  // the warp's 16 rows
  const int rank = blockIdx.x % CS;  // == the CTA's rank in its cluster
  const int o0 = blockIdx.x / CS * BM;
  const int n0 = blockIdx.y * BN;
  const int nk = b / 32;
  const int ks0 = rank * nk / CS, ks1 = (rank + 1) * nk / CS;
  const int ns = (ks1 - ks0 + KS - 1) / KS;

  // a stage lands when thread 0's TMA bytes have and every thread's
  // cp.async of index bytes has (one arrival each)
  // a K split's reduction: the other CTAs' slices of this one's rows
  // land on `red` (bulk copies into shared memory, see the epilogue)
  const int slice = BN / CS * TS * 4;  // bytes of a CTA's share of a tile
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) mbar_init(&full[s], 1 + SP_THREADS);
    mbar_init(&red, 1);
    if (CS > 1) mbar_expect_tx(&red, static_cast<uint32_t>((CS - 1) * slice));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // stage layout: x sub-tiles [2][BN][128 B], values [BM][128 B] (both
  // swizzled), index bytes [BM][IROW]
  auto load = [&](int slot, int s) {
    unsigned char* st = smem + slot * STAGE;
    const int kb = ks0 + s * KS;  // first 32-column step of the stage
    if (tid == 0) {
      mbar_expect_tx(&full[slot], KS / 2 * XS + BM * VROW);
      tma_load_2d(st + KS / 2 * XS, &tm_v, kb * 16, o0, &full[slot]);
#pragma unroll
      for (int h = 0; h < KS / 2; ++h)
        tma_load_2d(st + h * XS, &tm_x, kb * 32 + 64 * h, n0, &full[slot]);
    }
    unsigned char* si = st + KS / 2 * XS + BM * VROW;
    for (int l = tid; l < BM * KS; l += SP_THREADS) {
      const int r = l / KS, j = l % KS;
      const int k = kb + j;
      const bool ok = o0 + r < c && k < ks1;
      const uint8_t* src =
          ok ? idx + static_cast<int64_t>(o0 + r) * idx_stride + k * IK : idx;
      if constexpr (IDX_BITS == 4)
        cp_async8(si + r * IROW + j * IK, src, ok);
      else
        cp_async16(si + r * IROW + j * IK, src, ok);
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                     smem_u32(&full[slot]))
                 : "memory");
  };

  // slice ms of this warp: rows ms·128 + wrow …; this thread's metadata
  // rows (g and g + 8) and whether they exist, its ldmatrix row
  uint32_t mfix[MW];
#pragma unroll
  for (int ms = 0; ms < MW; ++ms) {
    const int r = o0 + ms * 128 + wrow + g;
    mfix[ms] = (r < c ? 0u : 0x0000FFFFu) | (r + 8 < c ? 0u : 0xFFFF0000u);
  }
  const int arow = wrow + (lane & 15);
  float acc[MW][BN / 2];
#pragma unroll
  for (int ms = 0; ms < MW; ++ms)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[ms][i] = 0.0f;

  // One stage: its fragments into (a, meta), its wgmmas issued; then wait
  // for the previous stage's, whose fragments (pa, pmeta) are free after.
  auto step = [&](int s, uint32_t (&a)[MW][KS][4], uint32_t (&meta)[MW][KS / 2],
                  uint32_t (&pa)[MW][KS][4], uint32_t (&pmeta)[MW][KS / 2]) {
    const int slot = s % NST;
    mbar_wait(&full[slot], static_cast<uint32_t>((s / NST) & 1));
    // stage s landed; every warp issued stage s − 1 and finished s − 2:
    // its slot takes stage s − 2 + NST
    __syncthreads();
    if (s >= 2 && s - 2 + NST < ns) {
      if (tid == 0) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load((s - 2) % NST, s - 2 + NST);
    }
    const unsigned char* xs = smem + slot * STAGE;
    const unsigned char* vs = xs + KS / 2 * XS;
    const unsigned char* si = vs + BM * VROW;
    const int nkk = min(KS, ks1 - ks0 - s * KS);
#pragma unroll
    for (int ms = 0; ms < MW; ++ms) {
      const int ar = ms * 128 + arow;
      // the swizzled 16-byte chunk of row ar: chunk XOR row & 7
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(a[ms][kk], vs + ar * VROW + (((kk * 2 + (lane >> 4)) ^ (ar & 7)) << 4));
#pragma unroll
      for (int p = 0; p < KS / 2; ++p) {
        const unsigned char* ip = si + (ms * 128 + wrow + g) * IROW +
                                  (2 * p + (t >> 1)) * IK + (t & 1) * (IK / 2);
        const uint32_t w =
            meta16<IDX_BITS>(ip) | (meta16<IDX_BITS>(ip + 8 * IROW) << 16);
        meta[ms][p] = (w & ~mfix[ms]) | (0x44444444u & mfix[ms]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk < nkk) {
        const uint64_t desc = gmma_desc_sw128(xs + (kk >> 1) * XS + (kk & 1) * 64);
#pragma unroll
        for (int ms = 0; ms < MW; ++ms) {
          if (kk & 1)
            wgmma_sp<BN, 1>(acc[ms], a[ms][kk], desc, meta[ms][kk >> 1]);
          else
            wgmma_sp<BN, 0>(acc[ms], a[ms][kk], desc, meta[ms][kk >> 1]);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int ms = 0; ms < MW; ++ms) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) keep(pa[ms][kk][q]);
#pragma unroll
      for (int p = 0; p < KS / 2; ++p) keep(pmeta[ms][p]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) keep(acc[ms][i]);
    }
  };

  // the whole ring at once: a short K range is in flight from the start
#pragma unroll
  for (int s = 0; s < NST; ++s)
    if (s < ns) load(s, s);
  uint32_t a0[MW][KS][4], a1[MW][KS][4], m0[MW][KS / 2], m1[MW][KS / 2];
  for (int s = 0; s < ns; s += 2) {
    step(s, a0, m0, a1, m1);
    if (s + 1 < ns) step(s + 1, a1, m1, a0, m0);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int ms = 0; ms < MW; ++ms) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        keep(a0[ms][kk][q]);
        keep(a1[ms][kk][q]);
      }
#pragma unroll
    for (int p = 0; p < KS / 2; ++p) {
      keep(m0[ms][p]);
      keep(m1[ms][p]);
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) keep(acc[ms][i]);
  }
  __syncthreads();  // the ring is free: stage the output tile in it

  constexpr int CH = BM / 8;  // 8-output chunks of an activation row
  if (CS == 1) {
    // bf16 tile [BN][TB], then 16-byte rows of 8 outputs to y
    constexpr int TB = BM + 8;
    __nv_bfloat16* tb = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
    for (int ms = 0; ms < MW; ++ms)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int o = ms * 128 + wrow + g, a = 8 * j + 2 * t;
        store(tb + a * TB + o, acc[ms][4 * j]);
        store(tb + (a + 1) * TB + o, acc[ms][4 * j + 1]);
        store(tb + a * TB + o + 8, acc[ms][4 * j + 2]);
        store(tb + (a + 1) * TB + o + 8, acc[ms][4 * j + 3]);
      }
    __syncthreads();
    for (int l = tid; l < BN * CH; l += SP_THREADS) {
      const int a = l / CH, j = l % CH;
      const int n = n0 + a, o = o0 + 8 * j;
      if (n >= B || o >= c) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(tb + a * TB + 8 * j);
      __nv_bfloat16* yo = y + static_cast<int64_t>(n) * c + o;
      if (vec_y && o + 8 <= c) {
        *reinterpret_cast<uint4*>(yo) = v;
      } else {
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
        for (int e = 0; e < 8 && o + e < c; ++e) yo[e] = h[e];
      }
    }
    return;
  }

  // a K split: the fp32 tile [BN][TS]; CTA q owns activation rows
  // [q·BN/CS, (q+1)·BN/CS) and receives the other CTAs' slices of them by
  // bulk copies (into recv, after the tile, slot = the sender's rank), then
  // sums all CS slices in rank order
  float* tile = reinterpret_cast<float*>(smem);
  unsigned char* recv = smem + BN * TS * 4;
#pragma unroll
  for (int ms = 0; ms < MW; ++ms)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int o = ms * 128 + wrow + g, a = 8 * j + 2 * t;
      tile[a * TS + o] = acc[ms][4 * j];
      tile[(a + 1) * TS + o] = acc[ms][4 * j + 1];
      tile[a * TS + o + 8] = acc[ms][4 * j + 2];
      tile[(a + 1) * TS + o + 8] = acc[ms][4 * j + 3];
    }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // for the copies
  namespace cg = cooperative_groups;
  cg::this_cluster().sync();  // every tile staged, every recv free
  if (tid == 0) {
    for (int q = 0; q < CS; ++q) {
      if (q == rank) continue;
      uint32_t dst, bar;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(dst)
                   : "r"(smem_u32(recv + rank * slice)), "r"(q));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(bar)
                   : "r"(smem_u32(&red)), "r"(q));
      asm volatile(
          "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];" ::"r"(dst),
          "r"(smem_u32(reinterpret_cast<unsigned char*>(tile) + q * slice)),
          "r"(slice), "r"(bar)
          : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  }
  mbar_wait(&red, 0u);
  const int rows = BN / CS;
  for (int l = tid; l < rows * CH; l += SP_THREADS) {
    const int ar = l / CH, j = l % CH;  // row ar of this CTA's share
    const int a = rank * rows + ar;
    const int n = n0 + a, o = o0 + 8 * j;
    if (n >= B || o >= c) continue;
    float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
    for (int q = 0; q < CS; ++q) {
      const float* rs = q == rank
          ? tile + a * TS + 8 * j
          : reinterpret_cast<const float*>(recv + q * slice) + ar * TS + 8 * j;
      const float4 lo = *reinterpret_cast<const float4*>(rs);
      const float4 hi = *reinterpret_cast<const float4*>(rs + 4);
      v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
      v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
    }
    __nv_bfloat16* yo = y + static_cast<int64_t>(n) * c + o;
    if (vec_y && o + 8 <= c) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        __nv_bfloat16 h[2];
        store(&h[0], v[2 * e]);
        store(&h[1], v[2 * e + 1]);
        w[e] = static_cast<uint32_t>(__bfloat16_as_ushort(h[0])) |
               (static_cast<uint32_t>(__bfloat16_as_ushort(h[1])) << 16);
      }
      *reinterpret_cast<uint4*>(yo) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (o + e < c) store(yo + e, v[e]);
    }
  }
  // this CTA's copies have read its tile before it leaves (every copy into
  // it has landed: red completed)
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// cuTensorMapEncodeTiled from the driver, found at run time (the library
// links only the runtime).
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

// A bf16 matrix (rows × cols, row-major) as boxes of box_rows × 64 columns
// (128 bytes, swizzled), zero past its edges.
bool tmap_bf16(CUtensorMap* map, const void* base, int rows, int cols,
               int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A byte matrix (rows × cols, row-major, cols % 16 == 0) as boxes of
// box_rows × box_cols bytes, unswizzled, zero past its edges.
bool tmap_u8(CUtensorMap* map, const void* base, int rows, int cols,
             int box_rows, int box_cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int IDX_BITS, int MW, int BN>
int launch_k2_sp(const void* x, const void* vals, const void* idx, void* y,
                 int B, int c, int b, int L, int idx_stride, int CS,
                 size_t smem, cudaStream_t s) {
  constexpr int BM = 128 * MW;
  auto kern = nm_sp_rows_kernel<IDX_BITS, MW, BN>;
  static size_t smem_set = 48 * 1024;  // the variant's limit so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  CUtensorMap tm_v, tm_x;
  if (!tmap_bf16(&tm_v, vals, c, L, BM) || !tmap_bf16(&tm_x, x, B, b, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec_y = c % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((c + BM - 1) / BM * CS),
                     static_cast<unsigned>((B + BN - 1) / BN));
  cfg.blockDim = dim3(SP_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = static_cast<unsigned>(CS);
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = CS > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kern, tm_v, tm_x, static_cast<const uint8_t*>(idx),
      static_cast<__nv_bfloat16*>(y), B, c, b, idx_stride, CS, vec_y));
}

// The checks of _k2_plan's many-row path: bf16 2:4, b % 32 == 0, index
// rows of exactly L·idx_bits/8 bytes, 16-byte aligned x, values and
// indices, at least one 32-column step a CTA, blocks of 128 or 256 output
// rows and 64 or 128 activation rows whose ring holds 3 stages, the plan's
// shared memory.
int launch_k2_sp_checked(const void* x, const void* vals, const void* idx,
                         void* y, int idx_bits, int B, int c, int b, int m,
                         int keep, int L, int idx_stride, int CS, int smem,
                         int BM, int BN, cudaStream_t s) {
  const bool cs_ok = CS == 1 || CS == 2 || CS == 4 || CS == 8;
  const bool al = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(vals) |
                   reinterpret_cast<uintptr_t>(idx)) % 16 == 0;
  if (m != 4 || keep != 2 || L * 2 != b || b % 32 != 0 || !cs_ok ||
      b / 32 < CS || idx_stride != L * idx_bits / 8 || !al ||
      (B + BN - 1) / BN > 65535 || (BM != 128 && BM != 256) ||
      (BM == 256 && CS != 1) || (BN / CS) * CS != BN ||
      (BN != 64 && BN != 128) || sp_nst(BM, BN, idx_bits) < 3 ||
      static_cast<size_t>(smem) != sp_smem(BM, BN, idx_bits))
    return static_cast<int>(cudaErrorInvalidValue);
#define SP_ARGS x, vals, idx, y, B, c, b, L, idx_stride, CS, smem, s
  if (idx_bits == 4) {
    if (BM == 256)
      return BN == 128 ? launch_k2_sp<4, 2, 128>(SP_ARGS) : launch_k2_sp<4, 2, 64>(SP_ARGS);
    return BN == 128 ? launch_k2_sp<4, 1, 128>(SP_ARGS) : launch_k2_sp<4, 1, 64>(SP_ARGS);
  }
  if (BM == 256) return BN == 64 ? launch_k2_sp<8, 2, 64>(SP_ARGS)
                                 : static_cast<int>(cudaErrorInvalidValue);
  return BN == 128 ? launch_k2_sp<8, 1, 128>(SP_ARGS) : launch_k2_sp<8, 1, 64>(SP_ARGS);
#undef SP_ARGS
}


// ---- K2 at decode batch: bf16 2:4 on the sparse tensor cores ----------------
// mode 4, nm_sp_dec_kernel: B < _ROWS_MIN_B activation rows (decode's slots,
// prefill's single rows), where the work is the weight bytes read once from
// HBM and nothing else.  The product is mode 3's — yᵀ = W · xᵀ on
// wgmma.mma_async.sp m64nNk32, W the sparse A operand in registers (ldmatrix
// from the 128-byte-swizzled TMA tile of values, metadata built from the
// stored positions, meta16), x (B, b) the K-major B operand read by the
// tensor cores from shared memory — shaped for a handful of rows:
//   * N = 8·⌈B/8⌉ (8 at B ≤ 8).  x is never staged whole: each ring stage
//     holds the stage's K slice of the N x rows (TMA zero-fills rows past B),
//     so a block reads B·2 bytes of x from L2 for every 1.25·BM bytes of
//     weights it streams, and B = 4 moves what B = 1 does.  (The 8-row
//     kernel, mode 2, copied its x rows whole into every 8-row block.)
//   * One producer lane keeps a ring of nst stages full (BM rows × 128
//     columns of values, their index bytes and the x slice, each by a TMA
//     tensor map: one arrival a stage), refilling a slot as soon as the
//     consumer warps free it (full and empty mbarriers), so the loads of
//     one stage overlap the products of the others.  At N = 8 a stage is
//     12–24 KB; the ring's depth is the plan's (dynamic shared memory = nst
//     stages + 1 024 bytes of alignment + a split's receive buffer): 4
//     stages, since several CTAs an SM with shallow rings measured faster
//     than one CTA with a deep one (tools/k2_plan_sweep.py --part decode).
//   * One consumer warpgroup of BM = 64 output rows.  It issues a stage's
//     four wgmmas, then waits for the previous stage's (two register sets,
//     as mode 3) and frees that stage's slot.  (A second warpgroup, BM =
//     128, was at most 7 % faster below B = 32 in the sweep, and up to 18 %
//     from B = 32 on, where its wide rows share each x slice between twice
//     the weight rows; it was dropped with its 16 instantiations, which
//     doubled this file's build.)
//   * K split over a cluster of CS CTAs on stage boundaries, so that the
//     grid's CTAs cover the SMs (c/BM blocks alone leave most of the 132 SMs
//     idle at c ≤ 2 048, or a short second wave).  CTA q owns rows
//     [q·BM/CS, (q+1)·BM/CS) of the block: every CTA stores its fp32 partial
//     sums of those rows straight into q's shared memory (st.async through
//     distributed shared memory, completing on q's mbarrier), and q sums
//     the CS slots in rank order — no atomics, the same y every run.  The
//     one cluster barrier is split (arrived at the start, waited for before
//     the stores), so no CTA waits for the cluster at its end: pulling the
//     tiles between two cluster-wide barriers cost 1.4–1.7 µs a launch
//     (tools/k2_dec_variants.py --part split measures the split's cost).
// y (B, c) is written in bf16 from the fp32 sums, rows < B only.  Nothing is
// skipped: a NaN kept weight gives NaN in its column.  Rows past c get
// positions (0, 1) with zero values, as in mode 3.
constexpr int DEC_MAXST = 32;  // ring stages at most (static mbarriers)
constexpr int DEC_KS = 4;      // 32-column steps a stage (a multiple of 4)
constexpr int DEC_BM = 64;     // output rows a block: one consumer warpgroup
// x (KS/2 sub-tiles of N rows × 128 bytes), values (KS/4 boxes of BM rows
// × 128 bytes), index bytes: one stage
__host__ __device__ constexpr int dec_stage(int BM, int N, int idx_bits) {
  return DEC_KS / 2 * N * 128 + BM * DEC_KS * 32 +
         BM * DEC_KS * (idx_bits == 4 ? 8 : 16);
}

template <int SEL>
__device__ __forceinline__ void wgmma_sp_dec(float (&d)[4], const uint32_t (&a)[4],
                                             uint64_t desc_b, uint32_t meta) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %11, 0;\n"
      "wgmma.mma_async.sp.sync.aligned.m64n8k32.f32.bf16.bf16 "
      "{%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, %8, %9, %10, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(meta),
        "n"(SEL), "r"(1));
}
template <int SEL>
__device__ __forceinline__ void wgmma_sp_dec(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc_b, uint32_t meta) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %15, 0;\n"
      "wgmma.mma_async.sp.sync.aligned.m64n16k32.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, "
      "{%8,%9,%10,%11}, %12, %13, %14, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(meta),
        "n"(SEL), "r"(1));
}
template <int SEL>
__device__ __forceinline__ void wgmma_sp_dec(float (&d)[12], const uint32_t (&a)[4],
                                             uint64_t desc_b, uint32_t meta) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %19, 0;\n"
      "wgmma.mma_async.sp.sync.aligned.m64n24k32.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11}, "
      "{%12,%13,%14,%15}, %16, %17, %18, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(meta),
        "n"(SEL), "r"(1));
}
template <int SEL>
__device__ __forceinline__ void wgmma_sp_dec(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b, uint32_t meta) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %23, 0;\n"
      "wgmma.mma_async.sp.sync.aligned.m64n32k32.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, %21, %22, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(meta),
        "n"(SEL), "r"(1));
}
template <int SEL>
__device__ __forceinline__ void wgmma_sp_dec(float (&d)[20], const uint32_t (&a)[4],
                                             uint64_t desc_b, uint32_t meta) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %27, 0;\n"
      "wgmma.mma_async.sp.sync.aligned.m64n40k32.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19}, "
      "{%20,%21,%22,%23}, %24, %25, %26, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(meta),
        "n"(SEL), "r"(1));
}
template <int SEL>
__device__ __forceinline__ void wgmma_sp_dec(float (&d)[24], const uint32_t (&a)[4],
                                             uint64_t desc_b, uint32_t meta) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %31, 0;\n"
      "wgmma.mma_async.sp.sync.aligned.m64n48k32.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23}, "
      "{%24,%25,%26,%27}, %28, %29, %30, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(meta),
        "n"(SEL), "r"(1));
}
template <int SEL>
__device__ __forceinline__ void wgmma_sp_dec(float (&d)[28], const uint32_t (&a)[4],
                                             uint64_t desc_b, uint32_t meta) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %35, 0;\n"
      "wgmma.mma_async.sp.sync.aligned.m64n56k32.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27}, "
      "{%28,%29,%30,%31}, %32, %33, %34, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(meta),
        "n"(SEL), "r"(1));
}
template <int SEL>
__device__ __forceinline__ void wgmma_sp_dec(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, uint32_t meta) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %39, 0;\n"
      "wgmma.mma_async.sp.sync.aligned.m64n64k32.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, %37, %38, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(meta),
        "n"(SEL), "r"(1));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  uint64_t state;  // the arrival's phase token, not needed here
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];"
               : "=l"(state)
               : "r"(smem_u32(bar))
               : "memory");
}

// One consumer warpgroup (BM = DEC_BM output rows) and one producer warp;
// N activation rows (B ≤ N, a multiple of 8).
template <int IDX_BITS, int N>
__global__ void __launch_bounds__(160, 1)
nm_sp_dec_kernel(const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_i,
                 __nv_bfloat16* __restrict__ y, int B, int c, int b, int CS,
                 int nst) {
  constexpr int BM = DEC_BM;
  constexpr int KS = DEC_KS;
  constexpr int IK = IDX_BITS == 4 ? 8 : 16, IROW = KS * IK;
  constexpr int XS = N * 128;   // bytes of an x sub-tile (KS/2 a stage)
  constexpr int VB = BM * 128;  // bytes of a value box (KS/4 a stage)
  constexpr int STAGE = dec_stage(BM, N, IDX_BITS);
  static_assert(KS % 4 == 0, "a stage holds whole 128-byte value boxes");
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[DEC_MAXST], empty[DEC_MAXST], red;
  // the ring on a 1 024-byte boundary, as the 128-byte swizzle needs
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x % CS;  // == the CTA's rank in its cluster
  const int o0 = blockIdx.x / CS * BM;
  const int nk = b / 32;
  // the CTA's stages of the K range: whole stages, the last CTA's last one
  // cut at b (its value and x boxes past b come zero-filled from TMA)
  const int nks = (nk + KS - 1) / KS;
  const int st0 = rank * nks / CS, st1 = (rank + 1) * nks / CS;
  const int ks0 = st0 * KS, ks1 = min(nk, st1 * KS);
  const int ns = st1 - st0;

  // full: the producer's TMA bytes; empty: every consumer warp, once the
  // stage's wgmmas are done; red: a split's partial rows of this CTA's
  // share, from every CTA of the cluster (BM · N fp32 in all)
  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init(&red, 1);
    if (CS > 1) mbar_expect_tx(&red, static_cast<uint32_t>(BM * N * 4));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // a split's cluster barrier, in two halves: arrived once `red` is set up,
  // waited for only before the partial rows are sent
  if (CS > 1) asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;  // the consumer warp's 16 rows

  if (warp == 4) {
    // the producer: stage s into slot s % nst once the slot's last stage
    // is consumed.  Stage layout: x sub-tiles [KS/2][N][128 B], value
    // boxes [KS/4][BM][128 B] (both swizzled), index bytes [BM][IROW]
    for (int s = 0; s < ns && lane == 0; ++s) {
      if (s == 0) {
        asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tm_v))
                     : "memory");
        asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tm_i))
                     : "memory");
        asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tm_x))
                     : "memory");
      }
      const int slot = s % nst;
      if (s >= nst) mbar_wait(&empty[slot], static_cast<uint32_t>((s / nst - 1) & 1));
      unsigned char* st = smem + slot * STAGE;
      const int kb = ks0 + s * KS;  // first 32-column step of the stage
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_expect_tx(&full[slot], KS / 2 * XS + KS / 4 * VB + BM * IROW);
#pragma unroll
      for (int h = 0; h < KS / 4; ++h)
        tma_load_2d(st + KS / 2 * XS + h * VB, &tm_v, kb * 16 + 64 * h, o0,
                    &full[slot]);
      tma_load_2d(st + KS / 2 * XS + KS / 4 * VB, &tm_i, kb * IK, o0, &full[slot]);
#pragma unroll
      for (int h = 0; h < KS / 2; ++h)
        tma_load_2d(st + h * XS, &tm_x, kb * 32 + 64 * h, 0, &full[slot]);
    }
  } else {
    // this thread's metadata rows (g and g + 8 of the warp's 16) and
    // whether they exist, its ldmatrix row
    const int r = o0 + wrow + g;
    const uint32_t mfix = (r < c ? 0u : 0x0000FFFFu) | (r + 8 < c ? 0u : 0xFFFF0000u);
    const int arow = wrow + (lane & 15);

    // One stage: its fragments into (a, meta), its wgmmas issued; then wait
    // for the previous stage's, whose fragments (pa, pmeta) and slot are
    // free after.
    auto step = [&](int s, uint32_t (&a)[KS][4], uint32_t (&meta)[KS / 2],
                    uint32_t (&pa)[KS][4], uint32_t (&pmeta)[KS / 2]) {
      const int slot = s % nst;
      mbar_wait(&full[slot], static_cast<uint32_t>((s / nst) & 1));
      const unsigned char* xs = smem + slot * STAGE;
      const unsigned char* vs = xs + KS / 2 * XS;
      const unsigned char* si = vs + KS / 4 * VB;
      const int nkk = min(KS, ks1 - ks0 - s * KS);
      // step kk's values: box kk / 4, the swizzled 16-byte chunk of row
      // arow (chunk XOR row & 7)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(a[kk], vs + (kk >> 2) * VB + arow * 128 +
                           ((((kk & 3) * 2 + (lane >> 4)) ^ (arow & 7)) << 4));
#pragma unroll
      for (int p = 0; p < KS / 2; ++p) {
        const unsigned char* ip =
            si + (wrow + g) * IROW + (2 * p + (t >> 1)) * IK + (t & 1) * (IK / 2);
        const uint32_t w =
            meta16<IDX_BITS>(ip) | (meta16<IDX_BITS>(ip + 8 * IROW) << 16);
        meta[p] = (w & ~mfix) | (0x44444444u & mfix);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if (kk < nkk) {
          const uint64_t desc = gmma_desc_sw128(xs + (kk >> 1) * XS + (kk & 1) * 64);
          if (kk & 1)
            wgmma_sp_dec<1>(acc, a[kk], desc, meta[kk >> 1]);
          else
            wgmma_sp_dec<0>(acc, a[kk], desc, meta[kk >> 1]);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) keep(pa[kk][q]);
#pragma unroll
      for (int p = 0; p < KS / 2; ++p) keep(pmeta[p]);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) keep(acc[i]);
      __syncwarp();
      if (s > 0 && lane == 0) mbar_arrive(&empty[(s - 1) % nst]);
    };

    uint32_t a0[KS][4], a1[KS][4], m0[KS / 2], m1[KS / 2];
    for (int s = 0; s < ns; s += 2) {
      step(s, a0, m0, a1, m1);
      if (s + 1 < ns) step(s + 1, a1, m1, a0, m0);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        keep(a0[kk][q]);
        keep(a1[kk][q]);
      }
#pragma unroll
    for (int p = 0; p < KS / 2; ++p) {
      keep(m0[p]);
      keep(m1[p]);
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) keep(acc[i]);
  }

  // d[4j + e]: output row wrow + g (+ 8 for e ≥ 2), activation row
  // 8j + 2t (+ 1 for odd e)
  const bool consumer = warp < 4;
  if (CS == 1) {
    if (!consumer) return;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int a = 8 * j + 2 * t + (e & 1), o = o0 + wrow + g + 8 * (e >> 1);
        if (a < B && o < c) store(y + static_cast<int64_t>(a) * c + o, acc[4 * j + e]);
      }
    return;
  }
  // a K split: CTA q owns rows [q·R, (q+1)·R) of the block (R = BM / CS).
  // Every CTA stores each partial sum straight into its owner's receive
  // buffer (recv [CS][R][N] fp32 after the ring, slot = the sender's rank)
  // by st.async, completing on the owner's `red`; the owner then sums the
  // CS slots in rank order.  Nothing is read remotely, so no CTA waits for
  // the cluster at its end.
  __syncwarp();  // the producer warp's lanes meet again for .aligned
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  const int R = BM / CS;
  float* recv = reinterpret_cast<float*>(smem + nst * STAGE);
  if (consumer) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = wrow + g + 8 * h, q = o / R;
        uint32_t dst, bar;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                     : "=r"(dst)
                     : "r"(smem_u32(recv + (rank * R + o - q * R) * N + 8 * j + 2 * t)),
                       "r"(q));
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                     : "=r"(bar)
                     : "r"(smem_u32(&red)), "r"(q));
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 "
            "[%0], {%1, %2}, [%3];" ::"r"(dst),
            "f"(acc[4 * j + 2 * h]), "f"(acc[4 * j + 2 * h + 1]), "r"(bar)
            : "memory");
      }
  }
  mbar_wait(&red, 0u);
  for (int l = tid; l < B * R; l += 160) {
    const int a = l / R, ol = l - a * R;
    float v = 0.0f;
    for (int q = 0; q < CS; ++q) v += recv[(q * R + ol) * N + a];
    if (o0 + rank * R + ol < c)
      store(y + static_cast<int64_t>(a) * c + o0 + rank * R + ol, v);
  }
}

// Dynamic shared memory of the decode path with an nst-stage ring: the
// ring, 1 024 bytes to align it and, for a split (CS > 1), the receive
// buffer of the partial rows (BM · N fp32); as _k2_dec_smem.
size_t dec_red(int BM, int N, int CS) {
  return CS > 1 ? static_cast<size_t>(BM) * N * 4 : 0;
}
size_t dec_smem(int BM, int N, int idx_bits, int nst, int CS) {
  return static_cast<size_t>(nst) * dec_stage(BM, N, idx_bits) + 1024 +
         dec_red(BM, N, CS);
}

template <int IDX_BITS, int N>
int launch_k2_dec(const void* x, const void* vals, const void* idx, void* y,
                  int B, int c, int b, int L, int idx_stride, int CS, int nst,
                  size_t smem, cudaStream_t s) {
  constexpr int BM = DEC_BM;
  auto kern = nm_sp_dec_kernel<IDX_BITS, N>;
  static size_t smem_set = 48 * 1024;  // the variant's limit so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  CUtensorMap tm_v, tm_x, tm_i;
  if (!tmap_bf16(&tm_v, vals, c, L, BM) || !tmap_bf16(&tm_x, x, B, b, N) ||
      !tmap_u8(&tm_i, idx, c, idx_stride, BM, DEC_KS * (IDX_BITS == 4 ? 8 : 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((c + BM - 1) / BM * CS));
  cfg.blockDim = dim3(160);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = static_cast<unsigned>(CS);
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = CS > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kern, tm_v, tm_x, tm_i, static_cast<__nv_bfloat16*>(y), B, c, b,
      CS, nst));
}

template <int IDX_BITS>
int launch_k2_dec_n(const void* x, const void* vals, const void* idx, void* y,
                    int B, int c, int b, int L, int idx_stride, int CS,
                    int nst, size_t smem, int N, cudaStream_t s) {
#define DEC_N(n)                                                           \
  case n:                                                                  \
    return launch_k2_dec<IDX_BITS, n>(x, vals, idx, y, B, c, b, L,        \
                                      idx_stride, CS, nst, smem, s);
  switch (N) {
    DEC_N(8) DEC_N(16) DEC_N(24) DEC_N(32) DEC_N(40) DEC_N(48) DEC_N(56)
    DEC_N(64)
  }
#undef DEC_N
  return static_cast<int>(cudaErrorInvalidValue);
}

// The checks of _k2_plan's decode path: bf16 2:4, b % 32 == 0, index rows
// of exactly L·idx_bits/8 bytes, a multiple of 16 (a TMA tensor map's row
// stride), 16-byte aligned x, values and indices,
// BM = DEC_BM output rows a block and N = 8·⌈B/8⌉ activation rows (BN),
// CS ∈ {1, 2, 4, 8} with ≥ one stage a CTA and BM % CS == 0, and smem
// bytes holding a ring of 2 … DEC_MAXST whole stages (their count is the
// ring's depth) within 227 KB beside the mbarriers.
int launch_k2_dec_checked(const void* x, const void* vals, const void* idx,
                          void* y, int idx_bits, int B, int c, int b, int m,
                          int keep, int L, int idx_stride, int CS, int smem,
                          int BM, int BN, cudaStream_t s) {
  const bool cs_ok = CS == 1 || CS == 2 || CS == 4 || CS == 8;
  const bool al = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(vals) |
                   reinterpret_cast<uintptr_t>(idx)) % 16 == 0;
  if (m != 4 || keep != 2 || L * 2 != b || b % 32 != 0 || !cs_ok ||
      (b / 32 + DEC_KS - 1) / DEC_KS < CS || idx_stride != L * idx_bits / 8 ||
      idx_stride % 16 != 0 ||
      !al || BM != DEC_BM || BM % CS != 0 ||
      BN != 8 * ((B + 7) / 8) || BN > 64 || smem <= 1024 ||
      smem + (2 * DEC_MAXST + 1) * sizeof(uint64_t) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int stage = dec_stage(BM, BN, idx_bits);
  const int nst = (smem - 1024 - static_cast<int>(dec_red(BM, BN, CS))) / stage;
  if (nst < 2 || nst > DEC_MAXST ||
      static_cast<size_t>(smem) != dec_smem(BM, BN, idx_bits, nst, CS))
    return static_cast<int>(cudaErrorInvalidValue);
#define DEC_ARGS x, vals, idx, y, B, c, b, L, idx_stride, CS, nst, smem, BN, s
  return idx_bits == 4 ? launch_k2_dec_n<4>(DEC_ARGS) : launch_k2_dec_n<8>(DEC_ARGS);
#undef DEC_ARGS
}

// ---- K3 at decode occupancy: bf16 2:4 on the sparse tensor cores ----------
// mode 4 of nm_matmul_stacked: nm_stacked_vote_kernel, then
// nm_stacked_sp_dec_kernel.  At decode a leaf's x (E, C, b) holds a token in
// a handful of its E · ⌈C/8⌉ row groups (8 experts of 128 at T = 1, ~30 at
// T = 4), so the work is the routed experts' weights read once from HBM, x
// read once to find them and y written (zeros where nothing was routed).
// The mode-2 grid of (128-row block, row group, expert) blocks is mostly blocks
// that vote and exit, and its few working blocks each stream a 128-row slab
// alone.  Here:
//   * The vote.  A row group is active when any of its x entries is ≠ 0
//     (−0 counts as zero, NaN as not; kernels/nm_spmm.py::active_row_groups),
//     one block a group writing a byte of `flags`, on the device at every
//     call (no host sync: a CUDA graph replayed on another routing computes
//     that routing).  The product is its programmatic dependent
//     (griddepcontrol): its CTAs are resident and set up when the vote ends.
//     An idle group's weights are never read and its y rows are written +0
//     by the product's CTAs while their first loads land — bitwise what the
//     full product gives for finite weights (CAVEAT, as the mode-2 kernel: a
//     non-finite weight in a skipped expert gives 0 where the plain version
//     gives NaN; the prune guards keep served weights finite).  (A vote
//     inside the product, its CTAs meeting at a grid-wide barrier, and a
//     vote without the dependent launch measured slower: PERF.md §6.)
//   * A persistent grid sized to the card (every CTA that is co-resident,
//     in clusters of CS CTAs: one an SM at 6 stages, two at 4) walks the
//     items (active group × 128-row tile of c).  Every CTA compacts the
//     flags into the list of active groups in shared memory (in order:
//     each thread counts a run of flags, one block-wide scan).
//   * The K split is decided there, from the work the vote found: where the
//     items × CS fit the grid at once (8 active groups of gate/up at T = 1:
//     48 items), each cluster takes one item and its CTAs split the K range
//     on stage boundaries — K2's decode split: every CTA stores its fp32
//     partial rows into the owner's shared memory (st.async, completing on
//     the owner's `red`), the owner sums the CS slots in rank order, no
//     atomics, the same y every run; elsewhere every CTA walks items of its
//     own (k = CTA, CTA + grid, …), each item's y stored from registers.
//     (The host cannot see the occupancy, and a split taken at every one
//     lost where the items alone fill the card: PERF.md §6.)
//   * The product of an item is K2's decode product at N = 8 (the group's
//     8 capacity rows), on two warpgroups of 64 rows that share each stage's
//     x slice: yᵀ = W_e · x_eᵀ on wgmma.mma_async.sp m64n8k32, W_e
//     the sparse A operand (ldmatrix from the 128-byte-swizzled value tile,
//     metadata built from the stored positions, meta16), x the K-major B
//     operand read from shared memory.  Three TMA tensor maps over the whole
//     stack, the expert a coordinate: values (E, c, L), index bytes (E, c,
//     idx_stride), x (E, C, b); TMA zero-fills rows past c and C and columns
//     past b, so nothing is padded by the caller (a cut stage's steps past
//     b multiply zeros, with valid metadata: no wgmma on a divergent path).
//   * One producer lane keeps a ring of nst stages (128 columns of values,
//     their index bytes and of the group's x rows) full across the CTA's
//     items (full / empty mbarriers), so the next item's loads are in
//     flight during an item's epilogue.  (64-row tiles, one warpgroup, read
//     the x slice twice as often and took up to 2 % longer past ~30 active
//     groups: PERF.md §6.)
// y (E, C, c) is written in bf16 from the fp32 sums, rows < C and < c only.
constexpr int K3D_VOTE_THREADS = 256;  // a vote block
constexpr int K3D_MAXST = 16;          // ring stages at most (static mbarriers)
constexpr int K3D_N = 8;               // capacity rows of a group: wgmma's N

constexpr int K3D_BM = 128;            // output rows a tile: two warpgroups
constexpr int K3D_THREADS = 2 * 128 + 32;  // and one producer warp
// Dynamic shared memory of the decode path: 1 024 bytes to align the ring,
// nst stages, a split's receive buffer (K3D_BM · 8 fp32) and the list of
// active groups (2 bytes each, EG = E · ⌈C/8⌉), as _k3_dec_smem.
size_t k3d_smem(int nst, int CS, int EG, int idx_bits) {
  return 1024 + static_cast<size_t>(nst) * dec_stage(K3D_BM, K3D_N, idx_bits) +
         (CS > 1 ? static_cast<size_t>(K3D_BM) * K3D_N * 4 : 0) +
         (static_cast<size_t>(EG) * 2 + 15) / 16 * 16;
}

__device__ __forceinline__ uint32_t ld_cg_u8(const uint8_t* p) {
  uint32_t v;
  asm volatile("ld.global.cg.u8 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// p[0..n) = +0 (bf16), this thread's share: 16-byte stores between a
// scalar head and tail.
__device__ __forceinline__ void zero_bf16(__nv_bfloat16* p, int64_t n) {
  uint16_t* h = reinterpret_cast<uint16_t*>(p);
  const int64_t mis = static_cast<int64_t>((reinterpret_cast<uintptr_t>(p) & 15) >> 1);
  int64_t head = (8 - mis) & 7;
  if (head > n) head = n;
  for (int64_t i = threadIdx.x; i < head; i += blockDim.x) h[i] = 0;
  const int64_t nvec = (n - head) >> 3;
  uint4* v = reinterpret_cast<uint4*>(h + head);
  for (int64_t i = threadIdx.x; i < nvec; i += blockDim.x)
    v[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t i = head + nvec * 8 + threadIdx.x; i < n; i += blockDim.x) h[i] = 0;
}

// One block a row group: flags[group] = any of its x rows ≠ 0.
__global__ void __launch_bounds__(K3D_VOTE_THREADS)
nm_stacked_vote_kernel(const __nv_bfloat16* __restrict__ x, uint8_t* __restrict__ flags,
                       int G, int C, int b) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int pair = blockIdx.x, e = pair / G, r0 = (pair - e * G) * K3D_N;
  const int nr = min(K3D_N, C - r0);
  const int nz = __syncthreads_or(
      any_nonzero(x + (static_cast<int64_t>(e) * C + r0) * b, static_cast<int64_t>(nr) * b));
  if (threadIdx.x == 0) flags[pair] = static_cast<uint8_t>(nz != 0);
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

template <int IDX_BITS>
__global__ void __launch_bounds__(K3D_THREADS, 2)
nm_stacked_sp_dec_kernel(const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_i,
                         __nv_bfloat16* __restrict__ y, const uint8_t* __restrict__ flags,
                         int E, int C, int c, int b, int CS, int nst) {
  constexpr int BM = K3D_BM, N = K3D_N, KS = DEC_KS;
  constexpr int IK = IDX_BITS == 4 ? 8 : 16, IROW = KS * IK;
  constexpr int XS = N * 128;   // bytes of an x sub-tile (KS/2 a stage)
  constexpr int VB = BM * 128;  // bytes of a value box (KS/4 a stage)
  constexpr int STAGE = dec_stage(BM, N, IDX_BITS);
  constexpr int THREADS = K3D_THREADS, WARPS = THREADS / 32;
  static_assert(KS % 4 == 0, "a stage holds whole 128-byte value boxes");
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[K3D_MAXST], empty[K3D_MAXST], red;
  __shared__ int warp_count[WARPS];
  // the ring on a 1 024-byte boundary, as the 128-byte swizzle needs
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* recv = reinterpret_cast<float*>(smem + nst * STAGE);  // [CS][BM/CS][N]
  uint16_t* list = reinterpret_cast<uint16_t*>(smem + nst * STAGE + (CS > 1 ? BM * N * 4 : 0));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = (C + N - 1) / N, EG = E * G;
  const int ntiles = (c + BM - 1) / BM;
  const int nk = b / 32, nks = (nk + KS - 1) / KS;

  // full: the producer's TMA bytes; empty: every consumer warp, once the
  // stage's wgmmas are done; red: a split's partial rows of this CTA's
  // share, from every CTA of the cluster (BM · N fp32 in all)
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tm_v)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tm_i)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tm_x)) : "memory");
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS - 1);
    }
    mbar_init(&red, 1);
    if (CS > 1) mbar_expect_tx(&red, static_cast<uint32_t>(BM * N * 4));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the vote's flags (the launch is its programmatic dependent)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __syncthreads();

  // 1. the active groups in order: thread t counts flags [t·per, (t+1)·per),
  // one block-wide scan gives its place in the list
  const int per = (EG + THREADS - 1) / THREADS;
  const int f0 = min(EG, tid * per), f1 = min(EG, f0 + per);
  int cnt = 0;
  for (int f = f0; f < f1; ++f) cnt += ld_cg_u8(flags + f) != 0u;
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_count[warp] = incl;
  __syncthreads();
  int before = 0, nact = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    before += w < warp ? warp_count[w] : 0;
    nact += warp_count[w];
  }
  int pos = before + incl - cnt;
  for (int f = f0; f < f1; ++f)
    if (ld_cg_u8(flags + f)) list[pos++] = static_cast<uint16_t>(f);
  __syncthreads();

  // 2. the split and this CTA's items: the whole cluster on one item where
  // every item's CS pieces fit the grid at once, else one CTA an item
  const int nall = nact * ntiles;
  const bool split = CS > 1 && nall * CS <= static_cast<int>(gridDim.x);
  const int parts = split ? CS : 1, part = split ? blockIdx.x % CS : 0;  // cluster rank
  const int unit = split ? blockIdx.x / CS : blockIdx.x;
  const int nunits = split ? gridDim.x / CS : gridDim.x;
  const int st0 = part * nks / parts, st1 = (part + 1) * nks / parts;
  const int ns = st1 - st0, ks0 = st0 * KS, ks1 = min(nk, st1 * KS);
  const int nitems = nall > unit ? (nall - unit + nunits - 1) / nunits : 0;  // ≤ 1 split
  const int total = nitems * ns;  // the CTA's stages over all its items
  // a split's cluster barrier, in two halves: arrived once `red` is set up,
  // waited for only before the partial rows are sent
  if (split) asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");

  // item i → expert e, its group's first capacity row r0, the tile's o0
  auto item = [&](int i, int& e, int& r0, int& o0) {
    const int k = unit + i * nunits, q = k / ntiles;
    const int pair = list[q];
    e = pair / G;
    r0 = (pair - e * G) * N;
    o0 = (k - q * ntiles) * BM;
  };
  // global stage gs → item gs / ns, stage gs % ns of its K range.  Stage
  // layout: x sub-tiles [KS/2][N][128 B], value boxes [KS/4][BM][128 B]
  // (both swizzled), index bytes [BM][IROW]
  auto issue = [&](int gs) {
    const int i = gs / ns, s = gs - i * ns;
    int e, r0, o0;
    item(i, e, r0, o0);
    const int slot = gs % nst;
    unsigned char* st = smem + slot * STAGE;
    const int kb = ks0 + s * KS;  // first 32-column step of the stage
    mbar_expect_tx(&full[slot], KS / 2 * XS + KS / 4 * VB + BM * IROW);
#pragma unroll
    for (int h = 0; h < KS / 4; ++h)
      tma_load_3d(st + KS / 2 * XS + h * VB, &tm_v, kb * 16 + 64 * h, o0, e, &full[slot]);
    tma_load_3d(st + KS / 2 * XS + KS / 4 * VB, &tm_i, kb * IK, o0, e, &full[slot]);
#pragma unroll
    for (int h = 0; h < KS / 2; ++h)
      tma_load_3d(st + h * XS, &tm_x, kb * 32 + 64 * h, r0, e, &full[slot]);
  };

  // 3. the producer lane starts the ring; then every thread writes +0 into
  // its share of the idle groups' y rows (the CTAs with the fewest items
  // first) while the first stages land
  if (warp == WARPS - 1 && lane == 0)
    for (int gs = 0; gs < min(nst, total); ++gs) issue(gs);
  for (int pair = gridDim.x - 1 - blockIdx.x; pair < EG; pair += gridDim.x) {
    if (ld_cg_u8(flags + pair)) continue;
    const int e = pair / G, r0 = (pair - e * G) * N;
    zero_bf16(y + (static_cast<int64_t>(e) * C + r0) * c,
              static_cast<int64_t>(min(N, C - r0)) * c);
  }
  if (total == 0) return;  // the same for every CTA of a split's cluster

  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;  // a consumer warp's 16 rows of the tile
  float acc[N / 2];
#pragma unroll
  for (int q = 0; q < N / 2; ++q) acc[q] = 0.0f;

  if (warp == WARPS - 1) {
    // the producer: stage gs into slot gs % nst once the slot's last stage
    // is consumed
    for (int gs = nst; gs < total && lane == 0; ++gs) {
      const int slot = gs % nst;
      mbar_wait(&empty[slot], static_cast<uint32_t>((gs / nst - 1) & 1));
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(gs);
    }
  } else {
    const int arow = wrow + (lane & 15);
    // a stage's slot is free once its wgmmas are: the previous stage's after
    // this one's are issued, an item's last stage at once
    auto free_slot = [&](int gs) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[gs % nst]);
    };
    // One stage: its fragments into (a, meta), its wgmmas issued; then wait
    // for the previous stage's, whose fragments (pa, pmeta) and slot are
    // free after; at an item's last stage its y (unsplit: stored here).
    auto step = [&](int gs, uint32_t (&a)[KS][4], uint32_t (&meta)[KS / 2],
                    uint32_t (&pa)[KS][4], uint32_t (&pmeta)[KS / 2]) {
      const int i = gs / ns, s = gs - i * ns;
      int e, r0, o0;
      item(i, e, r0, o0);
      // this thread's metadata rows (g and g + 8 of the warp's 16): rows
      // past c get positions (0, 1) with zero values, as do a cut stage's
      // steps past b
      const int r = o0 + wrow + g;
      const uint32_t mfix = (r < c ? 0u : 0x0000FFFFu) | (r + 8 < c ? 0u : 0xFFFF0000u);
      const int nkk = min(KS, ks1 - ks0 - s * KS);
      const int slot = gs % nst;
      mbar_wait(&full[slot], static_cast<uint32_t>((gs / nst) & 1));
      const unsigned char* xs = smem + slot * STAGE;
      const unsigned char* vs = xs + KS / 2 * XS;
      const unsigned char* si = vs + KS / 4 * VB;
      // step kk's values: box kk / 4, the swizzled 16-byte chunk of row
      // arow (chunk XOR row & 7)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(a[kk], vs + (kk >> 2) * VB + arow * 128 +
                           ((((kk & 3) * 2 + (lane >> 4)) ^ (arow & 7)) << 4));
#pragma unroll
      for (int p = 0; p < KS / 2; ++p) {
        const unsigned char* ip =
            si + (wrow + g) * IROW + (2 * p + (t >> 1)) * IK + (t & 1) * (IK / 2);
        const uint32_t w = meta16<IDX_BITS>(ip) | (meta16<IDX_BITS>(ip + 8 * IROW) << 16);
        meta[p] = 2 * p + (t >> 1) < nkk ? (w & ~mfix) | (0x44444444u & mfix) : 0x44444444u;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint64_t desc = gmma_desc_sw128(xs + (kk >> 1) * XS + (kk & 1) * 64);
        if (kk & 1)
          wgmma_sp_dec<1>(acc, a[kk], desc, meta[kk >> 1]);
        else
          wgmma_sp_dec<0>(acc, a[kk], desc, meta[kk >> 1]);
      }
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) keep(pa[kk][q]);
#pragma unroll
      for (int p = 0; p < KS / 2; ++p) keep(pmeta[p]);
#pragma unroll
      for (int q = 0; q < N / 2; ++q) keep(acc[q]);
      if (s > 0) free_slot(gs - 1);
      if (s < ns - 1) return;
      wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) keep(a[kk][q]);
#pragma unroll
      for (int p = 0; p < KS / 2; ++p) keep(meta[p]);
#pragma unroll
      for (int q = 0; q < N / 2; ++q) keep(acc[q]);
      free_slot(gs);
      if (split) return;  // the cluster sums it below
      // d[q]: output row o0 + wrow + g (+ 8 for q ≥ 2), capacity row
      // r0 + 2t (+ 1 for odd q)
      const int nr = min(N, C - r0);
      __nv_bfloat16* ye = y + (static_cast<int64_t>(e) * C + r0) * c;
#pragma unroll
      for (int q = 0; q < N / 2; ++q) {
        const int a2 = 2 * t + (q & 1), o = o0 + wrow + g + 8 * (q >> 1);
        if (a2 < nr && o < c) store(ye + static_cast<int64_t>(a2) * c + o, acc[q]);
        acc[q] = 0.0f;
        keep(acc[q]);
      }
    };

    uint32_t a0[KS][4], a1[KS][4], m0[KS / 2], m1[KS / 2];
    for (int gs = 0; gs < total; gs += 2) {
      step(gs, a0, m0, a1, m1);
      if (gs + 1 < total) step(gs + 1, a1, m1, a0, m0);
    }
  }
  if (!split) return;

  // a split's one item: CTA q owns rows [q·R, (q+1)·R) of the tile (R =
  // BM / CS).  Every CTA stores each partial sum straight into its owner's
  // receive buffer (recv [CS][R][N] fp32, slot = the sender's rank) by
  // st.async, completing on the owner's `red`; the owner then sums the CS
  // slots in rank order.
  __syncwarp();  // the producer warp's lanes meet again for .aligned
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  const int R = BM / CS;
  if (warp < WARPS - 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = wrow + g + 8 * h, q = o / R;
      uint32_t dst, bar;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(dst)
                   : "r"(smem_u32(recv + (part * R + o - q * R) * N + 2 * t)), "r"(q));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(bar)
                   : "r"(smem_u32(&red)), "r"(q));
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 "
          "[%0], {%1, %2}, [%3];" ::"r"(dst),
          "f"(acc[2 * h]), "f"(acc[2 * h + 1]), "r"(bar)
          : "memory");
    }
  }
  int e, r0, o0;
  item(0, e, r0, o0);
  const int nr = min(N, C - r0);
  __nv_bfloat16* ye = y + (static_cast<int64_t>(e) * C + r0) * c;
  mbar_wait(&red, 0u);
  for (int l = tid; l < nr * R; l += THREADS) {
    const int a2 = l / R, ol = l - a2 * R;
    float v = 0.0f;
    for (int q = 0; q < CS; ++q) v += recv[(q * R + ol) * N + a2];
    if (o0 + part * R + ol < c)
      store(ye + static_cast<int64_t>(a2) * c + o0 + part * R + ol, v);
  }
}

// A 3-D tensor map over a stack (E, rows, cols), row-major, of esize-byte
// elements: boxes of box_rows × box_cols of one matrix, zero past its edges.
bool tmap_3d(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* base,
             int E, int rows, int cols, int box_rows, int box_cols,
             CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * esize,
                                 static_cast<cuuint64_t>(cols) * esize * rows};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The CTAs of one launch: every CTA that is co-resident on the card, in
// whole clusters (a CTA past that would wait for a slot).  The co-resident
// CTAs of each (device, kernel, shared memory, cluster) are asked of the
// runtime once (its occupancy queries cost more host time than the launch)
// and kept.
template <typename K>
int k3d_grid(K kern, cudaLaunchConfig_t cfg, int CS) {
  struct Fit {
    int dev;
    const void* kern;
    size_t smem;
    int CS, fit;
  };
  static std::mutex lock;
  static Fit seen[64];
  static int nseen = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const void* key = reinterpret_cast<const void*>(kern);
  int fit = 0;
  {
    std::lock_guard<std::mutex> hold(lock);
    for (int i = 0; i < nseen && fit == 0; ++i)
      if (seen[i].dev == dev && seen[i].kern == key && seen[i].smem == cfg.dynamicSmemBytes &&
          seen[i].CS == CS)
        fit = seen[i].fit;
  }
  if (fit == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    if (CS > 1) {
      cfg.gridDim = dim3(static_cast<unsigned>(CS * sms));
      if (cudaOccupancyMaxActiveClusters(&fit, kern, &cfg) != cudaSuccess) return 0;
      fit *= CS;
    } else {
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kern, cfg.blockDim.x,
                                                        cfg.dynamicSmemBytes) != cudaSuccess)
        return 0;
      fit *= sms;
    }
    std::lock_guard<std::mutex> hold(lock);
    if (nseen < 64 && fit > 0) seen[nseen++] = {dev, key, cfg.dynamicSmemBytes, CS, fit};
  }
  return fit / CS * CS;
}

template <int IDX_BITS>
int launch_k3_dec(const void* x, const void* vals, const void* idx, void* y, uint8_t* flags,
                  int E, int C, int c, int b, int L, int idx_stride, int CS, int nst,
                  cudaStream_t s) {
  constexpr int BM = K3D_BM;
  auto kern = nm_stacked_sp_dec_kernel<IDX_BITS>;
  const int G = (C + K3D_N - 1) / K3D_N;
  const size_t smem = k3d_smem(nst, CS, E * G, IDX_BITS);
  static size_t smem_set = 48 * 1024;  // the variant's limit so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  constexpr int IROW = DEC_KS * (IDX_BITS == 4 ? 8 : 16);
  CUtensorMap tm_v, tm_x, tm_i;
  if (!tmap_3d(&tm_v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, vals, E, c, L, BM, 64,
               CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tmap_3d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, E, C, b, K3D_N, 64,
               CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tmap_3d(&tm_i, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, idx, E, c, idx_stride, BM, IROW,
               CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(K3D_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(CS);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CS > 1 ? 1 : 0;
  const int grid = k3d_grid(kern, cfg, CS);
  if (grid < CS) return static_cast<int>(cudaErrorInvalidConfiguration);
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  nm_stacked_vote_kernel<<<E * G, K3D_VOTE_THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), flags, G, C, b);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attr[cfg.numAttrs].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[cfg.numAttrs].val.programmaticStreamSerializationAllowed = 1;
  ++cfg.numAttrs;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kern, tm_v, tm_x, tm_i,
                                             static_cast<__nv_bfloat16*>(y),
                                             static_cast<const uint8_t*>(flags), E, C,
                                             c, b, CS, nst));
}

// The checks of _k3_plan's decode path: bf16 2:4, b % 32 == 0, index rows
// of exactly L·idx_bits/8 bytes, a multiple of 16 (a tensor map's row
// stride), 16-byte aligned x, values and indices, CS ∈ {1, 2, 4} with ≥
// one stage a CTA, a ring of 2 …
// K3D_MAXST stages, E · ⌈C/8⌉ < 65 536 groups and the
// shared memory within 227 KB.
int launch_k3_dec_checked(const void* x, const void* vals, const void* idx, void* y,
                          uint8_t* flags, int idx_bits, int E, int C, int c, int b, int m,
                          int keep, int L, int idx_stride, int CS, int nst,
                          cudaStream_t s) {
  const bool al = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(vals) |
                   reinterpret_cast<uintptr_t>(idx)) % 16 == 0;
  const int64_t EG = static_cast<int64_t>(E) * ((C + K3D_N - 1) / K3D_N);
  if (m != 4 || keep != 2 || L * 2 != b || b % 32 != 0 ||
      (CS != 1 && CS != 2 && CS != 4) || (b / 32 + DEC_KS - 1) / DEC_KS < CS ||
      idx_stride != L * idx_bits / 8 || idx_stride % 16 != 0 || !al || flags == nullptr ||
      nst < 2 || nst > K3D_MAXST || EG >= 65536 ||
      k3d_smem(nst, CS, static_cast<int>(EG), idx_bits) +
              (2 * K3D_MAXST + 1) * sizeof(uint64_t) + 64 > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
#define K3D_ARGS x, vals, idx, y, flags, E, C, c, b, L, idx_stride, CS, nst, s
  return idx_bits == 4 ? launch_k3_dec<4>(K3D_ARGS) : launch_k3_dec<8>(K3D_ARGS);
#undef K3D_ARGS
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, values and y share it).  mode (the
// caller's plan, kernels/nm_spmm.py::_k2_plan): 4 = the decode path on the
// sparse tensor cores (bf16 2:4: see launch_k2_dec_checked) with BM output
// rows a block, BN = 8·⌈B/8⌉, CS CTAs a cluster and smem bytes of dynamic
// shared memory (its ring of smem / stage stages); 3 = the many-row path on
// the sparse tensor cores (bf16 2:4: see launch_k2_sp_checked) with BM × BN
// tiles, CS CTAs a cluster and smem bytes of dynamic shared memory; 2 = the
// tensor-core path (bf16 2:4, 16-byte row slices: see launch_k2_tc_checked)
// with CS CTAs a cluster and smem bytes; 1 = the 16-byte vector path of
// nm_kernel (L % 8 == 0 and 16-byte aligned bases); 0 = its scalar path.
// CS and smem are ignored below mode 2, BM and BN below mode 3.  Returns
// the launch's error, else cudaGetLastError().
extern "C" int nm_matmul(const void* x, const void* vals, const void* idx,
                         void* y, int dtype, int idx_bits, int mode, int B,
                         int c, int b, int m, int keep, int L, int idx_stride,
                         int CS, int smem, int BM, int BN, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || c <= 0) return static_cast<int>(cudaGetLastError());
  if (mode < 0 || mode > 4) return static_cast<int>(cudaErrorInvalidValue);
  if (mode >= 2) {
    if (dtype != 1 || (idx_bits != 4 && idx_bits != 8))
      return static_cast<int>(cudaErrorInvalidValue);
    const int err =
        mode == 4 ? launch_k2_dec_checked(x, vals, idx, y, idx_bits, B, c, b, m,
                                          keep, L, idx_stride, CS, smem, BM, BN, s)
        : mode == 3 ? launch_k2_sp_checked(x, vals, idx, y, idx_bits, B, c, b, m,
                                           keep, L, idx_stride, CS, smem, BM, BN, s)
                    : launch_k2_tc_checked(x, vals, idx, y, idx_bits, B, c, b, m,
                                           keep, L, idx_stride, CS, smem, s);
    if (err != 0) return err;
    return static_cast<int>(cudaGetLastError());
  }
  const int vec = mode == 1;
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

// K3.  dtype / idx_bits as for nm_matmul.  mode (the caller's plan,
// kernels/nm_spmm.py::_k3_plan): 0 = the scalar path; 1 = the ring path on
// the CUDA cores, which needs L % 8 == 0, 16-byte rows of values (L·sizeof)
// and of indices (idx_stride % 16 == 0) and 16-byte aligned bases, with G
// (16 or 32 lanes a row) and SR (rows a ring stage); 2 = the tensor-core
// path, which needs all that, bf16, 2:4 and b % 32 == 0, with SR = 8 or 16
// output rows a stage (G ignored); 4 = the decode-occupancy path on the
// sparse tensor cores (bf16 2:4: see launch_k3_dec_checked) with clusters
// of CS CTAs and an nst-stage ring, flags E · ⌈C/8⌉ bytes of scratch for
// the vote.  G and SR are ignored at mode 4, CS, nst and flags below it.
// Shared memory within 227 KB, as _k3_plan computes it.  Returns
// cudaGetLastError().
extern "C" int nm_matmul_stacked(const void* x, const void* vals,
                                 const void* idx, void* y, void* flags,
                                 int dtype, int idx_bits, int mode, int E,
                                 int C, int c, int b, int m, int keep, int L,
                                 int idx_stride, int G, int SR, int CS,
                                 int nst, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0 || C <= 0 || c <= 0) return static_cast<int>(cudaGetLastError());
  if (E > 65535 || (C + MAXB - 1) / MAXB > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if (mode == 4) {
    if (dtype != 1 || (idx_bits != 4 && idx_bits != 8))
      return static_cast<int>(cudaErrorInvalidValue);
    err = launch_k3_dec_checked(x, vals, idx, y, static_cast<uint8_t*>(flags),
                                idx_bits, E, C, c, b, m, keep, L, idx_stride,
                                CS, nst, s);
  } else if (mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (dtype == 0 && idx_bits == 4) {
    err = launch_stacked<float, 4>(x, vals, idx, y, mode, E, C, c, b, m, keep,
                                   L, idx_stride, G, SR, s);
  } else if (dtype == 0 && idx_bits == 8) {
    err = launch_stacked<float, 8>(x, vals, idx, y, mode, E, C, c, b, m, keep,
                                   L, idx_stride, G, SR, s);
  } else if (dtype == 1 && idx_bits == 4) {
    err = launch_stacked<__nv_bfloat16, 4>(x, vals, idx, y, mode, E, C, c, b,
                                           m, keep, L, idx_stride, G, SR, s);
  } else if (dtype == 1 && idx_bits == 8) {
    err = launch_stacked<__nv_bfloat16, 8>(x, vals, idx, y, mode, E, C, c, b,
                                           m, keep, L, idx_stride, G, SR, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
