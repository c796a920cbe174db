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
// The cluster split and shared memory come from the host's plan
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, values and y share it).  mode (the
// caller's plan, kernels/nm_spmm.py::_k2_plan): 2 = the tensor-core path
// (bf16 2:4, 16-byte row slices: see launch_k2_tc_checked) with CS CTAs a
// cluster and smem bytes of dynamic shared memory; 1 = the 16-byte vector
// path of nm_kernel (L % 8 == 0 and 16-byte aligned bases); 0 = its scalar
// path.  CS and smem are ignored below mode 2.  Returns the launch's error,
// else cudaGetLastError().
extern "C" int nm_matmul(const void* x, const void* vals, const void* idx,
                         void* y, int dtype, int idx_bits, int mode, int B,
                         int c, int b, int m, int keep, int L, int idx_stride,
                         int CS, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || c <= 0) return static_cast<int>(cudaGetLastError());
  if (mode == 2) {
    if (dtype != 1 || (idx_bits != 4 && idx_bits != 8))
      return static_cast<int>(cudaErrorInvalidValue);
    const int err = launch_k2_tc_checked(x, vals, idx, y, idx_bits, B, c, b,
                                         m, keep, L, idx_stride, CS, smem, s);
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
// output rows a stage (G ignored).
// Shared memory within 227 KB, as _k3_plan computes it.  Returns
// cudaGetLastError().
extern "C" int nm_matmul_stacked(const void* x, const void* vals,
                                 const void* idx, void* y, int dtype,
                                 int idx_bits, int mode, int E, int C, int c,
                                 int b, int m, int keep, int L, int idx_stride,
                                 int G, int SR, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0 || C <= 0 || c <= 0) return static_cast<int>(cudaGetLastError());
  if (E > 65535 || (C + MAXB - 1) / MAXB > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if (dtype == 0 && idx_bits == 4) {
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
