// Experimental 1-NN lowerings for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by libpointmatcher_tpu_torch/ops/knn_variants_cuda.py.
//
// They replace the TPU kernels of tools/knn_variants.py, three lowerings of
// the dense 1-NN that tools/knn_micro.py (tools_torch/knn_micro.py in the
// port) times against K1 and K9:
//   T1  nn1_chunked_partial  <- _nn1_chunked_kernel (knn_variants.py:26, knn1_chunked)
//   T2  nn1_transposed       <- _nn1_t_kernel       (knn_variants.py:122, knn1_transposed)
//   T3  nn1_mxu<DIM>         <- _nn1_mxu3_kernel    (knn_variants.py:195, knn1_mxu)
//
// What bounds them: as K1 and K9 (csrc/knn.cu), each (query, reference)
// pair costs 8-9 fp32 operations on inputs of a few hundred kilobytes, so the
// fp32 issue rate bounds them, not memory: T2 issues at least 9
// instructions a pair (the exact form may not fuse into FMAs; its eight and
// the fminf of its group fold), twice the 67 TFLOP/s bound, the issue
// floor; T1 at least 11 (the eight and a compare and two selects); T3 at
// least 8 (its 7 and the fminf). Each keeps every pair in
// registers; they differ in the schedule, which is what the TPU variants
// explored:
//
// T1, independent accumulators with one reduction a chunk. Each thread owns
//   kT1QPer = 4 queries (a block of 128 threads, 512 queries, a warp's 128
//   one contiguous run) and stages the reference as T2 does (below: x +
//   pen, y, z arrays of kT2Stage rows through two buffers, one barrier a
//   stage), its chunks cut over gridDim.y by K1's split rule for T1's block
//   (ops/knn_variants_cuda.py t1_split). Each query keeps kT1Acc = 2
//   independent (min, id) accumulators, accumulator a taking the rows j = a
//   (mod 2), each updated on every pair by a compare and two selects, with
//   no group fold (T2's design). Two keep what this lowering explores, the
//   TPU kernel's lane accumulators merged once, at 80 registers: one
//   accumulator (no merge left) was 1-2% faster, four and eight (96 and 126
//   registers) slower, and eight queries a thread slower (PERF.md, "Findings").
//   After the chunk each query merges its accumulators once in (d2, id)
//   order, and T1's merge takes the chunks in order with a strict '<'. A
//   block whose queries are all masked does not sweep; a warp whose queries
//   are all masked joins the barriers only. The loop issues 11.5
//   instructions a pair: the 11 of d2 and the update, the loads and row
//   ids beside them.
// T2, the transposed layout: many queries share each staged reference row.
//   Each thread owns kT2QPer = 4 queries in registers (a block of 128
//   threads, 512 queries; the TPU tile's 2048 left only 10 blocks for 132
//   SMs at the tool's 20 480 queries). The reference is cut into chunks over
//   gridDim.y by K1's split rule for T2's block, in whole stages of 512
//   rows (ops/knn_variants_cuda.py t2_split), so a few thousand queries
//   still give every SM several blocks; per-chunk partials go to scratch the wrapper allocates and the
//   T1 merge takes them in chunk order with a strict '<'. Within a chunk
//   T2 runs K1's schedule (csrc/knn.cu): stages of kT2Stage rows as three
//   float arrays x + pen, y, z, the next stage loaded into registers while
//   the current one is swept and stored into the other of two buffers
//   after it, one barrier a stage; each group of kT2Group rows is read
//   from shared memory once (six 16-byte loads) for the thread's 4
//   queries, each folding the group's d2 with fminf (one instruction a
//   pair) and keeping (best, best group) with a strict '<' once a group;
//   after the chunk each query recomputes its best group's rows from
//   device memory and takes the first whose d2 equals its best. A block
//   whose queries are all masked does not sweep; a warp whose queries are
//   all masked joins the barriers only.
// T3, the matrix-product shape: a block owns 64 query rows, each thread
//   (ty, tx) of its 16 x 16 the rows ty + 16 i (i < 4) in registers, and
//   sweeps one chunk of the reference, cut over gridDim.y by K1's split rule
//   for T3's block in whole 256-column stages (ops/knn_variants_cuda.py
//   t3_split, aiming at 8 blocks an SM), so that a few thousand queries fill
//   all 132 SMs. The chunk is staged 256 columns at a time as four float
//   arrays x, y, z and r2pen through two buffers (the next stage loaded into
//   registers while the current one is swept, stored into the other buffer
//   after it, one barrier a stage). Each 128-column tile of a stage meets
//   the rows in a 4 x 8 register micro-tile of q.r over the d columns (a
//   SIMT fp32 GEMM tile, no tensor cores: TF32 and bf16 would not give the
//   plain version's bits), the thread's columns 4 tx .. 4 tx + 3 and 64 +
//   4 tx .. (two 16-byte loads an array); d2 = (q2 + r2pen) - 2 q.r. Per
//   row the thread's 8 columns of a tile are one group: folded with fminf
//   (one instruction a pair) and kept as (best, best tile) with a strict
//   '<' once a group, no id per pair. After the chunk each row's best group
//   is recomputed from device memory through the same functions and its
//   first column equal to the best taken; the 16 threads of a row then
//   reduce their (d2, id) lexicographically by shuffles, once a chunk. The
//   per-chunk partials, unclamped, go to scratch the wrapper allocates; T1's
//   merge takes them in chunk order with a strict '<' and only then clamps
//   at 0 (a clamp per chunk would tie two negative minima at 0 and let the
//   lower chunk win). A block whose queries are all masked does not sweep;
//   a warp whose rows are all masked joins the barriers only. The TPU
//   kernel's zero columns up to K = 128 add exact zeros and are not formed.
//   Bound: 8 fp32 operations a pair (the 5 of the dot product, q2 + r2pen,
//   and 2 dot folded into one fma with the subtraction) and the fminf; the
//   inner loop issues 8.69 instructions a pair. Rows of 8 a thread (128 a
//   block, 128 registers, two blocks an SM) were 13-15% slower at the
//   tool's shape and 1% at K1's inputs (PERF.md, "Findings").

// Exactness: T1 and T2 form d2 = (dx*dx + dy*dy) + dz*dz with dx taken
// against x + pen (K1's form), with explicitly rounded intrinsics (no FMA
// contraction); for pen 0 that is the order of ops/knn.py, ((pen + dx*dx) +
// dy*dy) + dz*dz (0 + dx*dx being dx*dx), for pen = +inf both are +inf, so
// they equal K1 and its plain version bit for bit. Each T1 accumulator,
// updated with a strict '<' in increasing row order, holds its rows'
// minimum at the first row holding it; their (d2, id) merge gives the
// chunk's minimum at its lowest index. T2's best group is the first that
// holds the chunk's minimum and its first row equal to it the lowest index;
// fminf ignores NaN as '<' does. T3 forms
// dot = (q0*r0 + q1*r1) + q2*r2 and d2 = (q2 + r2pen) - 2*dot with rounded
// intrinsics in the order of knn_variants_cuda.knn1_mxu3_plain, the last
// step as fma(-2, dot, q2 + r2pen): 2 dot is exact (doubling rounds nothing,
// subnormals included), so the fma's one rounding is the subtraction's, and
// T3 equals the plain version bit for bit wherever 2 dot does not overflow
// (|dot| < 2^127, coordinates below ~10^19; beyond it the plain version's
// d2 is -inf or NaN). Every comparison is a strict '<' in increasing reference
// order, or a (d2, id) lexicographic merge, so the lowest index wins a tie.
// pen = +inf at a masked reference row keeps every sum at +inf. Outputs: d2
// and id, (+inf, -1) for a masked query or one with no valid reference.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kT2Threads = 128;  // T2: threads a block
constexpr int kT2QPer = 4;       // T2: queries a thread
constexpr int kT2Stage = 512;    // T2: rows per shared stage (2 x 6 KB)
constexpr int kT2Group = 8;      // T2: rows per group (one fminf fold)
constexpr int kT2RowsPerThread = kT2Stage / kT2Threads;
static_assert(kT2Stage % kT2Group == 0 && kT2Group % 4 == 0, "whole float4 groups");
constexpr int kT1Threads = kT2Threads;  // T1: threads a block (T2's stages)
constexpr int kT1QPer = 4;              // T1: queries a thread
constexpr int kT1Acc = 2;               // T1: (min, id) accumulators a query
constexpr int kT1Step = 8;              // T1: rows a step (two float4 an array)
constexpr int kT1BlockQueries = kT1Threads * kT1QPer;
static_assert(kT2Stage % kT1Step == 0 && kT1Step % kT1Acc == 0,
              "a stage is whole steps, a step whole rounds of the accumulators");
constexpr int kT3Threads = 256;  // T3: threads a block, 16 x 16
constexpr int kT3RowsPer = 4;    // T3: query rows of a thread's micro-tile
constexpr int kT3Cols = 8;       // T3: its columns of a tile, one group
constexpr int kT3MinBlocks = 3;  // T3: blocks an SM (launch bounds: 80 registers)
constexpr int kT3Rows = 16 * kT3RowsPer;  // T3: query rows a block
constexpr int kT3Tile = 16 * kT3Cols;     // T3: reference columns a tile
constexpr int kT3Stage = 256;    // T3: columns a shared stage (2 x 4 KB)
static_assert(kT3Cols == 8, "a thread's group: two runs of four columns");
static_assert(kT3Stage == kT3Threads && kT3Stage % kT3Tile == 0,
              "a thread stages one column, a stage whole tiles");

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ void load_query(const float* __restrict__ q,
                                           int64_t i, int n, int dim,
                                           float& qx, float& qy, float& qz) {
  qx = qy = qz = 0.0f;
  if (i < n) {
    qx = q[i * dim];
    qy = q[i * dim + 1];
    if (dim == 3) qz = q[i * dim + 2];
  }
}

// (d, id) before (best, besti) in (d2, id) order; an entry without a
// neighbour is (+inf, -1), and only such entries hold +inf.
__device__ __forceinline__ bool before(float d, int id, float best, int besti) {
  return d < best || (d == best && id < besti);
}

// T1, T2 and T3: merge the chunks in increasing order with a strict '<',
// then (T3, `clamp`) clamp the minimum at 0.
__global__ void nn1_chunked_combine(const float* __restrict__ part_d,
                                    const int* __restrict__ part_i, int n,
                                    int splits, int clamp,
                                    const uint8_t* __restrict__ qmask,
                                    float* __restrict__ out_d,
                                    int* __restrict__ out_i) {
  const int64_t qi = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= n) return;
  float best = CUDART_INF_F;
  int besti = -1;
  for (int s = 0; s < splits; ++s) {
    const float d = part_d[(int64_t)s * n + qi];
    if (d < best) {
      best = d;
      besti = part_i[(int64_t)s * n + qi];
    }
  }
  if (clamp) best = fmaxf(best, 0.0f);
  const bool qv = qmask[qi] != 0;
  out_d[qi] = qv ? best : CUDART_INF_F;
  out_i[qi] = (qv && isfinite(best)) ? besti : -1;
}

// ---------------------------------------------------------------------- T2

// Reference row j with its penalty folded into x: (x + pen, y, z).
__device__ __forceinline__ void folded_row(const float* __restrict__ ref,
                                           const uint8_t* __restrict__ rmask,
                                           int64_t j, int dim, float& x,
                                           float& y, float& z) {
  const float pen = rmask[j] != 0 ? 0.0f : CUDART_INF_F;
  x = __fadd_rn(ref[j * dim], pen);
  y = ref[j * dim + 1];
  z = dim == 3 ? ref[j * dim + 2] : 0.0f;
}

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

// (dx*dx + dy*dy) + dz*dz against x + pen: K1's order (csrc/knn.cu).
__device__ __forceinline__ float d2_folded(float qx, float qy, float qz,
                                           float x, float y, float z) {
  return __fadd_rn(__fadd_rn(sq(__fsub_rn(qx, x)), sq(__fsub_rn(qy, y))),
                   sq(__fsub_rn(qz, z)));
}

// This thread's rows of the stage at t0 (rows t0 + r * kT2Threads + tid),
// rows at or past j1 as (+inf, 0, 0).
struct T2Stage {
  float x[kT2RowsPerThread], y[kT2RowsPerThread], z[kT2RowsPerThread];

  __device__ __forceinline__ void load(const float* __restrict__ ref,
                                       const uint8_t* __restrict__ rmask,
                                       int64_t t0, int64_t j1, int dim) {
#pragma unroll
    for (int r = 0; r < kT2RowsPerThread; ++r) {
      const int64_t j = t0 + r * kT2Threads + threadIdx.x;
      if (j < j1) {
        folded_row(ref, rmask, j, dim, x[r], y[r], z[r]);
      } else {
        x[r] = CUDART_INF_F;
        y[r] = z[r] = 0.0f;
      }
    }
  }

  __device__ __forceinline__ void store(float* sx, float* sy, float* sz) const {
#pragma unroll
    for (int r = 0; r < kT2RowsPerThread; ++r) {
      sx[r * kT2Threads + threadIdx.x] = x[r];
      sy[r * kT2Threads + threadIdx.x] = y[r];
      sz[r * kT2Threads + threadIdx.x] = z[r];
    }
  }
};

// The minimum of kT2Group values, NaN ignored (exact: no rounding).
__device__ __forceinline__ float group_min(const float (&d)[kT2Group]) {
  float t[kT2Group];
#pragma unroll
  for (int r = 0; r < kT2Group; ++r) t[r] = d[r];
#pragma unroll
  for (int w = kT2Group / 2; w >= 1; w /= 2) {
#pragma unroll
    for (int r = 0; r < w; ++r) t[r] = fminf(t[r], t[r + w]);
  }
  return t[0];
}

// The thread's kT2QPer queries: running (group minimum, its group's first
// row). One group's rows are read from shared memory once for all of them.
struct T2Nearest {
  float qx[kT2QPer], qy[kT2QPer], qz[kT2QPer], best[kT2QPer];
  int grp[kT2QPer];

  __device__ __forceinline__ void sweep(const float* sx, const float* sy,
                                        const float* sz, int t0, int rows) {
    const int groups = (rows + kT2Group - 1) / kT2Group;
#pragma unroll 1
    for (int g = 0; g < groups; ++g) {
      float x[kT2Group], y[kT2Group], z[kT2Group];
#pragma unroll
      for (int v = 0; v < kT2Group / 4; ++v) {
        const int o = g * (kT2Group / 4) + v;
        const float4 a = reinterpret_cast<const float4*>(sx)[o];
        const float4 b = reinterpret_cast<const float4*>(sy)[o];
        const float4 c = reinterpret_cast<const float4*>(sz)[o];
        x[4 * v] = a.x, x[4 * v + 1] = a.y, x[4 * v + 2] = a.z, x[4 * v + 3] = a.w;
        y[4 * v] = b.x, y[4 * v + 1] = b.y, y[4 * v + 2] = b.z, y[4 * v + 3] = b.w;
        z[4 * v] = c.x, z[4 * v + 1] = c.y, z[4 * v + 2] = c.z, z[4 * v + 3] = c.w;
      }
      const int gid = t0 + g * kT2Group;
#pragma unroll
      for (int k = 0; k < kT2QPer; ++k) {
        float d[kT2Group];
#pragma unroll
        for (int r = 0; r < kT2Group; ++r)
          d[r] = d2_folded(qx[k], qy[k], qz[k], x[r], y[r], z[r]);
        const float mn = group_min(d);
        if (mn < best[k]) {
          best[k] = mn;
          grp[k] = gid;
        }
      }
    }
  }
};

// The first row of group `grp` (rows below j1) whose d2 equals `best`
// (-1: none), recomputed from device memory.
__device__ __forceinline__ int first_row(float qx, float qy, float qz,
                                         float best, int grp,
                                         const float* __restrict__ ref,
                                         const uint8_t* __restrict__ rmask,
                                         int64_t j1, int dim) {
  if (grp < 0) return -1;
  for (int r = 0; r < kT2Group && grp + r < j1; ++r) {
    float x, y, z;
    folded_row(ref, rmask, grp + r, dim, x, y, z);
    if (d2_folded(qx, qy, qz, x, y, z) == best) return grp + r;
  }
  return -1;
}

// T2: (min, argmin) of kT2Threads * kT2QPer queries (query base + tid + k *
// kT2Threads) over one reference chunk per blockIdx.y. The chunk is staged
// kT2Stage rows at a time through two buffers: the next stage's rows are
// loaded into registers while this one is swept, stored after it, one
// barrier a stage. A block whose queries are all masked does not sweep; a
// warp whose queries are all masked joins the barriers only.
__global__ void __launch_bounds__(kT2Threads)
nn1_transposed(const float* __restrict__ q, const uint8_t* __restrict__ qmask,
               int n, const float* __restrict__ ref,
               const uint8_t* __restrict__ rmask, int m, int dim, int chunk,
               float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ __align__(16) float s_x[2][kT2Stage];
  __shared__ __align__(16) float s_y[2][kT2Stage];
  __shared__ __align__(16) float s_z[2][kT2Stage];
  const int64_t base = (int64_t)blockIdx.x * (kT2Threads * kT2QPer) + threadIdx.x;
  T2Nearest nn;
  bool live = false;
#pragma unroll
  for (int k = 0; k < kT2QPer; ++k) {
    const int64_t qi = base + (int64_t)k * kT2Threads;
    load_query(q, qi, n, dim, nn.qx[k], nn.qy[k], nn.qz[k]);
    nn.best[k] = CUDART_INF_F;
    nn.grp[k] = -1;
    live |= qi < n && qmask[qi] != 0;
  }
  const int64_t j0 = (int64_t)blockIdx.y * chunk;
  const int64_t j1 = min64(m, j0 + chunk);
  const int stages = j1 > j0 ? (int)((j1 - j0 + kT2Stage - 1) / kT2Stage) : 0;
  if (__syncthreads_or(live) && stages > 0) {
    const bool warp_live = __any_sync(0xffffffffu, live);
    T2Stage st;
    st.load(ref, rmask, j0, j1, dim);
    st.store(s_x[0], s_y[0], s_z[0]);
    __syncthreads();
    for (int s = 0; s < stages; ++s) {
      const int64_t t0 = j0 + (int64_t)s * kT2Stage;
      // the next stage's loads are in flight while this one is swept
      const bool more = s + 1 < stages;
      if (more) st.load(ref, rmask, t0 + kT2Stage, j1, dim);
      if (warp_live)
        nn.sweep(s_x[s & 1], s_y[s & 1], s_z[s & 1], (int)t0,
                 (int)min64(kT2Stage, j1 - t0));
      // the other buffer was last read before the previous barrier
      if (more) st.store(s_x[(s + 1) & 1], s_y[(s + 1) & 1], s_z[(s + 1) & 1]);
      __syncthreads();
    }
  }
  const int64_t out = (int64_t)blockIdx.y * n;
#pragma unroll
  for (int k = 0; k < kT2QPer; ++k) {
    const int64_t qi = base + (int64_t)k * kT2Threads;
    if (qi < n) {
      part_d[out + qi] = nn.best[k];
      part_i[out + qi] = first_row(nn.qx[k], nn.qy[k], nn.qz[k], nn.best[k],
                                   nn.grp[k], ref, rmask, j1, dim);
    }
  }
}

// ---------------------------------------------------------------------- T1

// T1's kT1QPer queries, each with kT1Acc independent (min, id)
// accumulators, accumulator a taking the rows j = a (mod kT1Acc); every pair
// updates its accumulator by a compare and two selects. An accumulator
// keeps its row less a (so at kT1Acc = kT1Step, the step's first row: no
// add a pair); row() gives the row back.
struct T1Nearest {
  float qx[kT1QPer], qy[kT1QPer], qz[kT1QPer];
  float bd[kT1QPer][kT1Acc];
  int bi[kT1QPer][kT1Acc];

  __device__ __forceinline__ void sweep(const float* sx, const float* sy,
                                        const float* sz, int t0, int rows) {
    const int steps = (rows + kT1Step - 1) / kT1Step;
#pragma unroll 1
    for (int g = 0; g < steps; ++g) {
      float x[kT1Step], y[kT1Step], z[kT1Step];
#pragma unroll
      for (int v = 0; v < kT1Step / 4; ++v) {
        const int o = g * (kT1Step / 4) + v;
        const float4 a = reinterpret_cast<const float4*>(sx)[o];
        const float4 b = reinterpret_cast<const float4*>(sy)[o];
        const float4 c = reinterpret_cast<const float4*>(sz)[o];
        x[4 * v] = a.x, x[4 * v + 1] = a.y, x[4 * v + 2] = a.z, x[4 * v + 3] = a.w;
        y[4 * v] = b.x, y[4 * v + 1] = b.y, y[4 * v + 2] = b.z, y[4 * v + 3] = b.w;
        z[4 * v] = c.x, z[4 * v + 1] = c.y, z[4 * v + 2] = c.z, z[4 * v + 3] = c.w;
      }
      const int j = t0 + g * kT1Step;
#pragma unroll
      for (int k = 0; k < kT1QPer; ++k) {
#pragma unroll
        for (int r = 0; r < kT1Step; ++r) {
          const float d = d2_folded(qx[k], qy[k], qz[k], x[r], y[r], z[r]);
          const int a = r % kT1Acc;
          if (d < bd[k][a]) {
            bd[k][a] = d;
            bi[k][a] = j + (r - a);
          }
        }
      }
    }
  }

  // accumulator a's row (-1: none)
  __device__ __forceinline__ int row(int k, int a) const {
    return bi[k][a] < 0 ? -1 : bi[k][a] + a;
  }
};

// T1: (min, argmin) of kT1BlockQueries queries over one reference chunk per
// blockIdx.y. Query k of lane l in warp w is base + w * 32 * kT1QPer + 32 *
// k + l, so a warp's queries are one contiguous run. The chunk is staged as
// T2 stages it (kT2Stage rows, x + pen, y, z, two buffers, one barrier a
// stage); a block whose queries are all masked does not sweep, a warp whose
// queries are all masked joins the barriers only. After the chunk each
// query merges its accumulators once, in (d2, id) order.
__global__ void __launch_bounds__(kT1Threads)
nn1_chunked_partial(const float* __restrict__ q, const uint8_t* __restrict__ qmask,
                    int n, const float* __restrict__ ref,
                    const uint8_t* __restrict__ rmask, int m, int dim,
                    int chunk, float* __restrict__ part_d,
                    int* __restrict__ part_i) {
  __shared__ __align__(16) float s_x[2][kT2Stage];
  __shared__ __align__(16) float s_y[2][kT2Stage];
  __shared__ __align__(16) float s_z[2][kT2Stage];
  const int64_t base = (int64_t)blockIdx.x * kT1BlockQueries +
                       (threadIdx.x >> 5) * (32 * kT1QPer) + (threadIdx.x & 31);
  T1Nearest nn;
  bool live = false;
#pragma unroll
  for (int k = 0; k < kT1QPer; ++k) {
    const int64_t qi = base + 32 * k;
    load_query(q, qi, n, dim, nn.qx[k], nn.qy[k], nn.qz[k]);
#pragma unroll
    for (int a = 0; a < kT1Acc; ++a) {
      nn.bd[k][a] = CUDART_INF_F;
      nn.bi[k][a] = -1;
    }
    live |= qi < n && qmask[qi] != 0;
  }
  const int64_t j0 = (int64_t)blockIdx.y * chunk;
  const int64_t j1 = min64(m, j0 + chunk);
  const int stages = j1 > j0 ? (int)((j1 - j0 + kT2Stage - 1) / kT2Stage) : 0;
  if (__syncthreads_or(live) && stages > 0) {
    const bool warp_live = __any_sync(0xffffffffu, live);
    T2Stage st;
    st.load(ref, rmask, j0, j1, dim);
    st.store(s_x[0], s_y[0], s_z[0]);
    __syncthreads();
    for (int s = 0; s < stages; ++s) {
      const int64_t t0 = j0 + (int64_t)s * kT2Stage;
      // the next stage's loads are in flight while this one is swept
      const bool more = s + 1 < stages;
      if (more) st.load(ref, rmask, t0 + kT2Stage, j1, dim);
      if (warp_live)
        nn.sweep(s_x[s & 1], s_y[s & 1], s_z[s & 1], (int)t0,
                 (int)min64(kT2Stage, j1 - t0));
      // the other buffer was last read before the previous barrier
      if (more) st.store(s_x[(s + 1) & 1], s_y[(s + 1) & 1], s_z[(s + 1) & 1]);
      __syncthreads();
    }
  }
  const int64_t out = (int64_t)blockIdx.y * n;
#pragma unroll
  for (int k = 0; k < kT1QPer; ++k) {
    const int64_t qi = base + 32 * k;
    float best = nn.bd[k][0];
    int besti = nn.row(k, 0);
#pragma unroll
    for (int a = 1; a < kT1Acc; ++a) {
      if (before(nn.bd[k][a], nn.row(k, a), best, besti)) {
        best = nn.bd[k][a];
        besti = nn.row(k, a);
      }
    }
    if (qi < n) {
      part_d[out + qi] = best;
      part_i[out + qi] = besti;
    }
  }
}

// x0*y0 + x1*y1 (+ x2*y2), each step rounded, in the plain version's order.
template <int DIM>
__device__ __forceinline__ float dot3(float x0, float x1, float x2, float y0,
                                      float y1, float y2) {
  const float s = __fadd_rn(__fmul_rn(x0, y0), __fmul_rn(x1, y1));
  return DIM == 3 ? __fadd_rn(s, __fmul_rn(x2, y2)) : s;
}

// T3's d2 of one pair: dot = (q0 r0 + q1 r1) + q2 r2 and (q2 + r2pen) -
// 2 dot, each step rounded, the last as one fma (see the header).
template <int DIM>
__device__ __forceinline__ float mxu_d2(float qx, float qy, float qz, float q2,
                                        float rx, float ry, float rz, float rp) {
  return __fmaf_rn(-2.0f, dot3<DIM>(qx, qy, qz, rx, ry, rz), __fadd_rn(q2, rp));
}

// Reference column j as T3 stages it: (x, y, z, r2pen), r2pen = r.r or
// +inf at a masked row; (0, 0, 0, +inf) at or past j1.
template <int DIM>
__device__ __forceinline__ float4 mxu_column(const float* __restrict__ ref,
                                             const uint8_t* __restrict__ rmask,
                                             int64_t j, int64_t j1) {
  float4 c = make_float4(0.0f, 0.0f, 0.0f, CUDART_INF_F);
  if (j < j1) {
    c.x = ref[j * DIM];
    c.y = ref[j * DIM + 1];
    if (DIM == 3) c.z = ref[j * DIM + 2];
    if (rmask[j] != 0) c.w = dot3<DIM>(c.x, c.y, c.z, c.x, c.y, c.z);
  }
  return c;
}

// Column e (0..7) of thread tx's group in the tile at t0: 4 tx + e, then
// 64 + 4 tx + e - 4, in increasing order.
__device__ __forceinline__ int64_t micro_column(int64_t t0, int tx, int e) {
  return t0 + (e < 4 ? 4 * tx + e : kT3Tile / 2 + 4 * tx + e - 4);
}

// T3: (min, argmin) of each of the block's kT3Rows query rows over one
// reference chunk per blockIdx.y, unclamped: thread (ty, tx) = (threadIdx.x
// / 16, threadIdx.x % 16) holds rows ty + 16 i (i < kT3RowsPer); the 16
// threads of a row group are one half of a warp.
template <int DIM>
__global__ void __launch_bounds__(kT3Threads, kT3MinBlocks)
nn1_mxu(const float* __restrict__ q, const uint8_t* __restrict__ qmask, int n,
        const float* __restrict__ ref, const uint8_t* __restrict__ rmask, int m,
        int chunk, float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ __align__(16) float s_r[2][4][kT3Stage];  // x, y, z, r2pen
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int64_t row0 = (int64_t)blockIdx.x * kT3Rows;
  float qx[kT3RowsPer], qy[kT3RowsPer], qz[kT3RowsPer], q2[kT3RowsPer];
  float best[kT3RowsPer];
  int grp[kT3RowsPer];                // the best group's tile
  bool live = false;
#pragma unroll
  for (int i = 0; i < kT3RowsPer; ++i) {
    const int64_t r = row0 + ty + 16 * i;
    qx[i] = qy[i] = qz[i] = 0.0f;
    if (r < n) {
      qx[i] = q[r * DIM];
      qy[i] = q[r * DIM + 1];
      if (DIM == 3) qz[i] = q[r * DIM + 2];
      live |= qmask[r] != 0;
    }
    q2[i] = dot3<DIM>(qx[i], qy[i], qz[i], qx[i], qy[i], qz[i]);
    best[i] = CUDART_INF_F;
    grp[i] = -1;
  }
  const int64_t j0 = (int64_t)blockIdx.y * chunk;
  const int64_t j1 = min64(m, j0 + chunk);
  const int stages = j1 > j0 ? (int)((j1 - j0 + kT3Stage - 1) / kT3Stage) : 0;
  if (__syncthreads_or(live) && stages > 0) {
    const bool warp_live = __any_sync(0xffffffffu, live);
    auto store = [&](float4 c, int b) {
      s_r[b][0][threadIdx.x] = c.x;
      s_r[b][1][threadIdx.x] = c.y;
      s_r[b][2][threadIdx.x] = c.z;
      s_r[b][3][threadIdx.x] = c.w;
    };
    float4 col = mxu_column<DIM>(ref, rmask, j0 + threadIdx.x, j1);
    store(col, 0);
    __syncthreads();
    for (int s = 0; s < stages; ++s) {
      const int64_t t0 = j0 + (int64_t)s * kT3Stage;
      // the next stage's loads are in flight while this one is swept
      const bool more = s + 1 < stages;
      if (more) col = mxu_column<DIM>(ref, rmask, t0 + kT3Stage + threadIdx.x, j1);
      if (warp_live) {
#pragma unroll 1
        for (int h = 0; h < kT3Stage / kT3Tile; ++h) {
          // the thread's 8 columns of the tile, two 16-byte loads an array
          auto load = [&](int a, float (&v)[kT3Cols]) {
            const float4* src =
                reinterpret_cast<const float4*>(s_r[s & 1][a] + h * kT3Tile);
            const float4 lo = src[tx], hi = src[kT3Tile / 8 + tx];
            v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
            v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
          };
          float rx[kT3Cols], ry[kT3Cols], rz[kT3Cols], rp[kT3Cols];
          load(0, rx);
          load(1, ry);
          load(2, rz);
          load(3, rp);
#pragma unroll
          for (int i = 0; i < kT3RowsPer; ++i) {
            float d[kT3Cols];
#pragma unroll
            for (int j = 0; j < kT3Cols; ++j)
              d[j] = mxu_d2<DIM>(qx[i], qy[i], qz[i], q2[i], rx[j], ry[j], rz[j],
                                 rp[j]);
#pragma unroll
            for (int w = kT3Cols / 2; w >= 1; w /= 2) {
#pragma unroll
              for (int j = 0; j < w; ++j) d[j] = fminf(d[j], d[j + w]);
            }
            if (d[0] < best[i]) {
              best[i] = d[0];
              grp[i] = (int)(t0 + h * kT3Tile);
            }
          }
        }
      }
      // the other buffer was last read before the previous barrier
      if (more) store(col, (s + 1) & 1);
      __syncthreads();
    }
  }
  // each row's first column of its best group equal to its best, then the
  // lowest (d2, id) of the row's 16 threads (unrolled: the rows' registers
  // are indexed by constants only)
#pragma unroll
  for (int i = 0; i < kT3RowsPer; ++i) {
    int id = -1;
    if (grp[i] >= 0) {
      for (int e = 0; e < kT3Cols; ++e) {
        const int64_t j = micro_column(grp[i], tx, e);
        const float4 c = mxu_column<DIM>(ref, rmask, j, j1);
        if (mxu_d2<DIM>(qx[i], qy[i], qz[i], q2[i], c.x, c.y, c.z, c.w) == best[i]) {
          id = (int)j;
          break;
        }
      }
    }
    float bd = best[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off, 16);
      const int oi = __shfl_xor_sync(0xffffffffu, id, off, 16);
      if (before(od, oi, bd, id)) {
        bd = od;
        id = oi;
      }
    }
    const int64_t r = row0 + ty + 16 * i;
    if (tx == 0 && r < n) {
      part_d[(int64_t)blockIdx.y * n + r] = bd;
      part_i[(int64_t)blockIdx.y * n + r] = id;
    }
  }
}

}  // namespace

extern "C" {

// T1's queries a block, rows a shared stage (its chunks' granularity) and
// accumulators a query; splits * chunk >= m.
int pm_t1_block_queries() { return kT1BlockQueries; }
int pm_t1_stage_rows() { return kT2Stage; }
int pm_t1_accumulators() { return kT1Acc; }

// q [n, dim], qmask [n] bytes, ref [m, dim], rmask [m] bytes; part_d and
// part_i hold splits * n entries; out_d, out_i [n].
int pm_nn1_chunked(const float* q, const uint8_t* qmask, int n,
                   const float* ref, const uint8_t* rmask, int m, int dim,
                   int splits, int chunk, float* part_d, int* part_i,
                   float* out_d, int* out_i, void* stream) {
  if (n == 0) return cudaSuccess;
  if (chunk % kT2Stage != 0) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((n + kT1BlockQueries - 1) / kT1BlockQueries, splits);
  nn1_chunked_partial<<<grid, kT1Threads, 0, st>>>(q, qmask, n, ref, rmask, m,
                                                   dim, chunk, part_d, part_i);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  nn1_chunked_combine<<<(n + 255) / 256, 256, 0, st>>>(
      part_d, part_i, n, splits, 0, qmask, out_d, out_i);
  return cudaGetLastError();
}

// T2's queries a block and rows a shared stage (its chunks' granularity),
// and rows a group (the emulation's, K1's); splits * chunk >= m; part_d and
// part_i hold splits * n entries.
int pm_t2_block_queries() { return kT2Threads * kT2QPer; }
int pm_t2_stage_rows() { return kT2Stage; }
int pm_t2_group_rows() { return kT2Group; }

int pm_nn1_transposed(const float* q, const uint8_t* qmask, int n,
                      const float* ref, const uint8_t* rmask, int m, int dim,
                      int splits, int chunk, float* part_d, int* part_i,
                      float* out_d, int* out_i, void* stream) {
  if (n == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int per_block = kT2Threads * kT2QPer;
  const dim3 grid((n + per_block - 1) / per_block, splits);
  nn1_transposed<<<grid, kT2Threads, 0, st>>>(q, qmask, n, ref, rmask, m, dim,
                                              chunk, part_d, part_i);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  nn1_chunked_combine<<<(n + 255) / 256, 256, 0, st>>>(
      part_d, part_i, n, splits, 0, qmask, out_d, out_i);
  return cudaGetLastError();
}

// T3's queries a block and columns a shared stage (its chunks'
// granularity); splits * chunk >= m; part_d and part_i hold splits * n
// entries.
int pm_t3_block_queries() { return kT3Rows; }
int pm_t3_stage_cols() { return kT3Stage; }

int pm_nn1_mxu(const float* q, const uint8_t* qmask, int n, const float* ref,
               const uint8_t* rmask, int m, int dim, int splits, int chunk,
               float* part_d, int* part_i, float* out_d, int* out_i,
               void* stream) {
  if (n == 0) return cudaSuccess;
  if (chunk % kT3Stage != 0) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((n + kT3Rows - 1) / kT3Rows), (unsigned)splits);
  if (dim == 3)
    nn1_mxu<3><<<grid, kT3Threads, 0, st>>>(q, qmask, n, ref, rmask, m, chunk,
                                            part_d, part_i);
  else if (dim == 2)
    nn1_mxu<2><<<grid, kT3Threads, 0, st>>>(q, qmask, n, ref, rmask, m, chunk,
                                            part_d, part_i);
  else
    return cudaErrorInvalidValue;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  nn1_chunked_combine<<<(n + 255) / 256, 256, 0, st>>>(
      part_d, part_i, n, splits, 1, qmask, out_d, out_i);
  return cudaGetLastError();
}

const char* pm_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
