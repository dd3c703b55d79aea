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
// fp32 issue rate bounds them, not memory: T1 and T2 issue at least 9
// instructions a pair (the exact form may not fuse into FMAs; T2's eight
// and the fminf of its group fold), twice the 67 TFLOP/s bound, the issue
// floor. Each keeps every pair in registers; they differ in the schedule,
// which is what the TPU variants explored:
//
// T1, per-lane accumulators with one reduction at the end. One thread owns
//   one query; reference rows are staged through shared memory as float4
//   (x, y, z, pen), as in K1. Each thread keeps kAcc = 8 independent
//   (min, id) accumulators, accumulator a taking the rows j = a (mod 8) of
//   each stage, which breaks the min chain's loop-carried dependence as the
//   TPU kernel's 128 lane accumulators do. They merge once after the last
//   stage in (d2, id) order. The reference is split into chunks over
//   gridDim.y, as K1 does, and a second kernel merges the chunks in order.
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
// T3, the matrix-product shape: a block owns 128 query rows and sweeps the
//   reference in tiles of 128 columns. Query rows (transposed) and reference
//   columns sit in shared memory; each thread forms an 8 x 8 register
//   micro-tile of q.r over the d columns (a SIMT fp32 GEMM tile, no tensor
//   cores: TF32 and bf16 would break the error bound), then d2 = (q2 + r2pen)
//   - 2 q.r, each row's min and argmin over the tile by warp shuffles, and a
//   strict '<' merge across tiles; clamped at 0 at the end. The TPU kernel's
//   zero columns up to K = 128 add exact zeros and are not formed.
//
// Exactness: T1 forms d2 = ((pen + dx*dx) + dy*dy) + dz*dz, T2 (dx*dx +
// dy*dy) + dz*dz with dx taken against x + pen (K1's form), with explicitly
// rounded intrinsics (no FMA contraction); for pen 0 both are the order of
// ops/knn.py (0 + dx*dx being dx*dx), for pen = +inf both are +inf, so they
// equal K1 and its plain version bit for bit. T2's best group is the first
// that holds the chunk's minimum and its first row equal to it the lowest
// index; fminf ignores NaN as '<' does. T3 forms
// dot = (q0*r0 + q1*r1) + q2*r2 and d2 = (q2 + r2pen) - 2*dot with rounded
// intrinsics in the order of knn_variants_cuda.knn1_mxu3_plain, and equals it
// bit for bit. Every comparison is a strict '<' in increasing reference
// order, or a (d2, id) lexicographic merge, so the lowest index wins a tie.
// pen = +inf at a masked reference row keeps every sum at +inf. Outputs: d2
// and id, (+inf, -1) for a masked query or one with no valid reference.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // threads per block
constexpr int kTile = 1024;  // reference rows per shared-memory stage (16 KB)
constexpr int kAcc = 8;      // T1: accumulators per thread
constexpr int kT2Threads = 128;  // T2: threads a block
constexpr int kT2QPer = 4;       // T2: queries a thread
constexpr int kT2Stage = 512;    // T2: rows per shared stage (2 x 6 KB)
constexpr int kT2Group = 8;      // T2: rows per group (one fminf fold)
constexpr int kT2RowsPerThread = kT2Stage / kT2Threads;
static_assert(kT2Stage % kT2Group == 0 && kT2Group % 4 == 0, "whole float4 groups");
constexpr int kT3 = 128;     // T3: query rows and reference columns per tile
constexpr int kMicro = 8;    // T3: rows and columns of a thread's micro-tile

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float4 stage_row(const float* __restrict__ ref,
                                            const uint8_t* __restrict__ rmask,
                                            int64_t j, int dim) {
  const float x = ref[j * dim];
  const float y = ref[j * dim + 1];
  const float z = dim == 3 ? ref[j * dim + 2] : 0.0f;
  return make_float4(x, y, z, rmask[j] != 0 ? 0.0f : CUDART_INF_F);
}

// ((pen + dx*dx) + dy*dy) + dz*dz; at dim = 2, dz = 0 adds +0, which leaves
// the sum's bits as they are, as in K1.
__device__ __forceinline__ float diff_d2(float qx, float qy, float qz,
                                         float4 r) {
  const float dx = __fsub_rn(qx, r.x);
  const float dy = __fsub_rn(qy, r.y);
  const float dz = __fsub_rn(qz, r.z);
  return __fadd_rn(__fadd_rn(__fadd_rn(r.w, __fmul_rn(dx, dx)),
                             __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
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

// T1: the (min, argmin) of one reference chunk per blockIdx.y.
__global__ void __launch_bounds__(kBlock)
nn1_chunked_partial(const float* __restrict__ q, int n,
                    const float* __restrict__ ref,
                    const uint8_t* __restrict__ rmask, int m, int dim,
                    int chunk, float* __restrict__ part_d,
                    int* __restrict__ part_i) {
  __shared__ float4 tile[kTile];
  const int64_t qi = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  const int64_t j0 = (int64_t)blockIdx.y * chunk;
  const int64_t j1 = min64(m, j0 + chunk);
  float qx, qy, qz;
  load_query(q, qi, n, dim, qx, qy, qz);
  float bd[kAcc];
  int bi[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    bd[a] = CUDART_INF_F;
    bi[a] = -1;
  }
  for (int64_t t0 = j0; t0 < j1; t0 += kTile) {
    const int cnt = (int)min64(kTile, j1 - t0);
    __syncthreads();
    for (int l = threadIdx.x; l < cnt; l += kBlock)
      tile[l] = stage_row(ref, rmask, t0 + l, dim);
    __syncthreads();
    const int full = cnt & ~(kAcc - 1);
    for (int l = 0; l < full; l += kAcc) {
#pragma unroll
      for (int a = 0; a < kAcc; ++a) {
        const float d = diff_d2(qx, qy, qz, tile[l + a]);
        if (d < bd[a]) {
          bd[a] = d;
          bi[a] = (int)(t0 + l + a);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {  // the stage's last cnt % 8 rows
      if (full + a < cnt) {
        const float d = diff_d2(qx, qy, qz, tile[full + a]);
        if (d < bd[a]) {
          bd[a] = d;
          bi[a] = (int)(t0 + full + a);
        }
      }
    }
  }
  float best = bd[0];
  int besti = bi[0];
#pragma unroll
  for (int a = 1; a < kAcc; ++a) {
    if (before(bd[a], bi[a], best, besti)) {
      best = bd[a];
      besti = bi[a];
    }
  }
  if (qi < n) {
    part_d[(int64_t)blockIdx.y * n + qi] = best;
    part_i[(int64_t)blockIdx.y * n + qi] = besti;
  }
}

// T1 and T2: merge the chunks in increasing order with a strict '<'.
__global__ void nn1_chunked_combine(const float* __restrict__ part_d,
                                    const int* __restrict__ part_i, int n,
                                    int splits,
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

// x0*y0 + x1*y1 (+ x2*y2), each step rounded, in the plain version's order.
template <int DIM>
__device__ __forceinline__ float dot3(float x0, float x1, float x2, float y0,
                                      float y1, float y2) {
  const float s = __fadd_rn(__fmul_rn(x0, y0), __fmul_rn(x1, y1));
  return DIM == 3 ? __fadd_rn(s, __fmul_rn(x2, y2)) : s;
}

// T3: thread (ty, tx) = (threadIdx.x / 16, threadIdx.x % 16) owns the tile's
// rows ty + 16 i and columns tx + 16 j, i, j < 8; the 16 threads of a row
// group are one half of a warp.
template <int DIM>
__global__ void __launch_bounds__(kBlock)
nn1_mxu(const float* __restrict__ q, const uint8_t* __restrict__ qmask, int n,
        const float* __restrict__ ref, const uint8_t* __restrict__ rmask, int m,
        float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float qs[4][kT3];  // x, y, z, q2 of the block's rows
  __shared__ float rs[4][kT3];  // x, y, z, r2pen of the tile's columns
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int64_t row0 = (int64_t)blockIdx.x * kT3;
  if (threadIdx.x < kT3) {
    const int64_t i = row0 + threadIdx.x;
    float x = 0.0f, y = 0.0f, z = 0.0f;
    if (i < n) {
      x = q[i * DIM];
      y = q[i * DIM + 1];
      if (DIM == 3) z = q[i * DIM + 2];
    }
    qs[0][threadIdx.x] = x;
    qs[1][threadIdx.x] = y;
    qs[2][threadIdx.x] = z;
    qs[3][threadIdx.x] = dot3<DIM>(x, y, z, x, y, z);
  }
  __syncthreads();
  float qx[kMicro], qy[kMicro], qz[kMicro], q2[kMicro], best[kMicro];
  int besti[kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int r = ty + 16 * i;
    qx[i] = qs[0][r];
    qy[i] = qs[1][r];
    qz[i] = qs[2][r];
    q2[i] = qs[3][r];
    best[i] = CUDART_INF_F;
    besti[i] = -1;
  }
  for (int64_t t0 = 0; t0 < m; t0 += kT3) {
    __syncthreads();
    if (threadIdx.x < kT3) {
      const int64_t j = t0 + threadIdx.x;
      float x = 0.0f, y = 0.0f, z = 0.0f, w = CUDART_INF_F;
      if (j < m) {
        x = ref[j * DIM];
        y = ref[j * DIM + 1];
        if (DIM == 3) z = ref[j * DIM + 2];
        if (rmask[j] != 0) w = dot3<DIM>(x, y, z, x, y, z);
      }
      rs[0][threadIdx.x] = x;
      rs[1][threadIdx.x] = y;
      rs[2][threadIdx.x] = z;
      rs[3][threadIdx.x] = w;
    }
    __syncthreads();
    float rx[kMicro], ry[kMicro], rz[kMicro], rp[kMicro];
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int c = tx + 16 * j;
      rx[j] = rs[0][c];
      ry[j] = rs[1][c];
      rz[j] = rs[2][c];
      rp[j] = rs[3][c];
    }
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      float tb = CUDART_INF_F;
      int tj = -1;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const float dot = dot3<DIM>(qx[i], qy[i], qz[i], rx[j], ry[j], rz[j]);
        const float d = __fsub_rn(__fadd_rn(q2[i], rp[j]), __fmul_rn(2.0f, dot));
        if (d < tb) {
          tb = d;
          tj = (int)(t0 + tx + 16 * j);
        }
      }
      // the row's min over the tile, across its 16 threads
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, tb, off, 16);
        const int oj = __shfl_xor_sync(0xffffffffu, tj, off, 16);
        if (before(od, oj, tb, tj)) {
          tb = od;
          tj = oj;
        }
      }
      if (tb < best[i]) {
        best[i] = tb;
        besti[i] = tj;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int64_t r = row0 + ty + 16 * i;
      if (r < n) {
        const float d = fmaxf(best[i], 0.0f);
        const bool qv = qmask[r] != 0;
        out_d[r] = qv ? d : CUDART_INF_F;
        out_i[r] = (qv && isfinite(d)) ? besti[i] : -1;
      }
    }
  }
}

}  // namespace

extern "C" {

// T1's rows per chunk must be a multiple of the stage tile, splits * chunk
// >= m.
int pm_tile_rows() { return kTile; }

// q [n, dim], qmask [n] bytes, ref [m, dim], rmask [m] bytes; part_d and
// part_i hold splits * n entries; out_d, out_i [n].
int pm_nn1_chunked(const float* q, const uint8_t* qmask, int n,
                   const float* ref, const uint8_t* rmask, int m, int dim,
                   int splits, int chunk, float* part_d, int* part_i,
                   float* out_d, int* out_i, void* stream) {
  if (n == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((n + kBlock - 1) / kBlock, splits);
  nn1_chunked_partial<<<grid, kBlock, 0, st>>>(q, n, ref, rmask, m, dim,
                                               chunk, part_d, part_i);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  nn1_chunked_combine<<<(n + 255) / 256, 256, 0, st>>>(
      part_d, part_i, n, splits, qmask, out_d, out_i);
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
      part_d, part_i, n, splits, qmask, out_d, out_i);
  return cudaGetLastError();
}

int pm_nn1_mxu(const float* q, const uint8_t* qmask, int n, const float* ref,
               const uint8_t* rmask, int m, int dim, float* out_d, int* out_i,
               void* stream) {
  if (n == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((n + kT3 - 1) / kT3);
  cudaStream_t st = (cudaStream_t)stream;
  if (dim == 3)
    nn1_mxu<3><<<blocks, kBlock, 0, st>>>(q, qmask, n, ref, rmask, m, out_d,
                                          out_i);
  else if (dim == 2)
    nn1_mxu<2><<<blocks, kBlock, 0, st>>>(q, qmask, n, ref, rmask, m, out_d,
                                          out_i);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

const char* pm_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
