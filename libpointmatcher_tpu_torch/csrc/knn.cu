// Dense exact k-NN kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by libpointmatcher_tpu_torch/ops/knn_cuda.py.
//
// They replace the TPU kernels of libpointmatcher_tpu/ops/knn_pallas.py:
//   K1  knn1_sweep         <- _nn1_kernel      (knn_pallas.py:32, knn1_pallas)
//   K9  knn1_mxu_partial   <- _nn1_mxu_kernel  (knn_pallas.py:93, knn1_pallas_mxu)
//   K5  knnk_sweep<K>      <- _nnk_kernel      (knn_pallas.py:123, knnk_pallas)
//
// What bounds them: at d = 3 each (query, reference) pair costs about ten
// fp32 operations and the inputs are a few hundred kilobytes, so the work is
// bound by the fp32 issue rate, not by memory. The exact difference form may
// not fuse into FMAs, so K1 and K5 issue at least 8 operations a pair; K9's
// expansion form 5 and its fold 1; each design keeps every other
// instruction off the pair. The reference rows are split into contiguous
// chunks over gridDim.y so that a few thousand queries still give every SM
// several blocks; a second small kernel merges the chunks in chunk order.
// Independent (query set, reference) pairs of one size, as pair-parallel
// one-shot registration stacks them, run in one launch with the pair on
// gridDim.z, each pair's rows at its own offset; one pair is the
// single-reference search.
//
// K1 and K5: 128 threads a block, K1 two queries a thread, K5 one (with
// two, the card needs twice the chunks to fill, and each chunk restarts the
// lists: at k = 5 and 10 one query a thread was 6% and 27% faster on an
// H100). A chunk is staged through shared memory kStage rows at a time as
// three float arrays, x + pen, y and z (pen 0 at valid rows, +inf at masked
// ones and past the chunk's end), so one 16-byte load gives four rows of
// one coordinate, to both of K1's queries. The next stage is loaded into
// registers while the current one is swept and stored into the other of
// two buffers after it, with one barrier a stage. Rows are swept in groups
// of kGroup: each query folds the group's d2 with fminf (one instruction a
// pair). K1 keeps (best, best group) with a strict '<' once a group and,
// after its chunk, recomputes its best group's rows from device memory to
// take the first row whose d2 equals the best. K5 keeps a sorted list of k
// slots (one instance per k) and compares the group's minimum with its last
// slot, the k-th distance, once a group; only then does it insert the
// group's rows in index order. A block, or a warp, whose queries are all
// masked does not sweep.
//
// K9: 128 threads a block, four queries a thread, a warp's 128 queries one
// contiguous run. A chunk is staged kK9Stage rows at a time as float4 (x,
// y, z, r2pen), r2pen +inf at a masked row and (0, 0, 0, +inf) past the
// chunk's end, through two buffers as K1 stages (one barrier a stage); one
// 16-byte broadcast load gives a row to all four queries. Rows are swept in
// groups of kK9Group = 16: each query folds the group's d2 with fminf (one
// instruction a pair beside the five of its d2) and keeps (best, best
// group) with a strict '<' once a group; the partial kernel writes the
// unclamped (best, best group's first row) of each chunk. The merge takes
// the chunks in order with a strict '<', recomputes the winning group's
// rows and takes the first whose d2 equals the minimum, then clamps at 0.
// A block, or a warp, whose queries are all masked does not sweep. The
// chunks are whole groups, cut by ops/knn_cuda.py k9_split so that the
// (query block, chunk) units fill whole waves of kK9MinBlocks blocks on
// each SM (the launch bounds ask for them; the wrapper checks the card
// gives them).
//
// Exactness: K1 and K5 form d2 = (dx*dx + dy*dy) + dz*dz with dx taken
// against x + pen, every step an explicitly rounded intrinsic (no FMA
// contraction). For pen 0 that is ((pen + dx*dx) + dy*dy) + dz*dz, the
// order of the plain torch version in ops/knn.py, bit for bit (0 + dx*dx
// being dx*dx); for pen = +inf both are +inf (or NaN where a coordinate is
// infinite), which no comparison takes. K1's best group is the first group
// that holds the chunk's minimum, and its first row equal to the minimum is
// the lowest index that holds it: what a strict '<' over the rows in
// increasing order gives, ties included; fminf ignores NaN as '<' does.
// K5 inserts with a strict '<' in increasing row order, so equal distances
// keep the lower index ahead; a group it skips holds no row below its k-th
// distance. The chunks merge in chunk order with a strict '<'. K9 forms
// dot = fma(qz, rz, fma(qy, ry, qx*rx)) and d2 = fma(-2, dot, q2 + r2pen),
// q2 and r2 as (x*x + y*y) + z*z, every step an explicitly rounded
// intrinsic (fp32 FMAs, no tensor cores: TF32 would break its error bound),
// so a recomputation gives the same bits; it is clamped at 0 only after the
// chunks merge, as knn1_pallas_mxu clamps after the minimum (a clamp per
// chunk would tie two negative minima at 0 and let the earlier chunk win).
// Its best group is the first that holds the chunk's minimum, the winning
// chunk the first that holds the overall one, and the first row of that
// group whose d2 equals it the lowest index holding it; fminf ignores NaN
// as '<' does, and masked rows and padding (r2pen = +inf) are never taken.
// So K9 returns the first row of the least unclamped d2, whatever the
// split: its first design's (d2, id) bit for bit. Outputs: (d2, id),
// (+inf, -1) for a masked query or for a slot with no valid reference.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;        // K1 queries per block, two a thread
constexpr int kTile = 1024;        // K1/K5 chunk granularity (rows)
constexpr int kThreads = 128;      // K1/K5 threads a block
constexpr int kStage = 512;        // K1/K5 rows per shared stage (2 x 6 KB)
constexpr int kGroup = 8;          // K1/K5 rows per group
constexpr int kRowsPerThread = kStage / kThreads;
static_assert(kTile % kStage == 0, "a chunk is whole stages");
static_assert(kStage % kGroup == 0 && kGroup % 4 == 0, "whole float4 groups");
constexpr int kK9Threads = 128;    // K9 threads a block
constexpr int kK9QPer = 4;         // K9 queries a thread
constexpr int kK9Group = 16;       // K9 rows a group (one fminf fold); its chunk granularity
constexpr int kK9Stage = 512;      // K9 rows per shared stage (2 x 8 KB)
constexpr int kK9MinBlocks = 4;    // K9 blocks an SM (launch bounds: 128 registers)
constexpr int kK9BlockQueries = kK9Threads * kK9QPer;
constexpr int kK9RowsPerThread = kK9Stage / kK9Threads;
static_assert(kK9Stage % kK9Group == 0 && kK9Stage % kK9Threads == 0,
              "a stage is whole groups, the same rows for every thread");

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

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

// ------------------------------------------------------------------ K1, K5

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

__device__ __forceinline__ float d2_folded(float qx, float qy, float qz,
                                           float x, float y, float z) {
  return __fadd_rn(__fadd_rn(sq(__fsub_rn(qx, x)), sq(__fsub_rn(qy, y))),
                   sq(__fsub_rn(qz, z)));
}

// This thread's rows of the stage at t0 (rows t0 + r * kThreads + tid),
// rows at or past j1 as (+inf, 0, 0).
struct Stage {
  float x[kRowsPerThread], y[kRowsPerThread], z[kRowsPerThread];

  __device__ __forceinline__ void load(const float* __restrict__ ref,
                                       const uint8_t* __restrict__ rmask,
                                       int64_t t0, int64_t j1, int dim) {
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int64_t j = t0 + r * kThreads + threadIdx.x;
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
    for (int r = 0; r < kRowsPerThread; ++r) {
      sx[r * kThreads + threadIdx.x] = x[r];
      sy[r * kThreads + threadIdx.x] = y[r];
      sz[r * kThreads + threadIdx.x] = z[r];
    }
  }
};

// Rows g * kGroup .. of a stage, one 16-byte load per four rows.
struct Group {
  float x[kGroup], y[kGroup], z[kGroup];

  __device__ __forceinline__ Group(const float* sx, const float* sy,
                                   const float* sz, int g) {
#pragma unroll
    for (int v = 0; v < kGroup / 4; ++v) {
      const float4 a = reinterpret_cast<const float4*>(sx)[g * (kGroup / 4) + v];
      const float4 b = reinterpret_cast<const float4*>(sy)[g * (kGroup / 4) + v];
      const float4 c = reinterpret_cast<const float4*>(sz)[g * (kGroup / 4) + v];
      x[4 * v] = a.x, x[4 * v + 1] = a.y, x[4 * v + 2] = a.z, x[4 * v + 3] = a.w;
      y[4 * v] = b.x, y[4 * v + 1] = b.y, y[4 * v + 2] = b.z, y[4 * v + 3] = b.w;
      z[4 * v] = c.x, z[4 * v + 1] = c.y, z[4 * v + 2] = c.z, z[4 * v + 3] = c.w;
    }
  }

  __device__ __forceinline__ void d2(float qx, float qy, float qz,
                                     float (&d)[kGroup]) const {
#pragma unroll
    for (int r = 0; r < kGroup; ++r) d[r] = d2_folded(qx, qy, qz, x[r], y[r], z[r]);
  }
};

// The group's minimum, NaN ignored (exact: no rounding).
__device__ __forceinline__ float group_min(const float (&d)[kGroup]) {
  float t[kGroup];
#pragma unroll
  for (int r = 0; r < kGroup; ++r) t[r] = d[r];
#pragma unroll
  for (int w = kGroup / 2; w >= 1; w /= 2) {
#pragma unroll
    for (int r = 0; r < w; ++r) t[r] = fminf(t[r], t[r + w]);
  }
  return t[0];
}

// The stage loop shared by K1 and K5: stages [j0, j1) through the two
// buffers and calls sweep(stage's x, y, z, first row, rows) on each stage
// unless `live` is false. Every thread of the block calls it. `sweep` holds
// the thread's queries and results; its operator() is force-inlined, so
// they stay in registers.
template <typename Sweep>
__device__ __forceinline__ void for_each_stage(
    const float* __restrict__ ref, const uint8_t* __restrict__ rmask,
    int64_t j0, int64_t j1, int dim, bool live, float (*s_x)[kStage],
    float (*s_y)[kStage], float (*s_z)[kStage], Sweep& sweep) {
  const int stages = j1 > j0 ? (int)((j1 - j0 + kStage - 1) / kStage) : 0;
  Stage st;
  if (stages > 0) {
    st.load(ref, rmask, j0, j1, dim);
    st.store(s_x[0], s_y[0], s_z[0]);
  }
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    const int64_t t0 = j0 + (int64_t)s * kStage;
    // the next stage's loads are in flight while this one is swept
    const bool more = s + 1 < stages;
    if (more) st.load(ref, rmask, t0 + kStage, j1, dim);
    if (live) sweep(s_x[s & 1], s_y[s & 1], s_z[s & 1], (int)t0,
                    (int)min64(kStage, j1 - t0));
    // the other buffer was last read before the previous barrier
    if (more) st.store(s_x[(s + 1) & 1], s_y[(s + 1) & 1], s_z[(s + 1) & 1]);
    __syncthreads();
  }
}

// K1: the first row of group `grp` whose d2 equals `best` (-1: none).
__device__ __forceinline__ int first_row(float qx, float qy, float qz,
                                         float best, int grp,
                                         const float* __restrict__ ref,
                                         const uint8_t* __restrict__ rmask,
                                         int64_t j1, int dim) {
  if (grp < 0) return -1;
  for (int r = 0; r < kGroup && grp + r < j1; ++r) {
    float x, y, z;
    folded_row(ref, rmask, grp + r, dim, x, y, z);
    if (d2_folded(qx, qy, qz, x, y, z) == best) return grp + r;
  }
  return -1;
}

// K1's two queries: running (group minimum, its group's first row).
struct Nearest {
  float ax, ay, az, bx, by, bz;
  float best_a, best_b;
  int grp_a, grp_b;

  __device__ __forceinline__ void operator()(const float* sx, const float* sy,
                                             const float* sz, int t0,
                                             int rows) {
    const int groups = (rows + kGroup - 1) / kGroup;
#pragma unroll 2
    for (int g = 0; g < groups; ++g) {
      const Group r(sx, sy, sz, g);
      float da[kGroup], db[kGroup];
      r.d2(ax, ay, az, da);
      r.d2(bx, by, bz, db);
      const float ma = group_min(da), mb = group_min(db);
      const int gid = t0 + g * kGroup;
      if (ma < best_a) {
        best_a = ma;
        grp_a = gid;
      }
      if (mb < best_b) {
        best_b = mb;
        grp_b = gid;
      }
    }
  }
};

// K1: (min, argmin) of 256 queries over one reference chunk per blockIdx.y.
__global__ void __launch_bounds__(kThreads)
knn1_sweep(const float* __restrict__ q, const uint8_t* __restrict__ qmask,
           int n, const float* __restrict__ ref,
           const uint8_t* __restrict__ rmask, int m, int dim, int chunk,
           float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ __align__(16) float s_x[2][kStage];
  __shared__ __align__(16) float s_y[2][kStage];
  __shared__ __align__(16) float s_z[2][kStage];
  const int64_t pair = blockIdx.z;
  q += pair * n * dim;
  qmask += pair * n;
  ref += pair * m * dim;
  rmask += pair * m;
  part_d += pair * gridDim.y * n;
  part_i += pair * gridDim.y * n;
  const int64_t qa = (int64_t)blockIdx.x * (2 * kThreads) + threadIdx.x;
  const int64_t qb = qa + kThreads;
  const bool live = (qa < n && qmask[qa] != 0) || (qb < n && qmask[qb] != 0);
  const int64_t j0 = (int64_t)blockIdx.y * chunk;
  const int64_t j1 = min64(m, j0 + chunk);
  Nearest nn;
  nn.best_a = nn.best_b = CUDART_INF_F;
  nn.grp_a = nn.grp_b = -1;
  load_query(q, qa, n, dim, nn.ax, nn.ay, nn.az);
  load_query(q, qb, n, dim, nn.bx, nn.by, nn.bz);
  if (__syncthreads_or(live))
    for_each_stage(ref, rmask, j0, j1, dim, __any_sync(0xffffffffu, live),
                   s_x, s_y, s_z, nn);
  const int64_t out = (int64_t)blockIdx.y * n;
  if (qa < n) {
    part_d[out + qa] = nn.best_a;
    part_i[out + qa] = first_row(nn.ax, nn.ay, nn.az, nn.best_a, nn.grp_a,
                                 ref, rmask, j1, dim);
  }
  if (qb < n) {
    part_d[out + qb] = nn.best_b;
    part_i[out + qb] = first_row(nn.bx, nn.by, nn.bz, nn.best_b, nn.grp_b,
                                 ref, rmask, j1, dim);
  }
}

// Insert (d, id) into the ascending register list (bd, bi) of length K.
// Equal distances keep their arrival order, so with ids arriving in
// increasing order the lower id stays first.
template <int K>
__device__ __forceinline__ void insert_sorted(float (&bd)[K], int (&bi)[K],
                                              float d, int id) {
  bool moved = false;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const bool sw = moved || d < bd[s];
    const float td = bd[s];
    const int ti = bi[s];
    bd[s] = sw ? d : td;
    bi[s] = sw ? id : ti;
    d = sw ? td : d;
    id = sw ? ti : id;
    moved = sw;
  }
}

// K5's query and its sorted list of K = k slots; the last slot is the
// threshold.
template <int K>
struct TopK {
  float qx, qy, qz;
  float bd[K];
  int bi[K];

  __device__ __forceinline__ void operator()(const float* sx, const float* sy,
                                             const float* sz, int t0,
                                             int rows) {
    const int groups = (rows + kGroup - 1) / kGroup;
#pragma unroll 1
    for (int g = 0; g < groups; ++g) {
      float d[kGroup];
      Group(sx, sy, sz, g).d2(qx, qy, qz, d);
      if (group_min(d) < bd[K - 1]) {  // rare once the list is full
        const int gid = t0 + g * kGroup;
#pragma unroll
        for (int e = 0; e < kGroup; ++e)
          if (d[e] < bd[K - 1]) insert_sorted<K>(bd, bi, d[e], gid + e);
      }
    }
  }
};

// K5: sorted top-K of kThreads queries over one reference chunk per
// blockIdx.y. No launch bounds: under __launch_bounds__(kThreads) ptxas
// spilled a few bytes at some K to stop at 64, 72, 80 or 128 registers;
// without them it spills at no K.
template <int K>
__global__ void
knnk_sweep(const float* __restrict__ q, const uint8_t* __restrict__ qmask,
           int n, const float* __restrict__ ref,
           const uint8_t* __restrict__ rmask, int m, int dim, int chunk,
           float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ __align__(16) float s_x[2][kStage];
  __shared__ __align__(16) float s_y[2][kStage];
  __shared__ __align__(16) float s_z[2][kStage];
  const int64_t pair = blockIdx.z;
  q += pair * n * dim;
  qmask += pair * n;
  ref += pair * m * dim;
  rmask += pair * m;
  part_d += pair * gridDim.y * n * K;
  part_i += pair * gridDim.y * n * K;
  const int64_t j0 = (int64_t)blockIdx.y * chunk;
  const int64_t j1 = min64(m, j0 + chunk);
  const int64_t qi = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = qi < n && qmask[qi] != 0;
  TopK<K> top;
  load_query(q, qi, n, dim, top.qx, top.qy, top.qz);
#pragma unroll
  for (int s = 0; s < K; ++s) {
    top.bd[s] = CUDART_INF_F;
    top.bi[s] = -1;
  }
  if (__syncthreads_or(live))
    for_each_stage(ref, rmask, j0, j1, dim, __any_sync(0xffffffffu, live),
                   s_x, s_y, s_z, top);
  if (qi < n) {
    const int64_t base = ((int64_t)blockIdx.y * n + qi) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      part_d[base + s] = top.bd[s];
      part_i[base + s] = top.bi[s];
    }
  }
}

// --------------------------------------------------------------------- K9

// Reference row j as K9 stages it: (x, y, z, r2pen), r2pen = (x*x + y*y) +
// z*z, or +inf at a masked row.
__device__ __forceinline__ float4 stage_row_mxu(const float* __restrict__ ref,
                                                const uint8_t* __restrict__ rmask,
                                                int64_t j, int dim) {
  const float x = ref[j * dim];
  const float y = ref[j * dim + 1];
  const float z = dim == 3 ? ref[j * dim + 2] : 0.0f;
  const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                             __fmul_rn(z, z));
  return make_float4(x, y, z, rmask[j] != 0 ? r2 : CUDART_INF_F);
}

__device__ __forceinline__ float mxu_q2(float qx, float qy, float qz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)),
                   __fmul_rn(qz, qz));
}

// K9's d2 of one pair: fma(-2, dot, q2 + r2pen), dot = fma(qz, rz, fma(qy,
// ry, qx * rx)); five fp32 instructions.
__device__ __forceinline__ float mxu_d2(float qx, float qy, float qz, float q2,
                                        float4 r) {
  const float dot = __fmaf_rn(qz, r.z, __fmaf_rn(qy, r.y, __fmul_rn(qx, r.x)));
  return __fmaf_rn(-2.0f, dot, __fadd_rn(q2, r.w));
}

// This thread's rows of the stage at t0 (rows t0 + r * kK9Threads + tid),
// rows at or past j1 as (0, 0, 0, +inf).
struct K9Stage {
  float4 row[kK9RowsPerThread];

  __device__ __forceinline__ void load(const float* __restrict__ ref,
                                       const uint8_t* __restrict__ rmask,
                                       int64_t t0, int64_t j1, int dim) {
#pragma unroll
    for (int r = 0; r < kK9RowsPerThread; ++r) {
      const int64_t j = t0 + r * kK9Threads + threadIdx.x;
      row[r] = j < j1 ? stage_row_mxu(ref, rmask, j, dim)
                      : make_float4(0.0f, 0.0f, 0.0f, CUDART_INF_F);
    }
  }

  __device__ __forceinline__ void store(float4* s) const {
#pragma unroll
    for (int r = 0; r < kK9RowsPerThread; ++r)
      s[r * kK9Threads + threadIdx.x] = row[r];
  }
};

// The thread's kK9QPer queries: running (group minimum, its group's first
// row). Each staged row is read from shared memory once (one 16-byte
// broadcast) for all of them; each query folds a group's d2 with fminf.
struct K9Nearest {
  float qx[kK9QPer], qy[kK9QPer], qz[kK9QPer], q2[kK9QPer], best[kK9QPer];
  int grp[kK9QPer];

  __device__ __forceinline__ void sweep(const float4* s, int t0, int rows) {
    const int groups = (rows + kK9Group - 1) / kK9Group;
#pragma unroll 1
    for (int g = 0; g < groups; ++g) {
      float gm[kK9QPer];
#pragma unroll
      for (int e = 0; e < kK9Group; ++e) {
        const float4 r = s[g * kK9Group + e];
#pragma unroll
        for (int k = 0; k < kK9QPer; ++k) {
          const float d = mxu_d2(qx[k], qy[k], qz[k], q2[k], r);
          gm[k] = e == 0 ? d : fminf(gm[k], d);
        }
      }
      const int gid = t0 + g * kK9Group;
#pragma unroll
      for (int k = 0; k < kK9QPer; ++k) {
        if (gm[k] < best[k]) {
          best[k] = gm[k];
          grp[k] = gid;
        }
      }
    }
  }
};

// K9: per query of the block, (min d2, first row of its first group holding
// it) over one reference chunk per blockIdx.y, unclamped. Query k of lane l
// in warp w is base + w * 32 * kK9QPer + 32 * k + l, so a warp's queries are
// one contiguous run. The chunk is staged kK9Stage rows at a time through
// two buffers: the next stage's rows are loaded into registers while this
// one is swept and stored after it, one barrier a stage. A block whose
// queries are all masked does not sweep; a warp whose queries are all masked
// joins the barriers only.
__global__ void __launch_bounds__(kK9Threads, kK9MinBlocks)
knn1_mxu_sweep(const float* __restrict__ q, const uint8_t* __restrict__ qmask,
               int n, const float* __restrict__ ref,
               const uint8_t* __restrict__ rmask, int m, int dim, int chunk,
               float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ __align__(16) float4 s_row[2][kK9Stage];
  const int64_t pair = blockIdx.z;
  q += pair * n * dim;
  qmask += pair * n;
  ref += pair * m * dim;
  rmask += pair * m;
  part_d += pair * gridDim.y * n;
  part_i += pair * gridDim.y * n;
  const int64_t base = (int64_t)blockIdx.x * kK9BlockQueries +
                       (threadIdx.x >> 5) * (32 * kK9QPer) + (threadIdx.x & 31);
  K9Nearest nn;
  bool live = false;
#pragma unroll
  for (int k = 0; k < kK9QPer; ++k) {
    const int64_t qi = base + 32 * k;
    load_query(q, qi, n, dim, nn.qx[k], nn.qy[k], nn.qz[k]);
    nn.q2[k] = mxu_q2(nn.qx[k], nn.qy[k], nn.qz[k]);
    nn.best[k] = CUDART_INF_F;
    nn.grp[k] = -1;
    live |= qi < n && qmask[qi] != 0;
  }
  const int64_t j0 = (int64_t)blockIdx.y * chunk;
  const int64_t j1 = min64(m, j0 + chunk);
  const int stages = j1 > j0 ? (int)((j1 - j0 + kK9Stage - 1) / kK9Stage) : 0;
  if (__syncthreads_or(live) && stages > 0) {
    const bool warp_live = __any_sync(0xffffffffu, live);
    K9Stage st;
    st.load(ref, rmask, j0, j1, dim);
    st.store(s_row[0]);
    __syncthreads();
    for (int s = 0; s < stages; ++s) {
      const int64_t t0 = j0 + (int64_t)s * kK9Stage;
      // the next stage's loads are in flight while this one is swept
      const bool more = s + 1 < stages;
      if (more) st.load(ref, rmask, t0 + kK9Stage, j1, dim);
      if (warp_live) nn.sweep(s_row[s & 1], (int)t0, (int)min64(kK9Stage, j1 - t0));
      // the other buffer was last read before the previous barrier
      if (more) st.store(s_row[(s + 1) & 1]);
      __syncthreads();
    }
  }
  const int64_t out = (int64_t)blockIdx.y * n;
#pragma unroll
  for (int k = 0; k < kK9QPer; ++k) {
    const int64_t qi = base + 32 * k;
    if (qi < n) {
      part_d[out + qi] = nn.best[k];
      part_i[out + qi] = nn.grp[k];
    }
  }
}

// K9's merge of pairs * n queries (query qi of pair p is row p * n + qi):
// the chunks in increasing order with a strict '<', then the first row of
// the winning chunk's best group whose d2, recomputed by the same
// functions, equals the minimum; then the clamp at 0.
__global__ void knn1_mxu_merge(const float* __restrict__ part_d,
                               const int* __restrict__ part_i, int n, int pairs,
                               int splits, const float* __restrict__ q,
                               const uint8_t* __restrict__ qmask,
                               const float* __restrict__ ref,
                               const uint8_t* __restrict__ rmask, int m, int dim,
                               float* __restrict__ out_d, int* __restrict__ out_i) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= (int64_t)pairs * n) return;
  const int64_t pair = row / n;
  const int64_t qi = row - pair * n;
  part_d += pair * splits * n;
  part_i += pair * splits * n;
  float best = CUDART_INF_F;
  int grp = -1;
  for (int s = 0; s < splits; ++s) {
    const float d = part_d[(int64_t)s * n + qi];
    if (d < best) {
      best = d;
      grp = part_i[(int64_t)s * n + qi];
    }
  }
  int id = -1;
  if (grp >= 0) {
    float qx, qy, qz;
    load_query(q + pair * n * dim, qi, n, dim, qx, qy, qz);
    const float q2 = mxu_q2(qx, qy, qz);
    const int last = (int)min64(m, (int64_t)grp + kK9Group);
    for (int j = grp; j < last; ++j) {
      const float4 r = stage_row_mxu(ref + pair * m * dim, rmask + pair * m, j, dim);
      if (mxu_d2(qx, qy, qz, q2, r) == best) {
        id = j;
        break;
      }
    }
  }
  best = fmaxf(best, 0.0f);
  const bool qv = qmask[row] != 0;
  out_d[row] = qv ? best : CUDART_INF_F;
  out_i[row] = (qv && isfinite(best)) ? id : -1;
}

// ----------------------------------------------------------------- merges

// K1's merge of pairs * n queries: the chunks in increasing order with a
// strict '<'; query qi of pair p is row p * n + qi of qmask and of the
// outputs.
__global__ void knn1_combine(const float* __restrict__ part_d,
                             const int* __restrict__ part_i, int n, int pairs,
                             int splits, const uint8_t* __restrict__ qmask,
                             float* __restrict__ out_d,
                             int* __restrict__ out_i) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= (int64_t)pairs * n) return;
  const int64_t pair = row / n;
  const int64_t qi = row - pair * n;
  part_d += pair * splits * n;
  part_i += pair * splits * n;
  float best = CUDART_INF_F;
  int besti = -1;
  for (int s = 0; s < splits; ++s) {
    const float d = part_d[(int64_t)s * n + qi];
    if (d < best) {
      best = d;
      besti = part_i[(int64_t)s * n + qi];
    }
  }
  const bool qv = qmask[row] != 0;
  out_d[row] = qv ? best : CUDART_INF_F;
  out_i[row] = (qv && isfinite(best)) ? besti : -1;
}

template <int K>
__global__ void knnk_combine(const float* __restrict__ part_d,
                             const int* __restrict__ part_i, int n, int pairs,
                             int splits, const uint8_t* __restrict__ qmask,
                             int k, float* __restrict__ out_d,
                             int* __restrict__ out_i) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= (int64_t)pairs * n) return;
  const int64_t pair = row / n;
  const int64_t qi = row - pair * n;
  part_d += pair * splits * n * K;
  part_i += pair * splits * n * K;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = -1;
  }
  for (int sp = 0; sp < splits; ++sp) {
    const int64_t base = ((int64_t)sp * n + qi) * K;
    for (int s = 0; s < K; ++s) {
      const float d = part_d[base + s];
      if (!(d < bd[K - 1])) break;  // each chunk's list is ascending
      insert_sorted<K>(bd, bi, d, part_i[base + s]);
    }
  }
  const bool qv = qmask[row] != 0;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s < k) {
      out_d[row * k + s] = qv ? bd[s] : CUDART_INF_F;
      out_i[row * k + s] = (qv && isfinite(bd[s])) ? bi[s] : -1;
    }
  }
}

template <int K>
cudaError_t launch_knnk(const float* q, const uint8_t* qmask, int n,
                        const float* ref, const uint8_t* rmask, int m,
                        int pairs, int dim, int k, int splits, int chunk,
                        float* part_d, int* part_i, float* out_d, int* out_i,
                        cudaStream_t st) {
  const dim3 grid((n + kThreads - 1) / kThreads, splits, pairs);
  knnk_sweep<K><<<grid, kThreads, 0, st>>>(
      q, qmask, n, ref, rmask, m, dim, chunk, part_d, part_i);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int64_t rows = (int64_t)pairs * n;
  knnk_combine<K><<<(unsigned)((rows + 127) / 128), 128, 0, st>>>(
      part_d, part_i, n, pairs, splits, qmask, k, out_d, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1's and K5's rows per chunk must be a multiple of this, splits * chunk
// >= m.
int pm_tile_rows() { return kTile; }
int pm_group_rows() { return kGroup; }

// Queries per block: K1 (kk = 0), K5 (a list of kk slots).
int pm_block_queries(int kk) { return kk == 0 ? kBlock : kThreads; }

// `pairs` (query set, reference) pairs in one launch: pair p's queries are
// rows p * n .. p * n + n - 1 of q and qmask, its reference rows p * m ..
// of ref and rmask, its results rows p * n .. of the outputs; part_d and
// part_i hold pairs * splits * n entries. One pair is the single-reference
// search.
int pm_knn1(const float* q, const uint8_t* qmask, int n, const float* ref,
            const uint8_t* rmask, int m, int pairs, int dim, int splits,
            int chunk, float* part_d, int* part_i, float* out_d, int* out_i,
            void* stream) {
  if (n == 0 || pairs == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((n + kBlock - 1) / kBlock, splits, pairs);
  knn1_sweep<<<grid, kThreads, 0, st>>>(q, qmask, n, ref, rmask, m, dim, chunk,
                                        part_d, part_i);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int64_t rows = (int64_t)pairs * n;
  knn1_combine<<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
      part_d, part_i, n, pairs, splits, qmask, out_d, out_i);
  return cudaGetLastError();
}

// K9's queries a block, rows a group (its chunks' granularity), the blocks
// an SM its launch bounds ask for, and the blocks an SM the card gives it.
int pm_k9_block_queries() { return kK9BlockQueries; }
int pm_k9_group_rows() { return kK9Group; }
int pm_k9_min_blocks() { return kK9MinBlocks; }
int pm_k9_occupancy() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, knn1_mxu_sweep,
                                                    kK9Threads, 0) != cudaSuccess)
    return -1;
  return blocks;
}

// K9, pairs and outputs as for pm_knn1; chunk a multiple of
// pm_k9_group_rows(), splits * chunk >= m.
int pm_knn1_mxu(const float* q, const uint8_t* qmask, int n, const float* ref,
                const uint8_t* rmask, int m, int pairs, int dim, int splits,
                int chunk, float* part_d, int* part_i, float* out_d, int* out_i,
                void* stream) {
  if (n == 0 || pairs == 0) return cudaSuccess;
  if (chunk % kK9Group != 0) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((n + kK9BlockQueries - 1) / kK9BlockQueries, splits, pairs);
  knn1_mxu_sweep<<<grid, kK9Threads, 0, st>>>(q, qmask, n, ref, rmask, m, dim,
                                              chunk, part_d, part_i);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int64_t rows = (int64_t)pairs * n;
  knn1_mxu_merge<<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
      part_d, part_i, n, pairs, splits, q, qmask, ref, rmask, m, dim, out_d,
      out_i);
  return cudaGetLastError();
}

// kk is the list length, max(2, k); pairs as for pm_knn1, part_d and
// part_i hold pairs * splits * n * kk.
int pm_knnk(const float* q, const uint8_t* qmask, int n, const float* ref,
            const uint8_t* rmask, int m, int pairs, int dim, int k, int kk,
            int splits, int chunk, float* part_d, int* part_i, float* out_d,
            int* out_i, void* stream) {
  if (n == 0 || pairs == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kk) {
#define PM_KNNK_CASE(K)                                                        \
  case K:                                                                      \
    return launch_knnk<K>(q, qmask, n, ref, rmask, m, pairs, dim, k, splits,  \
                          chunk, part_d, part_i, out_d, out_i, st);
    PM_KNNK_CASE(2) PM_KNNK_CASE(3) PM_KNNK_CASE(4) PM_KNNK_CASE(5)
    PM_KNNK_CASE(6) PM_KNNK_CASE(7) PM_KNNK_CASE(8) PM_KNNK_CASE(9)
    PM_KNNK_CASE(10) PM_KNNK_CASE(11) PM_KNNK_CASE(12) PM_KNNK_CASE(13)
    PM_KNNK_CASE(14) PM_KNNK_CASE(15) PM_KNNK_CASE(16) PM_KNNK_CASE(17)
    PM_KNNK_CASE(18) PM_KNNK_CASE(19) PM_KNNK_CASE(20) PM_KNNK_CASE(21)
    PM_KNNK_CASE(22) PM_KNNK_CASE(23) PM_KNNK_CASE(24) PM_KNNK_CASE(25)
    PM_KNNK_CASE(26) PM_KNNK_CASE(27) PM_KNNK_CASE(28) PM_KNNK_CASE(29)
    PM_KNNK_CASE(30) PM_KNNK_CASE(31) PM_KNNK_CASE(32)
#undef PM_KNNK_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

const char* pm_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
