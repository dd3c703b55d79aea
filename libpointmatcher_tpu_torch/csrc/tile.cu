// Tile-sweep k-NN kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by libpointmatcher_tpu_torch/ops/tile_cuda.py.
//
// They replace the TPU kernels of libpointmatcher_tpu/ops/tilesweep.py:
//   K7  tile_nn1      <- _tile_nn1_kernel  (tilesweep.py:460, _tile_sweep_pallas)
//   K8  tile_nnk<K>   <- _tile_nnk_kernel  (tilesweep.py:737, _tile_sweep_pallas_k)
//
// Inputs, one entry per (virtual) tile t of T:
//   q    [T, TQ, 8]  the tile's queries, coordinates in columns 0..dim-1;
//   cand [T, 8, M]   the tile's candidate table, M a multiple of 128: rows
//                    0..dim-1 the coordinates, row 6 the pad penalty (0 for a
//                    real candidate, +inf for padding), row 7 the candidate's
//                    original row id as a float (exact below 2^24).
// Tiles of several scans are just more tiles: the serving drivers flatten
// [scans, tiles] into one axis, so one launch serves a whole batch or queue.
//
// Design: one block per (tile, slice of up to 256 of its queries), one thread
// per query. The tile's candidates are staged through shared memory in steps
// of kStage columns, each as a float4 (x, y, z, pen) and its id, and read by
// all threads of the block at once (broadcast, no bank conflicts). K7 keeps
// its running (min, id) in registers, K8 its sorted top-K list (K a template
// parameter, so the list never spills to local memory; k is served by the
// smallest instantiated K >= k and the list cut to k).
//
// What bounds them: a block reads 20 bytes per candidate column (x, y, z,
// pen, id; dim + 2 rows) and does 9 fp32 operations per (query, candidate)
// pair. With all 64 queries of a serving tile valid that is 64 * 9 / 20 =
// 29 operations per byte, above an H100's 67 TFLOP/s over 3.35 TB/s = 20, so
// a full tile is bound by its operations; tiles whose queries or candidates
// are mostly padding fall below and are bound by their bytes. Which bound a
// launch meets depends on its data: chip_smoke.py computes both from the
// valid queries and candidates of the recorded main-path launch. The inner
// loop keeps every operand in registers or shared memory.
//
// Exactness: d2 = ((pen + dx*dx) + dy*dy) + dz*dz with explicitly rounded
// intrinsics (no FMA contraction), the order of the plain torch version in
// ops/tile_cuda.py, so both agree bit for bit. Candidates are visited in
// increasing position with a strict '<' (K7) or a strict-'<' insertion (K8),
// so among equal distances the lowest position wins. Outputs: K7 d2 [T, TQ],
// id [T, TQ]; K8 d2 [T, k, TQ], id [T, k, TQ] ascending along k; the id is
// -1 wherever d2 is not finite (no candidate, or an exhausted list).
//
// The ablations of tools/tile_kernel_micro.py, which measure what K7's id
// tracking and its schedule cost, are one min-only template (tile_min<TILES>)
// on K7's own table: per query the minimum d2 over its tile's candidates, no
// id read or kept, d2 formed as in K7, so both equal K7's d2 bit for bit.
//   T4  tile_min<8>  <- _min_only  (tile_kernel_micro.py:79, main.min_only)
//       eight tiles per block, candidates staged 2048 columns at a time,
//       each stage of each tile in turn (the Pallas grid step's schedule);
//   T5  tile_min<1>  <- _one       (tile_kernel_micro.py:131, main.one)
//       one tile per block, its whole candidate list staged in one pass
//       (dynamic shared memory, 16 bytes a column, so M <= 14528).
// They read 16 bytes per candidate column (x, y, z, pen) where K7 reads 20,
// and do K7's 9 operations per pair without its id select: bound by the fp32
// issue rate on full tiles, as K7.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;  // queries per block, one per thread
constexpr int kStage = 512;       // candidate columns per shared-memory stage
constexpr int kPenRow = 6;
constexpr int kCidRow = 7;
constexpr int kRows = 8;
constexpr int kMinStage = 2048;   // T4's candidate columns per stage
// T5's largest candidate list: 232,448 bytes of shared memory a block, at 16
// bytes a column
constexpr int kMinOneMax = 232448 / 16;

__device__ __forceinline__ float pair_d2(float qx, float qy, float qz,
                                         float4 r) {
  const float dx = __fsub_rn(qx, r.x);
  const float dy = __fsub_rn(qy, r.y);
  const float dz = __fsub_rn(qz, r.z);
  return __fadd_rn(__fadd_rn(__fadd_rn(r.w, __fmul_rn(dx, dx)),
                             __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Stage columns m0 .. m0 + cnt - 1 of one tile's table. For dim = 2 the z
// lane holds 0 on both sides, and adding 0 * 0 leaves d2 unchanged.
__device__ __forceinline__ void stage(const float* __restrict__ tab, int M,
                                      int dim, int m0, int cnt,
                                      float4* __restrict__ s_r,
                                      float* __restrict__ s_id) {
  for (int l = threadIdx.x; l < cnt; l += blockDim.x) {
    const int m = m0 + l;
    const float x = tab[m];
    const float y = tab[(int64_t)M + m];
    const float z = dim == 3 ? tab[2 * (int64_t)M + m] : 0.0f;
    s_r[l] = make_float4(x, y, z, tab[kPenRow * (int64_t)M + m]);
    s_id[l] = tab[kCidRow * (int64_t)M + m];
  }
}

__device__ __forceinline__ void load_query(const float* __restrict__ q,
                                           int64_t row, bool live, int dim,
                                           float& qx, float& qy, float& qz) {
  qx = qy = qz = 0.0f;
  if (live) {
    qx = q[row * kRows];
    qy = q[row * kRows + 1];
    if (dim == 3) qz = q[row * kRows + 2];
  }
}

// K7: per-tile 1-NN.
__global__ void __launch_bounds__(kMaxThreads)
tile_nn1(const float* __restrict__ q, const float* __restrict__ cand, int tq,
         int M, int dim, float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float4 s_r[kStage];
  __shared__ float s_id[kStage];
  const int64_t t = blockIdx.x;
  const int qi = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = qi < tq;
  const float* tab = cand + t * kRows * (int64_t)M;
  float qx, qy, qz;
  load_query(q, t * tq + qi, live, dim, qx, qy, qz);
  float best = CUDART_INF_F;
  float best_id = -1.0f;
  for (int m0 = 0; m0 < M; m0 += kStage) {
    const int cnt = M - m0 < kStage ? M - m0 : kStage;
    __syncthreads();
    stage(tab, M, dim, m0, cnt, s_r, s_id);
    __syncthreads();
#pragma unroll 8
    for (int l = 0; l < cnt; ++l) {
      const float d = pair_d2(qx, qy, qz, s_r[l]);
      if (d < best) {
        best = d;
        best_id = s_id[l];
      }
    }
  }
  if (live) {
    out_d[t * tq + qi] = best;
    out_i[t * tq + qi] = isfinite(best) ? (int)best_id : -1;
  }
}

// Insert (d, id) into the ascending register list (bd, bi) of length K.
// Equal distances keep their arrival order, so with candidates arriving in
// increasing position the lower position stays first.
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

// K8: per-tile sorted top-K, written cut to k.
template <int K>
__global__ void __launch_bounds__(kMaxThreads)
tile_nnk(const float* __restrict__ q, const float* __restrict__ cand, int tq,
         int M, int dim, int k, float* __restrict__ out_d,
         int* __restrict__ out_i) {
  __shared__ float4 s_r[kStage];
  __shared__ float s_id[kStage];
  const int64_t t = blockIdx.x;
  const int qi = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = qi < tq;
  const float* tab = cand + t * kRows * (int64_t)M;
  float qx, qy, qz;
  load_query(q, t * tq + qi, live, dim, qx, qy, qz);
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = -1;
  }
  for (int m0 = 0; m0 < M; m0 += kStage) {
    const int cnt = M - m0 < kStage ? M - m0 : kStage;
    __syncthreads();
    stage(tab, M, dim, m0, cnt, s_r, s_id);
    __syncthreads();
    for (int l = 0; l < cnt; ++l) {
      const float d = pair_d2(qx, qy, qz, s_r[l]);
      if (d < bd[K - 1]) insert_sorted<K>(bd, bi, d, (int)s_id[l]);
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (s < k) {
        const int64_t o = (t * k + s) * tq + qi;
        out_d[o] = bd[s];
        out_i[o] = isfinite(bd[s]) ? bi[s] : -1;
      }
    }
  }
}

// T4 (TILES = 8) and T5 (TILES = 1): the minimum d2 of each query over its
// tile's candidates, `stage_cols` columns of one tile staged at a time.
template <int TILES>
__global__ void __launch_bounds__(kMaxThreads)
tile_min(const float* __restrict__ q, const float* __restrict__ cand, int T,
         int tq, int M, int dim, int stage_cols, float* __restrict__ out_d) {
  extern __shared__ float4 s_dyn[];    // stage_cols entries
  const int64_t t0 = (int64_t)blockIdx.x * TILES;
  const int qi = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = qi < tq;
  float qx[TILES], qy[TILES], qz[TILES], best[TILES];
#pragma unroll
  for (int s = 0; s < TILES; ++s) {
    load_query(q, (t0 + s) * tq + qi, live && t0 + s < T, dim, qx[s], qy[s],
               qz[s]);
    best[s] = CUDART_INF_F;
  }
  for (int m0 = 0; m0 < M; m0 += stage_cols) {
    const int cnt = M - m0 < stage_cols ? M - m0 : stage_cols;
#pragma unroll
    for (int s = 0; s < TILES; ++s) {
      if (t0 + s < T) {                // the same for every thread
        const float* tab = cand + (t0 + s) * kRows * (int64_t)M;
        __syncthreads();
        for (int l = threadIdx.x; l < cnt; l += blockDim.x) {
          const int m = m0 + l;
          s_dyn[l] = make_float4(tab[m], tab[(int64_t)M + m],
                                 dim == 3 ? tab[2 * (int64_t)M + m] : 0.0f,
                                 tab[kPenRow * (int64_t)M + m]);
        }
        __syncthreads();
#pragma unroll 8
        for (int l = 0; l < cnt; ++l)
          best[s] = fminf(best[s], pair_d2(qx[s], qy[s], qz[s], s_dyn[l]));
      }
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < TILES; ++s)
      if (t0 + s < T) out_d[(t0 + s) * tq + qi] = best[s];
  }
}

dim3 grid_of(int T, int tq, int& threads) {
  const int warps = (tq + 31) / 32 * 32;
  threads = warps < kMaxThreads ? warps : kMaxThreads;
  return dim3((unsigned)T, (unsigned)((tq + threads - 1) / threads));
}

template <int K>
cudaError_t launch_nnk(const float* q, const float* cand, int T, int tq, int M,
                       int dim, int k, float* out_d, int* out_i,
                       cudaStream_t st) {
  int threads;
  const dim3 grid = grid_of(T, tq, threads);
  tile_nnk<K><<<grid, threads, 0, st>>>(q, cand, tq, M, dim, k, out_d, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [T, tq, 8], cand [T, 8, M]; out_d, out_i [T, tq].
int pm_tile_nn1(const float* q, const float* cand, int T, int tq, int M,
                int dim, float* out_d, int* out_i, void* stream) {
  if (T == 0 || tq == 0) return cudaSuccess;
  int threads;
  const dim3 grid = grid_of(T, tq, threads);
  tile_nn1<<<grid, threads, 0, (cudaStream_t)stream>>>(q, cand, tq, M, dim,
                                                       out_d, out_i);
  return cudaGetLastError();
}

// kk is the register list length: 4, 8, 16 or 32 with kk >= k; out_d, out_i
// [T, k, tq].
int pm_tile_nnk(const float* q, const float* cand, int T, int tq, int M,
                int dim, int k, int kk, float* out_d, int* out_i,
                void* stream) {
  if (T == 0 || tq == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kk) {
    case 4:
      return launch_nnk<4>(q, cand, T, tq, M, dim, k, out_d, out_i, st);
    case 8:
      return launch_nnk<8>(q, cand, T, tq, M, dim, k, out_d, out_i, st);
    case 16:
      return launch_nnk<16>(q, cand, T, tq, M, dim, k, out_d, out_i, st);
    case 32:
      return launch_nnk<32>(q, cand, T, tq, M, dim, k, out_d, out_i, st);
    default:
      return cudaErrorInvalidValue;
  }
}

int pm_tile_min_stage() { return kMinStage; }
int pm_tile_min_one_max() { return kMinOneMax; }

// T4 (tiles_per_block 8) or T5 (1): q [T, tq, 8], cand [T, 8, M]; out_d
// [T, tq]. T5 takes M <= pm_tile_min_one_max().
int pm_tile_min(const float* q, const float* cand, int T, int tq, int M,
                int dim, int tiles_per_block, float* out_d, void* stream) {
  if (T == 0 || tq == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  int threads;
  dim3 grid = grid_of(T, tq, threads);
  if (tiles_per_block == 8) {
    grid.x = (unsigned)((T + 7) / 8);
    const int stage = M < kMinStage ? M : kMinStage;
    tile_min<8><<<grid, threads, stage * sizeof(float4), st>>>(
        q, cand, T, tq, M, dim, kMinStage, out_d);
  } else if (tiles_per_block == 1) {
    if (M > kMinOneMax) return cudaErrorInvalidValue;
    const size_t bytes = (size_t)(M > 0 ? M : 1) * sizeof(float4);
    const cudaError_t e = cudaFuncSetAttribute(
        tile_min<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    tile_min<1><<<grid, threads, bytes, st>>>(q, cand, T, tq, M, dim,
                                              M > 0 ? M : 1, out_d);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* pm_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
