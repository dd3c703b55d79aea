// Survivor-sweep 1-NN kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by libpointmatcher_tpu_torch/ops/sweep_cuda.py.
//
// They replace the TPU kernels of libpointmatcher_tpu/ops/knn_sweep2.py:
//   K2  survivors_bounds      <- _bounds_kernel        (knn_sweep2.py:132, survivors_and_bounds)
//   K3  survivor_sweep<false> <- _sweep_kernel         (knn_sweep2.py:242, nn1_survivor_sweep)
//   K4  survivor_sweep<true>  <- _sweep_stream_kernel  (knn_sweep2.py:482, nn1_survivor_sweep_stream)
//   K6  survivor_sweep_k<K>   <- _sweepk_kernel        (knn_sweep2.py:349, nnk_survivor_sweep)
//
// The map is Morton-sorted and cut into chunks of 128 rows. Inputs:
//   qp   [n_pad, 8]       queries: cols 0..2 coordinates, col 3 the query
//                         penalty (0 valid, 1e15 invalid or padding), col 4
//                         the transported upper bound on the NN distance;
//   ct   [8, nch_pad]     per-chunk boxes: rows 0..2 lo, 3..5 hi (inflated
//                         outward on the host), row 6 the valid count;
//   rt3  [nch, 8, 128]    the chunked map: rows 0..2 coordinates, row 3 the
//                         row penalty (0 valid, +inf invalid or padding);
//   surv [tiles, nch_pad] int32 survival flags.
//
// K2, one block per 256-query tile, one thread per query. Pass 1: each
// thread takes its bound U = min(col 4, min over chunks of
// (|q - centre| + half-diagonal) * (1 + 4e-7)); for k > 1 only chunks with
// at least k valid rows may bind it. Pass 2: chunk c survives for the tile if
// any query has gap^2 * (1 - 4e-7) + pen <= U^2 * (1 + 4e-7), gap being the
// distance from q to the chunk's box. Only the map's nch chunks are visited:
// the padding columns nch..nch_pad-1 of ct (boxes at 1e15) can neither bind U
// nor survive, so their flags are written as 0 without being computed. A warp vote per chunk ORs the flags of
// 32 queries; one lane per warp sets a shared flag. The chunk table is staged
// through shared memory 512 chunks at a time, with each chunk's centre and
// half-diagonal formed once per block. Bound: at the serving shapes K2 does
// ~25 fp32 operations per (query, chunk) on a few MB of input, so it is
// bound by the fp32 issue rate, and the design keeps every operand of the
// inner loop in registers or shared memory (broadcast reads).
//
// K3/K4, one block per 1024-query tile, 256 threads, four queries each. The
// block builds its ordered survivor list in shared memory from the tile's
// flag row (warp ballots and a block prefix count over the flags, in place of
// the TPU kernel's scalar-core loop), then sweeps only the surviving chunks:
// each chunk's rows 0..3 (x, y, z, pen: 2 KB) are staged in shared memory and
// every thread folds them into the running (min, argmin) of its queries. K3
// stages each chunk with plain loads between two barriers. K4 keeps a
// two-stage ring and fetches chunk j+1 with cp.async while it sweeps chunk j,
// the counterpart of the Pallas kernel's double-buffered DMA. The work is
// ~10 fp32 operations per (query, surviving row), so both are bound by the
// fp32 issue rate over the survivors; K4 hides the load latency that K3
// waits on at each barrier.
//
// K6, the top-K sweep (K = 2..4) of the knn > 1 route, resident maps only,
// has K3's shape: the same survivor list, each chunk staged between two
// barriers, four queries per thread. Each query keeps its sorted top-K in
// registers (K template-instantiated, so the list never spills to local
// memory), and a row is inserted only when it beats the K-th distance. Its
// work is K3's plus the rare insertions, so it is bound by the fp32 issue
// rate over the survivors too.
//
// Exactness: K2 forms every quantity with explicitly rounded intrinsics in
// the order of the plain torch version (ops/sweep_cuda.py), so nvcc cannot
// contract an FMA into it and the flags are the same bit for bit. K3/K4 form
// d2 = ((pen + dx*dx) + dy*dy) + dz*dz, K1's order, so their d2 equals K1's
// on the same pair. Survivors are swept in increasing chunk order and rows in
// increasing order with a strict '<', so the lowest sorted-map index wins a
// tie. A query whose tile has no survivor, or whose minimum stays +inf, gets
// (+inf, 0); the caller masks it. K6 forms d2 the same way and inserts with
// a strict '<' in the same sweep order, so equal distances keep the lower
// index ahead: the order of the Pallas kernel's first-minimum merge, whose
// ids K6 therefore matches, ties included. Slots left empty hold (+inf, -1).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBoundTile = 256;    // queries per K2 block and flag row
constexpr int kChunkStage = 512;   // chunk columns staged per K2 pass
constexpr int kSweepThreads = 256;
constexpr int kPerThread = 4;      // queries per K3/K4 thread
constexpr int kSweepTile = kSweepThreads * kPerThread;  // 1024
constexpr int kChunk = 128;        // map rows per chunk
constexpr int kRows = 8;           // rows of a chunk in rt3

constexpr float kUp = 1.0000004f;    // float32(1 + 4e-7)
constexpr float kDown = 0.9999996f;  // float32(1 - 4e-7)
constexpr float kFar = 1.0e15f;

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

__device__ __forceinline__ float sum3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(a, b), c);
}

// K2: per-query bounds and per-(tile, chunk) survival flags.
__global__ void __launch_bounds__(kBoundTile)
survivors_bounds(const float* __restrict__ qp, const float* __restrict__ ct,
                 int nch, int nch_pad, int k, float* __restrict__ ub_out,
                 int* __restrict__ surv) {
  __shared__ float s_lo[3][kChunkStage];
  __shared__ float s_hi[3][kChunkStage];
  __shared__ float s_ctr[3][kChunkStage];
  __shared__ float s_rad[kChunkStage];   // sqrt of the half-diagonal squared
  __shared__ float s_add[kChunkStage];   // 1e15 where a chunk may not bind U
  __shared__ int s_flag[kChunkStage];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t qi = (int64_t)blockIdx.x * kBoundTile + tid;
  const float* q = qp + qi * 8;
  const float qx = q[0], qy = q[1], qz = q[2], pen = q[3];
  float u = q[4];

  // pass 1: the bound
  for (int c0 = 0; c0 < nch; c0 += kChunkStage) {
    const int cnt = min(kChunkStage, nch - c0);
    __syncthreads();
    for (int l = tid; l < cnt; l += kBoundTile) {
      float half2[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float lo = ct[(int64_t)c * nch_pad + c0 + l];
        const float hi = ct[(int64_t)(3 + c) * nch_pad + c0 + l];
        s_ctr[c][l] = __fmul_rn(0.5f, __fadd_rn(lo, hi));
        half2[c] = sq(__fmul_rn(0.5f, __fsub_rn(hi, lo)));
      }
      s_rad[l] = __fsqrt_rn(sum3(half2[0], half2[1], half2[2]));
      const float valid = ct[(int64_t)6 * nch_pad + c0 + l];
      s_add[l] = (k > 1 && valid < (float)k) ? kFar : 0.0f;
    }
    __syncthreads();
    for (int l = 0; l < cnt; ++l) {
      const float dc2 = sum3(sq(__fsub_rn(qx, s_ctr[0][l])),
                             sq(__fsub_rn(qy, s_ctr[1][l])),
                             sq(__fsub_rn(qz, s_ctr[2][l])));
      float cand = __fmul_rn(__fadd_rn(__fsqrt_rn(dc2), s_rad[l]), kUp);
      cand = __fadd_rn(cand, s_add[l]);
      u = fminf(u, cand);
    }
  }
  ub_out[qi] = u;

  // pass 2: survival of each chunk for the tile
  const float ub2 = __fmul_rn(sq(u), kUp);
  for (int c = nch + tid; c < nch_pad; c += kBoundTile)
    surv[(int64_t)blockIdx.x * nch_pad + c] = 0;
  for (int c0 = 0; c0 < nch; c0 += kChunkStage) {
    const int cnt = min(kChunkStage, nch - c0);
    __syncthreads();
    for (int l = tid; l < cnt; l += kBoundTile) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        s_lo[c][l] = ct[(int64_t)c * nch_pad + c0 + l];
        s_hi[c][l] = ct[(int64_t)(3 + c) * nch_pad + c0 + l];
      }
      s_flag[l] = 0;
    }
    __syncthreads();
    for (int l = 0; l < cnt; ++l) {
      const float gx = fmaxf(fmaxf(__fsub_rn(s_lo[0][l], qx),
                                   __fsub_rn(qx, s_hi[0][l])), 0.0f);
      const float gy = fmaxf(fmaxf(__fsub_rn(s_lo[1][l], qy),
                                   __fsub_rn(qy, s_hi[1][l])), 0.0f);
      const float gz = fmaxf(fmaxf(__fsub_rn(s_lo[2][l], qz),
                                   __fsub_rn(qz, s_hi[2][l])), 0.0f);
      const float gap2 = sum3(sq(gx), sq(gy), sq(gz));
      const bool ok = __fadd_rn(__fmul_rn(gap2, kDown), pen) <= ub2;
      if (__any_sync(0xffffffffu, ok) && lane == 0) s_flag[l] = 1;
    }
    __syncthreads();
    for (int l = tid; l < cnt; l += kBoundTile)
      surv[(int64_t)blockIdx.x * nch_pad + c0 + l] = s_flag[l];
  }
}

// The ordered list of the chunks flagged in `flags` (one tile's row of
// surv) into s_list, by warp ballots and a block prefix count; returns its
// length. Every thread of the block calls it.
__device__ __forceinline__ int survivor_list(const int* __restrict__ flags,
                                             int nch, int* s_list,
                                             int* s_warp) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int count = 0;
  for (int c0 = 0; c0 < nch; c0 += kSweepThreads) {
    const int c = c0 + tid;
    const bool f = c < nch && flags[c] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, f);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int off = count, total = 0;
#pragma unroll
    for (int w = 0; w < kSweepThreads / 32; ++w) {
      if (w < warp) off += s_warp[w];
      total += s_warp[w];
    }
    if (f) s_list[off + __popc(ballot & ((1u << lane) - 1u))] = c;
    __syncthreads();
    count += total;
  }
  return count;
}

// Copy rows 0..3 of chunk `ch` (2 KB) into one stage of the ring: 128
// copies of 16 bytes, one per thread of the first 128.
__device__ __forceinline__ void fetch_chunk_async(float (*stage)[kChunk],
                                                  const float* __restrict__ rt3,
                                                  int ch, int tid) {
  if (tid < 4 * kChunk / 4) {
    const int r = tid >> 5;
    const int off = (tid & 31) * 4;
    __pipeline_memcpy_async(&stage[r][off],
                            rt3 + ((int64_t)ch * kRows + r) * kChunk + off,
                            16);
  }
  __pipeline_commit();
}

// K3 (STREAM = false) and K4 (STREAM = true): exact 1-NN over the tile's
// surviving chunks.
template <bool STREAM>
__global__ void __launch_bounds__(kSweepThreads)
survivor_sweep(const float* __restrict__ qp, const float* __restrict__ rt3,
               const int* __restrict__ surv, int nch, int nch_pad,
               float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ int s_list[];  // nch entries
  __shared__ __align__(16) float s_chunk[2][4][kChunk];
  __shared__ int s_warp[kSweepThreads / 32];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;

  const int count = survivor_list(surv + (int64_t)tile * nch_pad, nch,
                                  s_list, s_warp);

  float qx[kPerThread], qy[kPerThread], qz[kPerThread], best[kPerThread];
  int besti[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const float* q = qp + ((int64_t)tile * kSweepTile + tid + j * kSweepThreads) * 8;
    qx[j] = q[0];
    qy[j] = q[1];
    qz[j] = q[2];
    best[j] = CUDART_INF_F;
    besti[j] = 0;
  }

  if (STREAM && count > 0) fetch_chunk_async(s_chunk[0], rt3, s_list[0], tid);
  for (int s = 0; s < count; ++s) {
    const int ch = s_list[s];
    const int st = STREAM ? (s & 1) : 0;
    if (STREAM) {
      if (s + 1 < count) {
        fetch_chunk_async(s_chunk[st ^ 1], rt3, s_list[s + 1], tid);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
    } else {
      for (int e = tid; e < 4 * kChunk; e += kSweepThreads) {
        const int r = e >> 7;
        const int l = e & (kChunk - 1);
        s_chunk[0][r][l] = rt3[((int64_t)ch * kRows + r) * kChunk + l];
      }
    }
    __syncthreads();
    const int base = ch * kChunk;
#pragma unroll 4
    for (int l = 0; l < kChunk; ++l) {
      const float rx = s_chunk[st][0][l];
      const float ry = s_chunk[st][1][l];
      const float rz = s_chunk[st][2][l];
      const float rp = s_chunk[st][3][l];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const float d = __fadd_rn(
            __fadd_rn(__fadd_rn(rp, sq(__fsub_rn(qx[j], rx))),
                      sq(__fsub_rn(qy[j], ry))),
            sq(__fsub_rn(qz[j], rz)));
        if (d < best[j]) {
          best[j] = d;
          besti[j] = base + l;
        }
      }
    }
    __syncthreads();  // the stage is refilled by the next iteration
  }

#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t qi = (int64_t)tile * kSweepTile + tid + j * kSweepThreads;
    out_d[qi] = best[j];
    out_i[qi] = besti[j];
  }
}

// Insert (d, id) into the ascending register list (bd, bi) of length K.
// Equal distances keep their arrival order, so with rows arriving in
// increasing sorted-map index the lower index stays first.
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

// K6: exact top-K (K = 2..4) over the tile's surviving chunks, resident map.
template <int K>
__global__ void __launch_bounds__(kSweepThreads)
survivor_sweep_k(const float* __restrict__ qp, const float* __restrict__ rt3,
                 const int* __restrict__ surv, int nch, int nch_pad,
                 float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ int s_list[];  // nch entries
  __shared__ float s_chunk[4][kChunk];
  __shared__ int s_warp[kSweepThreads / 32];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int count = survivor_list(surv + (int64_t)tile * nch_pad, nch,
                                  s_list, s_warp);

  float qx[kPerThread], qy[kPerThread], qz[kPerThread];
  float bd[kPerThread][K];
  int bi[kPerThread][K];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const float* q = qp + ((int64_t)tile * kSweepTile + tid + j * kSweepThreads) * 8;
    qx[j] = q[0];
    qy[j] = q[1];
    qz[j] = q[2];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[j][s] = CUDART_INF_F;
      bi[j][s] = -1;
    }
  }

  for (int s = 0; s < count; ++s) {
    const int ch = s_list[s];
    for (int e = tid; e < 4 * kChunk; e += kSweepThreads) {
      const int r = e >> 7;
      const int l = e & (kChunk - 1);
      s_chunk[r][l] = rt3[((int64_t)ch * kRows + r) * kChunk + l];
    }
    __syncthreads();
    const int base = ch * kChunk;
    for (int l = 0; l < kChunk; ++l) {
      const float rx = s_chunk[0][l];
      const float ry = s_chunk[1][l];
      const float rz = s_chunk[2][l];
      const float rp = s_chunk[3][l];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const float d = __fadd_rn(
            __fadd_rn(__fadd_rn(rp, sq(__fsub_rn(qx[j], rx))),
                      sq(__fsub_rn(qy[j], ry))),
            sq(__fsub_rn(qz[j], rz)));
        if (d < bd[j][K - 1]) insert_sorted<K>(bd[j], bi[j], d, base + l);
      }
    }
    __syncthreads();  // the stage is refilled by the next iteration
  }

#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t qi = (int64_t)tile * kSweepTile + tid + j * kSweepThreads;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      out_d[qi * K + s] = bd[j][s];
      out_i[qi * K + s] = bi[j][s];
    }
  }
}

}  // namespace

extern "C" {

int pm_bound_tile() { return kBoundTile; }
int pm_sweep_tile() { return kSweepTile; }

// n_pad a multiple of 256; surv is [n_pad / 256, nch_pad]; chunks nch and
// above are padding.
int pm_survivors_bounds(const float* qp, int n_pad, const float* ct, int nch,
                        int nch_pad, int k, float* ub, int* surv,
                        void* stream) {
  if (n_pad == 0) return cudaSuccess;
  survivors_bounds<<<n_pad / kBoundTile, kBoundTile, 0,
                     (cudaStream_t)stream>>>(qp, ct, nch, nch_pad, k, ub, surv);
  return cudaGetLastError();
}

// n_pad a multiple of 1024; surv is [n_pad / 1024, nch_pad]; the survivor
// list takes nch * 4 bytes of dynamic shared memory.
int pm_survivor_sweep(const float* qp, int n_pad, const float* rt3, int nch,
                      const int* surv, int nch_pad, int stream_map,
                      float* out_d, int* out_i, void* stream) {
  if (n_pad == 0) return cudaSuccess;
  const size_t smem = (size_t)(nch > 0 ? nch : 1) * sizeof(int);
  const dim3 grid(n_pad / kSweepTile);
  cudaStream_t st = (cudaStream_t)stream;
  if (stream_map)
    survivor_sweep<true><<<grid, kSweepThreads, smem, st>>>(
        qp, rt3, surv, nch, nch_pad, out_d, out_i);
  else
    survivor_sweep<false><<<grid, kSweepThreads, smem, st>>>(
        qp, rt3, surv, nch, nch_pad, out_d, out_i);
  return cudaGetLastError();
}

// K6: out_d, out_i are [n_pad, k], k in 2..4; otherwise as pm_survivor_sweep.
int pm_survivor_sweep_k(const float* qp, int n_pad, const float* rt3, int nch,
                        const int* surv, int nch_pad, int k, float* out_d,
                        int* out_i, void* stream) {
  if (n_pad == 0) return cudaSuccess;
  const size_t smem = (size_t)(nch > 0 ? nch : 1) * sizeof(int);
  const dim3 grid(n_pad / kSweepTile);
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
    case 2:
      survivor_sweep_k<2><<<grid, kSweepThreads, smem, st>>>(
          qp, rt3, surv, nch, nch_pad, out_d, out_i);
      break;
    case 3:
      survivor_sweep_k<3><<<grid, kSweepThreads, smem, st>>>(
          qp, rt3, surv, nch, nch_pad, out_d, out_i);
      break;
    case 4:
      survivor_sweep_k<4><<<grid, kSweepThreads, smem, st>>>(
          qp, rt3, surv, nch, nch_pad, out_d, out_i);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* pm_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
