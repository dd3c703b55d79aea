// Dense exact k-NN kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by libpointmatcher_tpu_torch/ops/knn_cuda.py.
//
// They replace the TPU kernels of libpointmatcher_tpu/ops/knn_pallas.py:
//   K1  knn1_partial<false>  <- _nn1_kernel      (knn_pallas.py:32, knn1_pallas)
//   K9  knn1_partial<true>   <- _nn1_mxu_kernel  (knn_pallas.py:93, knn1_pallas_mxu)
//   K5  knnk_partial<K>      <- _nnk_kernel      (knn_pallas.py:123, knnk_pallas)
//
// What bounds them: at d = 3 each (query, reference) pair costs about ten
// fp32 operations and the inputs are a few hundred kilobytes, so the work is
// bound by the fp32 issue rate, not by memory. The design keeps every pair
// in registers: one thread owns one query; reference rows are staged through
// shared memory as float4 (x, y, z, pen) and read by all threads of a block
// at once (a broadcast, no bank conflicts); the running minimum, or the
// sorted top-K, stays in registers. The reference rows are split into
// contiguous chunks over gridDim.y so that a few thousand queries still give
// every SM several blocks; a second small kernel merges the chunks in chunk
// order.
//
// Exactness: K1 and K5 form d2 = ((pen + dx*dx) + dy*dy) + dz*dz with
// explicitly rounded intrinsics (no FMA contraction), the order of the plain
// torch version in ops/knn.py, so both agree bit for bit. Every comparison is
// a strict '<' in increasing reference order, so the lowest index wins a tie.
// K9 forms d2 = (q2 + (r2 + pen)) - 2 (q.r) with fp32 FMAs (no tensor cores:
// TF32 would break its error bound) and is clamped at 0 after the minimum,
// as knn1_pallas_mxu does. pen = +inf at masked reference rows keeps every
// sum at +inf, never NaN. Outputs: (d2, id), (+inf, -1) for a masked query
// or for a slot with no valid reference.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // queries per block, one per thread
constexpr int kTile = 1024;  // reference rows per shared-memory stage (16 KB)

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float4 stage_row(const float* __restrict__ ref,
                                            const uint8_t* __restrict__ rmask,
                                            int64_t j, int dim, bool mxu) {
  const float x = ref[j * dim];
  const float y = ref[j * dim + 1];
  const float z = dim == 3 ? ref[j * dim + 2] : 0.0f;
  const bool valid = rmask[j] != 0;
  float w;
  if (mxu) {
    const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                               __fmul_rn(z, z));
    w = valid ? r2 : CUDART_INF_F;
  } else {
    w = valid ? 0.0f : CUDART_INF_F;
  }
  return make_float4(x, y, z, w);
}

__device__ __forceinline__ float pair_d2(float qx, float qy, float qz,
                                         float q2, float4 r, bool mxu) {
  if (mxu) {
    const float dot = fmaf(qz, r.z, fmaf(qy, r.y, __fmul_rn(qx, r.x)));
    return fmaf(-2.0f, dot, __fadd_rn(q2, r.w));
  }
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

// K1 / K9: running (min, argmin) of one reference chunk per blockIdx.y.
template <bool MXU>
__global__ void __launch_bounds__(kBlock)
knn1_partial(const float* __restrict__ q, int n, const float* __restrict__ ref,
             const uint8_t* __restrict__ rmask, int m, int dim, int chunk,
             float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ float4 tile[kTile];
  const int64_t qi = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  const int64_t j0 = (int64_t)blockIdx.y * chunk;
  const int64_t j1 = min64(m, j0 + chunk);
  float qx, qy, qz;
  load_query(q, qi, n, dim, qx, qy, qz);
  const float q2 = MXU ? __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)),
                                   __fmul_rn(qz, qz))
                       : 0.0f;
  float best = CUDART_INF_F;
  int besti = -1;
  for (int64_t t0 = j0; t0 < j1; t0 += kTile) {
    const int cnt = (int)min64(kTile, j1 - t0);
    __syncthreads();
    for (int l = threadIdx.x; l < cnt; l += kBlock)
      tile[l] = stage_row(ref, rmask, t0 + l, dim, MXU);
    __syncthreads();
#pragma unroll 8
    for (int l = 0; l < cnt; ++l) {
      const float d = pair_d2(qx, qy, qz, q2, tile[l], MXU);
      if (d < best) {
        best = d;
        besti = (int)(t0 + l);
      }
    }
  }
  if (qi < n) {
    part_d[(int64_t)blockIdx.y * n + qi] = best;
    part_i[(int64_t)blockIdx.y * n + qi] = besti;
  }
}

__global__ void knn1_combine(const float* __restrict__ part_d,
                             const int* __restrict__ part_i, int n, int splits,
                             const uint8_t* __restrict__ qmask, int clamp0,
                             float* __restrict__ out_d, int* __restrict__ out_i) {
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
  if (clamp0) best = fmaxf(best, 0.0f);
  const bool qv = qmask[qi] != 0;
  out_d[qi] = qv ? best : CUDART_INF_F;
  out_i[qi] = (qv && isfinite(best)) ? besti : -1;
}

// K5: sorted top-K of one reference chunk per blockIdx.y.
template <int K>
__global__ void __launch_bounds__(kBlock)
knnk_partial(const float* __restrict__ q, int n, const float* __restrict__ ref,
             const uint8_t* __restrict__ rmask, int m, int dim, int chunk,
             float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ float4 tile[kTile];
  const int64_t qi = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  const int64_t j0 = (int64_t)blockIdx.y * chunk;
  const int64_t j1 = min64(m, j0 + chunk);
  float qx, qy, qz;
  load_query(q, qi, n, dim, qx, qy, qz);
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = -1;
  }
  for (int64_t t0 = j0; t0 < j1; t0 += kTile) {
    const int cnt = (int)min64(kTile, j1 - t0);
    __syncthreads();
    for (int l = threadIdx.x; l < cnt; l += kBlock)
      tile[l] = stage_row(ref, rmask, t0 + l, dim, false);
    __syncthreads();
    for (int l = 0; l < cnt; ++l) {
      const float d = pair_d2(qx, qy, qz, 0.0f, tile[l], false);
      if (d < bd[K - 1]) insert_sorted<K>(bd, bi, d, (int)(t0 + l));
    }
  }
  if (qi < n) {
    const int64_t base = ((int64_t)blockIdx.y * n + qi) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      part_d[base + s] = bd[s];
      part_i[base + s] = bi[s];
    }
  }
}

template <int K>
__global__ void knnk_combine(const float* __restrict__ part_d,
                             const int* __restrict__ part_i, int n, int splits,
                             const uint8_t* __restrict__ qmask, int k,
                             float* __restrict__ out_d, int* __restrict__ out_i) {
  const int64_t qi = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= n) return;
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
  const bool qv = qmask[qi] != 0;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s < k) {
      out_d[qi * k + s] = qv ? bd[s] : CUDART_INF_F;
      out_i[qi * k + s] = (qv && isfinite(bd[s])) ? bi[s] : -1;
    }
  }
}

template <int K>
cudaError_t launch_knnk(const float* q, const uint8_t* qmask, int n,
                        const float* ref, const uint8_t* rmask, int m, int dim,
                        int k, int splits, int chunk, float* part_d,
                        int* part_i, float* out_d, int* out_i,
                        cudaStream_t st) {
  const dim3 grid((n + kBlock - 1) / kBlock, splits);
  knnk_partial<K><<<grid, kBlock, 0, st>>>(q, n, ref, rmask, m, dim, chunk,
                                           part_d, part_i);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  knnk_combine<K><<<(n + 127) / 128, 128, 0, st>>>(part_d, part_i, n, splits,
                                                   qmask, k, out_d, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per chunk must be a multiple of the stage tile, splits * chunk >= m.
int pm_tile_rows() { return kTile; }

int pm_knn1(const float* q, const uint8_t* qmask, int n, const float* ref,
            const uint8_t* rmask, int m, int dim, int mxu, int splits,
            int chunk, float* part_d, int* part_i, float* out_d, int* out_i,
            void* stream) {
  if (n == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((n + kBlock - 1) / kBlock, splits);
  if (mxu)
    knn1_partial<true><<<grid, kBlock, 0, st>>>(q, n, ref, rmask, m, dim,
                                                chunk, part_d, part_i);
  else
    knn1_partial<false><<<grid, kBlock, 0, st>>>(q, n, ref, rmask, m, dim,
                                                 chunk, part_d, part_i);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  knn1_combine<<<(n + 255) / 256, 256, 0, st>>>(part_d, part_i, n, splits,
                                                qmask, mxu, out_d, out_i);
  return cudaGetLastError();
}

// kk is the register list length: a power of two in [2, 32] with kk >= k.
int pm_knnk(const float* q, const uint8_t* qmask, int n, const float* ref,
            const uint8_t* rmask, int m, int dim, int k, int kk, int splits,
            int chunk, float* part_d, int* part_i, float* out_d, int* out_i,
            void* stream) {
  if (n == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kk) {
    case 2:
      return launch_knnk<2>(q, qmask, n, ref, rmask, m, dim, k, splits, chunk,
                            part_d, part_i, out_d, out_i, st);
    case 4:
      return launch_knnk<4>(q, qmask, n, ref, rmask, m, dim, k, splits, chunk,
                            part_d, part_i, out_d, out_i, st);
    case 8:
      return launch_knnk<8>(q, qmask, n, ref, rmask, m, dim, k, splits, chunk,
                            part_d, part_i, out_d, out_i, st);
    case 16:
      return launch_knnk<16>(q, qmask, n, ref, rmask, m, dim, k, splits, chunk,
                             part_d, part_i, out_d, out_i, st);
    case 32:
      return launch_knnk<32>(q, qmask, n, ref, rmask, m, dim, k, splits, chunk,
                             part_d, part_i, out_d, out_i, st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* pm_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
