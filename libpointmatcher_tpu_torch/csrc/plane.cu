// The point-to-plane minimizer's normal equations and their solve for Hopper
// (sm_90a), with a plain C interface loaded through ctypes by
// libpointmatcher_tpu_torch/ops/plane_cuda.py.
//
// It replaces no Pallas kernel. The JAX package forms the normal equations
// of PointToPlaneErrorMinimizer with XLA-fused reductions
// (libpointmatcher_tpu/minimizers.py) and solves them with its fused cyclic
// Jacobi (libpointmatcher_tpu/utils/smalleig.py::eigh_jacobi); the port's
// torch body of the same step (minimizers.py::PointToPlaneErrorMinimizer.
// _solve) runs about a hundred small launches, a [6 x P]·[P x 6] GEMM whose
// library kernel tiles 32x32 outputs and so leaves most of the card idle, and
// torch.linalg.eigh, which reads its error flags on the host every step.
// This pair of kernels is the whole minimize: two launches, no host read, no
// library call.
//
// plane_moments, grid (blocks per scan, B), kThreads threads. Block c of scan
// b takes the reading points [c * kBlockPoints, (c + 1) * kBlockPoints), a
// point a thread kPointsPerThread times at a stride of kThreads (coalesced),
// and each point its k match slots. A slot is valid where its distance is
// finite and its weight non-zero (minimizers.py::make_pairs). A valid slot
// gathers its reference row's point q and normal n (one shared [M, 3] table,
// or one per scan: ref_stride 0 or M rows) and forms, with p the stepped
// reading point,
//   F = [p x n, n],  dot = ((p - q) . n)
// and adds, in float32 (the configuration's precision; no TF32), the 21
// entries of the upper triangle of w F F^T, the 6 of w F dot, (w dot) dot and
// w. Counts, in int: valid slots, finite slots of zero weight (rejected
// matches), masked rows with no valid slot (rejected points), masked rows.
// The block reduces its threads' sums by shuffles (a fixed tree) and then
// over its warps in order, and writes one partial row: no atomics, so every
// launch gives the same bits.
//
// plane_solve, one warp a scan (kSolveWarps a block). The lanes merge the
// scan's partial rows column by column, in block order. Lane 0 then builds
// the symmetric A and b = -sum w F dot and runs the JAX package's Jacobi: the
// same 5 round-robin rounds of 3 disjoint rotations, 4 sweeps, each round's
// (c, s) taken from the pivots at its start, rows rotated then columns (that
// is A <- G^T A G), the eliminated entries set to 0, V <- V G; t = 0 where
// a_ij == 0 or t is NaN. Then the pseudo-inverse with the cutoff
// w > max|w| * 6 * 1e-7 (NaN-propagating max, as jnp.max and torch.amax), x =
// V (winv * V^T b), and T = [rodrigues(x[0:3]), x[3:6]] with se3.rodrigues's
// formula (the series below theta = 1e-6 included). A system of zeros gives x
// = 0 and the identity; a non-finite one a non-finite pose. One thread does
// the 6x6 solve: A and V stay in registers (every index is a compile-time
// constant after unrolling), about 60 rotations of sequential latency, a few
// microseconds, against a pass that reads the pairs. The outputs a scan:
// T (16 floats), the residual, the used and weighted used ratios over
// max(k * masked rows, 1), and the two rejection counts as int bits, the
// statistics as rows of B so that the wrapper's views of them are one
// unbind each.
//
// Bound: bytes. A slot reads its distance, id and weight (12 bytes), a point
// its coordinates and mask byte (13), a valid slot gathers 24 bytes of map
// rows (1.2 MB at the benchmark's 50 000-row map, held in the 50 MB L2). At
// 32 scans x 25 000 points x k = 1 that is 20 MB read once (39 MB counting
// each gather), 6-12 us at 3.35 TB/s; about 80 flops a valid slot are 1 us at
// 67 TFLOP/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPointsPerThread = 4;
constexpr int kBlockPoints = kThreads * kPointsPerThread;
// the float sums of a partial row: 21 of A's upper triangle (row-major), 6 of
// sum w F dot, the residual sum (w dot) dot, the weight sum
constexpr int kSums = 29;
constexpr int kResidual = 27;
constexpr int kWeightSum = 28;
// the int counts that follow them: valid slots, finite slots of zero weight,
// masked rows with no valid slot, masked rows
constexpr int kCounts = 4;
constexpr int kRow = kSums + kCounts;
constexpr int kSolveWarps = 4;
// the outputs a scan: T row-major (16 floats at out + 16 b), then five rows of
// B (at out + 16 B): residual, used ratio, weighted used ratio, rejected
// matches and rejected points as int bits
constexpr int kOut = 21;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
plane_moments(const float* __restrict__ pts, const uint8_t* __restrict__ mask, int n,
              int k, const float* __restrict__ dists, const int* __restrict__ ids,
              const float* __restrict__ weights, const float* __restrict__ ref,
              const float* __restrict__ nrm, long long ref_stride, int nblk,
              float* __restrict__ part) {
  const int b = blockIdx.y;
  const int c = blockIdx.x;
  float s[kSums];
  int cnt[kCounts];
#pragma unroll
  for (int e = 0; e < kSums; ++e) s[e] = 0.f;
#pragma unroll
  for (int e = 0; e < kCounts; ++e) cnt[e] = 0;

  const float* P = pts + (size_t)b * n * 3;
  const float* R = ref + (size_t)b * ref_stride * 3;
  const float* N = nrm + (size_t)b * ref_stride * 3;
  for (int r = 0; r < kPointsPerThread; ++r) {
    const int i = c * kBlockPoints + r * kThreads + (int)threadIdx.x;
    if (i >= n) break;
    const float px = P[3 * i], py = P[3 * i + 1], pz = P[3 * i + 2];
    bool kept = false;
    const size_t row = ((size_t)b * n + i) * k;
    for (int j = 0; j < k; ++j) {
      const float d = dists[row + j];
      const float w = weights[row + j];
      if (!isfinite(d)) continue;
      if (w == 0.f) {
        ++cnt[1];
        continue;
      }
      kept = true;
      ++cnt[0];
      const size_t id = (size_t)ids[row + j] * 3;
      const float qx = R[id], qy = R[id + 1], qz = R[id + 2];
      const float nx = N[id], ny = N[id + 1], nz = N[id + 2];
      const float F[6] = {py * nz - pz * ny, pz * nx - px * nz, px * ny - py * nx,
                          nx, ny, nz};
      const float dot = ((px - qx) * nx + (py - qy) * ny) + (pz - qz) * nz;
      int e = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        const float wf = w * F[a];
#pragma unroll
        for (int bb = a; bb < 6; ++bb) s[e++] += wf * F[bb];
        s[21 + a] += wf * dot;
      }
      s[kResidual] += (w * dot) * dot;
      s[kWeightSum] += w;
    }
    if (mask[(size_t)b * n + i]) {
      ++cnt[3];
      if (!kept) ++cnt[2];
    }
  }

  __shared__ float red[kThreads / 32][kRow];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < kSums; ++e) {
    const float v = warp_sum(s[e]);
    if (lane == 0) red[warp][e] = v;
  }
#pragma unroll
  for (int e = 0; e < kCounts; ++e) {
    const int v = warp_sum(cnt[e]);
    if (lane == 0) red[warp][kSums + e] = __int_as_float(v);
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < kRow) {
    float* out = part + ((size_t)b * nblk + c) * kRow;
    if (t < kSums) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) v += red[w][t];
      out[t] = v;
    } else {
      int v = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) v += __float_as_int(red[w][t]);
      out[t] = __int_as_float(v);
    }
  }
}

// one Jacobi pivot: (c, s) of the rotation that zeroes A[I][J]
template <int I, int J>
__device__ __forceinline__ void pivot(const float (&A)[6][6], float& c, float& s) {
  const float aij = A[I][J], aii = A[I][I], ajj = A[J][J];
  const float safe = aij == 0.f ? 1.f : 2.f * aij;
  const float tau = (ajj - aii) / safe;
  const float sgn = tau >= 0.f ? 1.f : -1.f;
  float t = sgn / (fabsf(tau) + sqrtf(1.f + tau * tau));
  if (aij == 0.f || isnan(t)) t = 0.f;
  c = 1.f / sqrtf(1.f + t * t);
  s = t * c;
}

template <int I, int J>
__device__ __forceinline__ void rotate_rows(float (&A)[6][6], float c, float s) {
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    const float ai = A[I][m], aj = A[J][m];
    A[I][m] = c * ai - s * aj;
    A[J][m] = s * ai + c * aj;
  }
}

template <int I, int J>
__device__ __forceinline__ void rotate_cols(float (&A)[6][6], float c, float s) {
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    const float ai = A[m][I], aj = A[m][J];
    A[m][I] = c * ai - s * aj;
    A[m][J] = s * ai + c * aj;
  }
}

// one round of three disjoint rotations: A <- G^T A G, V <- V G
template <int I0, int J0, int I1, int J1, int I2, int J2>
__device__ __forceinline__ void jacobi_round(float (&A)[6][6], float (&V)[6][6]) {
  float c0, s0, c1, s1, c2, s2;
  pivot<I0, J0>(A, c0, s0);
  pivot<I1, J1>(A, c1, s1);
  pivot<I2, J2>(A, c2, s2);
  rotate_rows<I0, J0>(A, c0, s0);
  rotate_rows<I1, J1>(A, c1, s1);
  rotate_rows<I2, J2>(A, c2, s2);
  rotate_cols<I0, J0>(A, c0, s0);
  rotate_cols<I1, J1>(A, c1, s1);
  rotate_cols<I2, J2>(A, c2, s2);
  A[I0][J0] = A[J0][I0] = 0.f;
  A[I1][J1] = A[J1][I1] = 0.f;
  A[I2][J2] = A[J2][I2] = 0.f;
  rotate_cols<I0, J0>(V, c0, s0);
  rotate_cols<I1, J1>(V, c1, s1);
  rotate_cols<I2, J2>(V, c2, s2);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || isnan(b)) ? b : a;
}

__global__ void __launch_bounds__(32 * kSolveWarps)
plane_solve(const float* __restrict__ part, int nblk, int B, int k,
            float* __restrict__ out) {
  __shared__ float rows[kSolveWarps][kRow];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kSolveWarps + warp;
  if (b >= B) return;
  const float* src = part + (size_t)b * nblk * kRow;
  for (int col = lane; col < kRow; col += 32) {
    if (col < kSums) {
      float v = 0.f;
      for (int r = 0; r < nblk; ++r) v += src[(size_t)r * kRow + col];
      rows[warp][col] = v;
    } else {
      int v = 0;
      for (int r = 0; r < nblk; ++r) v += __float_as_int(src[(size_t)r * kRow + col]);
      rows[warp][col] = __int_as_float(v);
    }
  }
  __syncwarp();
  if (lane != 0) return;
  const float* m = rows[warp];

  float A[6][6], V[6][6], rhs[6];
  {
    int e = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int bb = a; bb < 6; ++bb) {
        A[a][bb] = m[e];
        A[bb][a] = m[e];
        ++e;
      }
      rhs[a] = -m[21 + a];
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int bb = 0; bb < 6; ++bb) V[a][bb] = a == bb ? 1.f : 0.f;
  }
  for (int sweep = 0; sweep < 4; ++sweep) {
    jacobi_round<0, 5, 1, 4, 2, 3>(A, V);
    jacobi_round<0, 4, 3, 5, 1, 2>(A, V);
    jacobi_round<0, 3, 2, 4, 1, 5>(A, V);
    jacobi_round<0, 2, 1, 3, 4, 5>(A, V);
    jacobi_round<0, 1, 2, 5, 3, 4>(A, V);
  }

  float mx = fabsf(A[0][0]);
#pragma unroll
  for (int a = 1; a < 6; ++a) mx = nan_max(mx, fabsf(A[a][a]));
  const float tol = (mx * 6.f) * 1e-7f;
  float z[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float y = 0.f;
#pragma unroll
    for (int r = 0; r < 6; ++r) y += V[r][a] * rhs[r];
    const float w = A[a][a];
    const float winv = w > tol ? 1.f / w : 0.f;
    z[a] = winv * y;
  }
  float x[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    float v = 0.f;
#pragma unroll
    for (int a = 0; a < 6; ++a) v += V[r][a] * z[a];
    x[r] = v;
  }

  // se3.rodrigues: R = I + a K + b K^2, K the cross matrix of x[0:3]
  const float wx = x[0], wy = x[1], wz = x[2];
  const float theta2 = (wx * wx + wy * wy) + wz * wz;
  const float theta = sqrtf(theta2 + 1e-30f);
  const bool small = theta < 1e-6f;
  const float ca = small ? 1.f - theta2 / 6.f : sinf(theta) / theta;
  const float cb = small ? 0.5f - theta2 / 24.f : (1.f - cosf(theta)) / theta2;
  const float K[3][3] = {{0.f, -wz, wy}, {wz, 0.f, -wx}, {-wy, wx, 0.f}};
  float* o = out + (size_t)b * 16;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int col = 0; col < 3; ++col) {
      const float k2 = (K[r][0] * K[0][col] + K[r][1] * K[1][col]) + K[r][2] * K[2][col];
      o[4 * r + col] = ((r == col ? 1.f : 0.f) + ca * K[r][col]) + cb * k2;
    }
    o[4 * r + 3] = x[3 + r];
  }
  o[12] = 0.f;
  o[13] = 0.f;
  o[14] = 0.f;
  o[15] = 1.f;

  const int valid = __float_as_int(m[kSums]);
  const int rows_masked = __float_as_int(m[kSums + 3]);
  const long long kc = (long long)k * rows_masked;
  const float denom = (float)(kc > 1 ? kc : 1);
  float* st = out + (size_t)16 * B + b;
  st[0] = m[kResidual];
  st[B] = (float)valid / denom;
  st[2 * B] = m[kWeightSum] / denom;
  st[3 * B] = m[kSums + 1];
  st[4 * B] = m[kSums + 2];
}

}  // namespace

extern "C" {

int pm_plane_block_points() { return kBlockPoints; }
int pm_plane_row() { return kRow; }
int pm_plane_out() { return kOut; }

// pts [B, n, 3], mask [B, n] bytes, dists, ids (int32), weights [B, n, k];
// ref, nrm [M, 3] (ref_stride 0) or [B, M, 3] (ref_stride M); part scratch of
// [B, nblk, kRow] floats with nblk = max(1, ceil(n / kBlockPoints)); out of
// kOut * B floats (T [B, 16], then the statistics' five rows of B). Two
// launches: the moments, then the solve.
int pm_point_to_plane(const float* pts, const uint8_t* mask, int B, int n, int k,
                      const float* dists, const int* ids, const float* weights,
                      const float* ref, const float* nrm, long long ref_stride,
                      int nblk, float* part, float* out, void* stream) {
  if (B == 0) return cudaSuccess;
  if (k < 1 || nblk < 1 || (long long)nblk * kBlockPoints < n)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  plane_moments<<<dim3((unsigned)nblk, (unsigned)B), kThreads, 0, st>>>(
      pts, mask, n, k, dists, ids, weights, ref, nrm, ref_stride, nblk, part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  plane_solve<<<(unsigned)((B + kSolveWarps - 1) / kSolveWarps), 32 * kSolveWarps, 0,
                st>>>(part, nblk, B, k, out);
  return cudaGetLastError();
}

const char* pm_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
