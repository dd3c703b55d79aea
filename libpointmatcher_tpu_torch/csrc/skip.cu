// The v1 skip route's kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by libpointmatcher_tpu_torch/ops/skip_cuda.py.
//
// They replace the TPU kernels of libpointmatcher_tpu/ops/knn_skip.py:
//   K10  approx_min  <- _bound_kernel     (knn_skip.py:270, approx_min_sorted)
//   K11  nn1_skip    <- _nn1_skip_kernel  (knn_skip.py:377, nn1_sorted_skip)
//
// K10, the bound pass. Inputs qa [nq, 8] (per query -2q in columns 0..2, 1 in
// column 3, |q|^2 in column 4) and ra [8, m_pad] (the sorted map: r in rows
// 0..2, |r|^2 in row 3, 1 in row 4; 1e30 in row 3 at invalid and padding
// columns). Output, per query, the minimum over the map's columns of
//   s = (((a0*r0 + a1*r1) + a2*r2) + a3*r3) + a4*r4,
// the expansion form |q|^2 + |r|^2 - 2 q.r folded into one dot product. The
// TPU kernel runs it on the MXU; here the five products and four sums are
// explicitly rounded intrinsics in that order (no FMA, no TF32, no library
// GEMM), the order of the plain torch version, so both agree bit for bit.
// Columns 5..7 of qa and rows 5..7 of ra are not read. One block per 512
// queries, 256 threads of two queries each; the map is staged through shared
// memory 1024 columns at a time, each column as a float4 (r0, r1, r2, r3)
// and a float (r4) read by every thread at once. Bound: 10 fp32 operations
// per (query, map column) on 20 bytes per query and per column, so it is
// bound by the fp32 issue rate; two queries per thread halve the shared-memory
// reads per operation.
//
// Why BOUND_ERR_C = 8 covers K10's error (ops/skip.py::bound_margin). Let u =
// 2^-24 and eps = 2u, q a valid query, D(q, r) = |q - r|^2 exactly, D* the
// true minimum over the map, r* its row. The inputs: a_c = -2 q_c is exact;
// Q = fl((q0^2 + q1^2) + q2^2) (augment_queries) is within 3u |q|^2 of |q|^2;
// R = fl32(|r|^2 summed in float64) (augmented_ref_table) within u |r|^2. To
// first order in u, the three rounded products err by at most 2u |q||r|, and
// the four rounded sums by u times their partial sums: 2|q||r| twice,
// |R - 2q.r| = |D - |q|^2| <= D + |q|^2, then D. So for every column
//   |s - D| <= E(r) = u (6 |q||r| + |r|^2 + 4 |q|^2 + 2 D)
//               <= u (7 |q|^2 + 4 |r|^2 + 2 D).
// K10's minimum amin = s(r_a) for some row r_a, and amin <= s(r*) <= D* +
// E(r*), so D(q, r_a) <= D* + E(r*) + E(r_a) = D* + O(u). With |r_a|^2 <=
// (|q| + sqrt(D(q, r_a)))^2 <= 2|q|^2 + 2 D(q, r_a) (the JAX package's step),
//   D* - amin <= D(q, r_a) - s(r_a) <= E(r_a) <= u (15 |q|^2 + 10 D*).
// The margin is C eps (8 (Q + max(amin, 0)) + 1e-6) >= 16 C u (|q|^2 + D*)
// to first order (Q >= |q|^2 (1 - 3u), amin >= D* - E). It covers the error
// for C >= 15/16; C = 8, the JAX package's value, keeps a factor 16C/15 = 8.5
// on the |q|^2 term and 12.8 on the D* term, which also absorbs the rounding
// of amin + margin and of the skip test's gap sum. The JAX value stands.
// chip_smoke.py measures the effective C, max (D* - amin) / (eps (8 (Q +
// max(amin, 0)) + 1e-6)) over the valid queries of scene data, and fails
// below 8x headroom.
//
// K11, the predicated exact sweep. Inputs qs [B, n, 3] Morton-sorted queries
// and qm [B, n] their validity (one byte each), rt [8, m_pad] the sorted map
// (rows 0..2), rpen [m_pad] (0 valid, +inf invalid or padding), skip [B, ni,
// nsg] int32 flags per (256-query tile, 512-row super-chunk). One block per
// (tile, scan), one thread per query: the block walks the super-chunks in
// increasing order and, for each one its tile does not skip (a flag the
// whole block shares, so no thread diverges), stages its rows as float4 (x,
// y, z, pen) in shared memory and folds them into each query's running
// (min, argmin). The TPU kernel predicates each super-chunk with pl.when on
// an SMEM flag; here the block's loop simply passes over it. Bound: 9 fp32
// operations per (valid query, valid row of an unskipped super-chunk), so
// the fp32 issue rate; every operand of the inner loop is in registers or a
// broadcast shared-memory read.
//
// Exactness: d2 = ((pen + dx*dx) + dy*dy) + dz*dz with explicitly rounded
// intrinsics, K1's order, so K11's d2 equals K1's and its plain version's.
// Rows are visited in increasing sorted index with a strict '<', so the
// lowest index wins a tie; the Pallas kernel picks by lane (ROADMAP Queue 3
// #15). A masked query gets +inf, and the id is -1 wherever d2 is not finite.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTileQ = 256;              // queries per K11 block and flag row
constexpr int kGroup = 4;                // 128-row chunks per super-chunk
constexpr int kSuper = 128 * kGroup;     // map rows per skip flag
constexpr int kRows = 8;

constexpr int kBoundThreads = 256;
constexpr int kBoundPerThread = 2;       // queries per K10 thread
constexpr int kBoundBlock = kBoundThreads * kBoundPerThread;
constexpr int kBoundStage = 1024;        // map columns per K10 stage

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

// K10: the approximate minimum of the augmented dot product over the map.
__global__ void __launch_bounds__(kBoundThreads)
approx_min(const float* __restrict__ qa, int64_t nq,
           const float* __restrict__ ra, int m_pad, float* __restrict__ out) {
  __shared__ float4 s_r[kBoundStage];
  __shared__ float s_r4[kBoundStage];
  const int tid = threadIdx.x;
  float a[kBoundPerThread][5], best[kBoundPerThread];
#pragma unroll
  for (int j = 0; j < kBoundPerThread; ++j) {
    const int64_t qi = (int64_t)blockIdx.x * kBoundBlock + tid + j * kBoundThreads;
#pragma unroll
    for (int c = 0; c < 5; ++c) a[j][c] = qi < nq ? qa[qi * kRows + c] : 0.0f;
    best[j] = CUDART_INF_F;
  }
  for (int m0 = 0; m0 < m_pad; m0 += kBoundStage) {
    const int cnt = min(kBoundStage, m_pad - m0);
    __syncthreads();
    for (int l = tid; l < cnt; l += kBoundThreads) {
      const int m = m0 + l;
      s_r[l] = make_float4(ra[m], ra[(int64_t)m_pad + m],
                           ra[2 * (int64_t)m_pad + m], ra[3 * (int64_t)m_pad + m]);
      s_r4[l] = ra[4 * (int64_t)m_pad + m];
    }
    __syncthreads();
#pragma unroll 4
    for (int l = 0; l < cnt; ++l) {
      const float4 r = s_r[l];
      const float r4 = s_r4[l];
#pragma unroll
      for (int j = 0; j < kBoundPerThread; ++j) {
        float s = __fmul_rn(a[j][0], r.x);
        s = __fadd_rn(s, __fmul_rn(a[j][1], r.y));
        s = __fadd_rn(s, __fmul_rn(a[j][2], r.z));
        s = __fadd_rn(s, __fmul_rn(a[j][3], r.w));
        s = __fadd_rn(s, __fmul_rn(a[j][4], r4));
        best[j] = fminf(best[j], s);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kBoundPerThread; ++j) {
    const int64_t qi = (int64_t)blockIdx.x * kBoundBlock + tid + j * kBoundThreads;
    if (qi < nq) out[qi] = best[j];
  }
}

// K11: exact 1-NN over the super-chunks a tile does not skip.
__global__ void __launch_bounds__(kTileQ)
nn1_skip(const float* __restrict__ qs, const uint8_t* __restrict__ qm, int n,
         const float* __restrict__ rt, const float* __restrict__ rpen,
         int m_pad, const int* __restrict__ skip, int ni, int nsg,
         float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float4 s_r[kSuper];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int row = tile * kTileQ + tid;
  const bool live = row < n;
  const int64_t qi = b * n + row;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (live) {
    qx = qs[qi * 3];
    qy = qs[qi * 3 + 1];
    qz = qs[qi * 3 + 2];
  }
  const int* flags = skip + (b * ni + tile) * nsg;
  float best = CUDART_INF_F;
  int besti = -1;
  for (int sg = 0; sg < nsg; ++sg) {
    if (flags[sg] != 0) continue;       // the same for every thread
    const int base = sg * kSuper;
    const int cnt = min(kSuper, m_pad - base);
    __syncthreads();                    // the previous stage is consumed
    for (int l = tid; l < cnt; l += kTileQ) {
      const int m = base + l;
      s_r[l] = make_float4(rt[m], rt[(int64_t)m_pad + m],
                           rt[2 * (int64_t)m_pad + m], rpen[m]);
    }
    __syncthreads();
#pragma unroll 8
    for (int l = 0; l < cnt; ++l) {
      const float4 r = s_r[l];
      const float d = __fadd_rn(
          __fadd_rn(__fadd_rn(r.w, sq(__fsub_rn(qx, r.x))),
                    sq(__fsub_rn(qy, r.y))),
          sq(__fsub_rn(qz, r.z)));
      if (d < best) {
        best = d;
        besti = base + l;
      }
    }
  }
  if (live) {
    const bool valid = qm[qi] != 0;
    out_d[qi] = valid ? best : CUDART_INF_F;
    out_i[qi] = valid && isfinite(best) ? besti : -1;
  }
}

}  // namespace

extern "C" {

int pm_skip_tile() { return kTileQ; }
int pm_skip_group() { return kGroup; }

// qa [nq, 8], ra [8, m_pad]; out [nq].
int pm_approx_min(const float* qa, long long nq, const float* ra, int m_pad,
                  float* out, void* stream) {
  if (nq == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((nq + kBoundBlock - 1) / kBoundBlock);
  approx_min<<<blocks, kBoundThreads, 0, (cudaStream_t)stream>>>(
      qa, (int64_t)nq, ra, m_pad, out);
  return cudaGetLastError();
}

// qs [B, n, 3], qm [B, n] bytes, rt [8, m_pad], rpen [m_pad], skip [B, ni,
// nsg] with ni = ceil(n / 256) and nsg = ceil(m_pad / 512); out [B, n].
int pm_nn1_skip(const float* qs, const uint8_t* qm, int B, int n,
                const float* rt, const float* rpen, int m_pad, const int* skip,
                int ni, int nsg, float* out_d, int* out_i, void* stream) {
  if (B == 0 || n == 0) return cudaSuccess;
  const dim3 grid((unsigned)ni, (unsigned)B);
  nn1_skip<<<grid, kTileQ, 0, (cudaStream_t)stream>>>(
      qs, qm, n, rt, rpen, m_pad, skip, ni, nsg, out_d, out_i);
  return cudaGetLastError();
}

const char* pm_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
