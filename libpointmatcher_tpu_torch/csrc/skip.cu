// The v1 skip route's kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by libpointmatcher_tpu_torch/ops/skip_cuda.py.
//
// They replace the TPU kernels of libpointmatcher_tpu/ops/knn_skip.py:
//   K10  approx_chunks + approx_min  <- _bound_kernel    (knn_skip.py:270, approx_min_sorted)
//   K11  nn1_skip_sweep + nn1_skip_merge
//                                    <- _nn1_skip_kernel (knn_skip.py:377, nn1_sorted_skip)
//
// K10, the bound pass. Inputs qa [nq, 8] (per query -2q in columns 0..2, 1 in
// column 3, |q|^2 in column 4) and ra [8, m_pad] (the sorted map: r in rows
// 0..2, |r|^2 in row 3, 1 in row 4; 1e30 in row 3 at invalid and padding
// columns). Output, per query, the minimum over the map's columns of
//   s = (((a0*r0 + a1*r1) + a2*r2) + a3*r3) + a4*r4,
// the expansion form |q|^2 + |r|^2 - 2 q.r folded into one dot product, each
// product and sum rounded in that order (the plain torch version's), with
// explicitly rounded intrinsics: no FMA, no TF32, no library GEMM.
//
// The kernel relies on column 3 of qa being 1 and row 4 of ra being 1, as
// ops/skip.py::augment_queries and ::augmented_ref_table build them (the
// wrapper is only given their tables). Then a3*r3 = r3 and a4*r4 = a4
// exactly, and since rounding is monotone, the minimum over columns of
// RN(t + a4) is RN(min t + a4) with
//   t = RN(RN(RN(RN(a0*r0) + RN(a1*r1)) + RN(a2*r2)) + r3):
// 3 products, 3 sums and an fminf a (query, column) pair, a4 added once at
// the end. The TPU kernel computes every pair on the MXU; the H100 has no
// fp32 tensor core (and TF32 is not exact), so a brute-force K10 is bound by
// the fp32 issue rate. This one prunes instead, exactly.
//
// The pruned sweep. A warp owns 32 consecutive (Morton-sorted, so mostly
// nearby) queries, a query a lane. The map is cut into 128-column chunks,
// and approx_chunks (one warp a chunk, in the same wrapper call) tabulates
// per chunk: the box [lo, hi] of its valid columns (exact min and max, +inf
// and -inf if none), rho >= |r| over them, e2 = kErr * rho^2, and cap =
// 2^95 if the chunk holds an invalid or padding column (+inf if not). The
// warp finds the chunk whose centre lies nearest its queries' box (as K2
// does, csrc/sweep.cu) and visits chunks outward from it: c, c+1, c-1, c+2,
// c-2, ..., 32 at a time. First a box test, a chunk a lane: the bound below
// evaluated at the gap between the warp's box and the chunk's, against the
// largest limit and best of the warp's lanes at the batch's start; then,
// for each chunk that passes, in order, each lane tests its own query:
// skip = L > lim and best <= cap, L a lower bound on t over the chunk's
// valid columns, lim an upper bound on the query's running best plus the
// bound's error. A ballot sweeps the chunk if any lane fails the test. The
// lanes load the chunk's rows 0..3 four columns each (coalesced, through
// L1/L2). If at most kFew lanes need it, which is most chunks (a warp's
// queries need different chunks near their own neighbours; the masked rows
// that the Morton order puts last are scattered over the whole map), the
// warp forms t for one needing query at a time, four columns a lane, and
// reduces with shuffles: p needing lanes cost ~40 instructions each
// against ~1 000 for a sweep by all. Otherwise the columns go to the warp's
// own shared buffer (__syncwarp, no block-wide barrier) and every lane
// sweeps all 128 (lane by lane only, the kernel took 0.240-0.245 ms
// against 0.198-0.202 at the v1 + bound batch's recorded steps on an H100
// 80GB HBM3 at 700 W, tools_torch/skip_micro.py; PERF.md). fminf is exact and order-free, so skipping a chunk that
// provably holds no t <= the running best (and leaving a lane that does not
// need a chunk out of it) leaves every bit of the result unchanged (K2's
// pass-1 argument, csrc/sweep.cu). The box test is each lane's test at the
// batch's start taken at values no smaller than the lane's (the box's gap
// is at most each query's, each rounded step monotone), so a chunk it skips
// holds no t at or under any lane's best at the batch's start, nor under
// its later best, which only falls.
//
// The lemma. Let u = 2^-24, gamma_n = n u / (1 - n u). For a valid column r
// (row 3 R = fl32(|r|^2 summed in float64), so |R - |r|^2| <= u' |r|^2 with
// u' = u (1 + 2^-28)), t is a 4-term dot product with rounded products, so
// |t - (R - 2 q.r)| <= gamma_4 (2 |q||r| + R) (Cauchy-Schwarz). With
// R - 2 q.r = D - |q|^2 + (R - |r|^2), D = |q - r|^2 >= g^2 (g the distance
// from q to the chunk's box), |r| <= rho and R <= rho^2:
//   t >= g^2 - |q|^2 - E,  E = gamma_4 (2 |q| rho + rho^2) + u' rho^2
//                              <= 5.0000003 u (2 |q| rho + rho^2).
// An invalid or padding column has R >= 2^96; with every coordinate below
// 2^40, t >= R (1 - gamma_4) - 2 |q||r| (1 + gamma_4) > 2^95 = cap, so it
// cannot go under a running best <= cap. Underflow adds at most a few
// 2^-149 to any of these; kAbs = 2^-100 covers it.
//
// The fp32 evaluation errs only downward on L and upward on lim (u = 2^-24;
// kUp = 1 + 2^-20 = 1 + 16u, kDn = 1 - 16u; all steps RN):
//   table: rho = RN(RN(sqrt(RN(P kUp))) kUp) >= |r|, P the largest R of a
//     valid column, since RN(P kUp) >= R (1 + 14.9u) >= |r|^2; e2 =
//     RN(kErr RN(rho^2)); kErr = 40u, a factor 8 over E's 5u, as the JAX
//     package keeps C = 8 on K10's own error.
//   query (q = -0.5 a, exact): Qu = RN(RN((q0^2 + q1^2) + q2^2) kUp) >=
//     |q|^2 (1 + 11.9u); qn = RN(RN(sqrt(Qu)) kUp) >= |q|; qk = RN(kErr 2qn).
//   lower bound: g_i = fmaxf(RN(lo_i - q_i), RN(q_i - hi_i), 0) <=
//     (1 + u) times the exact axis gap, G = RN((g0^2 + g1^2) + g2^2) <=
//     g^2 (1 + 5.0001u), L = RN(G kDn) <= g^2 (1 - 9.9u) <= g^2.
//   limit: H = RN(RN(best + Qu) + RN(RN(kSlack RN(|best| + Qu)) + kAbs))
//     >= best + |q|^2 + 13.99u S + 0.99 kAbs, S = |best| + Qu, kSlack =
//     2^-20; Ec = RN(RN(qk rho) + e2) >= 7.99 E; lim = RN(H + Ec) >= best +
//     |q|^2 + E + 0.98 kAbs, its own rounding (u |H + Ec| <= u S (1 + 18u)
//     + u Ec) paid from the 13.99u S and Ec's factor.
//   So L > lim gives g^2 > best + |q|^2 + E, and every valid column's t >=
//   g^2 - |q|^2 - E > best: fminf keeps best. Safe ranges, checked, not
//   assumed: a query with a coordinate not below 2^40 in magnitude (or NaN)
//   has lim = +inf, and a chunk with such a column, or a row 3 that is
//   neither in [0, 2^96) nor >= 2^96, has e2 = +inf: neither ever skips.
//   A chunk without a valid column has L = +inf; one without an invalid
//   column has cap = +inf.
// Bound: the pruned work, counted at the inputs by the CPU emulation
// (tests/torch_skip_emulation.py::emulate_k10, which takes every decision
// with the same rounded operations): ~23 fp32 operations a (warp, chunk)
// box test and a (query, chunk) lane test, 7 a (query, column) pair that a
// lane failing its own test needs (the pairs a sweep by all lanes forms
// for the others are the kernel's choice and not counted), against the
// bytes of qa, ra and the chunk table. A warp's
// visits are sequential, so its time follows its latency as well.
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
// below 8x headroom. The pruned kernel returns the same bits as the brute
// force, so none of this changes.
//
// K11, the predicated exact sweep, on the schedule of K3/K4
// (csrc/sweep.cu::survivor_sweep + survivor_merge). Inputs qs [B, n, 3]
// Morton-sorted queries and qm [B, n] their validity (one byte each), rt
// [8, m_pad] the sorted map (rows 0..2), rpen [m_pad] (0 valid, +inf invalid
// or padding), skip [B, ni, nsg] int32 flags per (256-query tile, 512-row
// super-chunk). One block per (tile, segment, scan), 128 threads of two
// queries each. The block builds the ordered list of its tile's unskipped
// super-chunks in shared memory (warp ballots and a block prefix count over
// the flag row), read as four 128-row chunks each (the last super-chunk's
// missing chunks left out), and cuts it into kSegments segments of
// ceil(len / kSegments) chunks over gridDim.y: a long list spreads over
// several SMs, and the block scheduler gets kSegments times more, smaller
// units to balance. Rows 0..2 of rt and rpen of a chunk are four coalesced
// 512-byte loads, one float4 a thread, held in registers while the current
// chunk is swept and stored into the other of two shared buffers after, with
// one barrier a chunk. The sweep reads four rows per 16-byte shared load and
// folds each row's penalty into its x (x + 0 = x; x + inf = inf). Each
// segment writes a partial (d2, id) to scratch [kSegments, B, ni * 256], and
// nn1_skip_merge combines them in segment order with a strict '<', masks,
// and writes (d2, id). Bound: 9 fp32 operations per (valid query, valid row
// of an unskipped super-chunk), the fp32 issue rate; the sweep issues 8, a
// compare and two selects.
//
// Exactness: d2 = ((dx*dx + dy*dy) + dz*dz) with dx taken against x + pen,
// explicitly rounded; for a penalty of 0 or +inf (the table's only values)
// that is K1's ((pen + dx*dx) + dy*dy) + dz*dz bit for bit. Within a segment
// chunks are swept in increasing order and rows in increasing order with a
// strict '<', and the segments, which cut the list in order, merge in order
// with a strict '<', so the lowest sorted index wins a tie (the Pallas
// kernel picks by lane, ROADMAP Queue 3 #15). A masked query gets +inf, and
// the id is -1 wherever d2 is not finite.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTileQ = 256;              // queries per K11 tile and flag row
constexpr int kGroup = 4;                // 128-row chunks per super-chunk
constexpr int kChunk = 128;              // map rows (columns) per chunk
constexpr int kRows = 8;
constexpr unsigned kAll = 0xffffffffu;

// K10
constexpr int kBoundThreads = 256;       // 8 warps of 32 queries
constexpr int kTableThreads = 256;       // 8 chunks a block, a warp each
constexpr float kUp = 0x1.00001p+0f;     // 1 + 2^-20
constexpr float kDn = 0x1.ffffep-1f;     // 1 - 2^-20
constexpr float kErr = 0x1.4p-19f;       // 40 u = 5 * 2^-21
constexpr float kSlack = 0x1p-20f;
constexpr float kAbs = 0x1p-100f;
constexpr float kCoordMax = 0x1p+40f;
constexpr float kBigR = 0x1p+96f;        // row 3 at or above: not a valid column
constexpr float kCap = 0x1p+95f;         // t of such a column lies above
constexpr int kFew = 16;                 // lanes needing a chunk: one at a time

// K11
constexpr int kNnThreads = 128;          // two queries a thread
constexpr int kSegments = 8;             // list segments per tile
static_assert(2 * kNnThreads == kTileQ, "a K11 block owns one flag row's tile");
static_assert(kNnThreads == kChunk, "one float4 of a chunk's four rows a thread");

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

__device__ __forceinline__ float sum3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(a, b), c);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

// ------------------------------------------------------------------ K10

// The chunk table: one warp a 128-column chunk of ra.
__global__ void __launch_bounds__(kTableThreads)
approx_chunks(const float* __restrict__ ra, int m_pad, int nch,
              float4* __restrict__ tab_lo, float4* __restrict__ tab_hi,
              float* __restrict__ tab_cap) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * (kTableThreads / 32) + (threadIdx.x >> 5);
  if (c >= nch) return;  // the whole warp
  float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  float p = -CUDART_INF_F;
  bool big = false, bad = false;
#pragma unroll
  for (int k = 0; k < kChunk / 32; ++k) {
    const int m = c * kChunk + k * 32 + lane;
    if (m < m_pad) {
      float r[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) r[a] = ra[(int64_t)a * m_pad + m];
      const float r3 = ra[3 * (int64_t)m_pad + m];
      const bool v = r3 >= 0.0f && r3 < kBigR;
      const bool b = r3 >= kBigR;
      bad |= !(fabsf(r[0]) < kCoordMax && fabsf(r[1]) < kCoordMax &&
               fabsf(r[2]) < kCoordMax) || !(v || b);
      big |= b;
      if (v) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          lo[a] = fminf(lo[a], r[a]);
          hi[a] = fmaxf(hi[a], r[a]);
        }
        p = fmaxf(p, r3);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = warp_min(lo[a]);
    hi[a] = warp_max(hi[a]);
  }
  p = warp_max(p);
  big = __any_sync(kAll, big);
  bad = __any_sync(kAll, bad);
  if (lane == 0) {
    const float rho =
        p >= 0.0f ? __fmul_rn(__fsqrt_rn(__fmul_rn(p, kUp)), kUp) : 0.0f;
    const float e2 = bad ? CUDART_INF_F : __fmul_rn(kErr, sq(rho));
    tab_lo[c] = make_float4(lo[0], lo[1], lo[2], rho);
    tab_hi[c] = make_float4(hi[0], hi[1], hi[2], e2);
    tab_cap[c] = big ? kCap : CUDART_INF_F;
  }
}

// The per-axis distance from [lo, hi] to q as the lower bound rounds it:
// fmaxf(RN(lo - q), RN(q - hi), 0).
__device__ __forceinline__ float axis_gap(float lo, float q, float hi) {
  return fmaxf(fmaxf(__fsub_rn(lo, q), __fsub_rn(q, hi)), 0.0f);
}

// H: an upper bound on best + |q|^2 with slack for the test's last rounding
// (+inf for a query outside the safe range or with no best yet).
__device__ __forceinline__ float best_limit(float best, float qu, bool safe) {
  if (!safe) return CUDART_INF_F;
  return __fadd_rn(__fadd_rn(best, qu),
                   __fadd_rn(__fmul_rn(kSlack, __fadd_rn(fabsf(best), qu)), kAbs));
}

// t of one map column (r0, r1, r2, r3) for the query (a0, a1, a2).
__device__ __forceinline__ float dot_t(float a0, float a1, float a2, float4 r) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a0, r.x), __fmul_rn(a1, r.y)),
                             __fmul_rn(a2, r.z)),
                   r.w);
}

// The chunk at position j of the outward order from nearc: nearc, nearc + 1,
// nearc - 1, nearc + 2, ..., then the side that is left.
__device__ __forceinline__ int outward(int nearc, int j, int nch) {
  const int m = min(nearc, nch - 1 - nearc);
  if (j <= 2 * m) return nearc + ((j & 1) ? (j + 1) >> 1 : -(j >> 1));
  return nearc < nch - 1 - nearc ? nearc + (j - m) : nearc - (j - m);
}

// K10: the expansion-form minimum over the map, pruned per warp and chunk.
__global__ void __launch_bounds__(kBoundThreads)
approx_min(const float* __restrict__ qa, int64_t nq,
           const float* __restrict__ ra, int m_pad, int nch,
           const float4* __restrict__ tab_lo, const float4* __restrict__ tab_hi,
           const float* __restrict__ tab_cap, float* __restrict__ out) {
  __shared__ float4 s_r[kBoundThreads / 32][kChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t w0 = (int64_t)blockIdx.x * kBoundThreads + warp * 32;
  if (w0 >= nq) return;  // the whole warp; no block-wide barrier below
  const int64_t qi = w0 + lane;
  const bool live = qi < nq;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a4 = 0.0f;
  if (live) {
    const float* q = qa + qi * kRows;
    a0 = q[0];
    a1 = q[1];
    a2 = q[2];
    a4 = q[4];
  }
  const float qx = __fmul_rn(a0, -0.5f), qy = __fmul_rn(a1, -0.5f),
              qz = __fmul_rn(a2, -0.5f);
  const bool safe = fabsf(qx) < kCoordMax && fabsf(qy) < kCoordMax &&
                    fabsf(qz) < kCoordMax;
  const float qu = __fmul_rn(sum3(sq(qx), sq(qy), sq(qz)), kUp);
  const float qn = __fmul_rn(__fsqrt_rn(qu), kUp);
  const float qk = __fmul_rn(kErr, __fadd_rn(qn, qn));

  // the box of the live queries; the chunk whose centre lies nearest its
  // centre (both doubled; a chunk without a valid column gives NaN and is
  // never taken)
  const float bxlo = warp_min(live ? qx : CUDART_INF_F);
  const float bxhi = warp_max(live ? qx : -CUDART_INF_F);
  const float bylo = warp_min(live ? qy : CUDART_INF_F);
  const float byhi = warp_max(live ? qy : -CUDART_INF_F);
  const float bzlo = warp_min(live ? qz : CUDART_INF_F);
  const float bzhi = warp_max(live ? qz : -CUDART_INF_F);
  const float qkmax = warp_max(live ? qk : -CUDART_INF_F);
  const float wx = __fadd_rn(bxlo, bxhi), wy = __fadd_rn(bylo, byhi),
              wz = __fadd_rn(bzlo, bzhi);
  float near = CUDART_INF_F;
  int nearc = 0;
  for (int c = lane; c < nch; c += 32) {
    const float4 lo = tab_lo[c], hi = tab_hi[c];
    const float d = sum3(sq(__fsub_rn(__fadd_rn(lo.x, hi.x), wx)),
                         sq(__fsub_rn(__fadd_rn(lo.y, hi.y), wy)),
                         sq(__fsub_rn(__fadd_rn(lo.z, hi.z), wz)));
    if (d < near) {
      near = d;
      nearc = c;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(kAll, near, o);
    const int oc = __shfl_xor_sync(kAll, nearc, o);
    if (od < near || (od == near && oc < nearc)) {
      near = od;
      nearc = oc;
    }
  }

  float4* buf = s_r[warp];
  float best = CUDART_INF_F, lim_best = CUDART_INF_F;
  for (int j0 = 0; j0 < nch; j0 += 32) {
    // the box test, a chunk a lane, against the warp's largest limit and
    // best at the batch's start (larger than each lane's now or later)
    const float hmax = warp_max(live ? lim_best : -CUDART_INF_F);
    const float bmax = warp_max(live ? best : -CUDART_INF_F);
    bool pass = false;
    int c = 0;
    if (j0 + lane < nch) {
      c = outward(nearc, j0 + lane, nch);
      const float4 lo = tab_lo[c], hi = tab_hi[c];
      const float g2 = sum3(sq(fmaxf(fmaxf(__fsub_rn(lo.x, bxhi), __fsub_rn(bxlo, hi.x)), 0.0f)),
                            sq(fmaxf(fmaxf(__fsub_rn(lo.y, byhi), __fsub_rn(bylo, hi.y)), 0.0f)),
                            sq(fmaxf(fmaxf(__fsub_rn(lo.z, bzhi), __fsub_rn(bzlo, hi.z)), 0.0f)));
      const float low = __fmul_rn(g2, kDn);
      const float lim = __fadd_rn(hmax, __fadd_rn(__fmul_rn(qkmax, lo.w), hi.w));
      pass = !(low > lim && bmax <= tab_cap[c]);
    }
    unsigned cand = __ballot_sync(kAll, pass);
    while (cand) {
      const int src = __ffs(cand) - 1;
      cand &= cand - 1;
      const int cc = __shfl_sync(kAll, c, src);
      // each lane's own test against its running best
      const float4 lo = tab_lo[cc], hi = tab_hi[cc];
      const float g2 = sum3(sq(axis_gap(lo.x, qx, hi.x)), sq(axis_gap(lo.y, qy, hi.y)),
                            sq(axis_gap(lo.z, qz, hi.z)));
      const float low = __fmul_rn(g2, kDn);
      const float lim = __fadd_rn(lim_best, __fadd_rn(__fmul_rn(qk, lo.w), hi.w));
      const bool skip = !live || (low > lim && best <= tab_cap[cc]);
      const unsigned need = __ballot_sync(kAll, !skip);
      if (need == 0) continue;
      // columns lane, lane + 32, lane + 64, lane + 96 of the chunk (rows
      // 0..3); a column past the map gives t = +inf
      float4 col[kChunk / 32];
#pragma unroll
      for (int k = 0; k < kChunk / 32; ++k) {
        const int m = cc * kChunk + k * 32 + lane;
        col[k] = m < m_pad
                     ? make_float4(ra[m], ra[(int64_t)m_pad + m],
                                   ra[2 * (int64_t)m_pad + m], ra[3 * (int64_t)m_pad + m])
                     : make_float4(0.0f, 0.0f, 0.0f, CUDART_INF_F);
      }
      if (__popc(need) <= kFew) {
        // few lanes need it: the warp sweeps the chunk for one of them at a
        // time, four columns a lane, and reduces
        unsigned todo = need;
        while (todo) {
          const int q = __ffs(todo) - 1;
          todo &= todo - 1;
          const float b0 = __shfl_sync(kAll, a0, q), b1 = __shfl_sync(kAll, a1, q),
                      b2 = __shfl_sync(kAll, a2, q);
          const float v = warp_min(fminf(fminf(dot_t(b0, b1, b2, col[0]),
                                               dot_t(b0, b1, b2, col[1])),
                                         fminf(dot_t(b0, b1, b2, col[2]),
                                               dot_t(b0, b1, b2, col[3]))));
          if (lane == q) best = fminf(best, v);
        }
      } else {
        // many: stage the chunk in the warp's buffer and sweep it for all;
        // four running minima break fminf's dependency chain (exact:
        // fminf is order-free)
        __syncwarp();  // the previous chunk's reads are done
#pragma unroll
        for (int k = 0; k < kChunk / 32; ++k) buf[k * 32 + lane] = col[k];
        __syncwarp();
        float b0 = best, b1 = CUDART_INF_F, b2 = CUDART_INF_F, b3 = CUDART_INF_F;
#pragma unroll 4
        for (int j = 0; j < kChunk; j += 4) {
          b0 = fminf(b0, dot_t(a0, a1, a2, buf[j]));
          b1 = fminf(b1, dot_t(a0, a1, a2, buf[j + 1]));
          b2 = fminf(b2, dot_t(a0, a1, a2, buf[j + 2]));
          b3 = fminf(b3, dot_t(a0, a1, a2, buf[j + 3]));
        }
        best = fminf(fminf(b0, b1), fminf(b2, b3));
      }
      lim_best = best_limit(best, qu, safe);
    }
  }
  if (live) out[qi] = __fadd_rn(best, a4);
}

// ------------------------------------------------------------------ K11

// The ordered list of the super-chunks whose flag in `flags` is 0 into
// s_list, by warp ballots and a block prefix count; returns its length.
// Every thread of the block calls it.
__device__ __forceinline__ int unskipped_list(const int* __restrict__ flags,
                                              int nsg, int* s_list, int* s_warp) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int count = 0;
  for (int c0 = 0; c0 < nsg; c0 += kNnThreads) {
    const int c = c0 + tid;
    const bool f = c < nsg && flags[c] == 0;
    const unsigned ballot = __ballot_sync(kAll, f);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int off = count, total = 0;
#pragma unroll
    for (int w = 0; w < kNnThreads / 32; ++w) {
      if (w < warp) off += s_warp[w];
      total += s_warp[w];
    }
    if (f) s_list[off + __popc(ballot & ((1u << lane) - 1u))] = c;
    __syncthreads();
    count += total;
  }
  return count;
}

// Fold one map row (x already carrying its penalty) into a query's running
// (min, argmin), d2 in K1's order.
__device__ __forceinline__ void fold_row(float qx, float qy, float qz,
                                         float rx, float ry, float rz, int id,
                                         float& best, int& besti) {
  const float d = __fadd_rn(__fadd_rn(sq(__fsub_rn(qx, rx)), sq(__fsub_rn(qy, ry))),
                            sq(__fsub_rn(qz, rz)));
  if (d < best) {
    best = d;
    besti = id;
  }
}

// K11: exact 1-NN of a tile's 256 queries over one segment of its unskipped
// chunks → the segment's partial (d2, id) in part_[di][seg, B, ni * 256].
// Dynamic shared memory: the list (nsg ints).
__global__ void __launch_bounds__(kNnThreads)
nn1_skip_sweep(const float* __restrict__ qs, int n, const float* __restrict__ rt,
               const float* __restrict__ rpen, int m_pad,
               const int* __restrict__ skip, int ni, int nsg,
               float* __restrict__ part_d, int* __restrict__ part_i) {
  extern __shared__ int s_list[];
  __shared__ float4 s_buf[2][kChunk];  // x, y, z, pen of a chunk: 32 float4 each
  __shared__ int s_warp[kNnThreads / 32];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int64_t b = blockIdx.z;
  const int nsel = unskipped_list(skip + (b * ni + tile) * nsg, nsg, s_list, s_warp);
  // the list in chunks: four a super-chunk, less the last one's missing
  const int nch = m_pad / kChunk;
  int total = nsel * kGroup;
  if (nsel > 0 && s_list[nsel - 1] == nsg - 1) total -= nsg * kGroup - nch;
  const int per = (total + kSegments - 1) / kSegments;
  const int first = blockIdx.y * per;
  const int cnt = max(0, min(total - first, per));

  const int ra_row = tile * kTileQ + tid, rb_row = ra_row + kNnThreads;
  float ax = 0.0f, ay = 0.0f, az = 0.0f, bx = 0.0f, by = 0.0f, bz = 0.0f;
  if (ra_row < n) {
    const float* q = qs + (b * n + ra_row) * 3;
    ax = q[0], ay = q[1], az = q[2];
  }
  if (rb_row < n) {
    const float* q = qs + (b * n + rb_row) * 3;
    bx = q[0], by = q[1], bz = q[2];
  }
  float best_a = CUDART_INF_F, best_b = CUDART_INF_F;
  int id_a = -1, id_b = -1;

  // thread t carries float4 (t & 31) of row (t >> 5): x, y, z, pen
  const int row = tid >> 5;
  const float4* src = reinterpret_cast<const float4*>(
                          row < 3 ? rt + (int64_t)row * m_pad : rpen) + (tid & 31);
  auto chunk_at = [&](int p) { return s_list[p / kGroup] * kGroup + p % kGroup; };
  if (cnt > 0) s_buf[0][tid] = src[(int64_t)chunk_at(first) * (kChunk / 4)];
  __syncthreads();
  for (int s = 0; s < cnt; ++s) {
    // the next chunk's load is in flight while this one is swept
    const bool more = s + 1 < cnt;
    float4 next;
    if (more) next = src[(int64_t)chunk_at(first + s + 1) * (kChunk / 4)];
    const float4* sx = s_buf[s & 1];
    const float4* sy = sx + kChunk / 4;
    const float4* sz = sy + kChunk / 4;
    const float4* sp = sz + kChunk / 4;
    const int base = chunk_at(first + s) * kChunk;
#pragma unroll 2
    for (int v = 0; v < kChunk / 4; ++v) {
      const float4 x = sx[v], y = sy[v], z = sz[v], p = sp[v];
      const float x0 = __fadd_rn(x.x, p.x), x1 = __fadd_rn(x.y, p.y);
      const float x2 = __fadd_rn(x.z, p.z), x3 = __fadd_rn(x.w, p.w);
      const int id = base + 4 * v;
      fold_row(ax, ay, az, x0, y.x, z.x, id, best_a, id_a);
      fold_row(bx, by, bz, x0, y.x, z.x, id, best_b, id_b);
      fold_row(ax, ay, az, x1, y.y, z.y, id + 1, best_a, id_a);
      fold_row(bx, by, bz, x1, y.y, z.y, id + 1, best_b, id_b);
      fold_row(ax, ay, az, x2, y.z, z.z, id + 2, best_a, id_a);
      fold_row(bx, by, bz, x2, y.z, z.z, id + 2, best_b, id_b);
      fold_row(ax, ay, az, x3, y.w, z.w, id + 3, best_a, id_a);
      fold_row(bx, by, bz, x3, y.w, z.w, id + 3, best_b, id_b);
    }
    // the other buffer was last read before the previous barrier
    if (more) s_buf[(s + 1) & 1][tid] = next;
    __syncthreads();
  }

  const int64_t slot =
      ((int64_t)blockIdx.y * gridDim.z + b) * ni * kTileQ + (int64_t)tile * kTileQ + tid;
  part_d[slot] = best_a;
  part_i[slot] = id_a;
  part_d[slot + kNnThreads] = best_b;
  part_i[slot + kNnThreads] = id_b;
}

// Merge each query's kSegments partials in segment order with a strict '<'
// (the earliest segment, so the lowest index, on a tie), then mask.
__global__ void __launch_bounds__(256)
nn1_skip_merge(const float* __restrict__ part_d, const int* __restrict__ part_i,
               const uint8_t* __restrict__ qm, int B, int n, int ni,
               float* __restrict__ out_d, int* __restrict__ out_i) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (int64_t)B * n) return;
  const int64_t b = q / n;
  const int64_t stride = (int64_t)B * ni * kTileQ;
  const int64_t p = b * ni * kTileQ + (q - b * n);
  float best = part_d[p];
  int besti = part_i[p];
#pragma unroll
  for (int g = 1; g < kSegments; ++g) {
    const float d = part_d[g * stride + p];
    if (d < best) {
      best = d;
      besti = part_i[g * stride + p];
    }
  }
  const bool valid = qm[q] != 0;
  out_d[q] = valid ? best : CUDART_INF_F;
  out_i[q] = valid && isfinite(best) ? besti : -1;
}

}  // namespace

extern "C" {

int pm_skip_tile() { return kTileQ; }
int pm_skip_group() { return kGroup; }
int pm_skip_segments() { return kSegments; }
int pm_bound_chunk() { return kChunk; }

// qa [nq, 8], ra [8, m_pad]; tab scratch of 9 * ceil(m_pad / 128) floats,
// 16-byte aligned; out [nq]. Two launches: the chunk table, then the sweep.
int pm_approx_min(const float* qa, long long nq, const float* ra, int m_pad,
                  float* tab, float* out, void* stream) {
  if (nq == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int nch = (m_pad + kChunk - 1) / kChunk;
  float4* lo = reinterpret_cast<float4*>(tab);
  float4* hi = lo + nch;
  float* cap = reinterpret_cast<float*>(hi + nch);
  if (nch > 0) {
    const int per = kTableThreads / 32;
    approx_chunks<<<(nch + per - 1) / per, kTableThreads, 0, st>>>(ra, m_pad, nch,
                                                                   lo, hi, cap);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const unsigned blocks = (unsigned)((nq + kBoundThreads - 1) / kBoundThreads);
  approx_min<<<blocks, kBoundThreads, 0, st>>>(qa, (int64_t)nq, ra, m_pad, nch,
                                               lo, hi, cap, out);
  return cudaGetLastError();
}

// qs [B, n, 3], qm [B, n] bytes, rt [8, m_pad] and rpen [m_pad] 16-byte
// aligned with m_pad a multiple of 128, skip [B, ni, nsg] with ni = ceil(n /
// 256) and nsg = ceil(m_pad / 512); part_d, part_i scratch of [kSegments, B,
// ni * 256]; out [B, n]. Two launches: the segment sweep, then the merge.
int pm_nn1_skip(const float* qs, const uint8_t* qm, int B, int n,
                const float* rt, const float* rpen, int m_pad, const int* skip,
                int ni, int nsg, float* part_d, int* part_i, float* out_d,
                int* out_i, void* stream) {
  if (B == 0 || n == 0) return cudaSuccess;
  if (m_pad % kChunk || (size_t)nsg * sizeof(int) > 48 * 1024)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)(nsg > 0 ? nsg : 1) * sizeof(int);
  nn1_skip_sweep<<<dim3((unsigned)ni, kSegments, (unsigned)B), kNnThreads, smem, st>>>(
      qs, n, rt, rpen, m_pad, skip, ni, nsg, part_d, part_i);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int64_t total = (int64_t)B * n;
  nn1_skip_merge<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part_d, part_i, qm, B, n, ni, out_d, out_i);
  return cudaGetLastError();
}

const char* pm_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
