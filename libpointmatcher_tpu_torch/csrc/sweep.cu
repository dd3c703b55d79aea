// Survivor-sweep kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by libpointmatcher_tpu_torch/ops/sweep_cuda.py.
//
// They replace the TPU kernels of libpointmatcher_tpu/ops/knn_sweep2.py:
//   K2  survivors_bounds      <- _bounds_kernel        (knn_sweep2.py:132, survivors_and_bounds)
//   K3  survivor_sweep + survivor_merge <- _sweep_kernel (knn_sweep2.py:242, nn1_survivor_sweep)
//   K4  the same two         <- _sweep_stream_kernel  (knn_sweep2.py:482, nn1_survivor_sweep_stream)
//   K6  survivor_sweep_k<K> + survivor_merge_k<K>
//                            <- _sweepk_kernel        (knn_sweep2.py:349, nnk_survivor_sweep)
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
// K2 computes, per query, U = min(col 4, min over chunks c of cand_c(q)),
// cand_c(q) = (sqrt(|q - ctr_c|^2) + rad_c) * UP + add_c, ctr and rad the
// box's centre and half-diagonal, add_c = 1e15 where k > 1 and the chunk
// holds fewer than k valid rows (else 0); and per 256-query tile the flag
// of chunk c: any query with lhs_c(q) = gap_c(q)^2 * DOWN + pen <= U^2 * UP,
// gap the distance from q to the box. UP and DOWN are float32(1 -+ 4e-7).
// The old kernel evaluated both formulas for every (query, chunk) pair; on a
// warm iteration 86-89% of the (tile, chunk) pairs decide nothing. The
// redesign evaluates fewer pairs. One block per tile, one thread per query,
// no chunk staging: a warp takes 32 chunks at a time, one a lane, read from
// ct (coalesced; ct is a few KB and stays in L1) with the lane computing the
// chunk's terms; a warp-uniform prefilter decides per (warp, chunk) whether
// any of the warp's 32 Morton-consecutive queries could be changed by it;
// a ballot collects the chunks that pass, and for each of them, its terms
// shuffled from its lane, every query evaluates the old per-query formula.
//
// Both passes are order-free: pass 1 is an fminf over chunks (exact,
// commutative, associative), pass 2 an OR per chunk. So any visiting order
// gives the same bits, and so does skipping a pair that provably cannot
// change the result.
//
// The prefilter needs no margin. Every step of both formulas is a rounded
// IEEE operation (_rn intrinsics) or fmaxf, and each is monotone
// non-decreasing in its operands' magnitudes as used: RN(a - b) in a, and
// -RN(a - b) = RN(b - a) in b; RN(x*x) in |x|; RN(a + b), RN(a * UP),
// RN(sqrt(a)) and fmaxf in each operand. Take the warp's box [Blo, Bhi]
// (per axis the min and max of its queries' coordinates). Pass 1: for q in
// the box, |RN(q_i - ctr_i)| >= e_i = fmaxf(RN(Blo_i - ctr_i),
// RN(ctr_i - Bhi_i), 0) (if ctr_i < Blo_i the first term, if ctr_i > Bhi_i
// the second, else 0 <= anything), so the same rounded chain fed e_i gives
// low_c <= cand_c(q) for every query of the warp. If low_c >= Umax, the
// largest U among the warp's queries at that point, then cand_c(q) >= U(q)
// and fminf keeps U(q): the chunk is skipped. Pass 2: likewise
// g_i = fmaxf(RN(lo_i - Bhi_i), RN(Blo_i - hi_i), 0) <= the query's
// fmaxf(RN(lo_i - q_i), RN(q_i - hi_i), 0), over the box of the warp's
// queries with pen 0, so low_c = RN(RN(g^2 ...) * DOWN) <= lhs_c(q) for them,
// and none of them flags the chunk if low_c > their largest U^2 * UP; a
// query with pen != 0 (padding, invalid) has lhs_c(q) >= RN(0 + pen) = pen,
// so none of those flags it if their smallest pen > their largest U^2 * UP
// (the two groups are kept apart: padding rows' U, from the origin, is
// large). So skipping is exact at equality, with no margin, because the
// bound is the kernel's own formula evaluated at the box's nearest corner,
// not an estimate of it.
// NaN: a U that is NaN counts as +inf in Umax, so no skip rests on it; a
// NaN low_c fails both tests and the pair is evaluated.
//
// An exact per-query skip of the square root in pass 1: __fmaf_rn(-U, U,
// dc2) rounds dc2 - U^2 once, and a rounding keeps the sign of a nonzero
// value, so the result is > 0 only if dc2 > U^2 exactly ('> 0', not '>= 0':
// a tiny negative value may round to -0, which compares equal to 0). Then
// RN(sqrt(dc2)) >= RN(sqrt(U^2)) = U for U >= 0, rad >= 0, UP > 1 and
// add >= 0, so cand >= U and fminf keeps U. U = +inf gives -inf: no skip.
//
// Cold iterations have col 4 = +inf, so nothing prunes until U falls. Each
// warp therefore finds the chunk whose centre lies nearest its box's
// centre (one scan over ct, a chunk a lane, and a warp argmin), and visits
// the chunks in ring order from 16 before it: the first 32-chunk batch
// holds the nearby chunks, which set every U, and the later batches prune.
// Pass 2 is chunk-parallel within the block: each warp publishes its box
// and maxima in shared memory, then warp w takes the 32-chunk batches w,
// w + 8, ... and tests each batch against all 8 query warps of the tile,
// in order, the query warp's 32 queries read from shared memory for the
// chunks that pass; a chunk already flagged is not evaluated again, and the
// batch's 32 flags are written at once. So the block's pass-2 time follows
// the whole tile's work, not its heaviest warp's: a warp whose queries jump
// across the map in Morton order passes most chunks, and since all blocks
// are resident at once, such a warp sweeping alone would set the kernel's
// time.
// Bound: at the serving shapes the old kernel did ~33 fp32 operations a
// (query, chunk) pair, so it was bound by the issue rate. The pruned work is
// the prefilter's test of every (warp, chunk) pair (~20 operations a pass,
// one lane's) and the per-query formula (13 or 20) on the pairs that pass,
// a few per cent: so little that reading the query table and writing the
// flags (bytes) set the least time, and the kernel's fixed cost and its
// heaviest tile set its time.
//
// K3/K4 share one schedule: the TPU's resident/streaming split follows VMEM,
// while on the card both maps (at most 4 MB) read through the 50 MB L2. A
// block owns 256 queries, K2's own tile, and reads the flag row of its tile
// directly: each query sweeps only its own tile's survivors (flags given per
// 1024 queries, the TPU's fold, are read by the four blocks of the tile).
// 128 threads take two queries each. The block builds its ordered survivor
// list in shared memory (warp ballots and a block prefix count over the
// flags, in place of the TPU kernel's scalar-core loop). A list's length
// follows the map's density around the tile (at the serving shapes, warm:
// mean ~40 chunks, the longest 2-3x that), so each list is cut into
// kSegments segments of ceil(len / kSegments) chunks over gridDim.y: every
// segment block writes a partial (d2, id), and survivor_merge combines them
// in segment order with a strict '<'. That spreads a long list over several
// SMs and gives the block scheduler kSegments times more, smaller units to
// balance (on the H100 at the serving inputs: 1 segment 0.60 ms, 2 0.49,
// 4 0.43, 8 0.42).
// Rows 0..3 of a chunk (x, y, z, pen: 2 KB, contiguous in rt3) are 128
// float4s, one a thread: each thread loads its float4 of the next chunk
// before sweeping the current one and stores it into the other of two
// buffers after, with one __syncthreads a chunk. The chunk reads from L2 and
// arrives inside one chunk's sweep; a 4-stage cp.async.bulk ring on
// mbarriers was 3-4% slower on the H100. The sweep reads four rows per
// 16-byte shared load and folds each row's penalty into its x (x + 0 = x;
// x + inf = inf, so d2 = +inf exactly where K1's pen + dx*dx gives +inf),
// leaving 8 fp32 operations, a compare and two selects per (query, row):
// the kernel is bound by the issue rate over the surviving pairs, ~2.4x the
// 9-operation fp32 bound at best.
//
// K6, the top-K sweep (K = 2..4) of the knn > 1 route, runs K3/K4's
// schedule: K2's own 256-query flag rows, one a block, 128
// threads of two queries, the list cut into kSegments segments, rows 0..3
// of the next chunk held in registers while the current one is swept, one
// barrier a chunk, x + pen folded at the shared read. Each query keeps a
// sorted K-slot list in registers (one instance per K, so no list goes to
// local memory) and folds each group of 8 rows with fminf against its K-th
// distance; only a group under it is inserted, row by row in increasing
// index, with a strict '<' (K5's list, csrc/knn.cu). Each segment writes its
// lists to scratch [kSegments, n_pad, K], and survivor_merge_k merges them
// per query in segment order. Its work is a 1-NN sweep's plus the rare
// insertions, so it is bound by the fp32 issue rate over the survivors too.
//
// Exactness: K2 forms every quantity with explicitly rounded intrinsics in
// the order of the plain torch version (ops/sweep_cuda.py), so nvcc cannot
// contract an FMA into it and the flags are the same bit for bit. K3/K4 and
// K6 form d2 = (dx*dx + dy*dy) + dz*dz with dx taken against x + pen; for a
// penalty of 0 or +inf (the table's only values) that is K1's ((pen + dx*dx)
// + dy*dy) + dz*dz bit for bit, 0 + dx*dx being dx*dx. Within a segment
// survivors are swept in increasing chunk order and rows in increasing order
// with a strict '<', and the segments, which cut the list in order, merge in
// order with a strict '<', so the lowest sorted-map index wins a tie. A
// query whose tile has no survivor, or whose minimum stays +inf, gets
// (+inf, 0); the caller masks it. K6: within a segment a row enters the list
// only with a strict '<' and rows arrive in increasing index, so each
// segment's list is the first K of its rows in (d2, id) order; a skipped
// group holds no row under the K-th distance. Every id of segment s is below
// every id of segment s + 1. The merge inserts segment s + 1's entries in
// their order with a strict '<' (an entry equal to one already held goes
// after it) and stops at the first entry not under the K-th distance, the
// lists being ascending; so the result is the first K of all rows in
// (d2, id) order: the plain version's stable sort, and the Pallas kernel's
// first-minimum extraction. Slots that hold no finite distance give
// (+inf, -1).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBoundTile = 256;    // queries per K2 block and flag row
constexpr int kFoldTile = 1024;    // queries per flag row of the TPU's fold
constexpr int kNnThreads = 128;    // K3/K4/K6 threads a block, two queries each
constexpr int kNnTile = 2 * kNnThreads;                 // 256 = kBoundTile
constexpr int kSegments = 8;       // K3/K4/K6 list segments per tile
constexpr int kChunk = 128;        // map rows per chunk
constexpr int kRows = 8;           // rows of a chunk in rt3
constexpr int kGroup = 8;          // K6 rows per group
constexpr int kStartBefore = 16;   // K2: ring start, chunks before the nearest
constexpr int kWarps = kBoundTile / 32;  // K2: query warps a tile
constexpr int kBoxFloats = 9;      // K2: a query warp's pass-2 box and maxima
constexpr unsigned kAll = 0xffffffffu;
static_assert(kNnTile == kBoundTile, "K3/K4/K6 sweep K2's own tile");
static_assert(kNnThreads == kChunk, "one float4 of a chunk's rows 0..3 a thread");
static_assert(kBoundTile % 32 == 0, "K2 works in whole warps");

constexpr float kUp = 1.0000004f;    // float32(1 + 4e-7)
constexpr float kDown = 0.9999996f;  // float32(1 - 4e-7)
constexpr float kFar = 1.0e15f;

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

// ------------------------------------------------------------------- K2

// A chunk's terms of the bound, formed as the plain version forms them:
// ctr = 0.5 (lo + hi), rad = sqrt(|0.5 (hi - lo)|^2), add = 1e15 where
// k > 1 and the chunk holds fewer than k valid rows.
struct ChunkBound {
  float cx, cy, cz, rad, add;
};

__device__ __forceinline__ ChunkBound chunk_bound(const float* __restrict__ ct,
                                                  int nch_pad, int c, int k) {
  float ctr[3], half2[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo = ct[(int64_t)a * nch_pad + c];
    const float hi = ct[(int64_t)(3 + a) * nch_pad + c];
    ctr[a] = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    half2[a] = sq(__fmul_rn(0.5f, __fsub_rn(hi, lo)));
  }
  ChunkBound b;
  b.cx = ctr[0];
  b.cy = ctr[1];
  b.cz = ctr[2];
  b.rad = __fsqrt_rn(sum3(half2[0], half2[1], half2[2]));
  const float valid = ct[(int64_t)6 * nch_pad + c];
  b.add = (k > 1 && valid < (float)k) ? kFar : 0.0f;
  return b;
}

// cand = (sqrt(d2) + rad) * UP + add, each step rounded (add = 0 is exact)
__device__ __forceinline__ float bound_cand(float d2, float rad, float add) {
  return __fadd_rn(__fmul_rn(__fadd_rn(__fsqrt_rn(d2), rad), kUp), add);
}

// The per-axis distance from [lo, hi] to the point or interval the
// caller names, as the per-query formula rounds it: fmaxf(RN(a - b),
// RN(c - d), 0).
__device__ __forceinline__ float axis_gap(float a, float b, float c, float d) {
  return fmaxf(fmaxf(__fsub_rn(a, b), __fsub_rn(c, d)), 0.0f);
}

// K2: per-query bounds and per-(tile, chunk) survival flags.
__global__ void __launch_bounds__(kBoundTile)
survivors_bounds(const float* __restrict__ qp, const float* __restrict__ ct,
                 int nch, int nch_pad, int k, float* __restrict__ ub_out,
                 int* __restrict__ surv) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t qi = (int64_t)blockIdx.x * kBoundTile + tid;
  const float* q = qp + qi * 8;
  const float qx = q[0], qy = q[1], qz = q[2], pen = q[3];
  float u = q[4];
  int* row = surv + (int64_t)blockIdx.x * nch_pad;
  for (int c = nch + tid; c < nch_pad; c += kBoundTile) row[c] = 0;

  // ---- pass 1: the bound
  const float bxlo = warp_min(qx), bxhi = warp_max(qx);
  const float bylo = warp_min(qy), byhi = warp_max(qy);
  const float bzlo = warp_min(qz), bzhi = warp_max(qz);
  // the chunk whose centre lies nearest the box's centre (both doubled)
  float near = CUDART_INF_F;
  int nearc = 0;
  {
    const float wx = __fadd_rn(bxlo, bxhi), wy = __fadd_rn(bylo, byhi),
                wz = __fadd_rn(bzlo, bzhi);
    for (int c = lane; c < nch; c += 32) {
      const float dx = __fsub_rn(__fadd_rn(ct[c], ct[(int64_t)3 * nch_pad + c]), wx);
      const float dy = __fsub_rn(
          __fadd_rn(ct[(int64_t)nch_pad + c], ct[(int64_t)4 * nch_pad + c]), wy);
      const float dz = __fsub_rn(
          __fadd_rn(ct[(int64_t)2 * nch_pad + c], ct[(int64_t)5 * nch_pad + c]), wz);
      const float d = sum3(sq(dx), sq(dy), sq(dz));
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
  }
  const int start = max(0, min(nearc - kStartBefore, nch - 32));
  for (int j0 = 0; j0 < nch; j0 += 32) {
    const float umax = warp_max(u == u ? u : CUDART_INF_F);
    const int j = j0 + lane;
    int c = start + j;
    if (c >= nch) c -= nch;
    ChunkBound b = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    bool pass = false;
    if (j < nch) {
      b = chunk_bound(ct, nch_pad, c, k);
      const float ex = axis_gap(bxlo, b.cx, b.cx, bxhi);
      const float ey = axis_gap(bylo, b.cy, b.cy, byhi);
      const float ez = axis_gap(bzlo, b.cz, b.cz, bzhi);
      const float low = bound_cand(sum3(sq(ex), sq(ey), sq(ez)), b.rad, b.add);
      pass = !(low >= umax);
    }
    unsigned m = __ballot_sync(kAll, pass);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float cx = __shfl_sync(kAll, b.cx, src);
      const float cy = __shfl_sync(kAll, b.cy, src);
      const float cz = __shfl_sync(kAll, b.cz, src);
      const float rad = __shfl_sync(kAll, b.rad, src);
      const float add = __shfl_sync(kAll, b.add, src);
      const float dc2 = sum3(sq(__fsub_rn(qx, cx)), sq(__fsub_rn(qy, cy)),
                             sq(__fsub_rn(qz, cz)));
      // dc2 > u^2 exactly: the candidate cannot go under u
      if (!(__fmaf_rn(-u, u, dc2) > 0.0f)) u = fminf(u, bound_cand(dc2, rad, add));
    }
  }
  ub_out[qi] = u;

  // ---- pass 2: survival of each chunk for the tile, chunk-parallel: warp
  // w takes the 32-chunk batches w, w + kWarps, ... and tests each against
  // every query warp of the tile, so a query warp that passes many chunks
  // shares its work with the block
  __shared__ float4 s_q[kBoundTile];        // x, y, z, pen
  __shared__ float s_ub2[kBoundTile];
  __shared__ float s_box[kWarps][kBoxFloats];
  const float ub2 = __fmul_rn(sq(u), kUp);
  s_q[tid] = make_float4(qx, qy, qz, pen);
  s_ub2[tid] = ub2;
  {
    // the box of the warp's pen-0 queries and their largest U^2 * UP; the
    // smallest penalty and the largest U^2 * UP of the others
    const bool v0 = pen == 0.0f;
    const float box[kBoxFloats] = {
        warp_min(v0 ? qx : CUDART_INF_F), warp_min(v0 ? qy : CUDART_INF_F),
        warp_min(v0 ? qz : CUDART_INF_F), warp_max(v0 ? qx : -CUDART_INF_F),
        warp_max(v0 ? qy : -CUDART_INF_F), warp_max(v0 ? qz : -CUDART_INF_F),
        warp_max(v0 ? ub2 : -CUDART_INF_F), warp_min(v0 ? CUDART_INF_F : pen),
        warp_max(v0 ? -CUDART_INF_F : ub2)};
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kBoxFloats; ++i) s_box[warp][i] = box[i];
    }
  }
  __syncthreads();
  for (int c0 = warp * 32; c0 < nch; c0 += kBoundTile) {
    const int c = c0 + lane;
    float lo[3] = {0.0f, 0.0f, 0.0f}, hi[3] = {0.0f, 0.0f, 0.0f};
    if (c < nch) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[a] = ct[(int64_t)a * nch_pad + c];
        hi[a] = ct[(int64_t)(3 + a) * nch_pad + c];
      }
    }
    unsigned flags = 0;  // bit l: chunk c0 + l survives
    for (int w = 0; w < kWarps; ++w) {
      const float* b = s_box[w];
      bool pass = false;
      if (c < nch) {
        // an empty pen-0 box (lo = +inf, hi = -inf) gives +inf
        const float gx = axis_gap(lo[0], b[3], b[0], hi[0]);
        const float gy = axis_gap(lo[1], b[4], b[1], hi[1]);
        const float gz = axis_gap(lo[2], b[5], b[2], hi[2]);
        const float low = __fmul_rn(sum3(sq(gx), sq(gy), sq(gz)), kDown);
        pass = !(low > b[6]) || !(b[7] > b[8]);
      }
      unsigned m = __ballot_sync(kAll, pass) & ~flags;
      if (m == 0) continue;
      const float4 mq = s_q[w * 32 + lane];  // query lane of warp w
      const float mub2 = s_ub2[w * 32 + lane];
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const float lx = __shfl_sync(kAll, lo[0], src);
        const float ly = __shfl_sync(kAll, lo[1], src);
        const float lz = __shfl_sync(kAll, lo[2], src);
        const float hx = __shfl_sync(kAll, hi[0], src);
        const float hy = __shfl_sync(kAll, hi[1], src);
        const float hz = __shfl_sync(kAll, hi[2], src);
        const float gap2 = sum3(sq(axis_gap(lx, mq.x, mq.x, hx)),
                                sq(axis_gap(ly, mq.y, mq.y, hy)),
                                sq(axis_gap(lz, mq.z, mq.z, hz)));
        const bool ok = __fadd_rn(__fmul_rn(gap2, kDown), mq.w) <= mub2;
        if (__any_sync(kAll, ok)) flags |= 1u << src;
      }
    }
    if (c < nch) row[c] = (flags >> lane) & 1u;
  }
}

// ---------------------------------------------------------- K3, K4, K6

// The ordered list of the chunks flagged in `flags` (one tile's row of
// surv) into s_list, by warp ballots and a block prefix count; returns its
// length. Every thread of the block, NT of them, calls it.
template <int NT>
__device__ __forceinline__ int survivor_list(const int* __restrict__ flags,
                                             int nch, int* s_list,
                                             int* s_warp) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int count = 0;
  for (int c0 = 0; c0 < nch; c0 += NT) {
    const int c = c0 + tid;
    const bool f = c < nch && flags[c] != 0;
    const unsigned ballot = __ballot_sync(kAll, f);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int off = count, total = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      if (w < warp) off += s_warp[w];
      total += s_warp[w];
    }
    if (f) s_list[off + __popc(ballot & ((1u << lane) - 1u))] = c;
    __syncthreads();
    count += total;
  }
  return count;
}

// One block's segment of its tile's survivor list: [first, first + n).
struct Segment {
  int first, n;
};

__device__ __forceinline__ Segment list_segment(int count) {
  const int per = (count + kSegments - 1) / kSegments;
  const int first = blockIdx.y * per;
  return {first, max(0, min(count - first, per))};
}

// d2 in K1's order against a row whose x carries its penalty.
__device__ __forceinline__ float d2_row(float qx, float qy, float qz, float rx,
                                        float ry, float rz) {
  return __fadd_rn(__fadd_rn(sq(__fsub_rn(qx, rx)), sq(__fsub_rn(qy, ry))),
                   sq(__fsub_rn(qz, rz)));
}

// Fold one map row (x already carrying its penalty) into a query's running
// (min, argmin), d2 in K1's order.
__device__ __forceinline__ void fold_row(float qx, float qy, float qz,
                                         float rx, float ry, float rz, int id,
                                         float& best, int& besti) {
  const float d = d2_row(qx, qy, qz, rx, ry, rz);
  if (d < best) {
    best = d;
    besti = id;
  }
}

// The segment's chunks in list order through two shared buffers of rows
// 0..3: the next chunk's float4 (one a thread) is loaded before sweep(the
// buffer, the chunk's first row) runs on the current one and stored into
// the other buffer after it, with one barrier a chunk. Every thread of the
// block calls it.
template <typename Sweep>
__device__ __forceinline__ void for_each_chunk(const float* __restrict__ rt3,
                                               const int* s_list, Segment seg,
                                               float4 (*s_buf)[kChunk],
                                               Sweep& sweep) {
  const int tid = threadIdx.x;
  // a chunk's rows 0..3 are kChunk float4s, one a thread
  const float4* src = reinterpret_cast<const float4*>(rt3) + tid;
  constexpr int kChunkF4 = kRows * kChunk / 4;
  if (seg.n > 0) s_buf[0][tid] = src[(int64_t)s_list[seg.first] * kChunkF4];
  __syncthreads();
  for (int s = 0; s < seg.n; ++s) {
    // the next chunk's load is in flight while this one is swept
    const bool more = s + 1 < seg.n;
    float4 next;
    if (more) next = src[(int64_t)s_list[seg.first + s + 1] * kChunkF4];
    sweep(s_buf[s & 1], s_list[seg.first + s] * kChunk);
    // the other stage was last read before the previous barrier
    if (more) s_buf[(s + 1) & 1][tid] = next;
    __syncthreads();
  }
}

// K3/K4's two queries: running (min, argmin) over the rows.
struct Nearest2 {
  float ax, ay, az, bx, by, bz;
  float best_a, best_b;
  int id_a, id_b;

  __device__ __forceinline__ void operator()(const float4* sx, int base) {
    const float4* sy = sx + kChunk / 4;
    const float4* sz = sy + kChunk / 4;
    const float4* sp = sz + kChunk / 4;
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
  }
};

// K3 and K4: exact 1-NN of 256 queries over one segment of their tile's
// surviving chunks → the segment's partial (d2, id) in part_[di][seg, n_pad].
// Dynamic shared memory: the list (nch ints).
__global__ void __launch_bounds__(kNnThreads)
survivor_sweep(const float* __restrict__ qp, const float* __restrict__ rt3,
               const int* __restrict__ surv, int nch, int nch_pad,
               int blocks_per_flag_row, int n_pad,
               float* __restrict__ part_d, int* __restrict__ part_i) {
  extern __shared__ int s_list[];
  __shared__ float4 s_buf[2][kChunk];  // rows 0..3 of a chunk, two stages
  __shared__ int s_warp[kNnThreads / 32];
  const int tid = threadIdx.x;
  const int64_t q0 = (int64_t)blockIdx.x * kNnTile + tid;
  const int row = blockIdx.x / blocks_per_flag_row;
  const int count = survivor_list<kNnThreads>(surv + (int64_t)row * nch_pad,
                                              nch, s_list, s_warp);
  const float* qa = qp + q0 * 8;
  const float* qb = qp + (q0 + kNnThreads) * 8;
  Nearest2 nn;
  nn.ax = qa[0], nn.ay = qa[1], nn.az = qa[2];
  nn.bx = qb[0], nn.by = qb[1], nn.bz = qb[2];
  nn.best_a = nn.best_b = CUDART_INF_F;
  nn.id_a = nn.id_b = 0;
  for_each_chunk(rt3, s_list, list_segment(count), s_buf, nn);

  const int64_t out = (int64_t)blockIdx.y * n_pad + q0;
  part_d[out] = nn.best_a;
  part_i[out] = nn.id_a;
  part_d[out + kNnThreads] = nn.best_b;
  part_i[out + kNnThreads] = nn.id_b;
}

// Merge the kSegments partials of each query in segment order with a strict
// '<': the minimum, the earliest segment (so the lowest index) on a tie.
__global__ void __launch_bounds__(256)
survivor_merge(const float* __restrict__ part_d,
               const int* __restrict__ part_i, int n_pad,
               float* __restrict__ out_d, int* __restrict__ out_i) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_pad) return;
  float best = part_d[q];
  int besti = part_i[q];
#pragma unroll
  for (int g = 1; g < kSegments; ++g) {
    const float d = part_d[(int64_t)g * n_pad + q];
    if (d < best) {
      best = d;
      besti = part_i[(int64_t)g * n_pad + q];
    }
  }
  out_d[q] = best;
  out_i[q] = besti;
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

// A group's rows into a query's list: only if the group's minimum is under
// the K-th distance, then row by row in increasing index.
template <int K>
__device__ __forceinline__ void insert_group(float (&bd)[K], int (&bi)[K],
                                             const float (&d)[kGroup], int gid) {
  if (group_min(d) < bd[K - 1]) {  // rare once the list is full
#pragma unroll
    for (int e = 0; e < kGroup; ++e)
      if (d[e] < bd[K - 1]) insert_sorted<K>(bd, bi, d[e], gid + e);
  }
}

// K6's two queries and their sorted lists of K slots.
template <int K>
struct TopK2 {
  float ax, ay, az, bx, by, bz;
  float da[K], db[K];
  int ia[K], ib[K];

  __device__ __forceinline__ void operator()(const float4* sx, int base) {
    const float4* sy = sx + kChunk / 4;
    const float4* sz = sy + kChunk / 4;
    const float4* sp = sz + kChunk / 4;
#pragma unroll 1
    for (int g = 0; g < kChunk / kGroup; ++g) {
      float rx[kGroup], ry[kGroup], rz[kGroup];
#pragma unroll
      for (int h = 0; h < kGroup / 4; ++h) {
        const int v = g * (kGroup / 4) + h;
        const float4 x = sx[v], y = sy[v], z = sz[v], p = sp[v];
        rx[4 * h] = __fadd_rn(x.x, p.x);
        rx[4 * h + 1] = __fadd_rn(x.y, p.y);
        rx[4 * h + 2] = __fadd_rn(x.z, p.z);
        rx[4 * h + 3] = __fadd_rn(x.w, p.w);
        ry[4 * h] = y.x, ry[4 * h + 1] = y.y, ry[4 * h + 2] = y.z, ry[4 * h + 3] = y.w;
        rz[4 * h] = z.x, rz[4 * h + 1] = z.y, rz[4 * h + 2] = z.z, rz[4 * h + 3] = z.w;
      }
      float dA[kGroup], dB[kGroup];
#pragma unroll
      for (int e = 0; e < kGroup; ++e) {
        dA[e] = d2_row(ax, ay, az, rx[e], ry[e], rz[e]);
        dB[e] = d2_row(bx, by, bz, rx[e], ry[e], rz[e]);
      }
      const int gid = base + g * kGroup;
      insert_group<K>(da, ia, dA, gid);
      insert_group<K>(db, ib, dB, gid);
    }
  }
};

// K6: exact top-K (K = 2..4) of 256 queries over one segment of their
// tile's surviving chunks → the segment's sorted lists in
// part_[di][seg, n_pad, K]. Dynamic shared memory: the list (nch ints).
template <int K>
__global__ void __launch_bounds__(kNnThreads)
survivor_sweep_k(const float* __restrict__ qp, const float* __restrict__ rt3,
                 const int* __restrict__ surv, int nch, int nch_pad, int n_pad,
                 float* __restrict__ part_d, int* __restrict__ part_i) {
  extern __shared__ int s_list[];
  __shared__ float4 s_buf[2][kChunk];
  __shared__ int s_warp[kNnThreads / 32];
  const int tid = threadIdx.x;
  const int64_t q0 = (int64_t)blockIdx.x * kNnTile + tid;
  const int count = survivor_list<kNnThreads>(surv + (int64_t)blockIdx.x * nch_pad,
                                              nch, s_list, s_warp);
  const float* qa = qp + q0 * 8;
  const float* qb = qp + (q0 + kNnThreads) * 8;
  TopK2<K> top;
  top.ax = qa[0], top.ay = qa[1], top.az = qa[2];
  top.bx = qb[0], top.by = qb[1], top.bz = qb[2];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    top.da[s] = top.db[s] = CUDART_INF_F;
    top.ia[s] = top.ib[s] = -1;
  }
  for_each_chunk(rt3, s_list, list_segment(count), s_buf, top);

  const int64_t out_a = ((int64_t)blockIdx.y * n_pad + q0) * K;
  const int64_t out_b = out_a + (int64_t)kNnThreads * K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    part_d[out_a + s] = top.da[s];
    part_i[out_a + s] = top.ia[s];
    part_d[out_b + s] = top.db[s];
    part_i[out_b + s] = top.ib[s];
  }
}

// Merge the kSegments sorted lists of each query in segment order: a later
// segment's entry goes in only under the K-th distance and after any equal
// entry (strict '<'); the first that does not ends that segment's list.
template <int K>
__global__ void __launch_bounds__(256)
survivor_merge_k(const float* __restrict__ part_d,
                 const int* __restrict__ part_i, int n_pad,
                 float* __restrict__ out_d, int* __restrict__ out_i) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_pad) return;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = part_d[q * K + s];
    bi[s] = part_i[q * K + s];
  }
  for (int g = 1; g < kSegments; ++g) {
    const int64_t base = ((int64_t)g * n_pad + q) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const float d = part_d[base + s];
      if (!(d < bd[K - 1])) break;
      insert_sorted<K>(bd, bi, d, part_i[base + s]);
    }
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    out_d[q * K + s] = bd[s];
    out_i[q * K + s] = bi[s];
  }
}

template <int K>
cudaError_t launch_sweep_k(const float* qp, int n_pad, const float* rt3,
                           int nch, const int* surv, int nch_pad, size_t smem,
                           float* part_d, int* part_i, float* out_d, int* out_i,
                           cudaStream_t st) {
  survivor_sweep_k<K><<<dim3(n_pad / kNnTile, kSegments), kNnThreads, smem, st>>>(
      qp, rt3, surv, nch, nch_pad, n_pad, part_d, part_i);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  survivor_merge_k<K><<<(n_pad + 255) / 256, 256, 0, st>>>(part_d, part_i,
                                                           n_pad, out_d, out_i);
  return cudaGetLastError();
}

// Queries per flag row from surv's row count (256 or 1024), or 0.
int flag_tile(int n_pad, int flag_rows) {
  if (flag_rows <= 0 || n_pad % flag_rows) return 0;
  const int tile = n_pad / flag_rows;
  return tile == kNnTile || tile == kFoldTile ? tile : 0;
}

}  // namespace

extern "C" {

int pm_bound_tile() { return kBoundTile; }
int pm_fold_tile() { return kFoldTile; }
int pm_sweep_segments() { return kSegments; }

// n_pad a multiple of 256; surv is [n_pad / 256,
// nch_pad]; chunks nch and above are padding.
int pm_survivors_bounds(const float* qp, int n_pad, const float* ct, int nch,
                        int nch_pad, int k, float* ub, int* surv,
                        void* stream) {
  if (n_pad == 0) return cudaSuccess;
  survivors_bounds<<<n_pad / kBoundTile, kBoundTile, 0, (cudaStream_t)stream>>>(
      qp, ct, nch, nch_pad, k, ub, surv);
  return cudaGetLastError();
}

// K3 and K4: surv is [flag_rows, nch_pad], one row per 256 queries (K2's
// tiles) or per 1024 (the TPU's fold); n_pad a multiple of that tile. part_d,
// part_i are scratch of [kSegments, n_pad]; rt3 is 16-byte aligned. Two
// launches: the segment sweep, then the merge into out_d, out_i.
int pm_survivor_sweep(const float* qp, int n_pad, const float* rt3, int nch,
                      const int* surv, int flag_rows, int nch_pad,
                      float* part_d, int* part_i, float* out_d, int* out_i,
                      void* stream) {
  if (n_pad == 0) return cudaSuccess;
  const int tile = flag_tile(n_pad, flag_rows);
  if (tile == 0) return cudaErrorInvalidValue;
  // the list takes at most MAX_CHUNKS (8192) ints: 32 KB of the default 48
  const size_t smem = (size_t)(nch > 0 ? nch : 1) * sizeof(int);
  cudaStream_t st = (cudaStream_t)stream;
  survivor_sweep<<<dim3(n_pad / kNnTile, kSegments), kNnThreads, smem, st>>>(
      qp, rt3, surv, nch, nch_pad, tile / kNnTile, n_pad, part_d, part_i);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  survivor_merge<<<(n_pad + 255) / 256, 256, 0, st>>>(part_d, part_i, n_pad,
                                                     out_d, out_i);
  return cudaGetLastError();
}

// K6: out_d, out_i are [n_pad, k], k in 2..4; surv is [n_pad / 256,
// nch_pad], K2's own rows; part_d, part_i scratch of [kSegments, n_pad, k];
// rt3 16-byte aligned. Two launches: the segment sweep, then the merge.
int pm_survivor_sweep_k(const float* qp, int n_pad, const float* rt3, int nch,
                        const int* surv, int flag_rows, int nch_pad, int k,
                        float* part_d, int* part_i, float* out_d, int* out_i,
                        void* stream) {
  if (n_pad == 0) return cudaSuccess;
  if (n_pad % kNnTile || flag_rows != n_pad / kNnTile) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(nch > 0 ? nch : 1) * sizeof(int);
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
    case 2:
      return launch_sweep_k<2>(qp, n_pad, rt3, nch, surv, nch_pad, smem,
                               part_d, part_i, out_d, out_i, st);
    case 3:
      return launch_sweep_k<3>(qp, n_pad, rt3, nch, surv, nch_pad, smem,
                               part_d, part_i, out_d, out_i, st);
    case 4:
      return launch_sweep_k<4>(qp, n_pad, rt3, nch, surv, nch_pad, smem,
                               part_d, part_i, out_d, out_i, st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* pm_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
