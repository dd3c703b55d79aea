// Survivor-sweep 1-NN kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by libpointmatcher_tpu_torch/ops/sweep_cuda.py.
//
// They replace the TPU kernels of libpointmatcher_tpu/ops/knn_sweep2.py:
//   K2  survivors_bounds      <- _bounds_kernel        (knn_sweep2.py:132, survivors_and_bounds)
//   K3  survivor_sweep + survivor_merge <- _sweep_kernel (knn_sweep2.py:242, nn1_survivor_sweep)
//   K4  the same two         <- _sweep_stream_kernel  (knn_sweep2.py:482, nn1_survivor_sweep_stream)
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
// K6, the top-K sweep (K = 2..4) of the knn > 1 route, resident maps only,
// keeps the first K3's shape: one block per 1024-query tile, whose flags are
// the OR of its four bound tiles, 256 threads of four queries each, each
// chunk staged between two barriers. Each query keeps its sorted top-K in
// registers (K template-instantiated, so the list never spills to local
// memory), and a row is inserted only when it beats the K-th distance. Its
// work is a 1-NN sweep's plus the rare insertions, so it is bound by the fp32
// issue rate over the survivors too.
//
// Exactness: K2 forms every quantity with explicitly rounded intrinsics in
// the order of the plain torch version (ops/sweep_cuda.py), so nvcc cannot
// contract an FMA into it and the flags are the same bit for bit. K3/K4 form
// d2 = (dx*dx + dy*dy) + dz*dz with dx taken against x + pen; for a penalty
// of 0 or +inf (the table's only values) that is K1's ((pen + dx*dx) + dy*dy)
// + dz*dz bit for bit, 0 + dx*dx being dx*dx. Within a segment survivors are
// swept in increasing chunk order and rows in increasing order with a strict
// '<', and the segments, which cut the list in order, merge in order with a
// strict '<', so the lowest sorted-map index wins a tie. A query whose tile
// has no survivor, or whose minimum stays +inf, gets (+inf, 0); the caller
// masks it. K6 forms d2 the same way as K1 and inserts with
// a strict '<' in the same sweep order, so equal distances keep the lower
// index ahead: the order of the Pallas kernel's first-minimum merge, whose
// ids K6 therefore matches, ties included. Slots left empty hold (+inf, -1).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBoundTile = 256;    // queries per K2 block and flag row
constexpr int kChunkStage = 512;   // chunk columns staged per K2 pass
constexpr int kSweepThreads = 256; // K6
constexpr int kPerThread = 4;      // queries per K6 thread
constexpr int kSweepTile = kSweepThreads * kPerThread;  // 1024, K6's tile
constexpr int kNnThreads = 128;    // K3/K4 threads a block, two queries each
constexpr int kNnTile = 2 * kNnThreads;                 // 256 = kBoundTile
constexpr int kSegments = 8;       // K3/K4 list segments per tile
constexpr int kChunk = 128;        // map rows per chunk
constexpr int kRows = 8;           // rows of a chunk in rt3
static_assert(kNnTile == kBoundTile, "K3/K4 sweep K2's own tile");
static_assert(kNnThreads == kChunk, "one float4 of a chunk's rows 0..3 a thread");

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
    const unsigned ballot = __ballot_sync(0xffffffffu, f);
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

// Fold one map row (x already carrying its penalty) into a query's running
// (min, argmin), d2 in K1's order.
__device__ __forceinline__ void fold_row(float qx, float qy, float qz,
                                         float rx, float ry, float rz, int id,
                                         float& best, int& besti) {
  const float d = __fadd_rn(__fadd_rn(sq(__fsub_rn(qx, rx)),
                                      sq(__fsub_rn(qy, ry))),
                            sq(__fsub_rn(qz, rz)));
  if (d < best) {
    best = d;
    besti = id;
  }
}

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
  // this block's segment of the list: [first, first + n)
  const int per = (count + kSegments - 1) / kSegments;
  const int first = blockIdx.y * per;
  const int n = max(0, min(count - first, per));

  const float* qa = qp + q0 * 8;
  const float* qb = qp + (q0 + kNnThreads) * 8;
  const float ax = qa[0], ay = qa[1], az = qa[2];
  const float bx = qb[0], by = qb[1], bz = qb[2];
  float best_a = CUDART_INF_F, best_b = CUDART_INF_F;
  int id_a = 0, id_b = 0;

  // a chunk's rows 0..3 are kChunk float4s, one a thread
  const float4* src = reinterpret_cast<const float4*>(rt3) + tid;
  constexpr int kChunkF4 = kRows * kChunk / 4;
  if (n > 0) s_buf[0][tid] = src[(int64_t)s_list[first] * kChunkF4];
  __syncthreads();
  for (int s = 0; s < n; ++s) {
    // the next chunk's load is in flight while this one is swept
    const bool more = s + 1 < n;
    float4 next;
    if (more) next = src[(int64_t)s_list[first + s + 1] * kChunkF4];
    const float4* sx = s_buf[s & 1];
    const float4* sy = sx + kChunk / 4;
    const float4* sz = sy + kChunk / 4;
    const float4* sp = sz + kChunk / 4;
    const int base = s_list[first + s] * kChunk;
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
    // the other stage was last read before the previous barrier
    if (more) s_buf[(s + 1) & 1][tid] = next;
    __syncthreads();
  }

  const int64_t out = (int64_t)blockIdx.y * n_pad + q0;
  part_d[out] = best_a;
  part_i[out] = id_a;
  part_d[out + kNnThreads] = best_b;
  part_i[out + kNnThreads] = id_b;
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
  const int count = survivor_list<kSweepThreads>(
      surv + (int64_t)tile * nch_pad, nch, s_list, s_warp);

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
int pm_sweep_segments() { return kSegments; }

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

// K3 and K4: surv is [flag_rows, nch_pad], one row per 256 queries (K2's
// tiles) or per 1024 (the TPU's fold); n_pad a multiple of that tile. part_d,
// part_i are scratch of [kSegments, n_pad]; rt3 is 16-byte aligned. Two
// launches: the segment sweep, then the merge into out_d, out_i.
int pm_survivor_sweep(const float* qp, int n_pad, const float* rt3, int nch,
                      const int* surv, int flag_rows, int nch_pad,
                      float* part_d, int* part_i, float* out_d, int* out_i,
                      void* stream) {
  if (n_pad == 0) return cudaSuccess;
  if (flag_rows <= 0 || n_pad % flag_rows) return cudaErrorInvalidValue;
  const int tile = n_pad / flag_rows;
  if (tile != kNnTile && tile != 4 * kNnTile) return cudaErrorInvalidValue;
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

// K6: out_d, out_i are [n_pad, k], k in 2..4; surv is [n_pad / 1024,
// nch_pad]; the survivor list takes nch * 4 bytes of dynamic shared memory.
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
