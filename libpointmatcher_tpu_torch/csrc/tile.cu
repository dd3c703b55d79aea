// Tile-sweep k-NN kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by libpointmatcher_tpu_torch/ops/tile_cuda.py.
//
// They replace the TPU kernels of libpointmatcher_tpu/ops/tilesweep.py:
//   K7  tile_nn1      <- _tile_nn1_kernel  (tilesweep.py:460, _tile_sweep_pallas)
//   K8  tile_nnk<K>   <- _tile_nnk_kernel  (tilesweep.py:737, _tile_sweep_pallas_k)
//
// Inputs. A registration's queries are cut into parent tiles of TQ queries;
// a parent whose candidate union is long is split into virtual tiles (the
// TPU's bound on its VMEM), and each virtual tile has its own candidate
// table:
//   cand   [Bf * Tv, 8, M]  rows 0..dim-1 the coordinates, row 6 the pad
//                           penalty (0 for a real candidate, +inf for
//                           padding), row 7 the candidate's original row id
//                           as a float (exact below 2^24); M a multiple of
//                           128;
//   ncols  [Bf * Tv]        the live prefix of each table, a multiple of 64
//                           (the columns past it are the all-pad unit), or
//                           null: all M;
//   vrows  [Bf, K, Tp]      each parent's virtual tiles in merge order, past
//                           its own count an all-pad sentinel, or null: each
//                           tile its own parent (K = 1);
//   pts    query row r at pts[r * qstride], the coordinates first;
//   qmask  per query row (null: every row live);
//   q_rows [Tp, TQ]         the query row of each slot (-1: none), one scan,
//                           or null: tile order, slot r of parent p is row
//                           p * TQ + r (Bf scans of Tp parents stacked).
//
// Design: one block per parent tile (and slice of its queries on gridDim.y:
// 256 a K7 block, 256 or, above 24 slots, 128 a K8 block) sweeps the parent's
// whole virtual-tile list in merge order, each table only over its live
// prefix, so a sentinel or all-pad virtual tile costs nothing. The tables are
// staged through shared memory kStage columns at a time as three float
// arrays, x + pen, y and z (one 16-byte load gives four columns of one
// coordinate); the next stage is loaded into registers while the current one
// is swept and stored into the other of two buffers after it, one barrier a
// stage. Columns are swept in groups of kGroup. K7 takes two queries a
// thread: each folds a group's d2 with fminf and keeps (minimum, its first
// group) with one strict '<' a group; at the end of each virtual tile it
// recomputes its best group from device memory, takes the first column equal
// to the minimum and reads its id from row 7, then merges the virtual tile's
// (d2, id) into the parent's. At TQ <= 64 (one warp for a parent's queries) a
// block holds up to kMaxTeams such warps, each its own staging, which take
// the parent's virtual tiles in turn; their results merge at the end (the
// merge by (d2, id) does not depend on the order), so a parent of many
// virtual tiles is swept by several warps at once.
// K8 takes one query a thread and two sorted lists of K = k slots (one
// instance per k): the virtual tile's, in registers, and the parent's, in
// registers up to 24 slots and in shared memory above (two lists of 28 or
// more slots spilled; those blocks take 128 threads). A column enters the
// virtual tile's list only under both lists' k-th distances, so only a
// group whose minimum lies under them inserts, its columns in order with a
// strict '<'; at the end of each virtual tile its list is merged into the
// parent's entry by entry. The lists hold each entry's flat column (v * M +
// column), and the ids are read from row 7 once, at the end. A warp whose
// queries are all masked or absent skips the sweeps but joins the barriers;
// a block whose queries are all masked does not sweep. The kernel then
// applies the radius and the mask and writes (d2, id) at the query's row.
//
// What bounds them: 9 fp32 operations a (query, live candidate) pair, the
// 8 of the exact difference form (which may not fuse into FMAs) and the
// fminf of the group fold; a table column is read once per block, 16 bytes
// (x, y, z, pen) for every 64 or 128 queries. They are bound by the fp32
// issue rate; chip_smoke.py computes the bound from the recorded inputs'
// valid pairs.
//
// Exactness: d2 = (dx*dx + dy*dy) + dz*dz with dx taken against x + pen,
// every step an explicitly rounded intrinsic (no FMA contraction). For pen 0
// that is ((pen + dx*dx) + dy*dy) + dz*dz, the order of the plain torch
// version in ops/tile_cuda.py, bit for bit (0 + dx*dx being dx*dx); for pen =
// +inf both are +inf, which no comparison takes; 2-D stages z = 0 on both
// sides. Within a virtual tile the lowest column of equal distances wins: the
// best group is the first that holds the minimum and its first column equal
// to it is the lowest. Across a parent's virtual tiles, K7 merges as
// tilesweep._combine_min does: the smaller d2, and on equal d2 the lower row
// id with -1 the largest; K8's insertion keeps equal distances in column
// order within a virtual tile, as a stable sort does, and merges the virtual
// tiles' lists in vrows order with tilesweep._merge_sorted_k's pass
// (merge_one), which is not a stable merge: where an entry is carried into a
// run of equal distances, the run's first entry moves to the run's end. The
// radius r2 is applied once, after the merge (kept where d2 <= r2, else
// (+inf, -1)); the plain version applies it to each virtual tile before its
// merge. Both give the same result because the threshold is monotone: the
// merged minimum (or each merged slot) lies within r2 exactly when it came
// from a virtual tile whose value lies within r2, and values beyond r2 never
// precede values within it (nor change their order when merged). Outputs: K7
// d2 and id at the query's row; K8 k of each, in ascending order, at row * k
// + slot, or (per-tile form, tile_major) at (tile * k + slot) * TQ + query;
// (+inf, -1) for a masked query and past the candidates.
//
// The ablations of tools/tile_kernel_micro.py, which measure what K7's id
// tracking and its schedule cost, compute per query the minimum d2 over its
// tile's candidates (any M) on K7's own table, no id read or kept:
//   T4  tile_min_staged  <- _min_only  (tile_kernel_micro.py:79, main.min_only)
//       4 queries a thread, the fewest threads a tile (8..256, a power of
//       two: tile_cuda.t4_team) whose queries cover TQ, 256 / team tiles a
//       block (the tool's TQ 256: 64 threads, 4 tiles; K7's 64: 16, 16), a
//       tile of more than 1024 queries in slices on gridDim.y. The tables
//       are staged 4 * team columns each, 1024 a block, as four arrays x, y,
//       z, pen, by 16-byte cp.async (4-byte copies where a row is not
//       16-byte aligned, M % 4 != 0; columns past M zero-filled) into two
//       buffers, 32 KB in all: the copy of stage s + 1 is in flight while
//       stage s is swept, one barrier a stage. Each thread copies four
//       columns of its tile and, once they land, folds the penalty into
//       their x (x + pen, +inf past M) before the barrier, so the sweep
//       reads three arrays: six 16-byte loads a group of kGroup columns for
//       the thread's four queries, each folding the group's d2 with fminf
//       and its minimum into the query's with one more: 9 instructions a
//       pair.
//   T5  tile_min_one     <- _one       (tile_kernel_micro.py:131, main.one)
//       one tile a block, its whole candidate list in one step: kT5Threads
//       threads as `team` x `slices` (team the fewest threads, 8..256, a
//       power of two, whose four queries each cover TQ, slices = 256 /
//       team: tile_cuda.t5_shape; the tool's TQ 256: 64 x 4, K7's 64: 16 x
//       16); a tile of more than 1024 queries in slices on gridDim.y. Slice
//       s owns a contiguous run of whole groups of the tile's columns. Its
//       team copies that run's x, y and z rows by 16-byte cp.async (4-byte
//       where M % 4 != 0 or the table is not 16-byte aligned; zero-filled
//       past M) into three arrays of dynamic shared memory, 12 bytes a
//       column, in one commit group (two, the second half in flight while
//       the first is swept, were no faster: PERF.md, "Findings"), folds the
//       penalty into its x (x + pen read from device memory, +inf past M)
//       and, after one team barrier, sweeps the run. The sweep is T4's: six
//       16-byte loads a group for the thread's four queries, 9 instructions
//       a pair. Each query's minima over the slices are then taken with
//       fminf through shared memory. The list and the scratch of that
//       reduction fit in 232,448 bytes up to M = 19024 (kMinOneMax); at the
//       tool's M = 4096 a block takes 52 KB, four blocks an SM.
// Both equal K7's d2 bit for bit (in K7's form against x + pen; it agrees
// with the plain version's order for pen 0 and +inf, as the header above
// says). They read 16 bytes per candidate column (x, y, z, pen) and do 9
// operations per pair: bound by the fp32 issue rate on full tiles, at least
// 9 instructions a pair, twice the 67 TFLOP/s bound (the issue floor).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;  // K8's threads a block
constexpr int kMaxTeams = 4;      // K7's teams of threads a block
constexpr int kTeamThreads = 128; // K7's threads a block (a parent's queries
                                  // two a thread, or its teams of a warp)
static_assert(kTeamThreads == 32 * kMaxTeams, "a K7 team is one warp");
constexpr int kStage = 128;       // K7/K8 table columns per shared stage
constexpr int kGroup = 8;         // K7/K8 columns per group
constexpr int kLoaders = kStage / 4;  // threads that load a stage's float4s
constexpr int kPenRow = 6;
constexpr int kCidRow = 7;
constexpr int kRows = 8;
constexpr int kT4Threads = 256;   // T4's threads a block
constexpr int kT4Q = 4;           // T4's and T5's queries a thread, of one tile
constexpr int kT4Cols = 1024;     // T4's columns a block stages, over its tiles
constexpr int kT4MinTeamLog2 = 3; // T4's and T5's fewest threads a tile: 8
static_assert(kT4Cols == 4 * kT4Threads, "a T4 thread copies four columns a stage");
constexpr int kT5Threads = 256;   // T5's threads a block, team x slices
// T5's largest candidate list: three arrays of round_up(M, kGroup) floats and
// the cross-slice scratch (kT5Q floats a thread) in the 232,448 bytes of
// shared memory a block can hold
constexpr int kT5Scratch = kT4Q * kT5Threads;
constexpr int kMinOneMax = (232448 / 4 - kT5Scratch) / 3 / kGroup * kGroup;
static_assert(64 % kGroup == 0 && kStage % 64 == 0, "live prefixes are whole groups");
static_assert(kLoaders <= 32, "the first warp loads a stage");

// ------------------------------------------------------------ T4, T5 helpers

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

// ------------------------------------------------------------------ K7, K8

// One launch's tables (see the header).
struct Sweep {
  const float* pts;
  const uint8_t* qmask;
  const int64_t* q_rows;
  const float* cand;
  const int* ncols;
  const int* vrows;
  int qstride, dim, Tp, TQ, Tv, K, M;
  float r2;
};

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

__device__ __forceinline__ float d2_folded(float qx, float qy, float qz,
                                           float x, float y, float z) {
  return __fadd_rn(__fadd_rn(sq(__fsub_rn(qx, x)), sq(__fsub_rn(qy, y))),
                   sq(__fsub_rn(qz, z)));
}

// The query row of slot r of parent p (-1: none).
__device__ __forceinline__ int64_t query_row(const Sweep& s, int64_t p, int r) {
  if (r >= s.TQ) return -1;
  const int64_t slot = p * s.TQ + r;
  return s.q_rows != nullptr ? s.q_rows[slot] : slot;
}

// A live query's coordinates (0 elsewhere).
__device__ __forceinline__ bool load_point(const Sweep& s, int64_t row,
                                           float& x, float& y, float& z) {
  const bool live = row >= 0 && (s.qmask == nullptr || s.qmask[row] != 0);
  x = y = z = 0.0f;
  if (live) {
    const float* q = s.pts + row * s.qstride;
    x = q[0];
    y = q[1];
    if (s.dim == 3) z = q[2];
  }
  return live;
}

// The flat index of parent p's virtual tile at merge step j.
__device__ __forceinline__ int vtile_at(const Sweep& s, int64_t p, int j) {
  if (s.vrows == nullptr) return (int)p;
  const int64_t b = p / s.Tp, t = p - b * s.Tp;
  return (int)(b * s.Tv + s.vrows[(b * s.K + j) * s.Tp + t]);
}

// A stage of a parent's sweep: merge step j, its virtual tile v with n live
// columns, columns m0 .. m0 + kStage - 1 of them. j == K: the sweep is over.
struct Cursor {
  int j, v, n, m0;
};

// The next stage: the next kStage columns of this virtual tile, else the
// first of the next virtual tile, `step` merge steps on, that has live
// columns.
__device__ __forceinline__ void advance(const Sweep& s, int64_t p, int step,
                                        Cursor& c) {
  c.m0 += kStage;
  while (c.m0 >= c.n && (c.j += step) < s.K) {
    c.v = vtile_at(s, p, c.j);
    c.n = s.ncols != nullptr ? s.ncols[c.v] : s.M;
    c.m0 = 0;
  }
}

// Thread l < kLoaders's float4 of each staged row: columns 4l .. 4l + 3
// (l: the thread's index in its team of threads).
struct Stage {
  float4 x, y, z, p;

  __device__ __forceinline__ bool mine(const Cursor& c, int l) const {
    return l < kLoaders && 4 * l < c.n - c.m0;
  }

  __device__ __forceinline__ void load(const Sweep& s, const Cursor& c, int l) {
    if (!mine(c, l)) return;
    const float* tab = s.cand + (int64_t)c.v * kRows * s.M + c.m0 + 4 * l;
    x = __ldg(reinterpret_cast<const float4*>(tab));
    y = __ldg(reinterpret_cast<const float4*>(tab + s.M));
    z = s.dim == 3 ? __ldg(reinterpret_cast<const float4*>(tab + 2 * s.M))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    p = __ldg(reinterpret_cast<const float4*>(tab + kPenRow * s.M));
  }

  __device__ __forceinline__ void store(const Cursor& c, int l, float* sx,
                                        float* sy, float* sz) const {
    if (!mine(c, l)) return;
    reinterpret_cast<float4*>(sx)[l] =
        make_float4(__fadd_rn(x.x, p.x), __fadd_rn(x.y, p.y),
                    __fadd_rn(x.z, p.z), __fadd_rn(x.w, p.w));
    reinterpret_cast<float4*>(sy)[l] = y;
    reinterpret_cast<float4*>(sz)[l] = z;
  }
};

// Columns g * kGroup .. of a stage, one 16-byte load per four columns.
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

// The barrier of a team of threads: the block's, or its warp's when the
// team is one warp of several.
__device__ __forceinline__ void team_sync(bool warp) {
  if (warp)
    __syncwarp();
  else
    __syncthreads();
}

// The stage loop of K7 and K8: the stages of parent p's merge steps first,
// first + step, ... through the two buffers, sw.stage(x, y, z, v, m0,
// columns) on each and sw.end(s, v) after the last stage of each virtual
// tile v, unless `live` is false. Every thread of the team calls it (the
// cursor is the same in all of them; l is the thread's index in the team,
// `warp` whether the team is one warp of several); sw's members are
// force-inlined, so its state stays in registers.
template <typename Sweeper>
__device__ __forceinline__ void for_each_stage(const Sweep& s, int64_t p,
                                               int first, int step, int l,
                                               bool warp, bool live,
                                               float (*s_x)[kStage],
                                               float (*s_y)[kStage],
                                               float (*s_z)[kStage],
                                               Sweeper& sw) {
  Cursor c{first - step, 0, 0, 0};
  advance(s, p, step, c);
  Stage st;
  if (c.j < s.K) {
    st.load(s, c, l);
    st.store(c, l, s_x[0], s_y[0], s_z[0]);
  }
  team_sync(warp);
  for (int b = 0; c.j < s.K; b ^= 1) {
    Cursor nx = c;
    advance(s, p, step, nx);
    // the next stage's loads are in flight while this one is swept
    const bool more = nx.j < s.K;
    if (more) st.load(s, nx, l);
    if (live) {
      const int cols = c.n - c.m0 < kStage ? c.n - c.m0 : kStage;
      sw.stage(s_x[b], s_y[b], s_z[b], c.v, c.m0, cols);
      if (nx.j != c.j) sw.end(s, c.v);
    }
    // the other buffer was last read before the previous barrier
    if (more) st.store(nx, l, s_x[b ^ 1], s_y[b ^ 1], s_z[b ^ 1]);
    team_sync(warp);
    c = nx;
  }
}

// K7: the first column of group `grp` of virtual tile v whose d2 equals
// `best`, recomputed from device memory, and its id (-1: none).
__device__ __forceinline__ int first_id(const Sweep& s, int v, int grp,
                                        float qx, float qy, float qz,
                                        float best) {
  if (grp < 0) return -1;
  const float* tab = s.cand + (int64_t)v * kRows * s.M;
  for (int r = 0; r < kGroup; ++r) {
    const int m = grp + r;
    const float x = __fadd_rn(tab[m], tab[kPenRow * s.M + m]);
    const float y = tab[s.M + m];
    const float z = s.dim == 3 ? tab[2 * s.M + m] : 0.0f;
    if (d2_folded(qx, qy, qz, x, y, z) == best) return (int)tab[kCidRow * s.M + m];
  }
  return -1;
}

// K7: a virtual tile's (d, id) merged into the parent's (pd, pi): the
// smaller d2, on equal d2 the lower id with -1 the largest.
__device__ __forceinline__ void combine_min(float& pd, int& pi, float d, int i) {
  if (d < pd) {
    pd = d;
    pi = i;
  } else if (d == pd) {
    pi = (int)min((unsigned)pi, (unsigned)i);
  }
}

// K7's two queries: per virtual tile (group minimum, its first column), per
// parent the merged (d2, id).
struct Nearest {
  float ax, ay, az, bx, by, bz;
  float va, vb, pa, pb;
  int ga, gb, ia, ib;

  __device__ __forceinline__ void stage(const float* sx, const float* sy,
                                        const float* sz, int, int m0,
                                        int cols) {
    const int groups = cols / kGroup;
#pragma unroll 2
    for (int g = 0; g < groups; ++g) {
      const Group r(sx, sy, sz, g);
      float da[kGroup], db[kGroup];
      r.d2(ax, ay, az, da);
      r.d2(bx, by, bz, db);
      const float ma = group_min(da), mb = group_min(db);
      const int col = m0 + g * kGroup;
      if (ma < va) {
        va = ma;
        ga = col;
      }
      if (mb < vb) {
        vb = mb;
        gb = col;
      }
    }
  }

  __device__ __forceinline__ void end(const Sweep& s, int v) {
    combine_min(pa, ia, va, first_id(s, v, ga, ax, ay, az, va));
    combine_min(pb, ib, vb, first_id(s, v, gb, bx, by, bz, vb));
    va = vb = CUDART_INF_F;
    ga = gb = -1;
  }
};

// The epilogue: the radius and the mask, (+inf, -1) beyond them.
__device__ __forceinline__ bool kept(const Sweep& s, bool live, float d) {
  return live && d <= s.r2 && isfinite(d);
}

// K7: 1-NN of each query of a parent tile over its virtual tiles. With
// `teams` > 1 (one warp a team, TQ <= 64) the block's teams of threads take
// the parent's merge steps in turn (team w steps w, w + teams, ...), each
// with its own staging, and team 0 merges their results: the merge by (d2,
// id) is commutative, so its order does not matter.
__global__ void __launch_bounds__(kTeamThreads)
tile_nn1(Sweep s, int teams, float* __restrict__ out_d,
         int* __restrict__ out_i) {
  __shared__ __align__(16) float s_x[kMaxTeams][2][kStage];
  __shared__ __align__(16) float s_y[kMaxTeams][2][kStage];
  __shared__ __align__(16) float s_z[kMaxTeams][2][kStage];
  __shared__ float s_d[2][kTeamThreads];
  __shared__ int s_i[2][kTeamThreads];
  const int64_t p = blockIdx.x;
  const int qthreads = blockDim.x / teams;
  const int w = threadIdx.x / qthreads, l = threadIdx.x - w * qthreads;
  const int qa = blockIdx.y * 2 * qthreads + l;
  const int qb = qa + qthreads;
  const int64_t ra = query_row(s, p, qa), rb = query_row(s, p, qb);
  Nearest nn;
  const bool la = load_point(s, ra, nn.ax, nn.ay, nn.az);
  const bool lb = load_point(s, rb, nn.bx, nn.by, nn.bz);
  nn.va = nn.vb = nn.pa = nn.pb = CUDART_INF_F;
  nn.ga = nn.gb = nn.ia = nn.ib = -1;
  if (__syncthreads_or(la || lb))
    for_each_stage(s, p, w, teams, l, teams > 1,
                   __any_sync(0xffffffffu, la || lb), s_x[w], s_y[w], s_z[w],
                   nn);
  if (teams > 1) {
    s_d[0][threadIdx.x] = nn.pa;
    s_i[0][threadIdx.x] = nn.ia;
    s_d[1][threadIdx.x] = nn.pb;
    s_i[1][threadIdx.x] = nn.ib;
    __syncthreads();
    if (w != 0) return;
    for (int h = 1; h < teams; ++h) {
      combine_min(nn.pa, nn.ia, s_d[0][h * qthreads + l], s_i[0][h * qthreads + l]);
      combine_min(nn.pb, nn.ib, s_d[1][h * qthreads + l], s_i[1][h * qthreads + l]);
    }
  }
  if (ra >= 0) {
    const bool k = kept(s, la, nn.pa);
    out_d[ra] = k ? nn.pa : CUDART_INF_F;
    out_i[ra] = k ? nn.ia : -1;
  }
  if (rb >= 0) {
    const bool k = kept(s, lb, nn.pb);
    out_d[rb] = k ? nn.pb : CUDART_INF_F;
    out_i[rb] = k ? nn.ib : -1;
  }
}

// Insert (d, id) into the ascending register list (bd, bi) of length K.
// Equal distances keep their arrival order, so with a table's columns
// arriving in order the lower column stays first.
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

// A list of K (d2, flat column) slots, ascending: in registers, or (Shared,
// for the parent's list at large K) in shared memory, slot e of thread t at
// e * blockDim.x + t, so that a warp's accesses fall in 32 banks.
template <int K, bool Shared>
struct List;

template <int K>
struct List<K, false> {
  float d_[K];
  int i_[K];
  __device__ __forceinline__ float& d(int e) { return d_[e]; }
  __device__ __forceinline__ int& i(int e) { return i_[e]; }
};

template <int K>
struct List<K, true> {
  float* d_;
  int* i_;
  __device__ __forceinline__ float& d(int e) { return d_[e * blockDim.x]; }
  __device__ __forceinline__ int& i(int e) { return i_[e * blockDim.x]; }
};

// tilesweep._merge_sorted_k's pass for one entry: at each slot the smaller
// stays and the other is carried on, ties staying put. Where the carried
// entry meets a run of equal distances, the run's first entry is carried
// past the others, so the pass is not a stable insertion.
template <int K, typename L>
__device__ __forceinline__ void merge_one(L& p, float d, int id) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const float td = p.d(s);
    const int ti = p.i(s);
    if (d < td) {
      p.d(s) = d;
      p.i(s) = id;
      d = td;
      id = ti;
    }
  }
}

// K8's query, the sorted list of K = k slots of the virtual tile it sweeps
// (flat columns v * M + m) and the parent's merged list (its k-th distance
// also in `lim`). A column enters the virtual tile's list only under both
// lists' last slots: one that does not reach the parent's k-th distance can
// never be merged into it.
template <int K, bool Shared>
struct TopK {
  float qx, qy, qz, lim;
  int M;
  bool merged;
  float bd[K];
  int bi[K];
  List<K, Shared> par;

  __device__ __forceinline__ void stage(const float* sx, const float* sy,
                                        const float* sz, int v, int m0,
                                        int cols) {
    const int groups = cols / kGroup;
    const int base = v * M + m0;
#pragma unroll 1
    for (int g = 0; g < groups; ++g) {
      float d[kGroup];
      Group(sx, sy, sz, g).d2(qx, qy, qz, d);
      if (group_min(d) < fminf(bd[K - 1], lim)) {  // rare once full
#pragma unroll
        for (int e = 0; e < kGroup; ++e)
          if (d[e] < fminf(bd[K - 1], lim))
            insert_sorted<K>(bd, bi, d[e], base + g * kGroup + e);
      }
    }
  }

  // The virtual tile's list merged into the parent's in slot order, as
  // _merge_sorted_k merges (its head taken off in a loop that is not
  // unrolled, so the code stays K long); the first merged is the parent's
  // list itself. The virtual tile's list ends empty.
  __device__ __forceinline__ void end(const Sweep&, int) {
    if (!merged) {
#pragma unroll
      for (int e = 0; e < K; ++e) {
        par.d(e) = bd[e];
        par.i(e) = bi[e];
      }
      merged = true;
    } else {
#pragma unroll 1
      for (int e = 0; e < K && bd[0] < lim; ++e) {  // the rest changes nothing
        merge_one<K>(par, bd[0], bi[0]);
        lim = par.d(K - 1);
#pragma unroll
        for (int t = 0; t + 1 < K; ++t) {
          bd[t] = bd[t + 1];
          bi[t] = bi[t + 1];
        }
        bd[K - 1] = CUDART_INF_F;
      }
    }
    lim = par.d(K - 1);
#pragma unroll
    for (int e = 0; e < K; ++e) {
      bd[e] = CUDART_INF_F;
      bi[e] = -1;
    }
  }
};

// Lists longer than this keep the parent's list in shared memory: two
// lists of 28 or more slots in registers spilled.
constexpr int kRegisterList = 24;
constexpr int kSharedListThreads = 128;   // threads a block then (32 KB)

// K8: sorted top-K of each query of a parent tile over its virtual tiles.
// No launch bounds: as for csrc/knn.cu's K5, they make ptxas trade spills
// for occupancy at some K.
template <int K>
__global__ void tile_nnk(Sweep s, int tile_major, float* __restrict__ out_d,
                         int* __restrict__ out_i) {
  constexpr bool kShared = K > kRegisterList;
  __shared__ __align__(16) float s_x[2][kStage];
  __shared__ __align__(16) float s_y[2][kStage];
  __shared__ __align__(16) float s_z[2][kStage];
  __shared__ float s_pd[kShared ? K * kSharedListThreads : 1];
  __shared__ int s_pi[kShared ? K * kSharedListThreads : 1];
  const int64_t p = blockIdx.x;
  const int qi = blockIdx.y * blockDim.x + threadIdx.x;
  const int64_t row = query_row(s, p, qi);
  TopK<K, kShared> top;
  if constexpr (kShared) {
    top.par.d_ = s_pd + threadIdx.x;
    top.par.i_ = s_pi + threadIdx.x;
  }
  top.M = s.M;
  top.merged = false;
  top.lim = CUDART_INF_F;
  const bool live = load_point(s, row, top.qx, top.qy, top.qz);
#pragma unroll
  for (int e = 0; e < K; ++e) {
    top.bd[e] = top.par.d(e) = CUDART_INF_F;
    top.bi[e] = top.par.i(e) = -1;
  }
  if (__syncthreads_or(live))
    for_each_stage(s, p, 0, 1, threadIdx.x, false,
                   __any_sync(0xffffffffu, live), s_x, s_y, s_z, top);
  if (row < 0) return;
#pragma unroll
  for (int e = 0; e < K; ++e) {
    const float d = top.par.d(e);
    const bool k = kept(s, live, d);
    int id = -1;
    if (k) {
      const int c = top.par.i(e), v = c / s.M, m = c - v * s.M;
      id = (int)s.cand[((int64_t)v * kRows + kCidRow) * s.M + m];
    }
    const int64_t o = tile_major ? (p * K + e) * s.TQ + qi : row * K + e;
    out_d[o] = k ? d : CUDART_INF_F;
    out_i[o] = id;
  }
}

// Blocks of up to max_threads threads, each `per_thread` queries of one
// parent, the parent's slices on gridDim.y.
dim3 parent_grid(int parents, int tq, int per_thread, int max_threads,
                 int& threads) {
  const int need = (tq + per_thread - 1) / per_thread;
  const int warps = (need + 31) / 32 * 32;
  threads = warps < max_threads ? warps : max_threads;
  return dim3((unsigned)parents,
              (unsigned)((tq + per_thread * threads - 1) / (per_thread * threads)));
}

template <int K>
cudaError_t launch_nnk(const Sweep& s, int parents, int tile_major,
                       float* out_d, int* out_i, cudaStream_t st) {
  int threads;
  const dim3 grid = parent_grid(parents, s.TQ, 1,
                                K > kRegisterList ? kSharedListThreads : kMaxThreads,
                                threads);
  tile_nnk<K><<<grid, threads, 0, st>>>(s, tile_major, out_d, out_i);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ T4, T5

// 16 or 4 bytes from device to shared memory without registers; the
// bytes past src_bytes (0..size) are zero-filled and not read.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

// T4's stage of one tile: columns [m0, m0 + 4 * team) in four arrays (x, y,
// z, pen), each thread of the tile's team copying its own four columns.
struct T4Stage {
  float *x, *y, *z, *pen;
};

// Starts the copy of this thread's four columns c0.. of rows x, y, z (dim
// 3) and pen of table `tab`; columns at or past `valid` zero-filled.
// `vec`: every row 16-byte aligned (M % 4 == 0), one 16-byte copy a row.
__device__ __forceinline__ void t4_copy(const T4Stage& st, int lane,
                                        const float* __restrict__ tab,
                                        int64_t M, int c0, int valid, int dim,
                                        bool vec) {
  float* dst[4] = {st.x + 4 * lane, st.y + 4 * lane, st.z + 4 * lane,
                   st.pen + 4 * lane};
  const int rows[4] = {0, 1, 2, kPenRow};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int v = (r == 2 && dim != 3) ? 0 : valid;   // 2-D: z = 0
    const float* src = tab + rows[r] * M + c0;
    if (vec) {
      cp_async16(dst[r], v > 0 ? src : tab, v > 0 ? 4 * v : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cp_async4(dst[r] + e, e < v ? src + e : tab, e < v ? 4 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// T5's sweep, T4's group loop: the thread's kT4Q queries against `groups`
// groups of kGroup columns of three arrays (x + pen, y, z), six 16-byte
// loads a group, each query folding the group's d2 with fminf and its
// minimum into `best` with one more.
__device__ __forceinline__ void sweep_min(const float* sx, const float* sy,
                                          const float* sz, int groups,
                                          const float (&qx)[kT4Q],
                                          const float (&qy)[kT4Q],
                                          const float (&qz)[kT4Q],
                                          float (&best)[kT4Q]) {
#pragma unroll 1
  for (int g = 0; g < groups; ++g) {
    float x[kGroup], y[kGroup], z[kGroup];
#pragma unroll
    for (int v = 0; v < kGroup / 4; ++v) {
      const int o = g * (kGroup / 4) + v;
      const float4 a = reinterpret_cast<const float4*>(sx)[o];
      const float4 b = reinterpret_cast<const float4*>(sy)[o];
      const float4 c = reinterpret_cast<const float4*>(sz)[o];
      x[4 * v] = a.x, x[4 * v + 1] = a.y, x[4 * v + 2] = a.z, x[4 * v + 3] = a.w;
      y[4 * v] = b.x, y[4 * v + 1] = b.y, y[4 * v + 2] = b.z, y[4 * v + 3] = b.w;
      z[4 * v] = c.x, z[4 * v + 1] = c.y, z[4 * v + 2] = c.z, z[4 * v + 3] = c.w;
    }
#pragma unroll
    for (int k = 0; k < kT4Q; ++k) {
      float d[kGroup];
#pragma unroll
      for (int r = 0; r < kGroup; ++r)
        d[r] = __fadd_rn(__fadd_rn(sq(__fsub_rn(qx[k], x[r])),
                                   sq(__fsub_rn(qy[k], y[r]))),
                         sq(__fsub_rn(qz[k], z[r])));
#pragma unroll
      for (int w = kGroup / 2; w >= 1; w /= 2) {
#pragma unroll
        for (int r = 0; r < w; ++r) d[r] = fminf(d[r], d[r + w]);
      }
      best[k] = fminf(best[k], d[0]);
    }
  }
}

// T4: per query, the minimum d2 over its tile's candidates. A block holds
// kT4Threads / team tiles, `team` (8..256, a power of two) threads each,
// kT4Q queries a thread (query slot lane + k * team of the block's slice on
// gridDim.y). The tiles' tables are staged 4 * team columns each, kT4Cols
// in all, through two buffers by cp.async: the copy of stage s + 1 is in
// flight while stage s is swept, one barrier a stage. Each thread folds the
// penalty into x over the four columns it copied (x + pen; +inf past M),
// so the sweep reads three arrays and forms K7's d2; each query folds a
// group of kGroup columns with fminf.
__global__ void __launch_bounds__(kT4Threads)
tile_min_staged(const float* __restrict__ q, const float* __restrict__ cand,
                int T, int tq, int M, int dim, int team_log2, int vec,
                float* __restrict__ out_d) {
  __shared__ __align__(16) float s_tab[2][4][kT4Cols];
  const int team = 1 << team_log2;
  const int cols = 4 * team;                       // a tile's stage
  const int tl = threadIdx.x >> team_log2;         // the block's tile
  const int lane = threadIdx.x & (team - 1);
  const int64_t tile = (int64_t)blockIdx.x * (kT4Threads >> team_log2) + tl;
  const bool tile_ok = tile < T;
  const float* tab = cand + (tile_ok ? tile : 0) * kRows * (int64_t)M;
  const int q0 = blockIdx.y * team * kT4Q + lane;
  float qx[kT4Q], qy[kT4Q], qz[kT4Q], best[kT4Q];
#pragma unroll
  for (int k = 0; k < kT4Q; ++k) {
    load_query(q, tile * tq + q0 + k * team, tile_ok && q0 + k * team < tq,
               dim, qx[k], qy[k], qz[k]);
    best[k] = CUDART_INF_F;
  }
  auto stage = [&](int b) {
    return T4Stage{s_tab[b][0] + tl * cols, s_tab[b][1] + tl * cols,
                   s_tab[b][2] + tl * cols, s_tab[b][3] + tl * cols};
  };
  auto valid_from = [&](int c0) {
    const int v = tile_ok ? M - c0 : 0;
    return v < 0 ? 0 : (v > 4 ? 4 : v);
  };
  const int stages = (M + cols - 1) / cols;
  if (stages > 0)
    t4_copy(stage(0), lane, tab, M, 4 * lane, valid_from(4 * lane), dim, vec);
  for (int s = 0; s < stages; ++s) {
    const T4Stage st = stage(s & 1);
    const int m0 = s * cols;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    {  // fold the penalty into this thread's own four columns
      float4 x = reinterpret_cast<float4*>(st.x)[lane];
      const float4 p = reinterpret_cast<const float4*>(st.pen)[lane];
      const int v = valid_from(m0 + 4 * lane);
      x.x = v > 0 ? __fadd_rn(x.x, p.x) : CUDART_INF_F;
      x.y = v > 1 ? __fadd_rn(x.y, p.y) : CUDART_INF_F;
      x.z = v > 2 ? __fadd_rn(x.z, p.z) : CUDART_INF_F;
      x.w = v > 3 ? __fadd_rn(x.w, p.w) : CUDART_INF_F;
      reinterpret_cast<float4*>(st.x)[lane] = x;
    }
    // stage s is in place and folded; every thread has swept stage s - 1,
    // whose buffer the next copy fills
    __syncthreads();
    if (s + 1 < stages) {
      const int c0 = m0 + cols + 4 * lane;
      t4_copy(stage((s + 1) & 1), lane, tab, M, c0, valid_from(c0), dim, vec);
    }
    const int cnt = M - m0 < cols ? M - m0 : cols;
    const int groups = (cnt + kGroup - 1) / kGroup;
#pragma unroll 1
    for (int g = 0; g < groups; ++g) {
      float x[kGroup], y[kGroup], z[kGroup];
#pragma unroll
      for (int v = 0; v < kGroup / 4; ++v) {
        const int o = g * (kGroup / 4) + v;
        const float4 a = reinterpret_cast<const float4*>(st.x)[o];
        const float4 b = reinterpret_cast<const float4*>(st.y)[o];
        const float4 c = reinterpret_cast<const float4*>(st.z)[o];
        x[4 * v] = a.x, x[4 * v + 1] = a.y, x[4 * v + 2] = a.z, x[4 * v + 3] = a.w;
        y[4 * v] = b.x, y[4 * v + 1] = b.y, y[4 * v + 2] = b.z, y[4 * v + 3] = b.w;
        z[4 * v] = c.x, z[4 * v + 1] = c.y, z[4 * v + 2] = c.z, z[4 * v + 3] = c.w;
      }
#pragma unroll
      for (int k = 0; k < kT4Q; ++k) {
        float d[kGroup];
#pragma unroll
        for (int r = 0; r < kGroup; ++r)
          d[r] = __fadd_rn(__fadd_rn(sq(__fsub_rn(qx[k], x[r])),
                                     sq(__fsub_rn(qy[k], y[r]))),
                           sq(__fsub_rn(qz[k], z[r])));
#pragma unroll
        for (int w = kGroup / 2; w >= 1; w /= 2) {
#pragma unroll
          for (int r = 0; r < w; ++r) d[r] = fminf(d[r], d[r + w]);
        }
        best[k] = fminf(best[k], d[0]);
      }
    }
  }
  if (tile_ok) {
#pragma unroll
    for (int k = 0; k < kT4Q; ++k)
      if (q0 + k * team < tq) out_d[tile * tq + q0 + k * team] = best[k];
  }
}

// T5's copy of this thread's four columns c0.. of rows x, y and z (dim 3)
// of table `tab` into the three arrays at c0; columns at or past M
// zero-filled. `vec`: every row 16-byte aligned (M % 4 == 0).
__device__ __forceinline__ void t5_copy(float* sx, float* sy, float* sz,
                                        const float* __restrict__ tab,
                                        int64_t M, int c0, int dim, bool vec) {
  const int64_t left = M - c0;
  const int valid = left < 0 ? 0 : (left > 4 ? 4 : (int)left);
  float* dst[3] = {sx + c0, sy + c0, sz + c0};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int v = (r == 2 && dim != 3) ? 0 : valid;   // 2-D: z = 0
    const float* src = tab + r * M + c0;
    if (vec) {
      cp_async16(dst[r], v > 0 ? src : tab, 4 * v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cp_async4(dst[r] + e, e < v ? src + e : tab, e < v ? 4 : 0);
    }
  }
}

// T5's fold of this thread's four columns c0.. once they have landed: x +
// pen, +inf at or past M.
__device__ __forceinline__ void t5_fold(float* sx, const float* __restrict__ tab,
                                        int64_t M, int c0, bool vec) {
  const float* pen = tab + kPenRow * M + c0;
  const int64_t left = M - c0;
  float p[4];
  if (vec && left >= 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(pen));
    p[0] = v.x, p[1] = v.y, p[2] = v.z, p[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = e < left ? __ldg(pen + e) : 0.0f;
  }
  float4 x = reinterpret_cast<float4*>(sx)[c0 / 4];
  x.x = left > 0 ? __fadd_rn(x.x, p[0]) : CUDART_INF_F;
  x.y = left > 1 ? __fadd_rn(x.y, p[1]) : CUDART_INF_F;
  x.z = left > 2 ? __fadd_rn(x.z, p[2]) : CUDART_INF_F;
  x.w = left > 3 ? __fadd_rn(x.w, p[3]) : CUDART_INF_F;
  reinterpret_cast<float4*>(sx)[c0 / 4] = x;
}

// The barrier of slice s's team of `team` threads: a named barrier of its
// warps, or its warp's when several teams share one.
__device__ __forceinline__ void t5_team_sync(int s, int team) {
  if (team >= 32)
    asm volatile("bar.sync %0, %1;\n" ::"r"(s + 1), "r"(team) : "memory");
  else
    __syncwarp();
}

// T5: per query, the minimum d2 over its tile's candidates, one tile a
// block (a slice of kT4Q * team of its queries on gridDim.y), its whole list
// in one step. The block's kT5Threads threads are `slices` teams of `team`
// (a power of two, 8..kT5Threads; slices = kT5Threads / team), thread lane
// of team s holding queries lane + k * team and sweeping the columns [s *
// span, (s + 1) * span) of the tile (span whole groups; the last slices may
// hold none). The team copies its columns into the three arrays by
// cp.async, folds the penalty into them once they have landed, and sweeps
// them after its team barrier. Each query's slice minima are then folded
// with fminf through the scratch.
__global__ void __launch_bounds__(kT5Threads)
tile_min_one(const float* __restrict__ q, const float* __restrict__ cand,
             int tq, int M, int dim, int team_log2, int span, int vec,
             float* __restrict__ out_d) {
  extern __shared__ __align__(16) float s_dyn[];
  const int team = 1 << team_log2;
  const int s = threadIdx.x >> team_log2;          // the thread's slice
  const int lane = threadIdx.x & (team - 1);
  const int mp = (M + kGroup - 1) / kGroup * kGroup;
  float* sx = s_dyn;
  float* sy = s_dyn + mp;
  float* sz = s_dyn + 2 * mp;
  float* s_best = s_dyn + 3 * mp;                  // kT5Scratch floats
  const int64_t tile = blockIdx.x;
  const float* tab = cand + tile * kRows * (int64_t)M;
  const int q0 = blockIdx.y * team * kT4Q + lane;
  float qx[kT4Q], qy[kT4Q], qz[kT4Q], best[kT4Q];
#pragma unroll
  for (int k = 0; k < kT4Q; ++k) {
    load_query(q, tile * tq + q0 + k * team, q0 + k * team < tq, dim, qx[k],
               qy[k], qz[k]);
    best[k] = CUDART_INF_F;
  }
  // this slice's columns [a, a + cols), whole groups, four a thread a step
  const int a = s * span;
  const int cols = a < mp ? (mp - a < span ? mp - a : span) : 0;
  const int step = 4 * team;
  for (int c = 4 * lane; c < cols; c += step)
    t5_copy(sx, sy, sz, tab, M, a + c, dim, vec);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  for (int c = 4 * lane; c < cols; c += step) t5_fold(sx, tab, M, a + c, vec);
  t5_team_sync(s, team);                           // the run is in place, folded
  sweep_min(sx + a, sy + a, sz + a, cols / kGroup, qx, qy, qz, best);
#pragma unroll
  for (int k = 0; k < kT4Q; ++k) s_best[(s * kT4Q + k) * team + lane] = best[k];
  __syncthreads();
  const int slices = kT5Threads >> team_log2;
  for (int i = threadIdx.x; i < kT4Q * team; i += kT5Threads) {
    float v = s_best[i];
    for (int t = 1; t < slices; ++t) v = fminf(v, s_best[t * kT4Q * team + i]);
    const int qi = blockIdx.y * team * kT4Q + i;
    if (qi < tq) out_d[tile * tq + qi] = v;
  }
}

// The log2 of `team` threads (a power of two, 8..most), or -1.
int team_log2_of(int team, int most) {
  int log2 = kT4MinTeamLog2;
  while ((1 << log2) < team) ++log2;
  return (1 << log2) == team && team <= most ? log2 : -1;
}

}  // namespace

extern "C" {

// K7 over `parents` parent tiles (Bf * Tp, or T tiles with vrows null):
// out_d, out_i at each query's row (see the header). K = 1 when vrows is
// null; r2 = +inf applies no radius. `teams` (1..pm_tile_max_teams()) teams
// of threads share a parent's merge steps, above 1 only for tq <= 64.
int pm_tile_nn1(const float* pts, int qstride, const uint8_t* qmask,
                const int64_t* q_rows, const float* cand, const int* ncols,
                const int* vrows, int parents, int Tp, int tq, int Tv, int K,
                int M, int dim, float r2, int teams, float* out_d, int* out_i,
                void* stream) {
  if (parents == 0 || tq == 0) return cudaSuccess;
  const Sweep s{pts, qmask, q_rows, cand, ncols, vrows, qstride, dim, Tp, tq,
                Tv, K, M, r2};
  int threads;
  const dim3 grid = parent_grid(parents, tq, 2, kTeamThreads, threads);
  // several teams only of one warp each
  if (teams < 1 || teams > kMaxTeams || (teams > 1 && threads != 32))
    return cudaErrorInvalidValue;
  tile_nn1<<<grid, threads * teams, 0, (cudaStream_t)stream>>>(s, teams, out_d,
                                                               out_i);
  return cudaGetLastError();
}

// K8 with k (1..32) slots: out_d, out_i [rows, k], or [T, k, tq] when
// tile_major.
int pm_tile_nnk(const float* pts, int qstride, const uint8_t* qmask,
                const int64_t* q_rows, const float* cand, const int* ncols,
                const int* vrows, int parents, int Tp, int tq, int Tv, int K,
                int M, int dim, float r2, int k, int tile_major, float* out_d,
                int* out_i, void* stream) {
  if (parents == 0 || tq == 0) return cudaSuccess;
  const Sweep s{pts, qmask, q_rows, cand, ncols, vrows, qstride, dim, Tp, tq,
                Tv, K, M, r2};
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
#define PM_TILE_NNK_CASE(K)                                                    \
  case K:                                                                      \
    return launch_nnk<K>(s, parents, tile_major, out_d, out_i, st);
    PM_TILE_NNK_CASE(1) PM_TILE_NNK_CASE(2) PM_TILE_NNK_CASE(3)
    PM_TILE_NNK_CASE(4) PM_TILE_NNK_CASE(5) PM_TILE_NNK_CASE(6)
    PM_TILE_NNK_CASE(7) PM_TILE_NNK_CASE(8) PM_TILE_NNK_CASE(9)
    PM_TILE_NNK_CASE(10) PM_TILE_NNK_CASE(11) PM_TILE_NNK_CASE(12)
    PM_TILE_NNK_CASE(13) PM_TILE_NNK_CASE(14) PM_TILE_NNK_CASE(15)
    PM_TILE_NNK_CASE(16) PM_TILE_NNK_CASE(17) PM_TILE_NNK_CASE(18)
    PM_TILE_NNK_CASE(19) PM_TILE_NNK_CASE(20) PM_TILE_NNK_CASE(21)
    PM_TILE_NNK_CASE(22) PM_TILE_NNK_CASE(23) PM_TILE_NNK_CASE(24)
    PM_TILE_NNK_CASE(25) PM_TILE_NNK_CASE(26) PM_TILE_NNK_CASE(27)
    PM_TILE_NNK_CASE(28) PM_TILE_NNK_CASE(29) PM_TILE_NNK_CASE(30)
    PM_TILE_NNK_CASE(31) PM_TILE_NNK_CASE(32)
#undef PM_TILE_NNK_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

int pm_tile_max_teams() { return kMaxTeams; }
int pm_tile_min_cols() { return kT4Cols; }
int pm_tile_min_one_max() { return kMinOneMax; }
int pm_tile_t5_threads() { return kT5Threads; }

// T4 (kernel 4) or T5 (kernel 5): q [T, tq, 8], cand [T, 8, M]; out_d
// [T, tq]. `team` threads a tile (a power of two, 8..256;
// tile_cuda.t4_team, t5_shape), a tile of more than kT4Q * team queries in
// slices on gridDim.y. T4 packs kT4Threads / team tiles a block; T5 takes
// one tile a block in kT5Threads / team column slices, and M <=
// pm_tile_min_one_max().
int pm_tile_min(const float* q, const float* cand, int T, int tq, int M,
                int dim, int kernel, int team, float* out_d, void* stream) {
  if (T == 0 || tq == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int vec = M % 4 == 0 && (uintptr_t)cand % 16 == 0;
  const int most = kernel == 4 ? kT4Threads : kT5Threads;
  const int team_log2 = team_log2_of(team, most);
  if (team_log2 < 0) return cudaErrorInvalidValue;
  const int slice = kT4Q << team_log2;
  if (kernel == 4) {
    const int per_block = kT4Threads >> team_log2;
    const dim3 grid((unsigned)((T + per_block - 1) / per_block),
                    (unsigned)((tq + slice - 1) / slice));
    tile_min_staged<<<grid, kT4Threads, 0, st>>>(q, cand, T, tq, M, dim,
                                                 team_log2, vec, out_d);
  } else if (kernel == 5) {
    if (M > kMinOneMax) return cudaErrorInvalidValue;
    const int groups = (M + kGroup - 1) / kGroup;
    const int slices = kT5Threads >> team_log2;
    const int span = (groups + slices - 1) / slices * kGroup;
    const size_t bytes = (3 * (size_t)groups * kGroup + kT5Scratch) * sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(
        tile_min_one, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid((unsigned)T, (unsigned)((tq + slice - 1) / slice));
    tile_min_one<<<grid, kT5Threads, bytes, st>>>(q, cand, tq, M, dim,
                                                  team_log2, span, vec, out_d);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* pm_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
