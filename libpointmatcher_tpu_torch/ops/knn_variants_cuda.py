"""The experimental 1-NN lowerings on the card, each beside its plain
version (counterpart of ``tools/knn_variants.py``).

========  ====================================  ==============================
kernel    replaces (TPU, Pallas)                plain version
========  ====================================  ==============================
T1        knn_variants.py::knn1_chunked         ``ops.knn.knn_brute_force``
T2        knn_variants.py::knn1_transposed      ``ops.knn.knn_brute_force``
T3        knn_variants.py::knn1_mxu             :func:`knn1_mxu3_plain`
========  ====================================  ==============================

T1 and T2 compute K1's function, the exact difference-form 1-NN, with
other schedules; T3 the expansion form ‖q‖² + ‖r‖² − 2 q·r in a matrix
product's tiling. T1, T2 and T3 cut the reference into chunks over the
grid (:func:`t1_split`, :func:`t2_split`, :func:`t3_split`) and merge
the chunks' partials in order in a second kernel. The kernels are CUDA C++
in ``csrc/knn_variants.cu`` (see its header for each design), built at
first use by :mod:`.cuda_build`.
``tools_torch/knn_micro.py`` times them against K1 and K9; nothing in the
engine calls them.

Each takes ``(query [N, d], query_mask [N], ref [M, d], ref_mask [M])``,
d = 2 or 3, and returns ``(d2 [N], id [N] int32)``: (+inf, −1) for a masked
query or one with no valid reference, the lowest index among equal
distances. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises. Each wrapper counts its kernel
launches in ``<wrapper>.launches``.

T3's ``precision`` is the JAX variant's: only ``"highest"`` runs. The TPU's
``"high"`` and ``"default"`` select bf16 passes of its matrix unit, which
have no fp32 counterpart on the card and are refused.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import KernelLibrary
from .knn import knn_brute_force
from .knn_cuda import GROUP_ROWS, _check_inputs, _sms, _split

__all__ = ["knn1_chunked", "knn1_transposed", "knn1_mxu", "knn1_mxu3_plain",
           "t1_split", "t2_split", "t3_split", "build", "LIBRARY",
           "T1_BLOCK_QUERIES", "T2_BLOCK_QUERIES", "T3_BLOCK_QUERIES",
           "reset_launch_counts"]

#: T1's queries a block (csrc/knn_variants.cu kT1BlockQueries: 128 threads,
#: 4 queries each), its accumulators a query (kT1Acc, accumulator a taking
#: the rows j ≡ a mod T1_ACCUMULATORS), and its split rule, K1's
#: (:func:`.knn_cuda._split`) for T1's block: its aim, blocks per SM over
#: queries × chunks, and its chunks' granularity, one shared stage (T2's
#: kT2Stage)
T1_BLOCK_QUERIES = 512
T1_ACCUMULATORS = 2
T1_BLOCKS_PER_SM = 16
T1_CHUNK_ROWS = 512

#: T2's queries a block (csrc/knn_variants.cu: 128 threads, 4 queries each)
T2_BLOCK_QUERIES = 512
#: T2's split rule, K1's (:func:`.knn_cuda._split`) for T2's block: its aim,
#: blocks per SM over queries × chunks, and its chunks' granularity, one
#: shared stage (csrc/knn_variants.cu kT2Stage)
T2_BLOCKS_PER_SM = 16
T2_CHUNK_ROWS = 512
#: T3's query rows a block (csrc/knn_variants.cu kT3Rows: 256 threads, a
#: 4 x 8 micro-tile each), its split rule's aim (blocks per SM over queries ×
#: chunks) and its chunks' granularity, one shared stage (kT3Stage)
T3_BLOCK_QUERIES = 64
T3_BLOCKS_PER_SM = 8
T3_CHUNK_COLS = 256


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.pm_nn1_chunked, lib.pm_nn1_transposed, lib.pm_nn1_mxu):
        fn.argtypes = [p, p, i, p, p, i, i, i, i, p, p, p, p, p]
        fn.restype = i
    consts = (lib.pm_t1_block_queries, lib.pm_t1_stage_rows,
              lib.pm_t1_accumulators, lib.pm_t2_block_queries,
              lib.pm_t2_stage_rows, lib.pm_t2_group_rows,
              lib.pm_t3_block_queries, lib.pm_t3_stage_cols)
    for fn in consts:
        fn.argtypes = []
        fn.restype = i
    if (tuple(fn() for fn in consts)
            != (T1_BLOCK_QUERIES, T1_CHUNK_ROWS, T1_ACCUMULATORS,
                T2_BLOCK_QUERIES, T2_CHUNK_ROWS, GROUP_ROWS, T3_BLOCK_QUERIES,
                T3_CHUNK_COLS)):
        raise RuntimeError("csrc/knn_variants.cu T1's, T2's or T3's block, "
                           "stage, accumulators or group differ from "
                           "ops/knn_variants_cuda.py")


LIBRARY = KernelLibrary("knn_variants.cu", _declare)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    return LIBRARY.load()


def _check(query, query_mask, ref, ref_mask) -> None:
    if _check_inputs(query, query_mask, ref, ref_mask):
        raise ValueError("the variants take one query set and one reference, "
                         "no pair axis")


def _plain_nn1(query, query_mask, ref, ref_mask):
    d, i = knn_brute_force(query, query_mask, ref, ref_mask, k=1)
    return d[:, 0], i[:, 0]


def t1_split(n: int, m: int, sms: int) -> tuple:
    """T1's reference chunks over gridDim.y → ``(splits, chunk)``: K1's
    rule for T1's block of ``T1_BLOCK_QUERIES`` queries, aiming at
    ``T1_BLOCKS_PER_SM``, chunks of whole ``T1_CHUNK_ROWS``."""
    return _split(n, m, sms, aim=T1_BLOCKS_PER_SM, block=T1_BLOCK_QUERIES,
                  rows=T1_CHUNK_ROWS)


def t2_split(n: int, m: int, sms: int) -> tuple:
    """T2's reference chunks over gridDim.y → ``(splits, chunk)``: K1's
    rule for T2's block of ``T2_BLOCK_QUERIES`` queries, aiming at
    ``T2_BLOCKS_PER_SM``, chunks of whole ``T2_CHUNK_ROWS``."""
    return _split(n, m, sms, aim=T2_BLOCKS_PER_SM, block=T2_BLOCK_QUERIES,
                  rows=T2_CHUNK_ROWS)


def t3_split(n: int, m: int, sms: int) -> tuple:
    """T3's reference chunks over gridDim.y → ``(splits, chunk)``: K1's
    rule for T3's block of ``T3_BLOCK_QUERIES`` queries, aiming at
    ``T3_BLOCKS_PER_SM``, chunks of whole ``T3_CHUNK_COLS``."""
    return _split(n, m, sms, aim=T3_BLOCKS_PER_SM, block=T3_BLOCK_QUERIES,
                  rows=T3_CHUNK_COLS)


#: each variant's split rule; its launch is ``pm_nn1_<name>``
_SPLITS = {"chunked": t1_split, "transposed": t2_split, "mxu": t3_split}


def _launch(name, query, query_mask, ref, ref_mask):
    lib = build()
    q = query.contiguous()
    r = ref.contiguous()
    qm = query_mask.contiguous().view(torch.uint8)
    rm = ref_mask.contiguous().view(torch.uint8)
    n, dim = q.shape
    m = r.shape[0]
    out_d = torch.empty(n, dtype=torch.float32, device=q.device)
    out_i = torch.empty(n, dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    head = (q.data_ptr(), qm.data_ptr(), n, r.data_ptr(), rm.data_ptr(), m, dim)
    tail = (out_d.data_ptr(), out_i.data_ptr(), stream)
    # partials per reference chunk, merged in order
    splits, chunk = _SPLITS[name](n, m, _sms(q.device))
    part_d = torch.empty((splits, n), dtype=torch.float32, device=q.device)
    part_i = torch.empty((splits, n), dtype=torch.int32, device=q.device)
    err = getattr(lib, f"pm_nn1_{name}")(*head, splits, chunk, part_d.data_ptr(),
                                         part_i.data_ptr(), *tail)
    LIBRARY.check(err, f"1-NN {name} kernel")
    return out_d, out_i


def knn1_chunked(query, query_mask, ref, ref_mask):
    """T1: exact 1-NN, four queries a thread, each with
    ``T1_ACCUMULATORS`` (min, id) accumulators updated by a compare and
    selects on every pair and merged once a chunk, the reference cut into
    chunks over the grid (:func:`t1_split`) and merged in order →
    ``(d2 [N], id [N])``, K1's result bit for bit."""
    _check(query, query_mask, ref, ref_mask)
    if query.device.type == "cpu":
        return _plain_nn1(query, query_mask, ref, ref_mask)
    out = _launch("chunked", query, query_mask, ref, ref_mask)
    knn1_chunked.launches += 1
    return out


def knn1_transposed(query, query_mask, ref, ref_mask):
    """T2: exact 1-NN, four queries a thread, 512 a block, the reference
    cut into chunks over the grid (:func:`t2_split`) and merged in order →
    ``(d2 [N], id [N])``, K1's result bit for bit."""
    _check(query, query_mask, ref, ref_mask)
    if query.device.type == "cpu":
        return _plain_nn1(query, query_mask, ref, ref_mask)
    out = _launch("transposed", query, query_mask, ref, ref_mask)
    knn1_transposed.launches += 1
    return out


def knn1_mxu3_plain(query, query_mask, ref, ref_mask, tile_m: int = 4096):
    """Plain version of T3: ``dot = (q₀r₀ + q₁r₁) + q₂r₂``, ``q² = q·q``
    and ``r² = r·r`` in the same order, ``d² = (q² + r²pen) − 2·dot`` with
    pen = +inf at masked rows, each step a rounded torch op in the kernel's
    order, so the two agree bit for bit; argmin with the lowest index on
    ties, then clamped at 0."""
    n, dim = query.shape
    inf = float("inf")

    def dot(a, b):
        s = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
        return s + a[..., 2] * b[..., 2] if dim == 3 else s

    q2 = dot(query, query)
    r2pen = torch.where(ref_mask, dot(ref, ref), torch.full_like(ref[:, 0], inf))
    best_d = torch.full((n,), inf, dtype=torch.float32, device=query.device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=query.device)
    for t0 in range(0, ref.shape[0], tile_m):
        d2 = ((q2[:, None] + r2pen[None, t0:t0 + tile_m])
              - 2.0 * dot(query[:, None, :], ref[None, t0:t0 + tile_m, :]))
        ti = torch.argmin(d2, dim=1)
        td = torch.gather(d2, 1, ti[:, None])[:, 0]
        take = td < best_d
        best_d = torch.where(take, td, best_d)
        best_i = torch.where(take, ti + t0, best_i)
    best_d = torch.clamp(best_d, min=0.0)
    ok = torch.isfinite(best_d) & query_mask
    best_d = torch.where(query_mask, best_d, torch.full_like(best_d, inf))
    best_i = torch.where(ok, best_i, torch.full_like(best_i, -1))
    return best_d, best_i.to(torch.int32)


def knn1_mxu(query, query_mask, ref, ref_mask, precision: str = "highest"):
    """T3: 1-NN in the expansion form, 64 queries a block against 128-column
    product tiles, the reference cut into chunks over the grid
    (:func:`t3_split`) and merged in order before the clamp at 0 →
    ``(d2 [N], id [N])``, :func:`knn1_mxu3_plain` bit for bit, within
    2^-20·(q² + r²) of the exact d²."""
    if precision != "highest":
        raise ValueError(f"precision {precision!r} selects bf16 passes of the "
                         "TPU's matrix unit, which have no fp32 counterpart "
                         "here; only 'highest' runs")
    _check(query, query_mask, ref, ref_mask)
    if query.device.type == "cpu":
        return knn1_mxu3_plain(query, query_mask, ref, ref_mask)
    out = _launch("mxu", query, query_mask, ref, ref_mask)
    knn1_mxu.launches += 1
    return out


def reset_launch_counts() -> None:
    for fn in (knn1_chunked, knn1_transposed, knn1_mxu):
        fn.launches = 0


reset_launch_counts()
