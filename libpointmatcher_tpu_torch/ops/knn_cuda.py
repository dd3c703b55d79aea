"""The dense k-NN kernels on the card, each beside its plain version.

========  ==============================  =======================================
kernel    replaces (TPU, Pallas)          plain version (CPU path, comparisons)
========  ==============================  =======================================
K1        knn_pallas.py::knn1_pallas      ``ops.knn.knn_brute_force`` (k = 1)
K9        knn_pallas.py::knn1_pallas_mxu  :func:`knn1_mxu_plain`
K5        knn_pallas.py::knnk_pallas      ``ops.knn.knn_brute_force`` (k ≤ 32)
========  ==============================  =======================================

The kernels are CUDA C++ in ``csrc/knn.cu`` (see its header for the design
and for what bounds them), built at first use by :mod:`.cuda_build`. Each
takes one query set and one reference, or a pair axis: ``[B, N, d]``
queries against ``[B, M, d]`` references, pair b against its own, in one
launch.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. There is no fallback between the two. Each
wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import KernelLibrary
from .knn import knn_brute_force

__all__ = ["knn1", "knn1_mxu", "knnk", "knn1_mxu_plain", "k9_split", "build",
           "LIBRARY", "KNNK_MAX", "K9_BLOCK_QUERIES", "reset_launch_counts"]

#: largest k served by the K5 kernel (as ``knn_pallas.KNNK_MAX``)
KNNK_MAX = 32
#: K5's list lengths, one kernel instance each
KNNK_LISTS = tuple(range(2, KNNK_MAX + 1))
#: K1's and K5's chunk granularity (reference rows), mirrored from csrc/knn.cu
TILE_ROWS = 1024
#: K1's and K5's rows per group, mirrored from csrc/knn.cu
GROUP_ROWS = 8
#: the split rule's aim, blocks per SM over queries × chunks, per kernel.
#: K1 at 16 against 4 on an H100 (tools_torch/dense_micro.py): the dense
#: batch 0.697 against 0.754 ms, the pair axis 0.369 against 0.412, the
#: sequence 0.361 against 0.357.
BLOCKS_PER_SM = {"knn1": 16, "knnk": 4}
#: K9's queries a block (csrc/knn.cu kK9BlockQueries: 128 threads, 4
#: queries each), its rows a group and its chunks' granularity
#: (kK9Group), and the blocks an SM its launch bounds ask for
#: (kK9MinBlocks), mirrored and checked at load
K9_BLOCK_QUERIES = 512
K9_GROUP_ROWS = 16
K9_BLOCKS_PER_SM = 4
#: :func:`k9_split`'s waves to weigh, and its cost of a (query block,
#: chunk) unit beyond its rows, in rows (the first stage's load, the
#: partials' writes)
K9_MAX_WAVES = 8
K9_UNIT_ROWS = 128


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.pm_knn1, lib.pm_knn1_mxu):
        fn.argtypes = [p, p, i, p, p, i, i, i, i, i, p, p, p, p, p]
        fn.restype = i
    lib.pm_knnk.argtypes = [p, p, i, p, p, i, i, i, i, i, i, i, p, p, p, p, p]
    lib.pm_knnk.restype = i
    lib.pm_block_queries.argtypes = [i]
    for fn in ("pm_tile_rows", "pm_group_rows", "pm_block_queries",
               "pm_k9_block_queries", "pm_k9_group_rows", "pm_k9_min_blocks",
               "pm_k9_occupancy"):
        getattr(lib, fn).restype = i
    if ((lib.pm_tile_rows(), lib.pm_group_rows()) != (TILE_ROWS, GROUP_ROWS)
            or any(lib.pm_block_queries(kk) != block_queries(kk)
                   for kk in (0, *KNNK_LISTS))
            or (lib.pm_k9_block_queries(), lib.pm_k9_group_rows(),
                lib.pm_k9_min_blocks()) != (K9_BLOCK_QUERIES, K9_GROUP_ROWS,
                                            K9_BLOCKS_PER_SM)):
        raise RuntimeError("csrc/knn.cu tiles, groups or blocks differ from "
                           "ops/knn_cuda.py")
    if lib.pm_k9_occupancy() < K9_BLOCKS_PER_SM:
        raise RuntimeError(f"K9 fits {lib.pm_k9_occupancy()} blocks an SM, "
                           f"under the {K9_BLOCKS_PER_SM} its split assumes")


LIBRARY = KernelLibrary("knn.cu", _declare)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    return LIBRARY.load()


def _check_inputs(query, query_mask, ref, ref_mask):
    """Single search: query [N, d], ref [M, d]. Pairs: query [B, N, d] and
    ref [B, M, d], pair b searching its own reference. → B (0: single)."""
    pairs = query.ndim == 3
    for name, t in (("query", query), ("ref", ref)):
        if (t.dtype != torch.float32 or t.ndim != (3 if pairs else 2)
                or t.shape[-1] not in (2, 3)):
            raise ValueError(f"{name} must be float32 [rows, 2|3] or "
                             f"[pairs, rows, 2|3] for both, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if query.shape[-1] != ref.shape[-1]:
        raise ValueError("query and ref must have the same dimension")
    if pairs and query.shape[0] != ref.shape[0]:
        raise ValueError(f"{query.shape[0]} query sets for {ref.shape[0]} "
                         "references")
    for name, t, shape in (("query_mask", query_mask, query.shape[:-1]),
                           ("ref_mask", ref_mask, ref.shape[:-1])):
        if t.dtype != torch.bool or t.shape != shape:
            raise ValueError(f"{name} must be bool {tuple(shape)}")
    devs = {t.device for t in (query, query_mask, ref, ref_mask)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if max(query.numel(), ref.numel()) >= 2**31:
        raise ValueError("row counts must fit in int32")
    return query.shape[0] if pairs else 0


def knnk_list(k: int) -> int:
    """K5's register list length for ``k``: k itself, at least 2."""
    return max(2, k)


def block_queries(kk: int = 0) -> int:
    """Queries a block takes: K1 (``kk`` 0) 256, K5 128."""
    return 128 if kk else 256


def _split(n: int, m: int, sms: int, pairs: int = 1, kk: int = 0,
           aim: int = 4, block: int = 0, rows: int = TILE_ROWS) -> tuple:
    """Reference chunks over gridDim.y → ``(splits, chunk)``: enough blocks
    for ~``aim`` per SM, each chunk a whole number of ``rows``,
    ``splits * chunk >= m``. ``block`` and ``rows``: the queries a block
    takes and the chunks' granularity where not :func:`block_queries` and
    ``TILE_ROWS`` (T2's, ``knn_variants_cuda.t2_split``)."""
    qblocks = max(1, -(-n // (block or block_queries(kk)))) * max(pairs, 1)
    splits = max(1, min(-(-aim * sms // qblocks), -(-m // rows)))
    chunk = rows * -(-max(m, 1) // (rows * splits))
    splits = max(1, -(-m // chunk))
    return splits, chunk


def k9_split(n: int, m: int, sms: int, pairs: int = 1) -> tuple:
    """K9's reference chunks over gridDim.y → ``(splits, chunk)``, cut to
    fill whole waves: with U query blocks of ``K9_BLOCK_QUERIES`` (over
    every pair) and ``K9_BLOCKS_PER_SM × sms`` slots, each count of waves
    w ≤ ``K9_MAX_WAVES`` offers the most splits that fit in w waves, chunks
    of whole ``K9_GROUP_ROWS`` groups; the rule keeps the offer of least
    waves × (chunk + ``K9_UNIT_ROWS``), the fewest splits on a tie.
    ``splits * chunk >= m`` and no chunk is empty."""
    units = max(1, -(-n // K9_BLOCK_QUERIES)) * max(pairs, 1)
    slots = K9_BLOCKS_PER_SM * sms
    groups = max(1, -(-m // K9_GROUP_ROWS))
    best = None
    for w in range(1, K9_MAX_WAVES + 1):
        chunk = K9_GROUP_ROWS * -(-groups // max(1, min(w * slots // units, groups)))
        splits = max(1, -(-m // chunk))
        cost = -(-units * splits // slots) * (chunk + K9_UNIT_ROWS)
        if best is None or (cost, splits) < best[0]:
            best = ((cost, splits), (splits, chunk))
    return best[1]


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_knn1(query, query_mask, ref, ref_mask, mxu: bool, pairs: int):
    lib = build()
    q = query.contiguous()
    r = ref.contiguous()
    qm = query_mask.contiguous().view(torch.uint8)
    rm = ref_mask.contiguous().view(torch.uint8)
    b = max(pairs, 1)
    n, dim = q.shape[-2:]
    m = r.shape[-2]
    if mxu:
        splits, chunk = k9_split(n, m, _sms(q.device), b)
    else:
        splits, chunk = _split(n, m, _sms(q.device), b,
                               aim=BLOCKS_PER_SM["knn1"])
    part_d = torch.empty((b, splits, n), dtype=torch.float32, device=q.device)
    part_i = torch.empty((b, splits, n), dtype=torch.int32, device=q.device)
    out_d = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    out_i = torch.empty(q.shape[:-1], dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = (lib.pm_knn1_mxu if mxu else lib.pm_knn1)(
        q.data_ptr(), qm.data_ptr(), n, r.data_ptr(), rm.data_ptr(), m, b, dim,
        splits, chunk, part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), stream)
    LIBRARY.check(err, "k-NN kernel")
    return out_d, out_i


def knn1(query, query_mask, ref, ref_mask):
    """K1: exact 1-NN → ``(d2 [N], id [N])``, (+inf, −1) invalid; with a
    pair axis (query [B, N, d], ref [B, M, d]) one launch gives
    ``[B, N]``, each pair against its own reference."""
    pairs = _check_inputs(query, query_mask, ref, ref_mask)
    if query.device.type == "cpu":
        d, i = knn_brute_force(query, query_mask, ref, ref_mask, k=1)
        return d[..., 0], i[..., 0]
    out = _launch_knn1(query, query_mask, ref, ref_mask, False, pairs)
    knn1.launches += 1
    return out


def knn1_mxu_plain(query, query_mask, ref, ref_mask, tile_m: int = 4096):
    """Plain version of K9: d² = (q² + (r² + pen)) − 2·(q·r), each step a
    rounded torch op (the kernel fuses the products into FMAs, so the two
    agree within the tolerance that rounding allows, not bit for bit);
    argmin with the lowest index on ties, then clamped at 0."""
    n, dim = query.shape
    m = ref.shape[0]
    inf = float("inf")
    sq = lambda x: ((x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1])
                    + (x[:, 2] * x[:, 2] if dim == 3 else 0.0))
    q2 = sq(query)
    r2pen = torch.where(ref_mask, sq(ref), torch.full_like(ref[:, 0], inf))
    best_d = torch.full((n,), inf, dtype=torch.float32, device=query.device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=query.device)
    for t0 in range(0, m, tile_m):
        r = ref[t0:t0 + tile_m]
        dot = None
        for c in range(dim):
            term = query[:, c, None] * r[None, :, c]
            dot = term if dot is None else dot + term
        d2 = (q2[:, None] + r2pen[None, t0:t0 + tile_m]) - 2.0 * dot
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


def knn1_mxu(query, query_mask, ref, ref_mask):
    """K9: 1-NN in the expansion form, (1+ε)-exact for ε at or above
    ``dispatch.MXU_EPSILON_FLOOR`` → ``(d2 [N], id [N])``."""
    pairs = _check_inputs(query, query_mask, ref, ref_mask)
    if query.device.type == "cpu":
        if pairs:
            return tuple(torch.stack(x) for x in zip(*(
                knn1_mxu_plain(*a) for a in zip(query, query_mask, ref,
                                                ref_mask))))
        return knn1_mxu_plain(query, query_mask, ref, ref_mask)
    out = _launch_knn1(query, query_mask, ref, ref_mask, True, pairs)
    knn1_mxu.launches += 1
    return out


def knnk(query, query_mask, ref, ref_mask, k: int):
    """K5: exact top-k, 2 ≤ k ≤ 32 → ``(d2 [N, k], id [N, k])`` ascending,
    lowest index first on ties, (+inf, −1) for missing neighbours; with a
    pair axis as :func:`knn1`, ``[B, N, k]``."""
    if not 1 <= k <= KNNK_MAX:
        raise ValueError(f"k must be in 1..{KNNK_MAX}, got {k}")
    pairs = _check_inputs(query, query_mask, ref, ref_mask)
    if query.device.type == "cpu":
        return knn_brute_force(query, query_mask, ref, ref_mask, k=k)
    lib = build()
    q = query.contiguous()
    r = ref.contiguous()
    qm = query_mask.contiguous().view(torch.uint8)
    rm = ref_mask.contiguous().view(torch.uint8)
    b = max(pairs, 1)
    n, dim = q.shape[-2:]
    m = r.shape[-2]
    kk = knnk_list(k)
    splits, chunk = _split(n, m, _sms(q.device), b, kk, BLOCKS_PER_SM["knnk"])
    part_d = torch.empty((b, splits, n, kk), dtype=torch.float32, device=q.device)
    part_i = torch.empty((b, splits, n, kk), dtype=torch.int32, device=q.device)
    out_d = torch.empty((*q.shape[:-1], k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((*q.shape[:-1], k), dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.pm_knnk(q.data_ptr(), qm.data_ptr(), n, r.data_ptr(),
                      rm.data_ptr(), m, b, dim, k, kk, splits, chunk,
                      part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
                      out_i.data_ptr(), stream)
    LIBRARY.check(err, "k-NN kernel")
    knnk.launches += 1
    return out_d, out_i


def reset_launch_counts() -> None:
    for fn in (knn1, knn1_mxu, knnk):
        fn.launches = 0


reset_launch_counts()
