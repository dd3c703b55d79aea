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
product's tiling. The kernels are CUDA C++ in ``csrc/knn_variants.cu`` (see
its header for each design), built at first use by :mod:`.cuda_build`.
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
from .knn_cuda import _check_inputs, _split

__all__ = ["knn1_chunked", "knn1_transposed", "knn1_mxu", "knn1_mxu3_plain",
           "build", "LIBRARY", "reset_launch_counts"]


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pm_nn1_chunked.argtypes = [p, p, i, p, p, i, i, i, i, p, p, p, p, p]
    lib.pm_nn1_chunked.restype = i
    for fn in (lib.pm_nn1_transposed, lib.pm_nn1_mxu):
        fn.argtypes = [p, p, i, p, p, i, i, p, p, p]
        fn.restype = i
    lib.pm_tile_rows.argtypes = []
    lib.pm_tile_rows.restype = i


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
    if name == "chunked":
        splits, chunk = _split(lib, n, m, q.device)
        part_d = torch.empty((splits, n), dtype=torch.float32, device=q.device)
        part_i = torch.empty((splits, n), dtype=torch.int32, device=q.device)
        err = lib.pm_nn1_chunked(*head, splits, chunk, part_d.data_ptr(),
                                 part_i.data_ptr(), *tail)
    elif name == "transposed":
        err = lib.pm_nn1_transposed(*head, *tail)
    else:
        err = lib.pm_nn1_mxu(*head, *tail)
    LIBRARY.check(err, f"1-NN {name} kernel")
    return out_d, out_i


def knn1_chunked(query, query_mask, ref, ref_mask):
    """T1: exact 1-NN, eight per-thread accumulators merged once →
    ``(d2 [N], id [N])``, K1's result bit for bit."""
    _check(query, query_mask, ref, ref_mask)
    if query.device.type == "cpu":
        return _plain_nn1(query, query_mask, ref, ref_mask)
    out = _launch("chunked", query, query_mask, ref, ref_mask)
    knn1_chunked.launches += 1
    return out


def knn1_transposed(query, query_mask, ref, ref_mask):
    """T2: exact 1-NN, eight queries a thread, 2048 a block →
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
    """T3: 1-NN in the expansion form, in 128 x 128 product tiles →
    ``(d2 [N], id [N])``, within 2^-20·(q² + r²) of the exact d²."""
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
