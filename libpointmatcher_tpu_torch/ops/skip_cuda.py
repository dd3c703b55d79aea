"""The v1 skip route's kernels on the card, each beside its plain version.

========  ===========================================  ============================
kernel    replaces (TPU, Pallas)                       plain version
========  ===========================================  ============================
K10       knn_skip.py::approx_min_sorted               :func:`approx_min_sorted_plain`
K11       knn_skip.py::nn1_sorted_skip                 :func:`nn1_sorted_skip_plain`
========  ===========================================  ============================

The kernels are CUDA C++ in ``csrc/skip.cu`` (see its header for the design,
for what bounds them, and for the error bound of K10 that sets
``ops.skip.BOUND_ERR_C``), built at first use by :mod:`.cuda_build`. The
tables are those of :mod:`.skip`: ``qa [..., n_pad, 8]``, ``ra [8,
m_pad]``, ``rt [8, m_pad]``, ``rpen [1, m_pad]``, ``skip [B, ni, nsg]``
int32 per (``TILE_Q``-query tile, ``128·GROUP``-row super-chunk).

Each wrapper call launches two kernels: K10 its chunk table (per
``BOUND_CHUNK`` map columns) and its pruned sweep, K11 its segment sweep
(``SEGMENTS`` segments of each tile's list) and their merge; the scratch
of both is allocated here with ``torch.empty``.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernels or raises. There is no fallback between the two. Each
wrapper counts its calls that launch in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import KernelLibrary

__all__ = ["approx_min_sorted", "nn1_sorted_skip", "approx_min_sorted_plain",
           "nn1_sorted_skip_plain", "build", "LIBRARY", "TILE_Q", "GROUP",
           "SUPER", "SEGMENTS", "BOUND_CHUNK", "reset_launch_counts"]

#: queries per K11 tile (one row of skip flags each)
TILE_Q = 256
#: 128-row chunks per super-chunk (one skip flag each)
GROUP = 4
SUPER = 128 * GROUP
#: segments of a tile's list in K11 (csrc/skip.cu kSegments)
SEGMENTS = 8
#: map columns per chunk of K10's table and prune (csrc/skip.cu kChunk)
BOUND_CHUNK = 128
_DPAD = 8
_TERMS = 5         # non-zero columns of the augmented dot product
_MAX_SUPER = 48 * 1024 // 4     # K11's list in 48 KB of shared memory


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pm_approx_min.argtypes = [p, ctypes.c_longlong, p, i, p, p, p]
    lib.pm_approx_min.restype = i
    lib.pm_nn1_skip.argtypes = [p, p, i, i, p, p, i, p, i, i, p, p, p, p, p]
    lib.pm_nn1_skip.restype = i
    for fn in ("pm_skip_tile", "pm_skip_group", "pm_skip_segments",
               "pm_bound_chunk"):
        getattr(lib, fn).restype = i
    if ((lib.pm_skip_tile(), lib.pm_skip_group(), lib.pm_skip_segments(),
         lib.pm_bound_chunk()) != (TILE_Q, GROUP, SEGMENTS, BOUND_CHUNK)):
        raise RuntimeError("csrc/skip.cu tiles differ from ops/skip_cuda.py")


LIBRARY = KernelLibrary("skip.cu", _declare)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    return LIBRARY.load()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------------------ K10
def _check_bound(qa, ra):
    if qa.dtype != torch.float32 or qa.ndim < 2 or qa.shape[-1] != _DPAD:
        raise ValueError(f"qa must be float32 [..., n_pad, {_DPAD}], got "
                         f"{qa.dtype} {tuple(qa.shape)}")
    if ra.dtype != torch.float32 or ra.ndim != 2 or ra.shape[0] != _DPAD:
        raise ValueError(f"ra must be float32 [{_DPAD}, m_pad], got "
                         f"{ra.dtype} {tuple(ra.shape)}")
    if qa.device != ra.device:
        raise ValueError(f"inputs on several devices: {qa.device}, {ra.device}")
    if ra.shape[1] >= 2**31:
        raise ValueError("the map must hold fewer than 2^31 columns")


def approx_min_sorted_plain(qa, ra, block_rows: int = 4096):
    """Plain version of K10: per query row of ``qa``, the minimum over the
    columns of ``ra`` of (((a0·r0 + a1·r1) + a2·r2) + a3·r3) + a4·r4, each
    product and sum a rounded torch operation in that order."""
    flat = qa.reshape(-1, _DPAD)
    out = torch.empty(flat.shape[0], dtype=torch.float32, device=qa.device)
    if ra.shape[1] == 0:
        return out.fill_(float("inf")).reshape(qa.shape[:-1])
    for r0 in range(0, flat.shape[0], block_rows):
        a = flat[r0:r0 + block_rows]
        s = a[:, 0, None] * ra[0][None, :]
        for c in range(1, _TERMS):
            s = s + a[:, c, None] * ra[c][None, :]
        out[r0:r0 + block_rows] = s.amin(dim=1)
    return out.reshape(qa.shape[:-1])


def approx_min_sorted(qa, ra):
    """K10: ``qa [..., n_pad, 8]`` augmented queries, ``ra [8, m_pad]`` the
    augmented sorted map → ``[..., n_pad]``, each query's minimum of the
    expansion-form distance over the map: a bound's ingredient only (see
    :func:`.skip.bound_margin`).

    Precondition: column 3 of ``qa`` and row 4 of ``ra`` are 1 everywhere,
    padding rows and columns included, as :func:`.skip.augment_queries` and
    :func:`.skip.augmented_ref_table` build them. The kernel then takes
    a3·r3 = r3 and a4·r4 = a4 exactly and returns the plain version's bits;
    on other tables its result differs from the plain version's, unchecked.
    On the CPU the plain version computes the general five-term form."""
    _check_bound(qa, ra)
    if qa.device.type == "cpu":
        return approx_min_sorted_plain(qa, ra)
    lib = build()
    qa, ra = qa.contiguous(), ra.contiguous()
    out = torch.empty(qa.shape[:-1], dtype=torch.float32, device=qa.device)
    nch = -(-ra.shape[1] // BOUND_CHUNK)
    tab = torch.empty(9 * max(nch, 1), dtype=torch.float32, device=qa.device)
    err = lib.pm_approx_min(qa.data_ptr(), out.numel(), ra.data_ptr(),
                            ra.shape[1], tab.data_ptr(), out.data_ptr(),
                            _stream(qa))
    LIBRARY.check(err, "K10 approx_min_sorted")
    approx_min_sorted.launches += 1
    return out


# ------------------------------------------------------------------ K11
def _check_skip(qs, qm, rt, rpen, skip):
    if qs.dtype != torch.float32 or qs.ndim != 3 or qs.shape[2] not in (2, 3):
        raise ValueError(f"qs must be float32 [B, n, 2 or 3], got {qs.dtype} "
                         f"{tuple(qs.shape)}")
    B, n, _ = qs.shape
    if qm.dtype != torch.bool or tuple(qm.shape) != (B, n):
        raise ValueError(f"qm must be bool {(B, n)}, got {qm.dtype} "
                         f"{tuple(qm.shape)}")
    if (rt.dtype != torch.float32 or rt.ndim != 2 or rt.shape[0] != _DPAD
            or rt.shape[1] % 128):
        raise ValueError(f"rt must be float32 [{_DPAD}, m_pad] with m_pad a "
                         f"multiple of 128, got {rt.dtype} {tuple(rt.shape)}")
    m_pad = rt.shape[1]
    if rpen.dtype != torch.float32 or tuple(rpen.shape) != (1, m_pad):
        raise ValueError(f"rpen must be float32 (1, {m_pad}), got {rpen.dtype} "
                         f"{tuple(rpen.shape)}")
    want = (B, -(-n // TILE_Q), -(-m_pad // SUPER))
    if skip.dtype != torch.int32 or tuple(skip.shape) != want:
        raise ValueError(f"skip must be int32 {want}, got {skip.dtype} "
                         f"{tuple(skip.shape)}")
    devs = {t.device for t in (qs, qm, rt, rpen, skip)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if B * n >= 2**31 or m_pad >= 2**31:
        raise ValueError("row counts must fit in int32")


def nn1_sorted_skip_plain(qs, qm, rt, rpen, skip):
    """Plain version of K11: per tile, d² = ((pen + dx²) + dy²) + dz² to every
    map row, +inf at the rows of skipped super-chunks, and the first of the
    equal minima (the lowest sorted index); +inf at masked queries, id −1
    where d² is not finite."""
    B, n, d = qs.shape
    m_pad = rt.shape[1]
    ni = skip.shape[1]
    qp = torch.zeros((B, ni * TILE_Q, 3), dtype=torch.float32, device=qs.device)
    qp[:, :n, :d] = qs
    tiles = qp.reshape(B * ni, TILE_Q, 3)
    cols = skip.reshape(B * ni, -1).repeat_interleave(SUPER, dim=1)[:, :m_pad] != 0
    out_d = torch.empty((B * ni, TILE_Q), dtype=torch.float32, device=qs.device)
    out_i = torch.empty((B * ni, TILE_Q), dtype=torch.int64, device=qs.device)
    step = max(1, (1 << 24) // (TILE_Q * max(m_pad, 1)))
    for t0 in range(0, B * ni, step):
        q = tiles[t0:t0 + step]
        d2 = rpen[0][None, None, :]
        for c in range(3):
            diff = q[:, :, c, None] - rt[c][None, None, :]
            d2 = d2 + diff * diff
        d2 = torch.where(cols[t0:t0 + step, None, :], float("inf"), d2)
        best = torch.argmin(d2, dim=2, keepdim=True)       # first of equal minima
        out_d[t0:t0 + step] = torch.gather(d2, 2, best)[..., 0]
        out_i[t0:t0 + step] = best[..., 0]
    dist = out_d.reshape(B, -1)[:, :n]
    ids = out_i.reshape(B, -1)[:, :n].to(torch.int32)
    dist = torch.where(qm, dist, float("inf"))
    ids = torch.where(qm & torch.isfinite(dist), ids, -1)
    return dist, ids


def nn1_sorted_skip(qs, qm, rt, rpen, skip):
    """K11: exact 1-NN of ``qs [B, n, d]`` (Morton-sorted) against the
    resident sorted map, sweeping per tile only the super-chunks it does not
    skip → ``(d2 [B, n], id [B, n] int32)``; ids index the sorted map,
    (+inf, −1) at masked queries, −1 wherever d² is not finite."""
    _check_skip(qs, qm, rt, rpen, skip)
    if qs.device.type == "cpu":
        return nn1_sorted_skip_plain(qs, qm, rt, rpen, skip)
    if skip.shape[2] > _MAX_SUPER:
        raise ValueError(f"K11 lists at most {_MAX_SUPER} super-chunks "
                         f"({_MAX_SUPER * SUPER} map rows), got {skip.shape[2]}")
    lib = build()
    B, n, d = qs.shape
    if d == 2:       # rt's row 2 is zero: a zero z adds 0 to every d²
        qs = torch.nn.functional.pad(qs, (0, 1))
    qs, qm8 = qs.contiguous(), qm.contiguous().view(torch.uint8)
    rt, rpen, skip = rt.contiguous(), rpen.contiguous(), skip.contiguous()
    ni = skip.shape[1]
    part_d = torch.empty((SEGMENTS, B, ni * TILE_Q), dtype=torch.float32,
                         device=qs.device)
    part_i = torch.empty((SEGMENTS, B, ni * TILE_Q), dtype=torch.int32,
                         device=qs.device)
    out_d = torch.empty((B, n), dtype=torch.float32, device=qs.device)
    out_i = torch.empty((B, n), dtype=torch.int32, device=qs.device)
    err = lib.pm_nn1_skip(qs.data_ptr(), qm8.data_ptr(), B, n, rt.data_ptr(),
                          rpen.data_ptr(), rt.shape[1], skip.data_ptr(), ni,
                          skip.shape[2], part_d.data_ptr(), part_i.data_ptr(),
                          out_d.data_ptr(), out_i.data_ptr(), _stream(qs))
    LIBRARY.check(err, "K11 nn1_sorted_skip")
    nn1_sorted_skip.launches += 1
    return out_d, out_i


def reset_launch_counts() -> None:
    for fn in (approx_min_sorted, nn1_sorted_skip):
        fn.launches = 0


reset_launch_counts()
