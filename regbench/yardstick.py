"""The benchmark's table of peaks and its byte counts.

Peaks are NVIDIA's published figures for one H100 SXM (80 GB HBM3), dense
rates without sparsity, at its 700 W limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

#: bytes of a point (three float32 coordinates) and of a match (float32
#: squared distance and int32 row)
POINT_BYTES = 12
MATCH_BYTES = 8


def match_bytes(query_rows: int, map_rows: int) -> int:
    """The bytes any exact 1-NN of ``query_rows`` valid queries against a
    map of ``map_rows`` rows must move: every query and map row read once,
    every (distance, row) written once."""
    return (POINT_BYTES + MATCH_BYTES) * int(query_rows) + POINT_BYTES * int(map_rows)
