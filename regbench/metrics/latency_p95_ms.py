"""95th percentile over the window's calls of the host-clock time from a
call's start to its poses on the host (every scan of a call waits that
long). The count and the median go to standard error beside it."""

import sys

import numpy as np


def read(ctx):
    lat = 1e3 * np.asarray(ctx.latencies)
    print(f"latency: {len(lat)} calls, median {float(np.median(lat))!r} ms",
          file=sys.stderr)
    return float(np.percentile(lat, 95))
