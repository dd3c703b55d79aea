"""Spans and the profiled sub-window of a traced run.

The spans are the benchmark's own: a wrapper installed on the engine's
``ICPSequence._step`` times the host's enqueue of each iteration and counts
the iterations, and the time from a call's start to its first iteration is
the serving driver's prep. The program is not changed.

``device_us`` is a frozen copy of ``tools_torch/profile_registration.py::
_device_us``; the busy share (traced kernel time per iteration over the
untraced wall time per iteration of the same process) is the arithmetic of
``tools_torch/profile_serving.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


def device_us(evt) -> float:
    """A profiler event's own device time in µs (0 for a host event)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def is_device(evt) -> bool:
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


@dataclass
class CallSpans:
    """One serving call as the host saw it."""

    start: float
    end: float = 0.0
    first_step: Optional[float] = None
    steps: int = 0
    enqueue_s: float = 0.0

    @property
    def prep_s(self) -> float:
        return (self.first_step if self.first_step is not None else self.end) - self.start


class StepSpans:
    """Wraps ``seq._step``: per call, the first iteration's start, the
    iterations and the host seconds spent inside them. With ``labels``, each
    host phase is also a ``torch.profiler.record_function`` range named
    ``regbench.<phase>`` (prep, step_enqueue, flag_wait), so a profiled
    window can say what the host was doing while the device sat idle."""

    def __init__(self, seq):
        self.seq = seq
        self._inner = seq._step
        self.calls: List[CallSpans] = []
        self.labels = False
        self._range = None
        seq._step = self._step

    def remove(self) -> None:
        self.seq._step = self._inner

    def _open(self, name: str) -> None:
        if self.labels:
            from torch.profiler import record_function
            self._range = record_function(f"regbench.{name}")
            self._range.__enter__()

    def _close(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def begin(self) -> None:
        self.calls.append(CallSpans(time.perf_counter()))
        self._open("prep")

    def end(self) -> None:
        self._close()
        self.calls[-1].end = time.perf_counter()

    def _step(self, *args, **kwargs):
        call = self.calls[-1]
        self._close()
        self._open("step_enqueue")
        t = time.perf_counter()
        if call.first_step is None:
            call.first_step = t
        out = self._inner(*args, **kwargs)
        call.enqueue_s += time.perf_counter() - t
        call.steps += 1
        self._close()
        self._open("flag_wait")
        return out


@dataclass
class Profile:
    """What a profiled sub-window read."""

    wall_s: float
    steps: int
    device_s: float                      # summed device time of every op
    busy_s: float                        # union of the ops' device intervals
    ops: int                             # device operations (launches, copies)
    by_name: List[Tuple[str, float, int]] = field(default_factory=list)
    gaps: List[Tuple[str, float]] = field(default_factory=list)


def read_profile(prof, wall_s: float, steps: int) -> Profile:
    """Device time by name, busy time and the idle gaps, each gap named by
    the ``regbench.*`` host range open when it began (``other`` if none)."""
    by = []
    for evt in prof.key_averages():
        us = device_us(evt)
        # the host ranges also appear on the device's timeline: not ops
        if us > 0 and is_device(evt) and not evt.key.startswith("regbench."):
            by.append((evt.key, us / 1e6, int(evt.count)))
    by.sort(key=lambda x: -x[1])
    kern, host = [], []
    for evt in prof.events():
        tr = evt.time_range
        if is_device(evt):
            if not evt.name.startswith("regbench."):
                kern.append((tr.start, tr.end))
        elif evt.name.startswith("regbench."):
            host.append((tr.start, tr.end, evt.name[len("regbench."):]))
    kern.sort()
    host.sort()
    merged: List[List[float]] = []
    for s, e in kern:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_us = sum(e - s for s, e in merged)
    gaps = []
    j = 0
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        while j < len(host) and host[j][1] < e0:
            j += 1
        label = host[j][2] if j < len(host) and host[j][0] <= e0 else "other"
        gaps.append((label, (s1 - e0) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return Profile(wall_s=wall_s, steps=steps,
                   device_s=sum(b[1] for b in by), busy_s=busy_us / 1e6,
                   ops=sum(b[2] for b in by), by_name=by, gaps=gaps)
