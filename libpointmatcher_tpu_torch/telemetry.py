"""Host spans and counters of the port's public calls.

Each public entry (``register_batch_to_map``, ``register_queue_to_map``,
``register_batch``, ``ICP.compute``, ``ICPSequence.compute``) and
``ICPSequence.set_map`` opens one **call record** on the thread that runs
it; an entry called inside another's record (the queue falling back to the
batch) adds to that record. Inside it, the drivers, the engine and the step
open named **spans** and add to named **counters**:

=================  ====================================================
span               what it covers
=================  ====================================================
``call``           the whole call (the record's root)
``prep``           a call's prep, up to its loop. In a serving call its
                   children are ``prep.upload`` (the raw scans to the
                   device), ``prep.chain`` (every scan's reading chain
                   and its count reads), ``prep.order`` (the Morton
                   order, host orders or tile assignment, and the cut to
                   the cap with its count reads), ``prep.stack``
                   (stacking and the pre-transform). A one-shot engine
                   has one for its reference chain (``ICP.compute``) and
                   one for its reading chain, each to its count read.
``map_tables``     the first build of a map's survivor-route tables
``loop``           one engine loop (``_run_loop``, ``_run_queue``,
                   ``_run_stepped``); per step ``step``, ``merge`` (the
                   keep-active merges, Anderson and motion tracking),
                   ``flag_wait`` (the one host read of the flags) and, in
                   the queue, ``lane_swap`` (retiring and refilling lanes)
``step``           ``ICP._step``: ``step.filters`` (the step filters and
                   the move by the current pose), ``step.match``,
                   ``step.outliers``, ``step.minimize``, ``step.check``
``finish``         the poses and the per-scan info to the host
``set_map``        a map's set-up
=================  ====================================================

A serving call made with ``block=False`` returns before its ``finish``:
``PendingRegistration.result()`` adds that span, and its host syncs, to
the call's record (:func:`resume`), after the record's ``end``.

Counters: ``steps``, the engine steps of the call's loops;
``host_syncs``, every wait on the engine's device that the call causes
(:func:`sync`); at the ``detail``
level only, ``survivor_share`` and ``skip_share``, one value per matcher
step (per scan), which the survivor and v1 routes compute only then, and
``minimize_kernel_share``, one value per point-to-plane minimize (1.0 on
the kernel pair of ``ops/plane_cuda.py``, 0.0 on the torch solve; its mean
is the share of the call's steps that ran on the kernel). The kernel
wrappers' ``launches`` attributes stay the launch counters.

Levels (:func:`set_level`): ``"spans"``, the default, records spans and
counters on ``time.perf_counter()`` and issues no device operation,
synchronisation or profiler call; ``"detail"`` also opens a
``torch.profiler.record_function("pm.<span>")`` range around each span,
keeps every span of the newest ``DETAIL_CALLS`` calls with its start, end
and parent, and records the detail counters; ``"off"`` records nothing.

A record keeps, per span name, the count, the total and the self seconds
(a span's duration less what its children cover). At most ``MAX_CALLS``
records are kept, the newest. :func:`snapshot` and :func:`calls_between`
return them as plain data, :func:`reset` clears them.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["set_level", "detail", "call", "current", "resume", "span",
           "count", "sync", "sample", "snapshot", "calls_between", "reset",
           "LEVELS", "MAX_CALLS", "DETAIL_CALLS"]

LEVELS = ("off", "spans", "detail")
#: call records kept, the newest
MAX_CALLS = 4096
#: calls whose every span (and detail counter) is kept at ``detail``
DETAIL_CALLS = 64

_clock = time.perf_counter
_level = 1
_next_id = 1
_records: deque = deque(maxlen=MAX_CALLS)
_detailed: deque = deque()
_lock = threading.Lock()
_local = threading.local()


def set_level(name: str) -> None:
    """``"off"``, ``"spans"`` (the default) or ``"detail"``."""
    global _level
    if name not in LEVELS:
        raise ValueError(f"telemetry level must be one of {LEVELS}, got {name!r}")
    _level = LEVELS.index(name)


def detail() -> bool:
    """True at the ``detail`` level."""
    return _level == 2


class _Record:
    __slots__ = ("id", "entry", "device", "start", "end", "names", "counters",
                 "samples", "events", "stack")

    def __init__(self, entry: str, device: str, start: float, keep: bool):
        self.id = 0
        self.entry = entry
        self.device = device
        self.start = start
        self.end = start
        #: name → [count, total s, self s]
        self.names: Dict[str, list] = {}
        self.counters: Dict[str, int] = {}
        self.samples: Optional[Dict[str, list]] = {} if keep else None
        self.events: Optional[list] = [] if keep else None
        self.stack: list = [_Top()]


class _Top:
    """The bottom of a record's span stack: the call span's parent."""

    __slots__ = ("child", "idx")

    def __init__(self):
        self.child = 0.0
        self.idx = -1


class _Null:
    """The span or call of a level or thread that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "rec", "t0", "t1", "child", "idx", "rf")

    def __init__(self, name: str, rec: _Record):
        self.name = name
        self.rec = rec

    def __enter__(self):
        rec = self.rec
        if rec.events is not None:
            from torch.profiler import record_function
            self.rf = record_function("pm." + self.name)
            self.rf.__enter__()
            self.idx = len(rec.events)
            rec.events.append(None)
        else:
            self.idx = -1
        rec.stack.append(self)
        self.child = 0.0
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        t1 = self.t1 = _clock()
        rec = self.rec
        rec.stack.pop()
        parent = rec.stack[-1]
        dur = t1 - self.t0
        parent.child += dur
        agg = rec.names.get(self.name)
        if agg is None:
            rec.names[self.name] = [1, dur, dur - self.child]
        else:
            agg[0] += 1
            agg[1] += dur
            agg[2] += dur - self.child
        if self.idx >= 0:
            rec.events[self.idx] = (self.name, self.t0, t1, parent.idx)
            self.rf.__exit__(None, None, None)
        return False


def span(name: str):
    """A context manager timing ``name`` inside the thread's open call;
    nothing outside one, or at ``off``."""
    if _level == 0:
        return _NULL
    rec = getattr(_local, "rec", None)
    if rec is None:
        return _NULL
    return _Span(name, rec)


class _Call:
    __slots__ = ("entry", "device", "rec", "root")

    def __init__(self, entry: str, device):
        self.entry = entry
        self.device = device
        self.rec = None

    def __enter__(self):
        if _level == 0 or getattr(_local, "rec", None) is not None:
            return self
        dev = getattr(self.device, "type", None) or str(self.device or "cpu")
        rec = _Record(self.entry, dev, _clock(), _level == 2)
        self.rec = rec
        _local.rec = rec
        self.root = _Span("call", rec)
        self.root.__enter__()
        rec.start = self.root.t0
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is None:
            return False
        self.root.__exit__(None, None, None)
        rec.end = self.root.t1
        rec.stack = None
        _local.rec = None
        global _next_id
        with _lock:
            rec.id = _next_id
            _next_id += 1
            _records.append(rec)
            if rec.events is not None:
                _detailed.append(rec)
                while len(_detailed) > DETAIL_CALLS:
                    old = _detailed.popleft()
                    old.events = old.samples = None
        return False


def call(entry: str, device=None):
    """A context manager holding the call record of public entry ``entry``
    on this thread, its engine on ``device`` (a ``torch.device``: the
    device whose reads :func:`sync` counts); inside an open record it adds
    to that one."""
    return _Call(entry, device)


def current():
    """The thread's open call record (None outside one, or at ``off``),
    for :func:`resume`."""
    return getattr(_local, "rec", None) if _level else None


class _Resume:
    __slots__ = ("rec",)

    def __init__(self, rec):
        self.rec = rec

    def __enter__(self):
        if self.rec is not None:
            self.rec.stack = [_Top()]
            _local.rec = self.rec
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec.stack = None
            _local.rec = None
        return False


def resume(record):
    """A context manager adding spans and counters to ``record`` (from
    :func:`current`), a call that has returned, as children of its call
    span; nothing where ``record`` is None or another call is open."""
    if record is None or getattr(_local, "rec", None) is not None:
        return _NULL
    return _Resume(record)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the thread's open call."""
    rec = getattr(_local, "rec", None) if _level else None
    if rec is not None:
        c = rec.counters
        c[name] = c.get(name, 0) + n


def sync(device, n: int = 1, copy: bool = False) -> None:
    """Count ``n`` host syncs on ``device`` (a ``torch.device``) where it
    is the open call's engine device: host reads of values on it, or with
    ``copy`` copies to it from host memory. On the card each waits for the
    device's queue to drain. On a CPU engine the reads are counted where
    the card's would be (reads of the host's own input clouds too), and
    the copies, which do not happen there, are not."""
    rec = getattr(_local, "rec", None) if _level else None
    if (rec is not None and device.type == rec.device
            and not (copy and rec.device == "cpu")):
        c = rec.counters
        c["host_syncs"] = c.get("host_syncs", 0) + n


def sample(name: str, value) -> None:
    """At ``detail``, append ``value`` (a tensor, read on the host only by
    :func:`snapshot`) to detail counter ``name`` of the open call."""
    if _level != 2:
        return
    rec = getattr(_local, "rec", None)
    if rec is not None and rec.samples is not None:
        rec.samples.setdefault(name, []).append(value)


def _plain(rec: _Record) -> dict:
    counters = dict(rec.counters)
    for k, vals in (rec.samples or {}).items():
        counters[k] = [v.tolist() if hasattr(v, "tolist") else v for v in vals]
    return {
        "id": rec.id, "entry": rec.entry, "start": rec.start, "end": rec.end,
        "spans": {k: {"count": v[0], "total_s": v[1], "self_s": v[2]}
                  for k, v in rec.names.items()},
        "counters": counters,
        "events": None if rec.events is None else [
            {"name": e[0], "start": e[1], "end": e[2], "parent": e[3]}
            for e in rec.events],
    }


def snapshot() -> List[dict]:
    """Every kept call record, oldest first, as plain data: ``id`` (from 1
    in the process, or since the last :func:`reset`), ``entry``, ``start``, ``end`` (``perf_counter``
    seconds), ``spans`` {name: {count, total_s, self_s}}, ``counters`` and,
    for the newest ``DETAIL_CALLS`` calls recorded at ``detail``,
    ``events`` [{name, start, end, parent}] (``parent`` an index into the
    list, −1 for the call span), else None."""
    with _lock:
        recs = list(_records)
    return [_plain(r) for r in recs]


def calls_between(t0: float, t1: float) -> List[dict]:
    """The kept records of calls that started in ``[t0, t1]``, as
    :func:`snapshot` gives them."""
    with _lock:
        recs = [r for r in _records if t0 <= r.start <= t1]
    return [_plain(r) for r in recs]


def reset() -> None:
    """Drop every record; call ids start again from 1."""
    global _next_id
    with _lock:
        _records.clear()
        _detailed.clear()
        _next_id = 1
