"""What the program records of itself, for the per-layer metrics: the call
records of ``libpointmatcher_tpu_torch.telemetry`` (spans and counters on
``time.perf_counter()``, the clock of the harness's spans), matched to the
traced window's calls. A program without that module, or a window whose
calls do not hold exactly one program call each, gives None, and the
metrics that read it are left out of the line."""

from __future__ import annotations

from typing import List, Optional


def _telemetry():
    try:
        from libpointmatcher_tpu_torch import telemetry
    except ImportError:
        return None
    return telemetry


def window_calls(ctx) -> Optional[List[dict]]:
    """The program's call record of each of the window's calls, in order."""
    tel = _telemetry()
    if tel is None or not ctx.spans:
        return None
    recs = tel.calls_between(ctx.spans[0].start, ctx.spans[-1].end)
    out = []
    for c in ctx.spans:
        mine = [r for r in recs if c.start <= r["start"] <= c.end]
        if len(mine) != 1:
            return None
        out.append(mine[0])
    return out


def _total(calls: List[dict], span: str) -> Optional[float]:
    """Seconds of ``span`` summed over ``calls`` (None where none has it)."""
    found = [c["spans"][span]["total_s"] for c in calls if span in c["spans"]]
    return sum(found) if found else None


def ms_per_call(ctx, span: str) -> Optional[float]:
    """Mean milliseconds of ``span`` a window call."""
    calls = window_calls(ctx)
    total = _total(calls, span) if calls else None
    return None if total is None else 1e3 * total / len(calls)


def ms_per_step(ctx, span: str) -> Optional[float]:
    """Milliseconds of ``span`` over the window's engine steps."""
    calls = window_calls(ctx)
    total = _total(calls, span) if calls else None
    steps = sum(c["counters"].get("steps", 0) for c in calls or [])
    return None if total is None or not steps else 1e3 * total / steps


def count_per_call(ctx, counter: str) -> Optional[float]:
    """Mean of ``counter`` a window call."""
    calls = window_calls(ctx)
    if not calls or not any(counter in c["counters"] for c in calls):
        return None
    return sum(c["counters"].get(counter, 0) for c in calls) / len(calls)


def process_calls() -> Optional[List[dict]]:
    """Every call record of the process, oldest first, if none was dropped
    (the first has id 1)."""
    tel = _telemetry()
    recs = tel.snapshot() if tel is not None else []
    return recs if recs and recs[0]["id"] == 1 else None
