"""The process's first serving call, the harness's first warm call (the
program's first call record: it builds the map's tables and meets every
shape first), ms."""

from regbench import program


def read(ctx):
    recs = program.process_calls() or []
    calls = [r for r in recs if r["entry"] != "set_map"]
    return 1e3 * (calls[0]["end"] - calls[0]["start"]) if calls else None
