"""The process's first build of the map's survivor-route tables (the
program's first ``map_tables`` span, in the harness's first warm call),
ms."""

from regbench import program


def read(ctx):
    recs = program.process_calls() or []
    built = [r for r in recs if "map_tables" in r["spans"]]
    return 1e3 * built[0]["spans"]["map_tables"]["total_s"] if built else None
