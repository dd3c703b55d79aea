"""The process's last map set-up (the program's ``set_map`` span: the
map's filter chain, centring and matcher init), ms."""

from regbench import program


def read(ctx):
    recs = program.process_calls() or []
    maps = [r for r in recs if "set_map" in r["spans"]]
    return 1e3 * maps[-1]["spans"]["set_map"]["total_s"] if maps else None
