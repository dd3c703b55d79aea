"""(Host time inside the window's calls − their prep) over their engine
steps: the wall time of one engine iteration, flag read included."""


def read(ctx):
    if not ctx.spans:
        return None
    steps = sum(c.steps for c in ctx.spans)
    loop = sum(c.end - c.start - c.prep_s for c in ctx.spans)
    return 1e3 * loop / steps if steps else None
