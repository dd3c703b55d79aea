"""Host time from a call's start to its first engine step: the serving
driver's prep (reading chains, draws, upload, Morton order or tile
assignment, stacking), mean over the window's calls."""


def read(ctx):
    if not ctx.spans:
        return None
    return 1e3 * sum(c.prep_s for c in ctx.spans) / len(ctx.spans)
