"""Device operations (kernels, copies, fills) in the profiled sub-window
over its engine steps."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.steps or not p.ops:
        return None
    return p.ops / p.steps
