"""1 − device time per step in the profiled sub-window over the untraced
wall time per step of the same process's window, in %: how far the host
paces the device (the busy share of tools_torch/profile_serving.py)."""


def read(ctx):
    p = ctx.profile
    if p is None or not ctx.spans or not p.steps or p.device_s <= 0:
        return None
    steps = sum(c.steps for c in ctx.spans)
    wall = sum(c.end - c.start for c in ctx.spans)
    return 100.0 * (1.0 - (p.device_s / p.steps) / (wall / steps))
