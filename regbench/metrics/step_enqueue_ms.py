"""Host time inside the engine's step, per step: the host's cost of
issuing one iteration (the step holds no synchronize; the flag read
follows it)."""


def read(ctx):
    if not ctx.spans:
        return None
    steps = sum(c.steps for c in ctx.spans)
    return 1e3 * sum(c.enqueue_s for c in ctx.spans) / steps if steps else None
