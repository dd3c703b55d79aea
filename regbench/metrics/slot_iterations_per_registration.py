"""Engine steps times the slots a step serves (the batch's scans, or the
queue's lanes) over the registrations: the slot iterations a registration
costs, counting those lockstep spends on scans that already stopped."""


def read(ctx):
    if not ctx.spans:
        return None
    tr = ctx.cell.traffic
    width = int(tr["lanes"] if tr["driver"] == "queue" else tr["scans_per_call"])
    regs = len(ctx.spans) * int(tr["scans_per_call"])
    return sum(c.steps for c in ctx.spans) * width / regs
