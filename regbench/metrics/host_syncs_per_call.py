"""Waits on the device that the program causes (its ``host_syncs``
counter: host reads of device values and copies from host memory), a
window call."""

from regbench import program


def read(ctx):
    return program.count_per_call(ctx, "host_syncs")
