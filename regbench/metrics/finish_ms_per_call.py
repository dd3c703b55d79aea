"""The poses and the per-scan info copied to the host at the end of a call
(the program's ``finish`` span), ms a window call."""

from regbench import program


def read(ctx):
    return program.ms_per_call(ctx, "finish")
