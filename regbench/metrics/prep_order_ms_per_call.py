"""The Morton order, host orders or tile assignment and the cut to the
row cap with its count reads (the program's ``prep.order`` span), ms a
window call."""

from regbench import program


def read(ctx):
    return program.ms_per_call(ctx, "prep.order")
