"""Every scan's reading chain with its count reads (the program's
``prep.chain`` span), ms a window call."""

from regbench import program


def read(ctx):
    return program.ms_per_call(ctx, "prep.chain")
