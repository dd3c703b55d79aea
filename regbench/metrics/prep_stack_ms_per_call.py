"""Stacking the prepared scans and their pre-transform (the program's
``prep.stack`` span), ms a window call."""

from regbench import program


def read(ctx):
    return program.ms_per_call(ctx, "prep.stack")
