"""The engine's one host read of the step's flags (the program's
``flag_wait`` span), ms an engine step."""

from regbench import program


def read(ctx):
    return program.ms_per_step(ctx, "flag_wait")
