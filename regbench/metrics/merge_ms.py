"""The engine's work after a step: the keep-active merges, Anderson and
motion tracking (the program's ``merge`` span), ms an engine step."""

from regbench import program


def read(ctx):
    return program.ms_per_step(ctx, "merge")
