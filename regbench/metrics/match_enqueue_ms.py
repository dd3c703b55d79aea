"""Host time in the matcher's call of a step (the program's
``step.match`` span), ms an engine step."""

from regbench import program


def read(ctx):
    return program.ms_per_step(ctx, "step.match")
