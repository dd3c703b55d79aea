"""Host time in the transformation checkers of a step, the no-inlier test
included (the program's ``step.check`` span), ms an engine step."""

from regbench import program


def read(ctx):
    return program.ms_per_step(ctx, "step.check")
