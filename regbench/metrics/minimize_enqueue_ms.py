"""Host time in the error minimizer of a step, the pose update included
(the program's ``step.minimize`` span), ms an engine step."""

from regbench import program


def read(ctx):
    return program.ms_per_step(ctx, "step.minimize")
