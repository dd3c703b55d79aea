"""Host time in the outlier filters of a step (the program's
``step.outliers`` span), ms an engine step."""

from regbench import program


def read(ctx):
    return program.ms_per_step(ctx, "step.outliers")
