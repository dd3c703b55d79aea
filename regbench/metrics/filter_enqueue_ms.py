"""Host time in the step filters and the move of the scans by the current
pose (the program's ``step.filters`` span), ms an engine step."""

from regbench import program


def read(ctx):
    return program.ms_per_step(ctx, "step.filters")
