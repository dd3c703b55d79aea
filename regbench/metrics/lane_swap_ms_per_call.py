"""The queue's retiring and refilling of lanes (the program's
``lane_swap`` span), ms a window call."""

from regbench import program


def read(ctx):
    return program.ms_per_call(ctx, "lane_swap")
