"""The serving drivers' upload of the raw scans to the device (the
program's ``prep.upload`` span), ms a window call."""

from regbench import program


def read(ctx):
    return program.ms_per_call(ctx, "prep.upload")
