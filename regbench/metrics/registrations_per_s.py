"""Registrations completed in the window over the window's time (host
clock; the window is whole calls)."""


def read(ctx):
    return ctx.registrations / ctx.window_s
