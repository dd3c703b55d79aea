"""Process start to the first timed call: imports, CUDA start, the kernel
libraries (built by nvcc on a checkout's first run), the scene and pool,
``set_map`` and the warm-up calls."""


def read(ctx):
    return ctx.setup_s
