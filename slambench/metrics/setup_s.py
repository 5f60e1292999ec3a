"""setup_s (host clock): from the process's start to the window's first
frame: imports, the card, the scans made from the seed, the kernels'
build or load, one untimed sequence that captures the graphs."""


def read(ctx):
    return ctx.setup_s
