"""frames_per_s (host clock): every frame of every sequence the window
completed, over the whole window's time."""


def read(ctx):
    return sum(r["frames"] for r in ctx.records) / ctx.window_s
