"""icp_iters_per_frame (program counter): the front end's ICP iterations
(the info rows' iters; Slam3D.frontend_iters) over the window's frames."""


def read(ctx):
    frames = sum(r["frames"] for r in ctx.records)
    return sum(r["icp_iters"] for r in ctx.records) / frames
