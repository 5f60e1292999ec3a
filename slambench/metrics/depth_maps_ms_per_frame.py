"""depth_maps_ms_per_frame (device trace): the summed device time of the
operations launched inside the RGB-D drive's calls (the span of the
rgbd_trip family, slambench.rgbd) that belong to no ICP trip, over the
profiled frames: the frame's stages around its trips (backprojection,
normals, the source, T0, the maps handed to the next frame, the info
row). Left out: the family's kernels (PJ, K2S), copies between host and
card (the depth's upload, the trips' condition reads), and every operation
launched once an ICP iteration (its count in the block the profiled
sequences' ICP iterations: the product and sum that move the source by T
before each lookup)."""

import collections

COPIES = ("HtoD", "DtoH")


def read(ctx):
    fam = ctx.families.get("rgbd_trip")
    if fam is None or ctx.trace is None or not ctx.profiled:
        return None
    count, ns = collections.Counter(), collections.Counter()
    for name, _, d, span in ctx.trace.ops:
        if (span == fam["span"]
                and not any(p in name for p in fam["patterns"])
                and not any(c in name for c in COPIES)):
            count[name] += 1
            ns[name] += d
    trips = ctx.profiled_sum("icp_iters")
    total = sum(v for k, v in ns.items() if count[k] != trips)
    return total / 1e6 / ctx.profiled_frames() if total > 0 else None
