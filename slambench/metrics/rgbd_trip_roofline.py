"""rgbd_trip_roofline (device trace): the least time of the RGB-D ICP
trips' work in the profiled block over the summed device time of their
kernels, PJ and K2S (slambench/kernels/rgbd_trip*.json, launched inside
the span slambench.rgbd), in %.

The work is counted here from the cell's camera and the counts the
program returns, at roofline.py's peaks (float32 on the CUDA cores):

  bytes       a frame's source, M rows of 12 B, and its target maps,
              vertex and normal 12 B a pixel each and validity 1 B (25 B
              a pixel), read once a frame: a frame's ~11 MB at 640 x 480
              stay in the H100's 50 MB L2 across its trips, so a count of
              DRAM bytes a trip would pass 100% under a trip that reads
              them from L2;
  operations  FLOPS_PER_ROW a source row an ICP iteration, times the rows
              and the iterations.

FLOPS_PER_ROW, the plain reference's iteration (reference/rgbd.py) a row:
the source moved by T (R p + t: 9 products, 9 sums) 18; the projection
(x / z * fx + cx, and v) 6; d2 (3 differences, 3 products, 2 sums) 8; the
weight (gate x mask) 1; the residual n . (p - q) on those differences
(3 products, 2 sums) 5; the Jacobian's p x n (6 products, 3 differences)
9; the weighted row J w 6; the normal equations' 21 distinct entries of
the symmetric H and the 6 of g, a product and a sum each, 54; the RMS
distance's w d2 and its two sums 3: 110.
"""

from slambench import roofline

FLOPS_PER_ROW = 18 + 6 + 8 + 1 + 5 + 9 + 6 + 54 + 3
SOURCE_BYTES_PER_ROW = 12  # x, y, z float32
MAP_BYTES_PER_PIXEL = 25  # vertex and normal float32 x 3, validity bool


def work(ctx) -> tuple:
    """(operations, bytes) of the profiled sequences' ICP trips: every frame
    but each sequence's first runs the ICP."""
    cam = ctx.config["camera"]
    h, w = cam["height"], cam["width"]
    s = max(1, int(ctx.config["pipeline"]["rgbd_src_stride"]))
    rows = len(range(0, h, s)) * len(range(0, w, s))
    frames = sum(r["frames"] - 1 for r in ctx.profiled)
    flops = FLOPS_PER_ROW * rows * ctx.profiled_sum("icp_iters")
    nbytes = frames * (SOURCE_BYTES_PER_ROW * rows
                       + MAP_BYTES_PER_PIXEL * h * w)
    return flops, nbytes


def read(ctx):
    fam = ctx.families.get("rgbd_trip")
    if fam is None or ctx.trace is None or not ctx.profiled:
        return None
    flops, nbytes = work(ctx)
    ns = ctx.trace.family_ns(fam["patterns"], fam.get("span"))
    if flops <= 0 or ns <= 0:
        return None
    return 100.0 * roofline.bound_s(flops, nbytes, roofline.H100_FP32_FLOPS
                                    ) / (ns * 1e-9)
