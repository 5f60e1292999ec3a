"""knn_roofline (device trace): the least time of the knn family's
work in the profiled block (slambench/roofline.py) over the summed device
time of its kernels (slambench/kernels/knn*.json), in %."""

from slambench.roofline import share


def read(ctx):
    return share(ctx, "knn")
