"""icp_nn_roofline (device trace): the least time of the icp_nn family's
work in the profiled block (slambench/roofline.py) over the summed device
time of its kernels (slambench/kernels/icp_nn*.json), in %."""

from slambench.roofline import share


def read(ctx):
    return share(ctx, "icp_nn")
