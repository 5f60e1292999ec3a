"""icp_nn_roofline.slam: icp_nn_roofline in the full-SLAM cells, where it
moves frames_per_s.slam."""

from slambench.metrics.icp_nn_roofline import read  # noqa: F401
