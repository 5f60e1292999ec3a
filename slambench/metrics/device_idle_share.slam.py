"""device_idle_share.slam: device_idle_share in the full-SLAM cells, where it
moves frames_per_s.slam."""

from slambench.metrics.device_idle_share import read  # noqa: F401
