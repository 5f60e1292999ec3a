"""device_ms_per_frame.slam: device_ms_per_frame in the full-SLAM cells, where
it moves frames_per_s.slam."""

from slambench.metrics.device_ms_per_frame import read  # noqa: F401
