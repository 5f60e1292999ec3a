"""inserts_per_frame.slam: inserts_per_frame in the full-SLAM cells, where it
moves frames_per_s.slam."""

from slambench.metrics.inserts_per_frame import read  # noqa: F401
