"""knn_roofline.slam: knn_roofline in the full-SLAM cells, where it moves
frames_per_s.slam."""

from slambench.metrics.knn_roofline import read  # noqa: F401
