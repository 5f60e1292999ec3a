"""frames_per_s.slam (host clock): frames_per_s in the full-SLAM cells, where
its runs spread wider than in the odometry cells and it has a bound of its
own."""

from slambench.metrics.frames_per_s import read  # noqa: F401
