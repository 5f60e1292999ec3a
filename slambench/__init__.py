"""The benchmark of tpu_icp_slam_torch (see harness.py)."""
