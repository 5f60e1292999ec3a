from tpu_icp_slam_torch.obs.metrics import MetricsLogger  # noqa: F401
from tpu_icp_slam_torch.obs.timers import Timer, realize, timed, trace  # noqa: F401
