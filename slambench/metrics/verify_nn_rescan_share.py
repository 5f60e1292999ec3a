"""verify_nn_rescan_share (program counter): runs of 32 targets that loop
verification's batched 3-D NN rescanned in the difference form, per row
and split that its factored filter decided (nn_cuda.scan_counts: runs
rescanned over rows less fallback and shared rows). The counts are the
card's over the run's whole process, warm-up and the profiled sequences
included, not the window alone. 1.0 is one run a row, the least there is.
A fallback row (one that overflowed its slots, or one in a block that
dropped the filter) takes an exact scan of its split instead, and a shared
row (a padded one) its block's last row's pick. None where the program
keeps no such counts or made no such search."""

import sys


def read(ctx):
    nn_cuda = sys.modules.get("tpu_icp_slam_torch.kernels.nn_cuda")
    counts = getattr(nn_cuda, "scan_counts", None)
    if counts is None:
        return None
    c = counts()
    filtered = c["rows"] - c["fallback_rows"] - c.get("shared_rows", 0)
    return c["runs_rescanned"] / filtered if filtered > 0 else None
