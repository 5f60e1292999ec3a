"""`cli eval` (port of tpu_icp_slam/eval/runner.py): run the port's pipeline
AND the golden float64 CPU oracle (eval/golden.py) on the same log, and
report the ATE of each against ground truth and of the run against the
oracle. The keys are the reference's (`tpu_ate` is the port's run). An
RGB-D dataset has no scans for the oracle: its report holds the run's
`tpu_ate` alone, as the reference's does."""

from __future__ import annotations

import json

from tpu_icp_slam_torch.eval import golden
from tpu_icp_slam_torch.eval import metrics as em
from tpu_icp_slam_torch.slam.runner import (
    _build_cfg,
    load_dataset,
    preprocess,
    run_slam,
)


def eval_from_cli(args) -> int:
    cfg = _build_cfg(args)
    data = load_dataset(args.dataset, args.frames)
    poses, report = run_slam(cfg, data, out_dir=None, mode="fused",
                             device=args.device)

    mcd = cfg.icp.max_corr_dist if cfg.icp.max_corr_dist < 1e8 else 1.0
    scans = preprocess(cfg, data.scans)
    d = data.dim
    out = {
        "dataset": data.name,
        "frames": int(len(poses)),
        "mode": report.get("mode", "fused"),
    }
    if scans:
        gpose = golden.odometry(scans, max_iters=30, max_corr_dist=mcd)
        out["tpu_vs_golden_ate"] = em.ate_rmse(
            poses[:, :d, d], gpose[: len(poses), :d, d]
        )
    if data.gt_poses is not None:
        gt = data.gt_poses[: len(poses)]
        out["tpu_ate"] = report.get("ate_rmse")
        if scans:
            out["golden_ate"] = em.ate_rmse(gpose[: len(gt), :d, d], gt[:, :d, d])
    for k in ("n_loop_closures", "n_keyframes"):
        if k in report:
            out[k] = report[k]
    print(json.dumps(out, indent=2))
    return 0
