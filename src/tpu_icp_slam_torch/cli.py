"""Command-line interface of the port (counterpart of tpu_icp_slam/cli.py):
align / run / eval / localize, with the reference's arguments plus
`--device` (default `cuda`; `--device cpu` runs the plain version of every
kernel). Without a card the default raises; nothing moves to the CPU on its
own.

    python -m tpu_icp_slam_torch.cli align --n 4096
    python -m tpu_icp_slam_torch.cli run --dataset <sim2d | sim2d_loop |
        a .clf/.log file | sim3d | sim3d_loop | KITTI dir | simrgbd |
        simrgbd_fullres | TUM RGB-D dir> --frames F
        [--config configs/lidar2d_scan_to_map.json | kitti_full_res.json |
        rgbd.json] [--checkpoint-every N | --resume] [--save-map map.npz]
        --out DIR
    python -m tpu_icp_slam_torch.cli localize --map map.npz --dataset <same>
        --frame i --frames F
    python -m tpu_icp_slam_torch.cli eval --dataset <same> --frames F
        --config ...

    python -m tpu_icp_slam_torch.cli bench --config-id 1..5 [--json]
        (obs/bench.py; rung 5 scales over the ranks of a torchrun world on
        distinct cards)
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _parse_overrides(pairs: list[str]) -> dict:
    out = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"override must be key=value, got: {p}")
        k, v = p.split("=", 1)
        out[k.lstrip("-")] = v
    return out


def cmd_align(args) -> int:
    """Config 1: ICP of a synthetic cloud onto its rigidly moved copy."""
    import numpy as np

    from tpu_icp_slam_torch.config import ICPConfig
    from tpu_icp_slam_torch.core import pointcloud as pcm
    from tpu_icp_slam_torch.datasets import synthetic
    from tpu_icp_slam_torch.eval import metrics
    from tpu_icp_slam_torch.icp.loop import align
    from tpu_icp_slam_torch.obs import realize

    def clouds(seed):
        src, dst, T_gt = synthetic.two_scan_pair(n=args.n, seed=seed,
                                                 noise=args.noise)
        return (pcm.make(src, args.n, device=args.device),
                pcm.make(dst, args.n, device=args.device), T_gt)

    cfg = ICPConfig(max_iters=args.max_iters, nn_backend=args.nn_backend,
                    tol=1e-6)
    src, dst, T_gt = clouds(args.seed)
    # the host copy of T waits for the card: it fences each timed call
    t0 = time.perf_counter()
    res = align(src, dst, cfg=cfg)
    realize(res.T)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = align(src, dst, cfg=cfg)
    T = realize(res.T)
    t_steady = time.perf_counter() - t0
    rot_err, trans_err = metrics.transform_error(T.astype(np.float64), T_gt)
    report = {
        "n_points": args.n,
        "iters": int(res.iters),
        "rmse": float(res.rmse),
        "n_inliers": int(res.n_inliers),
        "converged": bool(res.converged),
        "rot_err_rad": rot_err,
        "trans_err_m": trans_err,
        "recovered_under_1e-3": bool(rot_err < 1e-3 and trans_err < 1e-3),
        "time_first_call_s": round(t_first, 4),
        "time_steady_s": round(t_steady, 4),
    }
    if args.repeat > 1:
        # the engine's rate: `repeat` independent solves back to back,
        # fenced once at the end (the reference vmaps them into one
        # dispatch; here each is its own align)
        pairs = [clouds(args.seed + r)[:2] for r in range(args.repeat)]
        t0 = time.perf_counter()
        realize([align(s, d, cfg=cfg).T for s, d in pairs])
        dt = time.perf_counter() - t0
        report["batched_repeat"] = args.repeat
        report["batched_solves_per_s"] = round(args.repeat / dt, 1)
    print(json.dumps(report, indent=2))
    return 0 if report["recovered_under_1e-3"] else 1


def cmd_run(args) -> int:
    from tpu_icp_slam_torch.slam.runner import run_from_cli

    return run_from_cli(args)


def cmd_bench(args) -> int:
    from tpu_icp_slam_torch.obs.bench import bench_from_cli

    return bench_from_cli(args)


def cmd_eval(args) -> int:
    from tpu_icp_slam_torch.eval.runner import eval_from_cli

    return eval_from_cli(args)


def cmd_localize(args) -> int:
    """Global relocalization in a saved map (kidnapped-robot query)."""
    import numpy as np

    from tpu_icp_slam_torch.slam import map_io
    from tpu_icp_slam_torch.slam.runner import (
        _build_cfg,
        load_dataset,
        pad_scans,
        preprocess,
    )

    cfg = _build_cfg(args)
    saved = map_io.load_map(args.map, cfg.backend, device=args.device)
    # the query must be preprocessed as the map's scans were: same log
    # length (the synthetic generators resample the route by frame count),
    # same downsample voxel, same padded capacity
    n_frames = args.frames if args.frames > 0 else max(args.frame + 1, 2)
    data = load_dataset(args.dataset, n_frames)
    cap = saved.kf_scans[0][0].shape[0]
    pts, msk = pad_scans(preprocess(cfg, data.scans), cap)
    out = map_io.localize_in_map(saved, pts[args.frame], msk[args.frame],
                                 topk=args.topk)
    report = {"map": args.map, "dataset": args.dataset, "frame": args.frame}
    if out is None:
        report["localized"] = False
    else:
        pose, match_idx, rmse = out
        report.update(
            localized=True,
            match_keyframe=int(match_idx),
            rmse=float(rmse),
            pose=np.asarray(pose).tolist(),
        )
        if data.gt_poses is not None:
            gt = data.gt_poses[args.frame]
            gt_rel = np.linalg.inv(data.gt_poses[0]) @ gt
            d = gt.shape[0] - 1
            report["error_vs_gt_m"] = float(
                np.linalg.norm(np.asarray(pose)[:d, d] - gt_rel[:d, d])
            )
    print(json.dumps(report, indent=2))
    return 0 if report.get("localized") else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu-icp-slam-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_arg(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda | cpu)")

    a = sub.add_parser("align", help="two-cloud ICP alignment demo (config 1)")
    a.add_argument("--n", type=int, default=4096)
    a.add_argument("--seed", type=int, default=0)
    a.add_argument("--noise", type=float, default=0.0)
    a.add_argument("--max-iters", type=int, default=60)
    a.add_argument("--nn-backend", default="auto", choices=["auto", "pallas", "xla"])
    a.add_argument("--repeat", type=int, default=1,
                   help="also report the engine rate: this many independent "
                        "solves back to back, fenced once")
    device_arg(a)
    a.set_defaults(fn=cmd_align)

    r = sub.add_parser("run", help="full SLAM over a dataset/log")
    r.add_argument("--dataset", default="sim2d",
                   help="sim2d | sim2d_loop | sim3d | sim3d_loop | simrgbd "
                        "| simrgbd_fullres | path to a real log (.clf / .log, "
                        "a KITTI sequence dir, a TUM RGB-D dir)")
    r.add_argument("--frames", type=int, default=60)
    r.add_argument("--config", default=None, help="JSON config file")
    r.add_argument("--out", default="out", help="artifact directory")
    r.add_argument("--resume", action="store_true")
    r.add_argument("--checkpoint-every", type=int, default=0)
    r.add_argument("--save-map", default=None, help="export the keyframe map "
                   "(.npz) for a later `localize` (the backend paths)")
    r.add_argument("overrides", nargs="*", help="dotted config overrides k=v")
    device_arg(r)
    r.set_defaults(fn=cmd_run)

    l = sub.add_parser(
        "localize", help="globally relocalize a scan in a saved map"
    )
    l.add_argument("--map", required=True, help="map .npz from run --save-map")
    l.add_argument("--dataset", default="sim3d", help="query scan source")
    l.add_argument("--frame", type=int, default=0, help="query frame index")
    l.add_argument("--frames", type=int, default=0,
                   help="query log length (match the mapping run; 0 = frame+1)")
    l.add_argument("--topk", type=int, default=3)
    l.add_argument("--config", default=None, help="JSON config file")
    l.add_argument("overrides", nargs="*", help="dotted config overrides k=v")
    device_arg(l)
    l.set_defaults(fn=cmd_localize)

    b = sub.add_parser("bench", help="frames/s benchmark harness")
    b.add_argument("--config-id", type=int, default=1, choices=[1, 2, 3, 4, 5])
    b.add_argument("--frames", type=int, default=50)
    b.add_argument("--json", action="store_true", help="one-line JSON output")
    device_arg(b)
    b.set_defaults(fn=cmd_bench)

    e = sub.add_parser("eval", help="trajectory accuracy evaluation")
    e.add_argument("--dataset", default="sim2d",
                   help="as for run; an RGB-D dataset has no scans, so it "
                        "runs no golden oracle and reports tpu_ate alone")
    e.add_argument("--frames", type=int, default=60)
    e.add_argument("--config", default=None, help="JSON config file")
    e.add_argument("overrides", nargs="*", help="dotted config overrides k=v")
    device_arg(e)
    e.set_defaults(fn=cmd_eval)
    return p


def main(argv=None) -> int:
    import torch

    args = build_parser().parse_args(argv)
    if hasattr(args, "overrides"):
        args.override_dict = _parse_overrides(args.overrides)
    device = getattr(args, "device", None)
    if device is not None and torch.device(device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
