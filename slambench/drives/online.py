"""The online drive: one client, each scan of a lidar log handed to
`ScanToMapPipeline.step`, the next once the last pose is on the host; a
fresh `init_state` at each sequence's first scan. The record keeps each
frame's time, scan handed in to pose on the host (`frame_s`)."""

from __future__ import annotations

import time

import numpy as np

from slambench.drives import _lidar

jobs, sequence = _lidar.jobs, _lidar.sequence
reference, numbers, key = _lidar.reference, _lidar.numbers, _lidar.key
FAULTS = {"no_inserts": _lidar.no_inserts}


class Program(_lidar.FrontEnd):
    def run(self, pts, msk) -> dict:
        import torch

        state = self.pipe.init_state(pts[0], msk[0])
        poses, infos, frame_s = [], [], []
        for f in range(1, len(pts)):
            t0 = time.perf_counter()
            state, info = self.pipe.step(state, pts[f], msk[f])
            poses.append(info["pose"].cpu().numpy())
            frame_s.append(time.perf_counter() - t0)
            infos.append(info)
        rows = {k: torch.stack([torch.as_tensor(i[k]) for i in infos]
                               ).cpu().numpy()
                for k in ("rmse", "iters", "is_keyframe", "map_inserted")}
        return {"poses": np.stack(poses), "rmse": rows["rmse"],
                "is_keyframe": rows["is_keyframe"],
                "map_inserted": rows["map_inserted"],
                "icp_iters": int(rows["iters"].sum()),
                "inserts": int(rows["map_inserted"].sum()),
                "frame_s": frame_s}

