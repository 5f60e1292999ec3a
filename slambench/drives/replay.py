"""The replay drive: each lidar log from a fresh `init_state` through
`ScanToMapPipeline.run_fused`, the next once its infos are on the host."""

from __future__ import annotations

from slambench.drives import _lidar

jobs, sequence = _lidar.jobs, _lidar.sequence
reference, numbers, key = _lidar.reference, _lidar.numbers, _lidar.key
FAULTS = {"no_inserts": _lidar.no_inserts}


class Program(_lidar.FrontEnd):
    def run(self, pts, msk) -> dict:
        state = self.pipe.init_state(pts[0], msk[0])
        _, infos = self.pipe.run_fused(state, pts[1:], msk[1:])
        out = {k: v.cpu().numpy() for k, v in infos.items()}
        return {"poses": out["pose"], "rmse": out["rmse"],
                "is_keyframe": out["is_keyframe"],
                "map_inserted": out["map_inserted"],
                "icp_iters": int(out["iters"].sum()),
                "inserts": int(out["map_inserted"].sum())}

