"""Faults planted in the program, never in the reference: each a function
of the cell's configuration that returns the program's configuration and a
patch to hold while the program is built and runs. The benchmark's own
runs plant none; slambench/calibrate.py reads them on the card (the
readings the numbers they move are held against) and
slambench/tests/test_slambench_control.py sees each come out not
correct.
"""

from __future__ import annotations

import contextlib
import json


def _no_inserts(cfg: dict):
    """The program's keyframe and insert gates never open: its map stays
    the first scan, and its info rows say so."""
    cfg = json.loads(json.dumps(cfg))
    cfg["pipeline"].update(keyframe_trans=1e9, keyframe_rot=1e9,
                           frontier_insert=False)
    return cfg, contextlib.nullcontext()


@contextlib.contextmanager
def _patched(obj, attr, value):
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


def _no_closures(cfg: dict):
    """LoopDetector.verify_batch runs and returns no closure."""
    from tpu_icp_slam_torch.backend.loop_closure import LoopDetector

    verify = LoopDetector.verify_batch

    def none(self, cands, *a, **kw):
        return [None] * len(verify(self, cands, *a, **kw))

    return cfg, _patched(LoopDetector, "verify_batch", none)


def _no_selection(cfg: dict):
    """Every verified closure goes into the pose graph: neither the
    pairwise consistency (PCM) nor the residual gate runs."""
    cfg = json.loads(json.dumps(cfg))
    cfg["backend"].update(pcm_gamma=0.0, reject_residual=0.0)
    return cfg, contextlib.nullcontext()


def _graph_unsolved(cfg: dict):
    """Slam3D's final pose-graph solve returns the graph unchanged (the
    residual gate's solves still run)."""
    import types

    import torch
    from tpu_icp_slam_torch.backend import pose_graph
    from tpu_icp_slam_torch.slam import slam3d

    def unsolved(graph, iters=10, **kw):
        return graph, torch.zeros(iters, dtype=torch.float64)

    pg = types.SimpleNamespace(**dict(vars(pose_graph), optimize=unsolved))
    return cfg, _patched(slam3d, "pg", pg)


# name -> cfg -> (the program's configuration, the patch in force while it
# runs); each a fault planted in the program, never in the reference
FAULTS = {"no_inserts": _no_inserts, "no_closures": _no_closures,
          "no_selection": _no_selection, "graph_unsolved": _graph_unsolved}
