"""How `correct` is decided: every sequence the window ran is judged by the
plain reference (slambench/reference) on the same inputs, once the window
has closed and the program's state is freed. The cell's drive
(slambench/drives/<drive>.py) runs the reference on a record and says which
numbers it compares (each drive's docstring lists its own);
slambench/limits/<cell>.json holds the numbers a cell compares and their
limits (PERF.md gives the readings each was set from). Each number is the
worst over the window's sequences; a sequence with a non-finite pose, or a
number over its limit, counts as failed.
"""

from __future__ import annotations


def judge(drive, cfg: dict, mix: dict, seqs: list, records: list,
          limits: dict, device, precision: str = "float32") -> dict:
    """Every record against the reference (one reference run for each
    distinct sequence and program trajectory, by the drive's `key`)."""
    refs: dict = {}
    worst = {k: 0.0 for k in limits}
    failed = 0
    for rec in records:
        key = drive.key(rec)
        inputs, gt = seqs[rec["seq"]]
        if key not in refs:
            refs[key] = drive.reference(cfg, mix, inputs, rec, device,
                                        precision)
        got = drive.numbers(rec, refs[key], gt)
        over = False
        for k in limits:
            worst[k] = max(worst[k], got[k])
            over |= not got[k] <= limits[k]
        failed += over
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in limits}
    lines = [f"check {k}: {worst[k]!r} (limit {limits[k]!r})"
             for k in limits]
    return {"correct": failed == 0 and bool(records), "failed": failed,
            "checks": checks, "lines": lines, "refs": refs}
