"""Every cell on the card, briefly, through the whole run: correct, and the
traced run's per-layer metrics present. Runs on a machine with a CUDA
device (`python -m pytest -m cuda slambench/tests`); skips elsewhere."""

import time

import pytest

from slambench import harness

BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell, trace):
    res, lines = harness.run(cell, 2**31 + 404, 2.0, trace,
                             time.perf_counter(), bench=BENCH)
    assert res["correct"], lines
    assert res["device"]["platform"] == "gpu"
    want = {m["name"] for m in harness.metrics_of(BENCH, cell, trace)}
    got = set(res["metrics"])
    if trace:
        assert res["device"]["busy_s"] > 0
        # a share reads nothing where the profiled block ran no kernel of
        # its family; every other metric reads
        assert want - got <= {"verify_nn_roofline"}
    else:
        assert got == want
