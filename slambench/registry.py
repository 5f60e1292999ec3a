"""The benchmark's registry: every piece found by its name in
BENCHMARK.json, as a file of its own under slambench/ (configs/<config>.json,
traffic/<mix>.json, limits/<cell>.json, metrics/<metric>.py, the union of
kernels/<family>*.json, and drives/<drive>.py by a traffic mix's `drive`
key). It imports neither torch nor the program, so that a run can read its
cell, and start making its inputs, before either is loaded.
"""

from __future__ import annotations

import glob
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent  # slambench/
CHECKOUT = ROOT.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(checkout: Path = CHECKOUT) -> dict:
    return _json(checkout / "BENCHMARK.json")


def config(name: str, root: Path = ROOT) -> dict:
    return _json(root / "configs" / f"{name}.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json(root / "traffic" / f"{name}.json")


def limits(cell: str, root: Path = ROOT) -> dict:
    return _json(root / "limits" / f"{cell}.json")


def reader(metric: str, root: Path = ROOT):
    """The module of slambench/metrics/<metric>.py."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"slambench.metrics.{metric}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {metric}: {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def drive(name: str, root: Path = ROOT):
    """The module of slambench/drives/<name>.py: how a kind of input is
    made, fed to the program and judged (the contract is
    slambench/drives/__init__.py's docstring).
    Loaded once a file and kept in sys.modules, so that its functions
    reach forked workers by name; a drive of another root than this
    checkout's gets a name of its own."""
    path = (root / "drives" / f"{name}.py").resolve()
    if not path.exists():
        raise FileNotFoundError(f"no drive {name}: {path}")
    module_name = f"slambench.drives.{name}"
    if root.resolve() != ROOT:
        tag = hashlib.sha256(str(path).encode()).hexdigest()[:12]
        module_name += f"_{tag}"
    module = sys.modules.get(module_name)
    if module is not None and Path(module.__file__).resolve() == path:
        return module
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[module_name]
        raise
    return module


def families(root: Path = ROOT) -> dict:
    """{family: {"patterns", "work", "span"}}: the union of the patterns of
    every slambench/kernels/<family>*.json that names the family."""
    out: dict = {}
    for path in sorted(glob.glob(str(root / "kernels" / "*.json"))):
        d = _json(Path(path))
        fam = out.setdefault(d["family"], {"patterns": [], "work": d["work"],
                                           "span": d.get("span")})
        fam["patterns"] += [p for p in d["patterns"]
                            if p not in fam["patterns"]]
    return out


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"slambench: no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with `trace` its per-layer ones:
    those listing the cell, or with no list those whose `moves` metric the
    cell reports."""
    def listed(m):
        return cell in m.get("workloads", [cell])

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]
