"""The benchmark's own tests: CPU tests at small sizes, and `cuda`-marked
tests that run cells on the card. Run them from the checkout's root:

    python -m pytest slambench/tests            # the CPU tests
    python -m pytest -m cuda slambench/tests    # on a machine with a card
"""

import json
import os
import sys

import pytest

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for _p in (os.path.join(_CHECKOUT, "src"), _CHECKOUT):
    if _p not in sys.path:
        sys.path.insert(0, _p)


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def small_config(cfg: dict) -> dict:
    """A configuration cut to a size a CPU test holds: 768-point scans,
    an 8,192-point map, a 2,048-point local model (widths unchanged); the
    backend's gates loosened so that an 8-frame out-and-back log closes
    loops."""
    cfg = json.loads(json.dumps(cfg))
    cfg["mapping"].update(map_capacity=8192, local_model_size=2048)
    cfg["pipeline"].update(scan_capacity=768, downsample_voxel=0.5)
    if cfg["backend"]["enabled"]:
        cfg["backend"].update(min_loop_separation=2, candidate_topk=1,
                              verify_yaws=4, gating_radius=10.0)
    return cfg


def small_traffic(mix: dict) -> dict:
    """The traffic mix on 8-frame (16 on the loop) logs of 10 x 192 rays,
    two worlds at most, one profiled sequence."""
    mix = dict(mix, rings=10, azimuth=192, frames=min(mix["frames"], 8),
               profile_sequences=1, worlds=mix["worlds"][:2])
    if mix["route"] == "straight":
        mix["path_fraction"] = 0.1
    else:
        mix["frames"] = 16
    return mix


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's cells run on the card")
    return torch.device("cuda")
