"""Small cells for the benchmark's CPU tests: the real configuration and
traffic files, cut to sizes a test run holds (a shorter record, fewer
inducing points, a narrower and shorter rollout)."""

import pytest
import torch

from benchmark import run

_NARROW = {"width": 16, "horizon": 4, "check_requests": 2, "check_candidates": 6, "trace_requests": 2}
SMALL = {
    "rgp1-rollout-w16384": ({"T": 64, "num_inducing": 12}, _NARROW),
    "rgp2mlp-rollout-w1024": ({"T": 48, "num_inducing": 12}, _NARROW),
}


def small_cell(name):
    cell = run.load_cell(name)
    over_cfg, over_traffic = SMALL[name]
    cell.config.update(over_cfg)
    cell.config.pop("served_params", None)  # fitted at the full size
    cell.traffic.update(over_traffic)
    return cell


@pytest.fixture
def cpu():
    return torch.device("cpu")
