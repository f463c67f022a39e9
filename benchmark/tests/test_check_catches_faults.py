"""A run's check comes out true on the program as it is and false with the
timed path broken underneath, or with the lower-precision control in the
program's place. The chip look is skipped: the rest of a run is driven on
the CPU at a small size. Each cell serves a model fitted here by
``fit_served_model`` at that size."""

import numpy as np
import pytest
import torch

from benchmark import faults, fit_served_model, rehearse
from benchmark.tests.conftest import small_cell


CELLS = ["rgp1-rollout-w16384", "rgp2mlp-rollout-w1024"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{cell: an npz of the model fitted at the cell's small size}."""
    out = {}
    for name in CELLS:
        leaves, _ = fit_served_model.fit(small_cell(name).config, 150, 0, torch.device("cpu"))
        path = tmp_path_factory.mktemp("served") / f"{name}.npz"
        np.savez(path, **leaves)
        out[name] = str(path)
    return out


def _cell(name, served):
    cell = small_cell(name)
    cell.config["served_params"] = served[name]
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_the_program_passes(name, served, cpu):
    row = rehearse.rehearse(_cell(name, served), 4242, "program", 0.3, cpu)
    assert row["correct"], row["numbers"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("mode", ["control"] + [f"fault:{f}" for f in faults.NAMES])
def test_the_check_fails(name, mode, served, cpu):
    row = rehearse.rehearse(_cell(name, served), 4242, mode, 0.3, cpu)
    assert not row["correct"], row["numbers"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card_is_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark import run

    result, _ = run.run_cell(run.load_cell(name), 1234567890123, 3.0, 0, torch.device("cuda", 0))
    assert result["correct"] and result["failed"] == 0, result["checks"]
