"""The port's example scripts (rgp_tpu_torch/examples) at tiny sizes on the
CPU, in this one process: tests/test_examples.py's sizes, ``--device cpu``.
Each must print one JSON line with the keys its JAX twin in examples/
prints; the tempered-SMC example prints its twin's line per variant, then a
JSON line."""

import ast
import importlib
import json
import pathlib
import re

import pytest
import torch

_JAX_EXAMPLES = pathlib.Path(__file__).parent.parent / "examples"

# tests/test_examples.py's _FAST_CASES and _SLOW_CASES
_CASES = [
    ("actuator_rgp", ["--iters", "10", "--num-inducing", "10"]),
    ("drives_deep_rgp", ["--iters", "10", "--num-inducing", "8"]),
    ("minibatch_svgp", ["--iters", "10", "--batch", "64", "--num-inducing", "16"]),
    ("nuts_smc_demo", ["--iters", "10", "--chains", "2", "--particles", "16", "--samples", "3", "--warmup", "3"]),
    ("evidence_tempered_smc", ["--iters", "10", "--particles", "8"]),
]


@pytest.fixture(autouse=True)
def _intra_op_threads(request):
    """One intra-op thread (many small ops; the test workers share the CPU),
    restored after the test. The tempered-SMC example takes up to four: its
    time goes to a few large dense Psi2 sums of (particles, T, M, M)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4) if "evidence" in request.node.name else 1)
    yield
    torch.set_num_threads(n)


def _jax_twin_keys(name):
    """The keys of the dict literal the JAX example hands ``json.dumps``."""
    tree = ast.parse((_JAX_EXAMPLES / f"{name}.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    return None


@pytest.mark.parametrize("name,args", _CASES, ids=[c[0] for c in _CASES])
def test_example_runs_on_the_cpu(name, args, capsys):
    mod = importlib.import_module(f"rgp_tpu_torch.examples.{name}")
    record = mod.main([*args, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(record))
    keys = _jax_twin_keys(name)
    if keys is not None:
        assert set(record) == keys
        return
    # the tempered-SMC example: its twin's text line per variant, then the record
    assert set(record["variants"]) == {"rgp1_rbf", "rgp1_rbf_plus_linear"}
    pattern = re.compile(r"^\s*(\S+): fitted ELBO\s+(\S+)\s+log-evidence\s+(\S+) \((\d+) tempering stages\)")
    text = [pattern.match(line) for line in lines[:-1]]
    assert [m.group(1) for m in text if m] == list(record["variants"])
    for m in text:
        row = record["variants"][m.group(1)]
        assert int(m.group(4)) == row["n_stages"] and 1 <= row["n_stages"] <= 50
        assert row["truncated"] == (row["beta_final"] < 1.0)
        assert all(map(lambda x: x == x and abs(x) < float("inf"), (row["fitted_elbo"], row["log_evidence"])))
