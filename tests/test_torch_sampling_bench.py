"""rgp_tpu_torch.bench.sampling and .posterior_check against
rgp_tpu.bench.sampling and .posterior_check on the CPU.

* ``_flagship`` loads the committed anchor ``artifacts/pcheck_params_r5.npz``
  without JAX into the JAX package's leaves, and the frozen-basis float64
  potential there is ``U_f64_frozen`` of ``artifacts/surrogate_check_r5.json``
  (-13.3, two decimals);
* the command line has the JAX benchmark's options and defaults, and nothing
  else;
* ``_jit_scale`` and ``compare_draws`` equal the JAX package's
  ``_jit_scale`` and the statistics of its ``mode_compare``.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgp_tpu.bench import posterior_check as jpc
from rgp_tpu.bench import sampling as jsampling
from rgp_tpu_torch.bench import posterior_check as tpc
from rgp_tpu_torch.bench import sampling as tsampling
from rgp_tpu_torch.params import leaves_with_paths
from rgp_tpu_torch.sample.api import make_rgp_potential

ROOT = Path(__file__).resolve().parents[1]
ANCHOR = ROOT / "artifacts" / "pcheck_params_r5.npz"


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Samplers run many small ops: one intra-op thread each, restored after
    the test. The test workers share the CPU, and with a thread pool per
    worker a sampler test ran ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_flagship_loads_the_anchor_in_jax_leaf_order():
    cfg, params, *_ = tsampling._flagship(0, torch.float32, str(ANCHOR), device="cpu")
    jcfg, jparams, *_ = jsampling._flagship(0, jnp.float32, str(ANCHOR))
    ours = [x.numpy() for _, x in leaves_with_paths(params)]
    ref = [np.asarray(x) for x in jax.tree.leaves(jparams)]
    assert len(ours) == len(ref) == 12
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert cfg.layers[0].num_inducing == jcfg.layers[0].num_inducing == 100


def test_frozen_f64_potential_at_the_anchor_is_the_recorded_one():
    record = json.loads((ROOT / "artifacts" / "surrogate_check_r5.json").read_text())
    u_ref = next(p["U_f64_frozen"] for p in record["points"] if p["point"] == "anchor")
    cfg, p64, Y, U, _, _ = tsampling._flagship(0, torch.float64, str(ANCHOR), device="cpu")
    pot, flat0, _, _ = make_rgp_potential(cfg, p64, Y, U, block=64, psi_prefer="scan", fixed_whitening=True)
    with torch.no_grad():
        assert abs(float(pot(flat0)) - u_ref) <= 0.005 + 1e-9


def _options(parser_main, argv):
    """The argparse namespace a benchmark's ``main`` builds, without running it."""
    import argparse

    seen = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen["ns"] = real(self, args, namespace)
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            parser_main(argv)
    finally:
        argparse.ArgumentParser.parse_args = real
    return vars(seen["ns"])


def test_command_line_is_the_jax_benchmarks():
    for argv in ([], ["--what", "smc", "--particles", "64"], ["--chains", "128", "--warmup", "24", "--draws", "8"]):
        assert _options(tsampling.main, argv) == _options(jsampling.main, argv)


def test_jit_scale_matches_jax():
    mass_inv = np.array([1e-4, 0.5, 3.0, 30.0, 1e4])
    np.testing.assert_allclose(tpc._jit_scale(torch.tensor(mass_inv)).numpy(),
                               np.asarray(jpc._jit_scale(jnp.asarray(mass_inv))), rtol=1e-15)


def test_compare_draws_matches_mode_compare(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((6, 40, 3)) + [0.0, 0.3, 0.0]
    b = rng.standard_normal((4, 60, 3)) * [1.0, 1.0, 2.0]
    div_a, div_b = rng.uniform(size=(6, 40)) < 0.05, np.zeros((4, 60), bool)
    np.savez(tmp_path / "a.npz", draws=a, diverging=div_a)
    np.savez(tmp_path / "b.npz", draws=b, diverging=div_b)
    ref = jpc.mode_compare(str(tmp_path / "a.npz"), str(tmp_path / "b.npz"))
    ours = {"mode": "compare", **tpc.compare_draws(a, div_a, b, div_b)}
    # the port names the JAX record's "tpu" and "cpu_ref" blocks "draws" and "reference"
    ours["tpu"], ours["cpu_ref"] = ours.pop("draws"), ours.pop("reference")
    assert sorted(ours) == sorted(ref)

    def close(x, y):
        if isinstance(x, dict):
            assert sorted(x) == sorted(y)
            for k in x:
                close(x[k], y[k])
        elif isinstance(x, list):
            for u, v in zip(x, y):
                close(u, v)
        elif isinstance(x, str):
            assert x == y
        else:  # the JAX record rounds its numbers
            np.testing.assert_allclose(x, y, atol=1e-3, rtol=1e-3)

    close(ours, ref)
