#!/usr/bin/env python3
"""Which ladder rung flips where the golden 50-step trajectory splits.

    JAX_PLATFORMS=cpu python tools/golden_cliff.py [--steps 38 39]

Trains the golden setup of tests/test_golden_regression.py (float64, actuator,
M=50, Adam 1e-2 from ``init_params(seed=0)``) for each given number of steps
in both packages on the CPU: ``rgp_tpu.train.fit_adam`` and
``rgp_tpu_torch.train.fit_adam``. At each package's parameters it evaluates
the port's ELBO with its discrete choices recorded: the float32 floor-ladder
trials of ``whitening_basis`` (two per layer: the base floor, then 1e3 x base;
True means the trial Cholesky failed) and the jitter rung of each
``jitchol`` (1, 1e3 or 1e7 x jitter0). It also prints the JAX package's ELBO
at its own parameters, to show the two packages agree at equal parameters.
"""

import argparse
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from rgp_tpu import train as jtrain  # noqa: E402
from rgp_tpu.models import rgp as jr  # noqa: E402
from rgp_tpu_torch import linalg, train  # noqa: E402
from rgp_tpu_torch.convert import params_from_jax  # noqa: E402
from rgp_tpu_torch.data import datasets as td  # noqa: E402
from rgp_tpu_torch.inference import collapsed_vi as cvi  # noqa: E402
from rgp_tpu_torch.models import rgp as tr  # noqa: E402

_choices = []


def _recording_jitchol(A, jitter0=1e-6):
    L, jitter = linalg.jitchol_with_jitter(A, jitter0)
    if not torch.is_grad_enabled():  # record the evaluations below, not the training steps
        _choices.append(("jitter_rung", float(jitter / torch.diagonal(A).mean().clamp(min=1e-30) / jitter0)))
    return L


def _recording_chol_fails(A, _orig=cvi._chol_fails):
    failed = _orig(A)
    if not torch.is_grad_enabled():
        _choices.append(("floor_trial_fails", bool(failed)))
    return failed


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, nargs="+", default=[38, 39])
    args = ap.parse_args()
    d = td.standardized_tensors(td.actuator(), dtype=torch.float64, device="cpu")
    cfg = tr.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=50)
    jcfg = jr.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=50)
    Y, U = jnp.asarray(d.Y.numpy()), jnp.asarray(d.U.numpy())
    cvi.jitchol = _recording_jitchol
    cvi._chol_fails = _recording_chol_fails

    for n in args.steps:
        tp = tr.init_params(cfg, d.Y, d.U, dtype=torch.float64, seed=0, device="cpu")
        ours = train.fit_adam(lambda p: tr.neg_elbo(cfg, p, d.Y, d.U, block=None), tp,
                              iters=n, learning_rate=1e-2).params
        jp = jr.init_params(jcfg, Y, U, dtype=jnp.float64, seed=0)
        ref = jtrain.fit_adam(lambda p: -jr.elbo(jcfg, p, Y, U, block=None), jp,
                              iters=n, learning_rate=1e-2).params
        ref_t = params_from_jax(jax.tree.map(np.asarray, ref), dtype=torch.float64, device="cpu")
        diff = max(float((a - b).abs().max())
                   for (_, a), (_, b) in zip(train.leaves_with_paths(ours), train.leaves_with_paths(ref_t)))
        print(f"after {n} steps: max |parameter difference| {diff:.3e}")
        for who, p in (("port", ours), ("jax", ref_t)):
            _choices.clear()
            with torch.no_grad():
                e = float(tr.elbo(cfg, p, d.Y, d.U, block=None))
            print(f"  {who} parameters: port ELBO {e!r}; per layer (hidden, output): {_choices}")
        print(f"  jax parameters: JAX ELBO {float(jr.elbo(jcfg, ref, Y, U, block=None))!r}")


if __name__ == "__main__":
    main()
