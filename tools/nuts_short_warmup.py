#!/usr/bin/env python3
"""What the NUTS warmup schedule does with a short warmup, in both packages.

    JAX_PLATFORMS=cpu python tools/nuts_short_warmup.py [--warmup 24] [--seeds 0 1 2]

Runs ``nuts_warmup`` then 8 draws of ``nuts_draw`` (16 chains, max depth 6,
target accept 0.6, start step size 0.1: the config-5 benchmark's settings)
on a diagonal Gaussian with variances (4, 0.04, 1), in float64 on the CPU,
with ``rgp_tpu.sample.nuts`` and ``rgp_tpu_torch.sample.nuts``. Prints per
seed and package the final step size (exp of dual averaging's averaged log
step), the mean accept statistic and the divergence rate of the draws, and
the adapted inverse mass. The random streams differ between the packages, so
compare the figures, not the bits.

The schedule restarts dual averaging at step int(0.9 n_warmup) from ten times
the averaged step size (``mu = log(10 eps)``), so after a 24-step warmup three
adaptation steps remain and the final step size is the overshoot of the
restart: the config-5 quick budget (24 warmup steps) ends with a step size
several times the one a longer warmup settles on.
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

from rgp_tpu.sample import nuts as jnuts  # noqa: E402
from rgp_tpu_torch.sample import nuts as tnuts  # noqa: E402

VAR = np.array([4.0, 0.04, 1.0])
KW = dict(max_depth=6, target_accept=0.6)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warmup", type=int, default=24)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args(argv)
    z0 = np.zeros((16, VAR.size))
    var_t = torch.tensor(VAR)

    def U_jax(z):
        return 0.5 * jnp.sum(z * z / VAR)

    def U_torch(z):
        return 0.5 * (z * z / var_t).sum(-1)

    for seed in args.seeds:
        key = jax.random.PRNGKey(seed)
        c = jnuts.nuts_init(jnp.asarray(z0), n_chains=16, step_size=0.1)
        c = jax.jit(lambda c: jnuts.nuts_warmup(U_jax, c, key, args.warmup, n_warmup=args.warmup, **KW))(c)
        _, r = jnuts.nuts_draw(U_jax, c, key, 8, max_depth=KW["max_depth"])
        ct = tnuts.nuts_init(torch.tensor(z0), n_chains=16, step_size=0.1)
        ct = tnuts.nuts_warmup(U_torch, ct, seed, args.warmup, n_warmup=args.warmup, **KW)
        _, rt = tnuts.nuts_draw(U_torch, ct, seed, 8, max_depth=KW["max_depth"])
        for name, eps, acc, div, mass in (
            ("rgp_tpu", jnp.exp(c.da.log_eps_avg), r.accept_prob.mean(), r.diverging.mean(), c.mass_inv),
            ("rgp_tpu_torch", torch.exp(ct.da.log_eps_avg), rt.accept_prob.mean(), rt.diverging.double().mean(),
             ct.mass_inv),
        ):
            print(f"seed {seed} {name:14s} step size {float(eps):.4f}  mean accept {float(acc):.4f}  "
                  f"divergence rate {float(div):.4f}  mass_inv {np.round(np.asarray(mass), 4).tolist()}")


if __name__ == "__main__":
    main()
