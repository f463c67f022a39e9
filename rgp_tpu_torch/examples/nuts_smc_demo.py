"""Config 5: NUTS over the kernel hyperparameters of a trained RGP
(narendra, M=30) and a particle filter over its latent trajectories; prints
NUTS's accept rate, divergence rate, step size and largest posterior
standard deviation, and the filter's log-marginal and least ESS.

    python -m rgp_tpu_torch.examples.nuts_smc_demo --chains 8 --particles 256
"""

from __future__ import annotations

import torch

import rgp_tpu_torch as rgp
from rgp_tpu_torch.data import datasets
from rgp_tpu_torch.examples._common import emit, parser
from rgp_tpu_torch.sample import api


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--particles", type=int, default=256)
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=100)
    args = ap.parse_args(argv)

    t = datasets.standardized_tensors(datasets.narendra(T=200), dtype=torch.float32, device=args.device)
    cfg = rgp.DeepRGP(wins=[0, 4], u_win=4, y_dim=1, u_dim=1, num_inducing=30)
    params = rgp.init(cfg, t.Y, t.U, seed=args.seed, device=args.device)
    fit = rgp.fit(lambda p: -rgp.elbo(cfg, p, t.Y, t.U), params, iters=args.iters, learning_rate=5e-3)

    nuts = api.sample_nuts(cfg, fit.params, t.Y, t.U, args.seed, n_samples=args.samples, n_warmup=args.warmup,
                           n_chains=args.chains, max_depth=6, step_size=0.02)
    gen = torch.Generator(device=t.Y.device).manual_seed(args.seed + 1)
    with torch.no_grad():
        smc_res = api.smc(cfg, fit.params, t.Y, t.U, t.U_test, t.Y_test, gen, n_particles=args.particles)
    return emit({
        "nuts_accept": round(float(nuts.accept_prob.mean()), 3),
        "nuts_divergence_rate": round(float(nuts.diverging.double().mean()), 4),
        "nuts_step_size": round(float(nuts.step_size), 5),
        "posterior_sd_max": round(float(nuts.samples.double().std(dim=(0, 1), correction=0).max()), 4),
        "smc_log_marginal": round(float(smc_res.log_marginal), 2),
        "smc_min_ess": round(float(smc_res.ess_history.min()), 1),
    })


if __name__ == "__main__":
    main()
