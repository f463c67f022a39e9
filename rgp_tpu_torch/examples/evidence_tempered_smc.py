"""Model comparison by tempered-SMC log-evidence: fits two RGP variants on
the actuator data (an RBF layer, and an RBF + Linear sum) and compares their
evidence estimates log Z = log E_prior[exp(ELBO)] from adaptive-tempering SMC
over the unconstrained kernel hyperparameters. Prints a line per variant,
then the same as one JSON line.

    python -m rgp_tpu_torch.examples.evidence_tempered_smc --iters 2000 --particles 256
"""

from __future__ import annotations

import torch

from rgp_tpu_torch import train
from rgp_tpu_torch.data import datasets
from rgp_tpu_torch.examples._common import emit, parser
from rgp_tpu_torch.kernels import RBF, Linear, Sum
from rgp_tpu_torch.models import rgp
from rgp_tpu_torch.sample.api import sample_tempered


def fit_and_evidence(cfg, Y, U, iters, particles, generator):
    params = rgp.init_params(cfg, Y, U, device=Y.device)
    res = train.fit_adam(lambda p: -rgp.elbo(cfg, p, Y, U, block=None), params, iters=iters, learning_rate=1e-2)
    tres, _ = sample_tempered(cfg, res.params, Y, U, generator, n_particles=particles, prior_std=1.0, n_moves=3)
    with torch.no_grad():
        elbo = float(rgp.elbo(cfg, res.params, Y, U, block=None))
    return elbo, float(tres.log_Z), tres.n_stages, float(tres.beta_final)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--particles", type=int, default=256)
    args = ap.parse_args(argv)

    t = datasets.standardized_tensors(datasets.load("actuator"), dtype=torch.float32, device=args.device)
    din = 10 + 10
    variants = {
        "rgp1_rbf": rgp.deep_rgp_config(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=50),
        "rgp1_rbf_plus_linear": rgp.deep_rgp_config(
            wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=50,
            kernels=[Sum(input_dim=din, parts=(RBF(input_dim=din), Linear(input_dim=din)))],
        ),
    }
    rows = {}
    for i, (name, cfg) in enumerate(variants.items()):
        gen = torch.Generator(device=t.Y.device).manual_seed(args.seed + i)
        elbo, log_z, stages, bf = fit_and_evidence(cfg, t.Y, t.U, args.iters, args.particles, gen)
        note = "" if bf >= 1.0 else f"  [TRUNCATED at beta={bf:.3f} — raise max_stages]"
        print(f"{name:>24}: fitted ELBO {elbo:10.1f}   log-evidence {log_z:10.1f} "
              f"({stages} tempering stages){note}")
        rows[name] = {"fitted_elbo": elbo, "log_evidence": log_z, "n_stages": stages, "beta_final": bf,
                      "truncated": bf < 1.0}
    return emit({"particles": args.particles, "iters": args.iters, "variants": rows})


if __name__ == "__main__":
    main()
