"""Config 1: a 1-layer RGP, RBF-ARD, M=100 on the actuator dataset, trained
with Adam (cosine decay to 1%), free-simulated over the test inputs; prints
the ELBO before and after training and the free-run RMSE beside the zero
predictor's.

    python -m rgp_tpu_torch.examples.actuator_rgp --iters 3000
"""

from __future__ import annotations

import numpy as np
import torch

import rgp_tpu_torch as rgp
from rgp_tpu_torch.data import datasets
from rgp_tpu_torch.examples._common import emit, parser
from rgp_tpu_torch.train import cosine_decay_schedule


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--iters", type=int, default=10000)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--num-inducing", type=int, default=100)
    args = ap.parse_args(argv)

    d = datasets.actuator()
    t = datasets.standardized_tensors(d, dtype=torch.float32, device=args.device)
    cfg = rgp.DeepRGP(wins=[0, 10], u_win=10, y_dim=1, u_dim=1, num_inducing=args.num_inducing)
    params = rgp.init(cfg, t.Y, t.U, seed=args.seed, device=args.device)
    res = rgp.fit(lambda p: -rgp.elbo(cfg, p, t.Y, t.U), params, iters=args.iters,
                  learning_rate=cosine_decay_schedule(args.lr, args.iters, 0.01))
    with torch.no_grad():
        means, _ = rgp.freerun(cfg, res.params, t.Y, t.U, t.U_test)
    m = t.sy.inverse(means.double().cpu().numpy())
    elbos = (-res.losses).double().cpu().numpy()
    return emit({
        "elbo": [round(float(elbos[0]), 2), round(float(elbos[-1]), 2)],
        "freerun_rmse": round(float(np.sqrt(np.mean((m - d.y_test) ** 2))), 4),
        "zero_rmse": round(float(np.sqrt(np.mean(d.y_test ** 2))), 4),
    })


if __name__ == "__main__":
    main()
