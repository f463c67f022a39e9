"""Config 4: stochastic minibatch VI with natural-gradient q(u) on a long
sequence corpus (a GP-NARX design, y window 5, u window 3); prints the
minibatch ELBO before and after training and the held-out one-step RMSE.

    python -m rgp_tpu_torch.examples.minibatch_svgp --iters 2000 --batch 256
"""

from __future__ import annotations

import torch

from rgp_tpu_torch import train
from rgp_tpu_torch.data import datasets
from rgp_tpu_torch.data.windows import narx_design
from rgp_tpu_torch.examples._common import emit, parser
from rgp_tpu_torch.kernels import RBF
from rgp_tpu_torch.models import svgp


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--num-inducing", type=int, default=128)
    ap.add_argument("--natgrad-lr", type=float, default=0.3)
    args = ap.parse_args(argv)

    t = datasets.standardized_tensors(datasets.long_corpus(), dtype=torch.float32, device=args.device)
    X, Yt = narx_design(t.Y, t.U, y_win=5, u_win=3)
    T = X.shape[0]
    cfg = svgp.SVGPConfig(RBF(input_dim=X.shape[1]), args.num_inducing)
    params = svgp.init_params(cfg, X, noise=0.2, seed=args.seed, device=args.device)

    def loss(p, batch):
        return -svgp.elbo(cfg, p, batch["X"], batch["Y"], T_total=T)

    res = train.fit_minibatch(loss, params, {"X": X, "Y": Yt}, iters=args.iters, batch_size=args.batch,
                              seed=args.seed, learning_rate=5e-3, natgrad_block="qu", natgrad_lr=args.natgrad_lr)
    Xte, Yte = narx_design(t.Y_test, t.U_test, y_win=5, u_win=3)
    with torch.no_grad():
        m, _ = svgp.predict(cfg, res.params, Xte, include_noise=True)
    elbos = (-res.losses).double().cpu()
    return emit({
        "T_train": T,
        "batch": args.batch,
        "elbo_minibatch": [round(float(elbos[0]), 1), round(float(elbos[-1]), 1)],
        "one_step_rmse_test": round(float(torch.sqrt(torch.mean((m - Yte) ** 2))), 4),
    })


if __name__ == "__main__":
    main()
