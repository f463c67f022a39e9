#!/usr/bin/env python3
"""How far the float32 config-5 potential is from float64, on the CPU.

    python tools/potential_dtype_gap.py [--points 8]

At the committed anchor ``artifacts/pcheck_params_r5.npz`` (the flagship:
actuator, M=100) and at the last draw of each of the first ``--points``
chains of ``artifacts/pcheck_tpu_r5.npz``, evaluates the batched frozen-basis
potential of ``rgp_tpu_torch.sample.api.make_rgp_potential`` with its
gradient in float64 (block 64) and in float32 (block 32) on two Psi2 routes:
the plain chunked path, and the path of the CUDA kernels K1/K2, which on the
CPU runs their plain versions (the same T partition and summation order)
through the autograd Function. Prints, per point and route, the float32
value minus the float64 one, and the worst gradient error. The card's
numbers come from ``chip_smoke.py`` phase 9a.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rgp_tpu_torch.bench.sampling import _flagship  # noqa: E402
from rgp_tpu_torch.ops import psi_stats  # noqa: E402
from rgp_tpu_torch.ops.cuda import psi2  # noqa: E402
from rgp_tpu_torch.sample.api import make_rgp_potential  # noqa: E402
from rgp_tpu_torch.sample.hmc import value_and_grad  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANCHOR = os.path.join(ROOT, "artifacts", "pcheck_params_r5.npz")


def _batched(dtype, block):
    cfg, params, Y, U, _, _ = _flagship(0, dtype, ANCHOR, device="cpu")
    return make_rgp_potential(cfg, params, Y, U, block=block, psi_prefer="scan", fixed_whitening=True)[3]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=8)
    args = ap.parse_args(argv)
    with np.load(os.path.join(ROOT, "artifacts", "pcheck_tpu_r5.npz")) as z:
        points = z["draws"][:args.points, -1]
    u64, g64 = value_and_grad(_batched(torch.float64, 64), torch.tensor(points, dtype=torch.float64))
    plain = psi_stats._rbf_psi2_sum
    rows = {"plain": value_and_grad(_batched(torch.float32, 32), torch.tensor(points, dtype=torch.float32))}

    def through_function(p, Z, mu, s, block, prefer="auto", remat=True):
        return psi2.rbf_psi2_sum(p, Z, mu, s)

    psi_stats._rbf_psi2_sum = through_function
    try:
        rows["K1/K2 plain versions"] = value_and_grad(_batched(torch.float32, 32),
                                                      torch.tensor(points, dtype=torch.float32))
    finally:
        psi_stats._rbf_psi2_sum = plain
    print("U_f64:", np.round(u64.numpy(), 4).tolist())
    for name, (u, g) in rows.items():
        print(f"{name:22s} U_f32 - U_f64: {np.round((u.double() - u64).numpy(), 4).tolist()}  "
              f"worst |grad err| {float((g.double() - g64).abs().max()):.4f} (max |grad| {float(g64.abs().max()):.2f})")


if __name__ == "__main__":
    main()
