"""RBF with a lengthscale for each input dimension (ARD):
k(x, x') = var exp(-sum_q (x_q - x'_q)^2 / (2 l_q^2)), with the leaves of
``rgp_tpu_torch.kernels.RBF``. What a kernel file holds is set out at
:func:`benchmark.reference.kernel_file`.
"""

from __future__ import annotations

import torch

from ..reference import mm, softplus, softplus_inv

F32 = 4


def program(din):
    from rgp_tpu_torch.kernels import RBF

    return RBF(input_dim=din)


def init(n, din, dtype, device):
    """Unit variance and unit lengthscales."""
    return {"log_var": torch.full((n,), softplus_inv(1.0), dtype=dtype, device=device),
            "log_ls": torch.full((n, din), softplus_inv(1.0), dtype=dtype, device=device)}


def hyper(kp):
    return {"var": softplus(kp["log_var"]), "ls": softplus(kp["log_ls"])}


def K(p, X, X2):
    d = (X[:, None, :] - X2[None, :, :]) / p["ls"]
    return p["var"] * torch.exp(-0.5 * (d * d).sum(-1))


def psi0(p, mu, s):
    return p["var"].expand(mu.shape[0])


def psi1(p, Z, mu, s):
    """E k(x_t, z_m): (T, M)."""
    l2 = p["ls"] * p["ls"]
    d = mu[:, None, :] - Z[None, :, :]
    den = l2 + s[:, None, :]
    return p["var"] * torch.exp(-0.5 * torch.log1p(s / l2).sum(-1)[:, None] - 0.5 * (d * d / den).sum(-1))


def _log_psi2(p, Z, mu, s):
    """log E k(x_t, z_m) k(x_t, z_n), (T, M, M), from the midpoint form
    -|z_m - z_n|^2 / (4 l^2) - (mu - (z_m + z_n)/2)^2 / (l^2 + 2 s)."""
    l2 = p["ls"] * p["ls"]
    M, Q = Z.shape
    dz = (Z[:, None, :] - Z[None, :, :]) ** 2 / (4.0 * l2)
    zbar = (0.5 * (Z[:, None, :] + Z[None, :, :])).reshape(M * M, Q)
    w = 1.0 / (l2 + 2.0 * s)  # (T, Q)
    quad = (w * mu * mu).sum(-1)[:, None] - 2.0 * mm(w * mu, zbar.T) + mm(w, (zbar * zbar).T)
    logc = 2.0 * torch.log(p["var"]) - 0.5 * torch.log1p(2.0 * s / l2).sum(-1)
    return logc[:, None, None] - dz.sum(-1)[None] - quad.reshape(-1, M, M)


def psi2(p, Z, mu, s):
    """E k(x_t, z_m) k(x_t, z_n): (T, M, M)."""
    return torch.exp(_log_psi2(p, Z, mu, s))


def psi2_sum(p, Z, mu, s, block):
    """sum_t E k(x_t, z_m) k(x_t, z_n), (M, M), ``block`` steps at a time."""
    out = 0.0
    for a in range(0, mu.shape[0], block):
        out = out + torch.exp(_log_psi2(p, Z, mu[a:a + block], s[a:a + block])).sum(0)
    return out


def work(M, Q):
    """Psi0 is the variance itself; Psi1 M(4Q+4); Psi2 at the symmetric
    half, M(M+1)/2 (2Q+7) (an exp counts as one operation)."""
    return {"psi0": 0, "psi1": M * (4 * Q + 4), "psi2": M * (M + 1) // 2 * (2 * Q + 7)}


def time_sum_work(T, M, Q):
    """sum_t Psi2_t as K1 computes it from (base, E, D1, w, Z): T M(M+1)/2
    elements at 2Q+6 operations and one exp each (a copy of
    ``rgp_tpu_torch/bench/roofline.py``'s ``k1_work``)."""
    elems = T * M * (M + 1) // 2
    return elems * (2 * Q + 6), elems, F32 * (T + T * M + M * M + T * Q + M * Q + M * M)
