"""GPy's additive kernel ``Add(RBF(ARD), Linear(ARD))``, both parts over every
input:

    k(x, x') = var exp(-sum_q (x_q - x'_q)^2 / (2 l_q^2)) + sum_q v_q x_q x'_q,

with the leaves of ``rgp_tpu_torch.kernels.Sum(parts=(RBF, Linear))``: a
tuple of the RBF part's leaves (``rbf_ard.py``) and the Linear part's
``log_var``, one softplus-transformed variance an input. What a kernel file
holds is set out at :func:`benchmark.reference.kernel_file`.

The expectations under x ~ N(mu, diag s) are the parts' own plus, in Psi2,
the cross term E[k_rbf(x, z_m) k_lin(x, z_n)] and its transpose. The RBF
factor times the density of x is a Gaussian in x, per input q with precision
1/s_q + 1/l_q^2 and mean

    xt_mq = (l_q^2 mu_q + s_q z_mq) / (l_q^2 + s_q),

and mass Psi1_rbf[m], so the linear factor's expectation under it gives

    E[k_rbf(x, z_m) k_lin(x, z_n)] = Psi1_rbf[m] sum_q v_q z_nq xt_mq.

Departure from GPy: GPy's ``Add.psi2`` takes an RBF x Linear cross term only
over disjoint active dimensions (there the expectation factorizes as
Psi1_rbf Psi1_lin^T). Here both parts span all inputs, so the cross term is
the exact Gaussian expectation above, as the program's is.
"""

from __future__ import annotations

from pathlib import Path

import torch

from ..reference import kernel_file, mm, softplus, softplus_inv

F32 = 4
rbf = kernel_file("rbf_ard", Path(__file__).resolve().parent)


def program(din):
    from rgp_tpu_torch.kernels import RBF, Linear, Sum

    return Sum(input_dim=din, parts=(RBF(input_dim=din), Linear(input_dim=din)))


def init(n, din, dtype, device):
    """The RBF part's unit variance and lengthscales; unit linear variances
    (GPy's default and the program's ``Linear.init``)."""
    return (rbf.init(n, din, dtype, device),
            {"log_var": torch.full((n, din), softplus_inv(1.0), dtype=dtype, device=device)})


def hyper(kp):
    return rbf.hyper(kp[0]), {"v": softplus(kp[1]["log_var"])}


def K(p, X, X2):
    return rbf.K(p[0], X, X2) + mm(X * p[1]["v"], X2.mT)


def psi0(p, mu, s):
    return rbf.psi0(p[0], mu, s) + (p[1]["v"] * (mu * mu + s)).sum(-1)


def _lin_psi1(v, Z, mu):
    return mm(mu * v, Z.mT)


def psi1(p, Z, mu, s):
    """E k(x_t, z_m): (T, M)."""
    return rbf.psi1(p[0], Z, mu, s) + _lin_psi1(p[1]["v"], Z, mu)


def cross(p, Z, mu, s):
    """E[k_rbf(x_t, z_m) k_lin(x_t, z_n)], (T, M, M), one direction: the
    means xt (T, M, Q) of the RBF factor's Gaussian in x, contracted with
    v z_n and weighted by Psi1_rbf."""
    T, Q = mu.shape
    M = Z.shape[0]
    l2 = p[0]["ls"] * p[0]["ls"]
    xt = (l2 * mu[:, None, :] + s[:, None, :] * Z[None, :, :]) / (l2 + s)[:, None, :]
    lin = mm(xt.reshape(T * M, Q), (Z * p[1]["v"]).mT).reshape(T, M, M)
    return rbf.psi1(p[0], Z, mu, s)[:, :, None] * lin


def psi2(p, Z, mu, s):
    """E k(x_t, z_m) k(x_t, z_n), (T, M, M): the RBF part's, the Linear
    part's (psi1_m psi1_n + sum_q v_q^2 s_q z_mq z_nq) and the cross term
    both ways."""
    v = p[1]["v"]
    a = _lin_psi1(v, Z, mu)
    Zv = Z * v
    lin = a[:, :, None] * a[:, None, :] + mm(Zv[None] * s[:, None, :], Zv.mT)
    c = cross(p, Z, mu, s)
    return rbf.psi2(p[0], Z, mu, s) + lin + c + c.mT


def psi2_sum(p, Z, mu, s, block):
    """sum_t of :func:`psi2`, (M, M), ``block`` steps at a time."""
    out = 0.0
    for a in range(0, mu.shape[0], block):
        out = out + psi2(p, Z, mu[a:a + block], s[a:a + block]).sum(0)
    return out


def work(M, Q):
    """The RBF part's counts (``rbf_ard.work``) plus, at one input point:
    the Linear Psi0, v (mu^2 + s) summed, 4Q; the Linear Psi1, mu v (Q) and
    a dot with each z_m (2MQ), added to the RBF's (M); the Linear Psi2 at the
    symmetric half, M(M+1)/2 (2Q+2); the cross term: xt, 3MQ, its
    contraction with v z, 2M^2 Q, the weight Psi1_rbf, M^2, and C + C^T
    and the three terms added, 3 M(M+1)/2."""
    r = rbf.work(M, Q)
    half = M * (M + 1) // 2
    return {"psi0": r["psi0"] + 4 * Q, "psi1": r["psi1"] + 2 * M * Q + Q + M,
            "psi2": r["psi2"] + half * (2 * Q + 2) + 3 * M * Q + 2 * M * M * Q + M * M + 3 * half}


def time_sum_work(T, M, Q):
    """sum_t Psi2_t as the program computes it: the RBF part on K1
    (``rbf_ard.time_sum_work``), the Linear part in closed form (Psi1_lin,
    2TMQ; its Gram, 2TM^2; sum_t s, TQ; (Z v s) (Z v)^T, 2M^2 Q) and the
    cross term from its time sum sum_t Psi1_rbf[t,m] xt_tmq (xt 3TMQ, the
    weighted sum 2TMQ; the contraction with v z 2M^2 Q; C + C^T, M^2).
    Psi1_rbf over the record is counted with Psi1. Bytes: K1's, plus mu, s
    and Psi1_rbf read and the two (M, M) terms written."""
    ops, trans, nbytes = rbf.time_sum_work(T, M, Q)
    lin = 2 * T * M * Q + 2 * T * M * M + T * Q + 2 * M * M * Q
    crs = 5 * T * M * Q + 2 * M * M * Q + M * M
    return ops + lin + crs, trans, nbytes + F32 * (2 * T * Q + T * M + 2 * M * M)
