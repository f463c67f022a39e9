"""The yardstick: the card's published FP32 peak and the operations a
rollout step needs, counted from shapes.

The step count is the same whatever implements it: per candidate and layer
the moment-matched predictive, per layer a posterior spread over the
request's horizon. The Psi statistics' share of it, and the Psi2 time sum's,
are counted by each layer's kernel file (``kernels/<name>.py``). Ladder
trials beyond the first are not counted: a factorization that passes is
reused.
"""

from __future__ import annotations

from .reference import input_dims, layer_kernels

FP32_OPS_PER_S = 67e12  # H100 SXM data sheet: FP32 outside the tensor cores, at 700 W


def layer_shapes(cfg, T):
    """(T, M, Q) of each layer's Psi2 time sum, hidden layers first."""
    return [(T, cfg["num_inducing"], Q) for Q in input_dims(cfg)]


def _refresh(kf, T, M, Q):
    """A whitening basis: eigh, the first floor trial (whitened products and
    a Cholesky) and the Psi2 time sum."""
    k1 = kf.time_sum_work(T, M, Q)
    return 10 * M ** 3 / 3 + 8 * M ** 3 + M ** 3 / 3 + k1[0] + k1[1]


def rollout_per_step(cfg, traffic, T):
    """Operations of one step of a rollout request over its whole
    width, the request's posteriors spread over its horizon: per candidate
    and layer the Psi statistics (the kernel file's ``work``), the mean
    (2M), the quadratic and trace terms (4M^2); per layer a posterior (the
    Psi2 time sum, Psi0 and Psi1 over the record, a refresh's eigh and floor
    trial, the whitened products, two factors, two triangular solves of M
    right-hand sides and two products)."""
    B, H, ops = traffic["width"], traffic["horizon"], 0.0
    for (T_, M, Q), kf in zip(layer_shapes(cfg, T), layer_kernels(cfg)):
        w = kf.work(M, Q)
        per = w["psi0"] + w["psi1"] + w["psi2"] + 2 * M + 4 * M * M
        post = (_refresh(kf, T_, M, Q) + T_ * (w["psi0"] + w["psi1"]) + 8 * M ** 3 + 2 * M ** 3 / 3 + 2 * M ** 3
                + 4 * M ** 3)
        ops += B * per + post / H
    return ops
