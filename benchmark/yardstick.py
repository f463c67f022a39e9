"""The yardstick: the card's published FP32 peak, the least work of the
Psi2 time sum K1, and the operations a rollout step needs, counted from
shapes.

The K1 count is a copy of ``rgp_tpu_torch/bench/roofline.py``'s
``k1_work`` (an exp counts as one operation). The step count is the same
whatever implements it: per candidate and layer the moment-matched
predictive, per layer a posterior spread over the request's horizon. Ladder
trials beyond the first are not counted: a factorization that passes is
reused.
"""

from __future__ import annotations

from .reference import layout

FP32_OPS_PER_S = 67e12  # H100 SXM data sheet: FP32 outside the tensor cores, at 700 W
F32 = 4


def k1_work(T, M, Q):
    """(operations, exps, bytes) of sum_t Psi2_t from (base, E, D1, w, Z):
    T M(M+1)/2 elements at 2Q+6 operations and one exp each."""
    elems = T * M * (M + 1) // 2
    return elems * (2 * Q + 6), elems, F32 * (T + T * M + M * M + T * Q + M * Q + M * M)


def layer_shapes(cfg, T):
    """(T, M, Q) of each layer's Psi2 time sum, hidden layers first."""
    lay = layout(cfg)
    M, out = cfg["num_inducing"], []
    for h, L in enumerate(lay.wins):
        out.append((T, M, L * lay.q + (lay.u_win if h == 0 else L * lay.q)))
    out.append((T, M, lay.out_win * lay.q))
    return out


def _refresh(T, M, Q):
    """A whitening basis: eigh, the first floor trial (whitened products and
    a Cholesky) and K1."""
    k1 = k1_work(T, M, Q)
    return 10 * M ** 3 / 3 + 8 * M ** 3 + M ** 3 / 3 + k1[0] + k1[1]


def rollout_per_step(cfg, traffic, T):
    """Operations of one step of a rollout request over its whole
    width, the request's posteriors spread over its horizon: per candidate
    and layer Psi1 (M(4Q+4)), Psi2 at the symmetric half (M(M+1)/2 (2Q+7)),
    the mean (2M), the quadratic and trace terms (4M^2); per layer a
    posterior (K1, Psi1, a refresh's eigh and floor trial, the whitened
    products, two factors, two triangular solves of M right-hand sides and
    two products)."""
    B, H, ops = traffic["width"], traffic["horizon"], 0.0
    for T_, M, Q in layer_shapes(cfg, T):
        per = M * (4 * Q + 4) + M * (M + 1) // 2 * (2 * Q + 7) + 2 * M + 4 * M * M
        post = _refresh(T_, M, Q) + T_ * M * (4 * Q + 4) + 8 * M ** 3 + 2 * M ** 3 / 3 + 2 * M ** 3 + 4 * M ** 3
        ops += B * per + post / H
    return ops
