"""Deep Recurrent Gaussian Process with REVARB variational inference (port of
``rgp_tpu/models/rgp.py``: the bound, the posteriors and free simulation).

The model is a frozen config (:class:`RGPConfig`) plus a nested parameter dict

  {"layers": [{"kern": {"log_var", "log_ls"}, "Z", "log_noise",
               "mu0", "log_lam0", "mu", "log_lam"}, ...],
   "out": {"kern": {...}, "Z", "log_noise"}}

of unconstrained tensors, with the same key names as the JAX package's pytree
(:func:`rgp_tpu_torch.convert.params_from_jax` carries one over). With
back-constraints (``back_cstr``) it also holds ``"encoder"``, one MLP per
hidden layer mapping the windows of Y and U to that layer's q(X) means (and,
with ``amortize_var``, its log-variances). Layers are indexed deepest-first
(layer 0 is driven by U):

  layer 0:  xbar^0_t = [x^0_{t-1..t-L0}, u_t..u_{t-Lu+1}]
  layer h:  xbar^h_t = [x^h_{t-1..t-Lh}, x^{h-1}_t..x^{h-1}_{t-Lh+1}]
  output :  y_t      = f_out(x^{H-1}_t .. x^{H-1}_{t-Lout+1}) + eps_y

:func:`elbo` (and :func:`neg_elbo`, the training loss) is differentiable on
every device: on float32 CUDA tensors its Psi2 sums run through the kernels K1
and K2. :func:`freerun` is the serving path: posteriors once, then a
closed-loop moment-matched rollout, one Python step per test input;
given a batch of input sequences it rolls them out at once, replaying
captured CUDA graphs of its steps on the card (:class:`StepGraphs`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from ..data.windows import current_window, lagged, np_current_window, np_lagged
from ..device import resolve_device
from ..inference.collapsed_vi import collapsed_bound, posterior, predict_uncertain, whitening_basis
from ..kernels import RBF, Kernel, Prod, Sum
from ..ops.psi_stats import psi_statistics
from ..params import np_positive_inv, positive
from ..utils.profiling import annotate
from .encoder import init_mlp, mlp_apply
from .sparse_gp import host, kmeans_init

__all__ = ["LayerSpec", "RGPConfig", "init_params", "elbo", "neg_elbo", "freerun", "predict_train",
           "deep_rgp_config", "compute_whitenings", "StepGraphs", "step_graphs"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kernel: Kernel
    win: int  # autoregressive window L_h (> 0)
    q_dim: int  # latent dimension Q_h
    num_inducing: int


@dataclasses.dataclass(frozen=True)
class RGPConfig:
    layers: Tuple[LayerSpec, ...]  # hidden layers, deepest (U-driven) first
    out_kernel: Kernel
    out_num_inducing: int
    out_win: int  # emission window over top latents (>= 1)
    u_win: int  # exogenous window L_u on layer 0
    y_dim: int
    u_dim: int
    back_cstr: bool = False
    mlp_hidden: Tuple[int, ...] = ()
    amortize_var: bool = False
    # additive lower bound on every layer's noise variance (0 disables)
    noise_floor: float = 0.0

    @property
    def n_hidden(self) -> int:
        return len(self.layers)


def deep_rgp_config(wins, u_win: int, y_dim: int, u_dim: int, num_inducing: int = 100,
                    q_dims=None, kernels=None, out_kernel: Optional[Kernel] = None,
                    back_cstr: bool = False, mlp_hidden: Tuple[int, ...] = (),
                    amortize_var: bool = False, noise_floor: float = 1e-4) -> RGPConfig:
    """``wins=[w_out, w_1, ..., w_H]`` with wins[0] the emission window over
    the top latent (0 -> current latent only) and wins[1:] ordered from the
    layer below the output down to the U-driven layer; stored deepest-first."""
    w_out = wins[0]
    hidden_wins = list(wins[1:])[::-1]
    H = len(hidden_wins)
    q_dims = [1] * H if q_dims is None else list(q_dims)[::-1]
    kernels_d = None if kernels is None else list(kernels)[::-1]
    layer_specs = []
    for h, (w, q) in enumerate(zip(hidden_wins, q_dims)):
        din = w * q + (u_win * u_dim if h == 0 else w * q_dims[h - 1])
        k = kernels_d[h] if kernels_d is not None else RBF(input_dim=din)
        if k.input_dim != din:
            raise ValueError(
                f"kernel for hidden layer {h} (deepest-first) has input_dim "
                f"{k.input_dim}, but the layer's windowed input dim is {din}"
            )
        layer_specs.append(LayerSpec(kernel=k, win=w, q_dim=q, num_inducing=num_inducing))
    out_win = max(1, w_out)
    ok = out_kernel if out_kernel is not None else RBF(input_dim=out_win * q_dims[-1])
    return RGPConfig(
        layers=tuple(layer_specs), out_kernel=ok, out_num_inducing=num_inducing,
        out_win=out_win, u_win=u_win, y_dim=y_dim, u_dim=u_dim, back_cstr=back_cstr,
        mlp_hidden=tuple(mlp_hidden), amortize_var=amortize_var, noise_floor=noise_floor,
    )


# ----------------------------------------------------------------- init


def _smooth(y, width: int = 5):
    if width <= 1:
        return y
    k = np.ones(width) / width
    return np.stack([np.convolve(y[:, d], k, mode="same") for d in range(y.shape[1])], -1)


def init_params(cfg: RGPConfig, Y, U, *, noise: float = 0.01, lam_init: float = 0.01,
                seed: int = 0, dtype=torch.float32, device=None):
    """Data-driven initialization, computed in numpy from
    ``np.random.default_rng(seed)`` exactly as the JAX package does, so the
    result is array-equal to ``rgp_tpu.models.rgp.init_params``. With
    ``back_cstr`` the encoder weights are drawn from
    ``torch.Generator().manual_seed(seed)``: ``jax.random`` cannot be
    reproduced, so those differ from the JAX package's. ``device=None`` means
    the card."""
    dev = resolve_device(device)
    Y, U = host(Y), host(U)
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    y_sm = _smooth(Y)
    y_std = (y_sm - y_sm.mean(0)) / (y_sm.std(0) + 1e-9)

    layers = []
    mu_prev_full = None
    for h, spec in enumerate(cfg.layers):
        L = spec.win
        base = np.tile(y_std[:, :1], (1, spec.q_dim))
        mu_full = np.concatenate([0.1 * rng.standard_normal((L, spec.q_dim)), base], axis=0)
        mu_full = mu_full + 0.01 * rng.standard_normal(mu_full.shape)
        lam_full = np.full(mu_full.shape, lam_init)
        own = np_lagged(mu_full, L)[L:]
        if h == 0:
            low = np_current_window(U, cfg.u_win)
        else:
            low = np_current_window(mu_prev_full[cfg.layers[h - 1].win:], L)
        Z = kmeans_init(np.concatenate([own, low], axis=-1), spec.num_inducing, seed=seed + h)
        layers.append({
            "kern": spec.kernel.init(dtype=dtype, device=dev),
            "Z": t(Z),
            "log_noise": np_positive_inv(noise, dtype, dev),
            "mu0": t(mu_full[:L]),
            "log_lam0": t(np.log(lam_full[:L])),
            "mu": t(mu_full[L:]),
            "log_lam": t(np.log(lam_full[L:])),
        })
        mu_prev_full = mu_full

    top = mu_prev_full[cfg.layers[-1].win:]
    Zout = kmeans_init(np_current_window(top, cfg.out_win), cfg.out_num_inducing, seed=seed + 1000)
    out = {
        "kern": cfg.out_kernel.init(dtype=dtype, device=dev),
        "Z": t(Zout),
        "log_noise": np_positive_inv(noise, dtype, dev),
    }
    params = {"layers": layers, "out": out}
    if cfg.back_cstr:
        gen = torch.Generator().manual_seed(seed)
        params["encoder"] = tuple(
            init_mlp(gen, (spec.win * cfg.y_dim + cfg.u_win * cfg.u_dim, *cfg.mlp_hidden,
                           spec.q_dim * (2 if cfg.amortize_var else 1)), dtype=dtype, device=dev)
            for spec in cfg.layers
        )
    return params


# ----------------------------------------------------------------- ELBO


def _fln(cfg: RGPConfig, log_noise):
    """Effective (floored) unconstrained noise: softplus^{-1}(softplus(raw) +
    noise_floor), applied at every consumption site."""
    if cfg.noise_floor <= 0.0:
        return log_noise
    return torch.log(torch.expm1(positive(log_noise) + cfg.noise_floor))


_LOG_LAM_BIAS = -4.605170185988091  # ln(0.01): amortized variances start ~ the
# reference's 0.01 init when the encoder's raw output is near zero


def _hidden_moments(cfg: RGPConfig, params, Y, U):
    """Full latent (means, variances) per layer, each (T+L_h, Q_h).

    With back-constraints the target-section means are amortized, MLP(window
    of Y, U); with ``amortize_var`` the encoder's output doubles to (mu,
    log-variance) per latent dim. Initial-window moments stay free
    parameters."""
    mus, lams = [], []
    for h, spec in enumerate(cfg.layers):
        lp = params["layers"][h]
        mu_t, lam_t = lp["mu"], torch.exp(lp["log_lam"])
        if cfg.back_cstr:
            feats = []
            if spec.win > 0:
                feats.append(lagged(Y, spec.win))
            if cfg.u_win > 0:
                feats.append(current_window(U, cfg.u_win))
            out = mlp_apply(params["encoder"][h], torch.cat(feats, dim=-1))  # (T, Q or 2Q)
            if cfg.amortize_var:
                mu_t = out[:, :spec.q_dim]
                lam_t = torch.exp(out[:, spec.q_dim:] + _LOG_LAM_BIAS)
            else:
                mu_t = out
        mus.append(torch.cat([lp["mu0"], mu_t], dim=0))
        lams.append(torch.cat([torch.exp(lp["log_lam0"]), lam_t], dim=0))
    return mus, lams


def _layer_inputs(cfg: RGPConfig, h: int, mu_full, lam_full, mu_lower_t, lam_lower_t, U):
    """Windowed uncertain inputs (means, vars) for hidden layer h, (T, Din)."""
    L = cfg.layers[h].win
    own_mu = lagged(mu_full, L)[L:]
    own_s = lagged(lam_full, L)[L:]
    if h == 0:
        low_mu = current_window(U, cfg.u_win)
        low_s = torch.zeros_like(low_mu)
    else:
        low_mu = current_window(mu_lower_t, L)
        low_s = current_window(lam_lower_t, L)
    return torch.cat([own_mu, low_mu], dim=-1), torch.cat([own_s, low_s], dim=-1)


def _layer_stats(cfg: RGPConfig, params, Y, U, block, prefer="auto", remat=True):
    """Yields (kernel, layer params, psi stats, full latent means, full latent
    variances, window L) for every hidden layer, then the output layer's with
    the last three None. ``prefer`` and ``remat`` go to every
    :func:`psi_statistics` call."""
    mus, lams = _hidden_moments(cfg, params, Y, U)
    mu_lower_t = lam_lower_t = None
    for h, spec in enumerate(cfg.layers):
        lp = params["layers"][h]
        L = spec.win
        X_mu, X_s = _layer_inputs(cfg, h, mus[h], lams[h], mu_lower_t, lam_lower_t, U)
        stats = psi_statistics(spec.kernel, lp["kern"], lp["Z"], X_mu, X_s, block=block, prefer=prefer,
                               remat=remat)
        yield spec.kernel, lp, stats, mus[h], lams[h], L
        mu_lower_t, lam_lower_t = mus[h][L:], lams[h][L:]
    op = params["out"]
    Xo_mu = current_window(mu_lower_t, cfg.out_win)
    Xo_s = current_window(lam_lower_t, cfg.out_win)
    stats = psi_statistics(cfg.out_kernel, op["kern"], op["Z"], Xo_mu, Xo_s, block=block, prefer=prefer,
                           remat=remat)
    yield cfg.out_kernel, op, stats, None, None, None


def elbo(cfg: RGPConfig, params, Y, U, *, block: Optional[int] = 128, whitening=None,
         psi_prefer: str = "auto", chol_jitter: Optional[float] = None, psi_remat: bool = True):
    """REVARB evidence lower bound, one scalar. ``whitening``: optional H+1
    precomputed :class:`Whitening` bases (see :func:`compute_whitenings`).
    ``psi_prefer``: ``"scan"`` sends every layer's RBF Psi2 sum to the plain
    chunked path (a Hessian's route); ``chol_jitter`` overrides the whitened
    Cholesky ladders' base rung (sampler potentials pass 1e-3); ``psi_remat``
    False is for a caller under ``torch.func.vmap`` (see
    :mod:`rgp_tpu_torch.ops.psi_stats`)."""
    total = 0.0
    layers = _layer_stats(cfg, params, Y, U, block, psi_prefer, psi_remat)
    for h, (kern, lp, stats, mu_full, lam_full, L) in enumerate(layers):
        W = None if whitening is None else whitening[h]
        if mu_full is None:  # output layer
            total = total + collapsed_bound(
                kern, lp["kern"], lp["Z"], _fln(cfg, lp["log_noise"]), stats, Y,
                W=W, jitter=chol_jitter,
            )
            continue
        tgt_mu, tgt_lam = mu_full[L:], lam_full[L:]
        total = total + collapsed_bound(
            kern, lp["kern"], lp["Z"], _fln(cfg, lp["log_noise"]), stats, tgt_mu, tgt_lam, W=W,
            jitter=chol_jitter,
        )
        # entropy of q over targets + KL(init window || N(0,1))
        total = total + 0.5 * torch.log(2.0 * math.pi * math.e * tgt_lam).sum()
        mu0, lam0 = mu_full[:L], lam_full[:L]
        total = total - 0.5 * (mu0 * mu0 + lam0 - torch.log(lam0) - 1.0).sum()
    return total


def neg_elbo(cfg: RGPConfig, params, Y, U, *, block: Optional[int] = 128):
    """The training loss, ``-elbo``."""
    return -elbo(cfg, params, Y, U, block=block)


def compute_whitenings(cfg: RGPConfig, params, Y, U, *, block: Optional[int] = 128,
                       ladder: bool = True):
    """Fresh per-layer spectral whitening bases (H+1 tuple). ``ladder=False``
    pins the spectral floor at its base value and skips the psi pass."""
    if not ladder:
        kerns = [(s.kernel, params["layers"][h]) for h, s in enumerate(cfg.layers)]
        kerns.append((cfg.out_kernel, params["out"]))
        return tuple(whitening_basis(k.K(lp["kern"], lp["Z"])) for k, lp in kerns)
    return tuple(whitening_basis(*x) for x in _whitening_inputs(cfg, params, Y, U, block))


def _whitening_inputs(cfg: RGPConfig, params, Y, U, block):
    """(Kmm, Psi2, beta) of each layer: what the laddered whitening basis
    of :func:`compute_whitenings` is formed from."""
    return tuple((kern.K(lp["kern"], lp["Z"]), stats.psi2, 1.0 / positive(_fln(cfg, lp["log_noise"])))
                 for kern, lp, stats, *_ in _layer_stats(cfg, params, Y, U, block))


# ----------------------------------------------------------------- serving


def _posteriors(cfg: RGPConfig, params, Y, U, *, block=None):
    """Per-layer sparse posteriors from the variational state, computed once
    and reused across all freerun steps."""
    posts = []
    top = None
    for kern, lp, stats, mu_full, lam_full, L in _layer_stats(cfg, params, Y, U, block):
        if mu_full is not None:
            top = (mu_full[L:], lam_full[L:])
        target = Y if mu_full is None else mu_full[L:]
        posts.append(posterior(kern, lp["kern"], lp["Z"], _fln(cfg, lp["log_noise"]), stats, target))
    return posts, top


def predict_train(cfg: RGPConfig, params, Y, U, *, include_noise: bool = True):
    """One-step-ahead (teacher-forced) prediction over the training span.
    Returns (mean (T, Dy), var (T, Dy))."""
    posts, (mu_top, lam_top) = _posteriors(cfg, params, Y, U)
    op = params["out"]
    return predict_uncertain(
        cfg.out_kernel, op["kern"], op["Z"], _fln(cfg, op["log_noise"]), posts[-1],
        current_window(mu_top, cfg.out_win), current_window(lam_top, cfg.out_win),
        include_noise=include_noise,
    )


def _window(new, buf, W, q_dim):
    """(1, W*q): the just-computed step followed by the W-1 newest buffered."""
    if W <= 1:
        return new.reshape(1, -1)
    return torch.cat([new[None, :], buf[: W - 1].reshape(-1, q_dim)], dim=0).reshape(1, -1)


def _initial_buffers(cfg: RGPConfig, params, Y_train, U_train, like, init_from_train_tail: bool):
    """The freerun's starting state, (means, variances): per hidden layer a
    most-recent-first buffer (B, Q_h), B the longer of its own window and
    the window of the layer above on it; the tails of the trained
    variational moments, or means 0 and variances 1 in ``like``'s dtype and
    device."""
    H = cfg.n_hidden
    mus, lams = _hidden_moments(cfg, params, Y_train, U_train)
    buf_lens = [max(spec.win, cfg.layers[h + 1].win if h + 1 < H else cfg.out_win)
                for h, spec in enumerate(cfg.layers)]
    if init_from_train_tail:
        return (tuple(torch.flip(mus[h][-B:], [0]) for h, B in enumerate(buf_lens)),
                tuple(torch.flip(lams[h][-B:], [0]) for h, B in enumerate(buf_lens)))
    return (tuple(like.new_zeros((B, spec.q_dim)) for B, spec in zip(buf_lens, cfg.layers)),
            tuple(like.new_ones((B, spec.q_dim)) for B, spec in zip(buf_lens, cfg.layers)))


def _input_windows(cfg: RGPConfig, U_train, U_test):
    """(T*, L_u*Du): layer 0's exogenous window at each test step, the first
    ones reaching back into the training inputs."""
    Lu = cfg.u_win
    if Lu == 0:
        return U_test.new_zeros((U_test.shape[0], 0))
    U_cat = torch.cat([U_train[-(Lu - 1):], U_test], dim=0) if Lu > 1 else U_test
    return current_window(U_cat, Lu)[Lu - 1:]


def _step_params(cfg: RGPConfig, params):
    """What a step reads of ``params``: (kernel parameters, Z, floored
    noise) of each hidden layer, then of the output layer."""
    return tuple((lp["kern"], lp["Z"], _fln(cfg, lp["log_noise"])) for lp in (*params["layers"], params["out"]))


def _step(cfg: RGPConfig, state, u, posts, sp, *, moment_match: bool = True, psi_region=None):
    """One closed-loop step: from the buffers ``state`` (as
    :func:`_initial_buffers` gives them) and the step's exogenous window
    ``u``, (new state, y mean (Dy,), y variance (Dy,)). ``posts`` and ``sp``
    (:func:`_step_params`) are only read. ``psi_region`` goes to every
    layer's :func:`predict_uncertain`: :class:`StepGraphs` cuts a step's
    graphs there."""
    bufs_mu, bufs_s = state
    new_mu, new_s = [], []
    for h, spec in enumerate(cfg.layers):
        L = spec.win
        own_mu = bufs_mu[h][:L].reshape(1, -1)
        own_s = bufs_s[h][:L].reshape(1, -1)
        if h == 0:
            low_mu = u.reshape(1, -1)
            low_s = torch.zeros_like(low_mu)
        else:
            q_lo = cfg.layers[h - 1].q_dim
            low_mu = _window(new_mu[h - 1], bufs_mu[h - 1], L, q_lo)
            low_s = _window(new_s[h - 1], bufs_s[h - 1], L, q_lo)
        x_mu = torch.cat([own_mu, low_mu], dim=-1)
        x_s = torch.cat([own_s, low_s], dim=-1)
        kp, Z, noise = sp[h]
        m, v = predict_uncertain(spec.kernel, kp, Z, noise, posts[h], x_mu, x_s if moment_match else None,
                                 include_noise=True, psi_region=psi_region)
        new_mu.append(m[0])
        new_s.append(v[0])

    W = cfg.out_win
    q_top = cfg.layers[-1].q_dim
    top_mu = _window(new_mu[-1], bufs_mu[-1], W, q_top)
    top_s = _window(new_s[-1], bufs_s[-1], W, q_top)
    kp, Z, noise = sp[-1]
    ym, yv = predict_uncertain(cfg.out_kernel, kp, Z, noise, posts[-1], top_mu, top_s if moment_match else None,
                               include_noise=True, psi_region=psi_region)
    H = cfg.n_hidden
    bufs_mu = tuple(torch.cat([new_mu[h][None, :], bufs_mu[h][:-1]], dim=0) for h in range(H))
    bufs_s = tuple(torch.cat([new_s[h][None, :], bufs_s[h][:-1]], dim=0) for h in range(H))
    return (bufs_mu, bufs_s), ym[0], yv[0]


def freerun(cfg: RGPConfig, params, Y_train, U_train, U_test, *, moment_match: bool = True,
            init_from_train_tail: bool = True):
    """Closed-loop free simulation over test inputs ``U_test`` (T*, Du), or
    over each of B input sequences (B, T*, Du) at once. Each hidden layer's
    feedback window starts from the tail of its trained variational means
    (``init_from_train_tail``; else means 0 and variances 1); with
    ``moment_match`` every step goes through the psi-statistics with the
    accumulated state uncertainty, else it plugs in the means alone. Returns
    (y_means (T*, Dy), y_vars (T*, Dy)), or (B, T*, Dy) each. Profiled as
    the regions ``rgp.posteriors`` and ``rgp.freerun.step`` (one a test
    step).

    The posteriors and the starting buffers are computed once, for every
    sequence of a batch; a batch's steps are ``torch.func.vmap`` of
    :func:`_step` over its sequences. On a CUDA device, with grad off, no
    input that requires grad and kernels whose Psi terms copy nothing from
    the host (:func:`_capturable`), they replay the CUDA graphs that
    :data:`step_graphs` captured on the first call of their shapes;
    elsewhere they run eagerly."""
    with annotate("rgp.posteriors"):
        posts, _ = _posteriors(cfg, params, Y_train, U_train)
    state = _initial_buffers(cfg, params, Y_train, U_train, U_test, init_from_train_tail)
    sp = _step_params(cfg, params)
    if U_test.dim() == 3:
        return _batched_steps(cfg, posts, state, U_train, U_test, sp, moment_match)
    Uw = _input_windows(cfg, U_train, U_test)
    y_means, y_vars = [], []
    for i in range(Uw.shape[0]):
        with annotate("rgp.freerun.step"):
            state, ym, yv = _step(cfg, state, Uw[i], posts, sp, moment_match=moment_match)
        y_means.append(ym)
        y_vars.append(yv)
    return torch.stack(y_means), torch.stack(y_vars)


def _batched_steps(cfg: RGPConfig, posts, bufs, U_train, U_tests, sp, moment_match):
    """:func:`freerun`'s steps over the (B, T*, Du) sequences ``U_tests``,
    all from the buffers ``bufs``: (means (B, T*, Dy), variances (B, T*,
    Dy))."""
    B = U_tests.shape[0]
    # materialized, as a graph's static copy of them must be: the same layout picks the same kernels
    state = tuple(tuple(b.expand(B, *b.shape).contiguous() for b in part) for part in bufs)
    Uw = torch.func.vmap(lambda u: _input_windows(cfg, U_train, u))(U_tests)
    step = functools.partial(_step, cfg, moment_match=moment_match)
    if _capturable(cfg, (Uw, state, posts, sp)):
        return step_graphs.run(step, (cfg, moment_match), (Uw, state, posts, sp))
    vstep = torch.func.vmap(step, in_dims=(0, 0, None, None))
    means, variances = [], []
    for i in range(Uw.shape[1]):
        with annotate("rgp.freerun.step"):
            state, ym, yv = vstep(state, Uw[:, i], posts, sp)
        means.append(ym)
        variances.append(yv)
    return torch.stack(means, dim=1), torch.stack(variances, dim=1)


# ------------------------------------------------------- graphed steps


def _host_free(kern: Kernel) -> bool:
    """True where a step's Psi terms of ``kern`` copy nothing from the host:
    no active dims to index by, and no parts whose cross terms scatter by
    active dim (Sum, Prod)."""
    return kern.active_dims is None and not isinstance(kern, (Sum, Prod))


def _capturable(cfg: RGPConfig, inputs) -> bool:
    """Whether a batched :func:`freerun`'s steps on ``inputs`` can replay
    captured graphs: CUDA tensors, grad off and not required by any input,
    and every kernel :func:`_host_free`."""
    leaves = tree_leaves(inputs)
    return (leaves[0].is_cuda and not torch.is_grad_enabled() and not any(x.requires_grad for x in leaves)
            and all(_host_free(k) for k in (*(s.kernel for s in cfg.layers), cfg.out_kernel)))


class _Chain:
    """One step's graphs, captured in turn into one memory pool on the
    current stream: entering begins the first graph, :meth:`cut` ends the
    graph being captured and begins the next, leaving ends the last."""

    def __init__(self, pool):
        self.pool, self.graphs = pool, []

    def _next(self):
        if self.graphs:
            self.graphs[-1].capture_end()
        self.graphs.append(torch.cuda.CUDAGraph())
        self.graphs[-1].capture_begin(pool=self.pool)

    def __enter__(self):
        self._next()
        return self

    def __exit__(self, *exc):
        self.graphs[-1].capture_end()

    @contextlib.contextmanager
    def cut(self):
        self._next()
        yield
        self._next()


class _Captured(NamedTuple):
    static: list  # the inputs' leaves, refreshed by copy_ each call
    chains: list  # per step: its graphs, a layer's Psi terms at the odd places
    means: list  # per step: its (B, Dy) y means in the pool, and its variances
    variances: list


class StepGraphs:
    """CUDA graphs of a batched :func:`freerun`'s closed-loop steps, one entry
    a key: the configuration and ``moment_match``, the structure, shapes,
    strides and dtypes of the step's inputs (so the width and the horizon)
    and the device. An entry holds static copies of the inputs in their
    layouts, since a layout picks the kernels (the candidates' input
    windows, the starting buffers, the posteriors and the step parameters:
    each call copies its values in, so new parameters of the same shapes
    are never read from a stale capture) and, for each step of the horizon,
    a chain of graphs cut around each layer's Psi terms, all in one memory
    pool and replayed in the order captured. A call replays each step's
    chain inside the regions its operations ran in eagerly, each graph in a
    region ``rgp.freerun.replay``. ``captures`` counts the entries made,
    ``replays`` the steps replayed."""

    def __init__(self):
        self._entries = {}
        self.captures = 0
        self.replays = 0

    def run(self, step, key, inputs):
        leaves, spec = tree_flatten(inputs)
        key = (key, spec, tuple((x.shape, x.stride(), x.dtype) for x in leaves), leaves[0].device)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = self._capture(step, leaves, spec)
            self.captures += 1
        else:
            for s, x in zip(entry.static, leaves):
                s.copy_(x)
        for chain in entry.chains:
            with annotate("rgp.freerun.step"):
                for k, g in enumerate(chain):
                    with annotate("psi.per_t") if k % 2 else contextlib.nullcontext(), \
                            annotate("rgp.freerun.replay"):
                        g.replay()
            self.replays += 1
        return torch.stack(entry.means, dim=1), torch.stack(entry.variances, dim=1)

    @staticmethod
    def _capture(step, leaves, spec) -> _Captured:
        """Copies the inputs into static tensors, runs one step eagerly on a
        side stream (cuBLAS's workspace and every kernel's first load happen
        outside a capture), then captures every step of the horizon."""
        dev = leaves[0].device
        static = [torch.empty_like(x) for x in leaves]
        for s, x in zip(static, leaves):
            s.copy_(x)
        Uw, state, posts, sp = tree_unflatten(static, spec)
        stream, pool = torch.cuda.Stream(dev), torch.cuda.graph_pool_handle()
        stream.wait_stream(torch.cuda.current_stream(dev))
        chains, means, variances = [], [], []
        with torch.cuda.stream(stream):
            torch.func.vmap(step, in_dims=(0, 0, None, None))(state, Uw[:, 0], posts, sp)
            for i in range(Uw.shape[1]):
                with _Chain(pool) as chain:
                    vstep = torch.func.vmap(functools.partial(step, psi_region=chain.cut), in_dims=(0, 0, None, None))
                    state, ym, yv = vstep(state, Uw[:, i], posts, sp)
                chains.append(chain.graphs)
                means.append(ym)
                variances.append(yv)
        torch.cuda.current_stream(dev).wait_stream(stream)
        return _Captured(static, chains, means, variances)


step_graphs = StepGraphs()
