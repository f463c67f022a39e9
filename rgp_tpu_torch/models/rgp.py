"""Deep Recurrent Gaussian Process with REVARB variational inference (port of
``rgp_tpu/models/rgp.py``: the bound, the posteriors and free simulation).

The model is a frozen config (:class:`RGPConfig`) plus a nested parameter dict

  {"layers": [{"kern": {"log_var", "log_ls"}, "Z", "log_noise",
               "mu0", "log_lam0", "mu", "log_lam"}, ...],
   "out": {"kern": {...}, "Z", "log_noise"}}

of unconstrained tensors, with the same key names as the JAX package's pytree
(:func:`rgp_tpu_torch.convert.params_from_jax` carries one over). Layers are
indexed deepest-first (layer 0 is driven by U):

  layer 0:  xbar^0_t = [x^0_{t-1..t-L0}, u_t..u_{t-Lu+1}]
  layer h:  xbar^h_t = [x^h_{t-1..t-Lh}, x^{h-1}_t..x^{h-1}_{t-Lh+1}]
  output :  y_t      = f_out(x^{H-1}_t .. x^{H-1}_{t-Lout+1}) + eps_y

:func:`elbo` (and :func:`neg_elbo`, the training loss) is differentiable on
every device: on float32 CUDA tensors its Psi2 sums run through the kernels K1
and K2. :func:`freerun` is the serving path: posteriors once, then a
closed-loop moment-matched rollout, one Python step per test input.

Back-constraints (the MLP encoder, ``back_cstr``/``amortize_var``) are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.windows import current_window, lagged, np_current_window, np_lagged
from ..device import resolve_device
from ..inference.collapsed_vi import collapsed_bound, posterior, predict_uncertain, whitening_basis
from ..kernels import RBF, Kernel
from ..ops.psi_stats import psi_statistics
from ..params import np_positive_inv, positive
from .sparse_gp import kmeans_init

__all__ = ["LayerSpec", "RGPConfig", "init_params", "elbo", "neg_elbo", "freerun", "predict_train",
           "deep_rgp_config", "compute_whitenings"]


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


def _require_no_encoder(cfg: RGPConfig):
    if cfg.back_cstr or cfg.amortize_var:
        raise NotImplementedError(
            "back-constraints (back_cstr/amortize_var) are not ported to rgp_tpu_torch yet"
        )


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
    cfg = RGPConfig(
        layers=tuple(layer_specs), out_kernel=ok, out_num_inducing=num_inducing,
        out_win=out_win, u_win=u_win, y_dim=y_dim, u_dim=u_dim, back_cstr=back_cstr,
        mlp_hidden=tuple(mlp_hidden), amortize_var=amortize_var, noise_floor=noise_floor,
    )
    _require_no_encoder(cfg)
    return cfg


# ----------------------------------------------------------------- init


def _smooth(y, width: int = 5):
    if width <= 1:
        return y
    k = np.ones(width) / width
    return np.stack([np.convolve(y[:, d], k, mode="same") for d in range(y.shape[1])], -1)


def _host(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def init_params(cfg: RGPConfig, Y, U, *, noise: float = 0.01, lam_init: float = 0.01,
                seed: int = 0, dtype=torch.float32, device=None):
    """Data-driven initialization, computed in numpy from
    ``np.random.default_rng(seed)`` exactly as the JAX package does, so the
    result is array-equal to ``rgp_tpu.models.rgp.init_params``. ``device=None``
    means the card."""
    _require_no_encoder(cfg)
    dev = resolve_device(device)
    Y, U = _host(Y), _host(U)
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
    return {"layers": layers, "out": out}


# ----------------------------------------------------------------- ELBO


def _fln(cfg: RGPConfig, log_noise):
    """Effective (floored) unconstrained noise: softplus^{-1}(softplus(raw) +
    noise_floor), applied at every consumption site."""
    if cfg.noise_floor <= 0.0:
        return log_noise
    return torch.log(torch.expm1(positive(log_noise) + cfg.noise_floor))


def _hidden_moments(cfg: RGPConfig, params):
    """Full latent (means, variances) per layer, each (T+L_h, Q_h)."""
    mus, lams = [], []
    for lp in params["layers"]:
        mus.append(torch.cat([lp["mu0"], lp["mu"]], dim=0))
        lams.append(torch.cat([torch.exp(lp["log_lam0"]), torch.exp(lp["log_lam"])], dim=0))
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


def _layer_stats(cfg: RGPConfig, params, U, block):
    """Yields (kernel, layer params, psi stats, full latent means, full latent
    variances, window L) for every hidden layer, then the output layer's with
    the last three None."""
    mus, lams = _hidden_moments(cfg, params)
    mu_lower_t = lam_lower_t = None
    for h, spec in enumerate(cfg.layers):
        lp = params["layers"][h]
        L = spec.win
        X_mu, X_s = _layer_inputs(cfg, h, mus[h], lams[h], mu_lower_t, lam_lower_t, U)
        stats = psi_statistics(spec.kernel, lp["kern"], lp["Z"], X_mu, X_s, block=block)
        yield spec.kernel, lp, stats, mus[h], lams[h], L
        mu_lower_t, lam_lower_t = mus[h][L:], lams[h][L:]
    op = params["out"]
    Xo_mu = current_window(mu_lower_t, cfg.out_win)
    Xo_s = current_window(lam_lower_t, cfg.out_win)
    stats = psi_statistics(cfg.out_kernel, op["kern"], op["Z"], Xo_mu, Xo_s, block=block)
    yield cfg.out_kernel, op, stats, None, None, None


def elbo(cfg: RGPConfig, params, Y, U, *, block: Optional[int] = 128, whitening=None):
    """REVARB evidence lower bound, one scalar. ``whitening``: optional H+1
    precomputed :class:`Whitening` bases (see :func:`compute_whitenings`)."""
    total = 0.0
    for h, (kern, lp, stats, mu_full, lam_full, L) in enumerate(_layer_stats(cfg, params, U, block)):
        W = None if whitening is None else whitening[h]
        if mu_full is None:  # output layer
            total = total + collapsed_bound(
                kern, lp["kern"], lp["Z"], _fln(cfg, lp["log_noise"]), stats, Y,
                W=W,
            )
            continue
        tgt_mu, tgt_lam = mu_full[L:], lam_full[L:]
        total = total + collapsed_bound(
            kern, lp["kern"], lp["Z"], _fln(cfg, lp["log_noise"]), stats, tgt_mu, tgt_lam, W=W,
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
    del Y  # the bases depend on the inputs only, as in the JAX package
    if not ladder:
        kerns = [(s.kernel, params["layers"][h]) for h, s in enumerate(cfg.layers)]
        kerns.append((cfg.out_kernel, params["out"]))
        return tuple(whitening_basis(k.K(lp["kern"], lp["Z"])) for k, lp in kerns)
    out = []
    for kern, lp, stats, *_ in _layer_stats(cfg, params, U, block):
        Kmm = kern.K(lp["kern"], lp["Z"])
        out.append(whitening_basis(Kmm, stats.psi2, 1.0 / positive(_fln(cfg, lp["log_noise"]))))
    return tuple(out)


# ----------------------------------------------------------------- serving


def _posteriors(cfg: RGPConfig, params, Y, U, *, block=None):
    """Per-layer sparse posteriors from the variational state, computed once
    and reused across all freerun steps."""
    posts = []
    for kern, lp, stats, mu_full, _, L in _layer_stats(cfg, params, U, block):
        target = Y if mu_full is None else mu_full[L:]
        posts.append(posterior(kern, lp["kern"], lp["Z"], _fln(cfg, lp["log_noise"]), stats, target))
    mus, lams = _hidden_moments(cfg, params)
    L = cfg.layers[-1].win
    return posts, (mus[-1][L:], lams[-1][L:])


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


def freerun(cfg: RGPConfig, params, Y_train, U_train, U_test):
    """Closed-loop free simulation over test inputs. Each hidden layer's
    feedback window starts from the tail of its trained variational means;
    every step is moment-matched through the psi-statistics with the
    accumulated state uncertainty. Returns (y_means (T*, Dy), y_vars (T*, Dy))."""
    posts, _ = _posteriors(cfg, params, Y_train, U_train)
    H = cfg.n_hidden
    mus, lams = _hidden_moments(cfg, params)

    buf_lens = []
    for h, spec in enumerate(cfg.layers):
        need_above = cfg.layers[h + 1].win if h + 1 < H else cfg.out_win
        buf_lens.append(max(spec.win, need_above))

    # most-recent-first buffers, started from the trained latent tails
    bufs_mu = [torch.flip(mus[h][-B:], [0]) for h, B in enumerate(buf_lens)]
    bufs_s = [torch.flip(lams[h][-B:], [0]) for h, B in enumerate(buf_lens)]

    Lu = cfg.u_win
    if Lu > 0:
        U_cat = torch.cat([U_train[-(Lu - 1):], U_test], dim=0) if Lu > 1 else U_test
        Uw = current_window(U_cat, Lu)[Lu - 1:]
    else:
        Uw = U_test.new_zeros((U_test.shape[0], 0))

    fl_noise = [_fln(cfg, lp["log_noise"]) for lp in params["layers"]]
    op = params["out"]
    fl_out = _fln(cfg, op["log_noise"])
    y_means, y_vars = [], []
    for i in range(Uw.shape[0]):
        new_mu, new_s = [], []
        for h, spec in enumerate(cfg.layers):
            lp = params["layers"][h]
            L = spec.win
            own_mu = bufs_mu[h][:L].reshape(1, -1)
            own_s = bufs_s[h][:L].reshape(1, -1)
            if h == 0:
                low_mu = Uw[i].reshape(1, -1)
                low_s = torch.zeros_like(low_mu)
            else:
                q_lo = cfg.layers[h - 1].q_dim
                low_mu = _window(new_mu[h - 1], bufs_mu[h - 1], L, q_lo)
                low_s = _window(new_s[h - 1], bufs_s[h - 1], L, q_lo)
            x_mu = torch.cat([own_mu, low_mu], dim=-1)
            x_s = torch.cat([own_s, low_s], dim=-1)
            m, v = predict_uncertain(
                spec.kernel, lp["kern"], lp["Z"], fl_noise[h], posts[h],
                x_mu, x_s, include_noise=True,
            )
            new_mu.append(m[0])
            new_s.append(v[0])

        W = cfg.out_win
        q_top = cfg.layers[-1].q_dim
        top_mu = _window(new_mu[-1], bufs_mu[-1], W, q_top)
        top_s = _window(new_s[-1], bufs_s[-1], W, q_top)
        ym, yv = predict_uncertain(
            cfg.out_kernel, op["kern"], op["Z"], fl_out, posts[-1],
            top_mu, top_s, include_noise=True,
        )
        bufs_mu = [torch.cat([new_mu[h][None, :], bufs_mu[h][:-1]], dim=0) for h in range(H)]
        bufs_s = [torch.cat([new_s[h][None, :], bufs_s[h][:-1]], dim=0) for h in range(H)]
        y_means.append(ym[0])
        y_vars.append(yv[0])
    return torch.stack(y_means), torch.stack(y_vars)

