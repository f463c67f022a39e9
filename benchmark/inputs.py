"""What the benchmark hands to the program and to the reference alike: the
system-identification record a configuration names, the parameters made
from ``--seed`` and the rollout requests' candidate input sequences.

The records are synthesized from published difference equations with their
own fixed seeds (a copy of the recipes the program's package ships, so the
benchmark reads no data through the program): ``actuator`` (T=1024, split
512/512, a random-telegraph valve input) and ``drives`` (T=500, split
250/250, an 8-sine multisine input). Parameters follow the data-driven
recipe a user's ``init_params`` follows (latent means from the smoothed
output, variances 0.01, noise 0.01, the kernel file's initial kernel
parameters (unit variance and lengthscales for ``rbf_ard``), inducing points by k-means of each layer's windowed inputs, Glorot-normal
encoder weights, the encoder's output layer fitted to the lagged output),
drawn on the device from one ``torch.Generator`` seeded by ``--seed`` in a
few batched calls.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .reference import current_window, lagged, layer_kernels, layout, softplus_inv


# ------------------------------------------------------------------ records


def _telegraph(rng, T, p_switch=0.03, levels=(-1.0, 1.0)):
    u = np.empty(T)
    level = rng.choice(levels)
    for t in range(T):
        if rng.uniform() < p_switch:
            level = rng.choice(levels)
        u[t] = level + 0.1 * rng.standard_normal()
    return u


def _multisine(rng, T, n_sin, fmax):
    t = np.arange(T)
    freqs = rng.uniform(0.002, fmax, n_sin)
    phases = rng.uniform(0, 2 * np.pi, n_sin)
    amps = rng.uniform(0.3, 1.0, n_sin)
    return (amps[:, None] * np.sin(2 * np.pi * freqs[:, None] * t + phases[:, None])).sum(0)


def actuator(T=1024, seed=11, noise=0.02):
    rng = np.random.default_rng(seed)
    u = _telegraph(rng, T)
    y = np.zeros(T)
    for k in range(2, T):
        y[k] = (1.45 * y[k - 1] - 0.6 * y[k - 2] + 0.8 * np.tanh(1.5 * u[k - 1]) - 0.4 * np.tanh(1.5 * u[k - 2])
                - 0.05 * y[k - 1] ** 2 * np.sign(y[k - 1]) * 0.1 + noise * rng.standard_normal())
    return u, y


def drives(T=500, seed=7, noise=0.02):
    rng = np.random.default_rng(seed)
    u = _multisine(rng, T, 8, 0.08)
    u = u / (np.abs(u).max() + 1e-12)
    y = np.zeros(T)
    for k in range(2, T):
        e1 = np.exp(-(y[k - 1] ** 2))
        y[k] = ((0.8 - 0.5 * e1) * y[k - 1] - (0.3 + 0.9 * e1) * y[k - 2] + u[k - 1] + 0.2 * u[k - 2]
                + 0.1 * u[k - 1] * u[k - 2] + noise * rng.standard_normal())
    return u, y


RECORDS = {"actuator": actuator, "drives": drives}


class Record(NamedTuple):
    Y: torch.Tensor  # (T, 1) standardized training outputs
    U: torch.Tensor  # (T, 1) standardized training inputs
    u_mean: float
    u_std: float
    T_full: int


def record(cfg, dtype, device, T=None):
    """The configuration's record, standardized on its training half.
    ``T`` cuts the training half (the tests' small sizes)."""
    u, y = RECORDS[cfg["record"]]()
    h = u.shape[0] // 2
    ut, yt = u[:h], y[:h]
    um, us = float(ut.mean()), float(ut.std() + 1e-12)
    ym, ys = float(yt.mean()), float(yt.std() + 1e-12)
    Y = torch.as_tensor((yt - ym) / ys, dtype=dtype, device=device)[:, None]
    U = torch.as_tensor((ut - um) / us, dtype=dtype, device=device)[:, None]
    if T is not None:
        Y, U = Y[:T], U[:T]
    return Record(Y, U, um, us, u.shape[0])


# --------------------------------------------------------------- parameters


def _smooth(Y, width=5):
    """Moving average over ``width`` steps, zero-padded at both ends."""
    k = torch.ones(1, 1, width, dtype=Y.dtype, device=Y.device) / width
    return torch.nn.functional.conv1d(Y.T[:, None, :], k, padding=width // 2)[:, 0, :].T


def kmeans(X, k, gen, iters=10):
    """Lloyd's k-means of each batch element of X (R, N, D) into k centres,
    started at a random subset of rows; an empty cluster is re-seeded at a
    random row plus 1e-3 of a normal."""
    R, N, D = X.shape
    idx = torch.argsort(torch.rand(R, N, generator=gen, device=X.device), dim=1)[:, :k]
    C = torch.gather(X, 1, idx[..., None].expand(R, k, D))
    x2 = (X * X).sum(-1)[..., None]
    for _ in range(iters):
        d2 = x2 - 2.0 * X @ C.mT + (C * C).sum(-1)[:, None, :]
        onehot = torch.nn.functional.one_hot(d2.argmin(-1), k).to(X.dtype)  # (R, N, k)
        counts = onehot.sum(1)[..., None]
        mean = onehot.mT @ X / counts.clamp(min=1.0)
        pick = torch.randint(0, N, (R, k), generator=gen, device=X.device)
        reseed = torch.gather(X, 1, pick[..., None].expand(R, k, D))
        reseed = reseed + 1e-3 * torch.randn(R, k, D, generator=gen, device=X.device, dtype=X.dtype)
        C = torch.where(counts > 0, mean, reseed)
    return C


def generator(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def init_params(cfg, rec: Record, n: int, gen, dtype):
    """``n`` parameter sets stacked on a leading axis, in the program's tree
    layout: {"layers": [{"kern", "Z", "log_noise", "mu0", "log_lam0", "mu",
    "log_lam"}], "out": {...}, "encoder": ...}, each "kern" as the layer's
    kernel file lays it out."""
    lay = layout(cfg)
    kfs = layer_kernels(cfg)
    dev, M = rec.Y.device, cfg["num_inducing"]
    T = rec.Y.shape[0]

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=dev)

    ys = _smooth(rec.Y)
    ys = (ys - ys.mean(0)) / (ys.std(0, unbiased=False) + 1e-9)
    layers, prev = [], None
    for h, L in enumerate(lay.wins):
        base = ys[:, :1].expand(T, lay.q)
        mu_full = torch.cat([0.1 * normal(n, L, lay.q), base[None].expand(n, T, lay.q)], 1)
        mu_full = mu_full + 0.01 * normal(n, T + L, lay.q)
        own = torch.stack([lagged(m, L)[L:] for m in mu_full])
        if h == 0:
            low = current_window(rec.U, lay.u_win)[None].expand(n, T, -1)
        else:
            low = torch.stack([current_window(m[lay.wins[h - 1]:], L) for m in prev])
        X = torch.cat([own, low], -1)
        din = X.shape[-1]
        layers.append({
            "kern": kfs[h].init(n, din, dtype, dev),
            "Z": kmeans(X, M, gen),
            "log_noise": full((n,), softplus_inv(cfg["init_noise"])),
            "mu0": mu_full[:, :L].contiguous(),
            "log_lam0": full((n, L, lay.q), math.log(cfg["init_lam"])),
            "mu": mu_full[:, L:].contiguous(),
            "log_lam": full((n, T, lay.q), math.log(cfg["init_lam"])),
        })
        prev = mu_full
    top = prev[:, lay.wins[-1]:]
    Xo = torch.stack([current_window(m, lay.out_win) for m in top])
    out = {"kern": kfs[-1].init(n, Xo.shape[-1], dtype, dev),
           "Z": kmeans(Xo, M, gen), "log_noise": full((n,), softplus_inv(cfg["init_noise"]))}
    params = {"layers": layers, "out": out}
    if cfg.get("back_cstr"):
        # Glorot-normal hidden weights; the output weights by ridge regression
        # of the previous output y_{t-1} on the hidden units, so that each
        # layer's amortized means start as a lagged copy of the record and
        # the model responds to its inputs as a fitted one does
        enc, target = [], lagged(rec.Y, 1)
        for L in lay.wins:
            dims = (L + lay.u_win, *cfg["mlp_hidden"], lay.q)
            feats = torch.cat([lagged(rec.Y, L), current_window(rec.U, lay.u_win)], -1)
            layers_h, h = [], feats[None].expand(n, T, -1)
            for a, b in zip(dims[:-2], dims[1:-1]):
                w = normal(n, a, b) * math.sqrt(2.0 / (a + b))
                layers_h.append({"w": w, "b": full((n, b), 0.0)})
                h = torch.tanh(h @ w)
            gram = h.mT @ h + 1e-3 * T * torch.eye(h.shape[-1], dtype=dtype, device=dev)
            w_out = torch.linalg.solve(gram, h.mT @ target[None].expand(n, T, 1))
            layers_h.append({"w": w_out, "b": full((n, lay.q), 0.0)})
            enc.append(tuple(layers_h))
        params["encoder"] = tuple(enc)
    return params


def served_params(cfg, rec: Record, gen, dtype):
    """The parameters a rollout serves: the fitted ones in the npz the
    configuration names (``served_params``, a path under the checkout,
    written by ``fit_served_model.py``), else one set from ``gen``."""
    params = member(init_params(cfg, rec, 1, gen, dtype), 0)
    if not cfg.get("served_params"):
        return params
    from .reference import tree_leaves, tree_with

    path = Path(__file__).resolve().parents[1] / cfg["served_params"]
    with np.load(path) as z:
        leaves = [torch.as_tensor(z[name], dtype=dtype, device=rec.Y.device) for name, _ in tree_leaves(params)]
    return tree_with(params, leaves)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def member(stacked, r):
    """Set ``r`` of a stacked tree."""
    return tree_map(lambda x: x[r], stacked)


# ------------------------------------------------------------------ requests


def candidates(cfg, rec: Record, n, horizon, gen):
    """(n, horizon, 1) standardized input sequences that continue the
    record's training half, drawn from the record's own input process."""
    proc = cfg["input_process"]
    dev, dt = rec.U.device, rec.U.dtype
    if proc["kind"] == "multisine":
        k = proc["n_sin"]
        f = proc["fmin"] + (proc["fmax"] - proc["fmin"]) * torch.rand(n, k, 1, generator=gen, device=dev, dtype=dt)
        ph = 2 * math.pi * torch.rand(n, k, 1, generator=gen, device=dev, dtype=dt)
        a = 0.3 + 0.7 * torch.rand(n, k, 1, generator=gen, device=dev, dtype=dt)
        t = torch.arange(rec.T_full, dtype=dt, device=dev)
        u = (a * torch.sin(2 * math.pi * f * t + ph)).sum(1)  # (n, T_full)
        u = u / u.abs().amax(1, keepdim=True)
        start = rec.T_full // 2
        u = u[:, start:start + horizon]
    elif proc["kind"] == "telegraph":
        p = proc["p_switch"]
        lv = torch.where(torch.rand(n, horizon + 1, generator=gen, device=dev) < 0.5, -1.0, 1.0).to(dt)
        sw = torch.rand(n, horizon, generator=gen, device=dev) < p
        seg = torch.cumsum(sw.long(), 1)  # which level each step holds
        u = torch.gather(lv, 1, seg) + 0.1 * torch.randn(n, horizon, generator=gen, device=dev, dtype=dt)
    else:
        raise ValueError(f"unknown input process {proc['kind']!r}")
    return ((u - rec.u_mean) / rec.u_std)[..., None]
