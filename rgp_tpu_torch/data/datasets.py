"""System-identification benchmark datasets (offline-synthesized).

A numpy-only copy of ``rgp_tpu/data/datasets.py`` (the port imports nothing of
the JAX package), plus :func:`standardized_tensors`, which turns a split into
standardized tensors on a device. Each dataset is synthesized from published
difference equations with a fixed seed, so both packages see identical data.

Systems:

* ``actuator``  — hydraulic-actuator-like SISO NARX system: second-order linear
  resonance with a saturating (tanh) valve nonlinearity driven by a random
  telegraph input; shapes match DaISy actuator (T=1024, split 512/512).
* ``drives``    — the classic nonlinear benchmark of Chen/Billings-style
  exponential-autoregressive form used throughout the system-id literature,
  with input cross-terms; T=500, split 250/250 (matching the Drives demo scale).
* ``narendra``  — Narendra & Parthasarathy (1990) example:
  x_{k+1} = x_k / (1 + x_k^2) + u_k^3, y = x.
* ``ballbeam`` — ball-and-beam position control analogue (DaISy 96-004):
  marginally stable double integrator with friction + soft limits.
* ``dryer``    — hair-dryer thermal system analogue (DaISy 96-006): first-order
  heat dynamics with transport delay, telegraph heater input.
* ``gas_furnace`` — Box-Jenkins gas furnace analogue (T=296, the original length).
* ``long_corpus`` — long multisine-driven sequence for throughput/minibatch
  benchmarks (config 4, BASELINE.json:10).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .windows import Standardizer

__all__ = ["SysIdData", "SysIdTensors", "standardized_tensors", "actuator", "drives", "narendra", "ballbeam", "dryer", "gas_furnace", "tanks", "long_corpus", "load"]


class SysIdData(NamedTuple):
    u_train: np.ndarray  # (T_train, Du)
    y_train: np.ndarray  # (T_train, Dy)
    u_test: np.ndarray
    y_test: np.ndarray
    name: str


def _telegraph(rng, T, p_switch=0.03, levels=(-1.0, 1.0)):
    """Random telegraph signal (piecewise-constant input, DaISy-style)."""
    u = np.empty(T)
    level = rng.choice(levels)
    for t in range(T):
        if rng.uniform() < p_switch:
            level = rng.choice(levels)
        u[t] = level + 0.1 * rng.standard_normal()
    return u


def _multisine(rng, T, n_sin=12, fmax=0.15):
    t = np.arange(T)
    freqs = rng.uniform(0.002, fmax, n_sin)
    phases = rng.uniform(0, 2 * np.pi, n_sin)
    amps = rng.uniform(0.3, 1.0, n_sin)
    return (amps[:, None] * np.sin(2 * np.pi * freqs[:, None] * t + phases[:, None])).sum(0)


def actuator(T: int = 1024, seed: int = 11, noise: float = 0.02) -> SysIdData:
    rng = np.random.default_rng(seed)
    u = _telegraph(rng, T)
    y = np.zeros(T)
    for k in range(2, T):
        y[k] = (
            1.45 * y[k - 1]
            - 0.6 * y[k - 2]
            + 0.8 * np.tanh(1.5 * u[k - 1])
            - 0.4 * np.tanh(1.5 * u[k - 2])
            - 0.05 * y[k - 1] ** 2 * np.sign(y[k - 1]) * 0.1
            + noise * rng.standard_normal()
        )
    h = T // 2
    return SysIdData(u[:h, None], y[:h, None], u[h:, None], y[h:, None], "actuator")


def drives(T: int = 500, seed: int = 7, noise: float = 0.02) -> SysIdData:
    rng = np.random.default_rng(seed)
    u = _multisine(rng, T, n_sin=8, fmax=0.08)
    u = u / (np.abs(u).max() + 1e-12)
    y = np.zeros(T)
    for k in range(2, T):
        e1 = np.exp(-(y[k - 1] ** 2))
        y[k] = (
            (0.8 - 0.5 * e1) * y[k - 1]
            - (0.3 + 0.9 * e1) * y[k - 2]
            + u[k - 1]
            + 0.2 * u[k - 2]
            + 0.1 * u[k - 1] * u[k - 2]
            + noise * rng.standard_normal()
        )
    h = T // 2
    return SysIdData(u[:h, None], y[:h, None], u[h:, None], y[h:, None], "drives")


def narendra(T: int = 600, seed: int = 3, noise: float = 0.0) -> SysIdData:
    rng = np.random.default_rng(seed)
    u = np.sin(2 * np.pi * np.arange(T) / 25.0) + 0.3 * rng.standard_normal(T) * 0
    x = np.zeros(T)
    for k in range(1, T):
        x[k] = x[k - 1] / (1 + x[k - 1] ** 2) + u[k - 1] ** 3
    y = x + noise * rng.standard_normal(T)
    h = T // 2
    return SysIdData(u[:h, None], y[:h, None], u[h:, None], y[h:, None], "narendra")


def ballbeam(T: int = 1000, seed: int = 5, noise: float = 0.01) -> SysIdData:
    """Ball-and-beam-like SISO system (DaISy 96-004 analogue): the ball
    position integrates the beam-angle-driven acceleration — a marginally
    stable double-integrator with rolling friction and a soft position limit,
    driven by a low-frequency multisine beam angle."""
    rng = np.random.default_rng(seed)
    u = _multisine(rng, T, n_sin=6, fmax=0.03)
    u = u / (np.abs(u).max() + 1e-12) * 0.4
    y = np.zeros(T)  # position
    v = 0.0  # velocity
    for k in range(1, T):
        acc = 5.0 * np.sin(u[k - 1]) - 0.3 * v - 0.8 * np.tanh(2.0 * y[k - 1])
        v = 0.97 * v + 0.05 * acc
        y[k] = y[k - 1] + 0.05 * v + noise * rng.standard_normal()
    h = T // 2
    return SysIdData(u[:h, None], y[:h, None], u[h:, None], y[h:, None], "ballbeam")


def dryer(T: int = 1000, seed: int = 13, noise: float = 0.02) -> SysIdData:
    """Hair-dryer-like SISO thermal system (DaISy 96-006 analogue): first-order
    heat dynamics with transport delay and a mild flow-dependent gain,
    heater-voltage input as a random telegraph signal."""
    rng = np.random.default_rng(seed)
    u = 0.5 * (_telegraph(rng, T, p_switch=0.05) + 1.2)
    y = np.zeros(T)
    for k in range(3, T):
        gain = 0.9 + 0.2 * np.tanh(u[k - 3])
        y[k] = (
            0.85 * y[k - 1]
            + 0.06 * y[k - 2]
            + gain * 0.45 * u[k - 2]
            - 0.1 * u[k - 3]
            + noise * rng.standard_normal()
        )
    h = T // 2
    return SysIdData(u[:h, None], y[:h, None], u[h:, None], y[h:, None], "dryer")


def gas_furnace(T: int = 296, seed: int = 17, noise: float = 0.05) -> SysIdData:
    """Box-Jenkins gas-furnace analogue (CO2 concentration from methane feed):
    second-order dynamics with delayed input and saturating response, at the
    original series' length (296 samples)."""
    rng = np.random.default_rng(seed)
    u = _multisine(rng, T, n_sin=5, fmax=0.06)
    u = u / (np.abs(u).max() + 1e-12)
    y = np.zeros(T)
    for k in range(4, T):
        y[k] = (
            1.2 * y[k - 1]
            - 0.45 * y[k - 2]
            - 0.6 * np.tanh(u[k - 3])
            - 0.25 * u[k - 4]
            + 0.05 * y[k - 1] * u[k - 3]
            + noise * rng.standard_normal()
        )
    h = T // 2
    return SysIdData(u[:h, None], y[:h, None], u[h:, None], y[h:, None], "gas_furnace")


def tanks(T: int = 1024, seed: int = 29, noise_frac: float = 0.25) -> SysIdData:
    """Cascaded-tanks-like two-state system (the depth benchmark, VERDICT r3
    #2): upper state x1 is a SLOW saturating integrator of the pump input
    (relaxation ~60 steps — far longer than the u_win=10 input window the
    benchmarked methods use), lower state x2 is a fast nonlinear tank fed by
    x1, and only x2 is observed, under SUBSTANTIAL observation noise
    (``noise_frac`` of the clean signal's std; the latent states themselves
    are noise-free). Both properties are what latent recurrence buys:

    * a windowed model (GP-NARX) must regress on NOISY y-lags, so its learned
      dynamics are attenuated (errors-in-variables), while a latent model
      smooths the state through q(X);
    * the slow stage's memory exceeds every input window, so a model needs a
      RECURRENT hidden state per stage — the structure a 2-hidden-layer
      REVARB stack matches exactly and a 1-hidden-layer model must cram into
      one latent channel.

    (The round-4 first cut of this task used noise 0.01 with fast dynamics —
    GP-NARX free-ran AT the noise floor, RMSE 0.0115 vs floor 0.01: a
    windowed model solves that regime, so it cannot reward depth. Recorded
    in BASELINE.md.)

    Published analogue: the cascaded-tanks nonlinear system-identification
    benchmark (Schoukens et al. 2016); fixed-seed Euler scheme with sqrt
    outflow nonlinearities and overflow saturation."""
    rng = np.random.default_rng(seed)
    u = 0.5 * (_telegraph(rng, T, p_switch=0.012) + 1.4)  # pump voltage >= ~0.2
    x1 = np.zeros(T)
    x2 = np.zeros(T)
    a1, a2 = 0.015, 0.18  # outflow coefficients: x1 slow (~60 steps), x2 fast
    for k in range(1, T):
        inflow1 = 0.018 * np.clip(u[k - 1], 0.0, None) ** 2
        x1[k] = np.clip(x1[k - 1] - a1 * np.sqrt(max(x1[k - 1], 0.0)) + inflow1, 0.0, 1.0)
        inflow2 = a1 * np.sqrt(max(x1[k - 1], 0.0)) + 0.4 * max(x1[k - 1] - 0.98, 0.0)
        x2[k] = np.clip(x2[k - 1] - a2 * np.sqrt(max(x2[k - 1], 0.0)) + 2.0 * inflow2, 0.0, 1.2)
    # NON-INVERTIBLE emission (a level sensor reading distance-from-setpoint):
    # y reveals only (x2 - c)^2, so a y-window is ambiguous about which branch
    # the state is on, while the branch determines the next reading — a
    # windowed model must disambiguate from history it does not have, a
    # latent-state model simply carries x2 through q(X).
    c = np.median(x2)
    y_clean = (x2 - c) ** 2 / (np.abs(x2 - c).max() + 1e-12)
    y = y_clean + noise_frac * y_clean.std() * rng.standard_normal(T)
    h = T // 2
    return SysIdData(u[:h, None], y[:h, None], u[h:, None], y[h:, None], "tanks")


def long_corpus(T: int = 16384, seed: int = 23, noise: float = 0.05) -> SysIdData:
    """Long sequence for minibatch/data-parallel throughput (config 4)."""
    rng = np.random.default_rng(seed)
    u = _multisine(rng, T, n_sin=24, fmax=0.2)
    y = np.zeros(T)
    for k in range(2, T):
        y[k] = (
            0.7 * y[k - 1]
            - 0.2 * y[k - 2]
            + np.sin(y[k - 1]) * 0.3
            + 0.8 * u[k - 1]
            + noise * rng.standard_normal()
        )
    h = (T * 3) // 4
    return SysIdData(u[:h, None], y[:h, None], u[h:, None], y[h:, None], "long_corpus")


_REGISTRY = {
    "actuator": actuator,
    "drives": drives,
    "narendra": narendra,
    "ballbeam": ballbeam,
    "dryer": dryer,
    "gas_furnace": gas_furnace,
    "tanks": tanks,
    "long_corpus": long_corpus,
}


def load(name: str, **kw) -> SysIdData:
    return _REGISTRY[name](**kw)


class SysIdTensors(NamedTuple):
    """A split standardized by train-split statistics, as tensors on a device."""

    Y: torch.Tensor  # (T_train, Dy)
    U: torch.Tensor  # (T_train, Du)
    U_test: torch.Tensor  # (T_test, Du)
    Y_test: torch.Tensor  # (T_test, Dy), standardized like Y
    sy: Standardizer
    su: Standardizer


def standardized_tensors(data: SysIdData, *, dtype=torch.float32, device=None) -> SysIdTensors:
    """Standardize ``data`` by its training split and move it to ``device``
    (``None`` means the card; see :func:`rgp_tpu_torch.device.resolve_device`)."""
    dev = resolve_device(device)
    sy, su = Standardizer.fit(data.y_train), Standardizer.fit(data.u_train)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=dev)

    return SysIdTensors(
        t(sy.transform(data.y_train)), t(su.transform(data.u_train)),
        t(su.transform(data.u_test)), t(sy.transform(data.y_test)), sy, su,
    )
