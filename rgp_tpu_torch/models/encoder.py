"""MLP back-constraint encoder, amortized q(X) means (port of
``rgp_tpu/models/encoder.py``).

Maps a window of observed outputs (and exogenous inputs) at time t to the
variational mean of a hidden layer: tanh hidden layers, a linear output. Its
products are plain ``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..device import resolve_device

__all__ = ["init_mlp", "mlp_apply"]


def init_mlp(generator: torch.Generator, dims: Sequence[int], dtype=torch.float32, device=None):
    """dims = (d_in, h1, ..., d_out). Glorot-normal weights drawn from
    ``generator`` on its own device and moved to ``device`` (``None`` means
    the card); zero biases. ``jax.random`` draws cannot be reproduced, so
    parity with the JAX package is held by carrying its weights over
    (:mod:`rgp_tpu_torch.convert`)."""
    device = resolve_device(device)
    params = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        w = torch.randn((fan_in, fan_out), generator=generator, dtype=dtype,
                        device=generator.device) * math.sqrt(2.0 / (fan_in + fan_out))
        params.append({"w": w.to(device), "b": torch.zeros((fan_out,), dtype=dtype, device=device)})
    return tuple(params)


def mlp_apply(params, x):
    """tanh hidden layers, linear output."""
    h = x
    for layer in params[:-1]:
        h = torch.tanh(h @ layer["w"] + layer["b"])
    return h @ params[-1]["w"] + params[-1]["b"]
