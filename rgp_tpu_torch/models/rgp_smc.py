"""The trained deep RGP as a particle-filterable state-space model (port of
``rgp_tpu/models/rgp_smc.py``).

A particle is the concatenated per-layer state window (values, not moments).
The transition samples each layer's next state from its sparse-GP predictive
at the particle's windowed input (a bootstrap proposal); the emission weighs
by the output GP's predictive density at the observed y_t. Both go through
the trained posteriors of :func:`rgp_tpu_torch.models.rgp._posteriors` and
:func:`~rgp_tpu_torch.inference.collapsed_vi.predict_uncertain` at certain
inputs, batched over the particles (the JAX package vmaps one particle).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..data.windows import current_window
from ..inference.collapsed_vi import predict_uncertain
from . import rgp

__all__ = ["make_ssm", "SSM"]


class SSM(NamedTuple):
    transition_sample: Callable  # (generator, particles (N, S), t) -> (N, S)
    transition_from_normals: Callable  # (normals (N, noise_dim), particles, t) -> (N, S)
    emission_logpdf: Callable  # (particles (N, S), t) -> (N,)
    init_sample: Callable  # (generator, n) -> (n, S)
    n_steps: int
    state_dim: int
    noise_dim: int  # standard normals a transition consumes per particle
    unpack: Callable  # (N, S) states -> per-layer (N, B_h, Q_h) windows, most recent first


def make_ssm(cfg: rgp.RGPConfig, params, Y_train, U_train, U_test, Y_test) -> SSM:
    """Build the particle-filter view of the trained model over the test span."""
    with torch.no_grad():
        posts, _ = rgp._posteriors(cfg, params, Y_train, U_train)
        mus, _ = rgp._hidden_moments(cfg, params, Y_train, U_train)
    H = cfg.n_hidden
    specs = cfg.layers

    buf_lens = []
    for h, spec in enumerate(specs):
        need_above = specs[h + 1].win if h + 1 < H else cfg.out_win
        buf_lens.append(max(spec.win, need_above))
    offsets = [0]
    for h, spec in enumerate(specs):
        offsets.append(offsets[-1] + buf_lens[h] * spec.q_dim)
    state_dim = offsets[-1]
    noise_offsets = [0]
    for spec in specs:
        noise_offsets.append(noise_offsets[-1] + spec.q_dim)

    Lu = cfg.u_win
    if Lu > 0:
        U_cat = torch.cat([U_train[-(Lu - 1):], U_test], dim=0) if Lu > 1 else U_test
        Uw = current_window(U_cat, Lu)[Lu - 1:]
    else:
        Uw = U_test.new_zeros((U_test.shape[0], 0))
    fl_noise = [rgp._fln(cfg, lp["log_noise"]) for lp in params["layers"]]
    op = params["out"]
    fl_out = rgp._fln(cfg, op["log_noise"])

    def unpack(states):
        N = states.shape[0]
        return [states[:, offsets[h]:offsets[h + 1]].reshape(N, buf_lens[h], specs[h].q_dim) for h in range(H)]

    def pack(bufs):
        return torch.cat([b.reshape(b.shape[0], -1) for b in bufs], dim=-1)

    @torch.no_grad()
    def transition_from_normals(normals, particles, t):
        """Each layer's new state m + sqrt(v) * normal, deepest layer first,
        every particle at once."""
        bufs = unpack(particles)
        N = particles.shape[0]
        new_vals = []
        for h, spec in enumerate(specs):
            lp = params["layers"][h]
            L = spec.win
            own = bufs[h][:, :L].reshape(N, -1)
            if h == 0:
                low = Uw[t].reshape(1, -1).expand(N, -1)
            else:
                low = torch.cat([new_vals[h - 1][:, None, :], bufs[h - 1][:, :L - 1]], dim=1).reshape(N, -1)
            m, v = predict_uncertain(spec.kernel, lp["kern"], lp["Z"], fl_noise[h], posts[h],
                                     torch.cat([own, low], dim=-1), None, include_noise=True)
            new_vals.append(m + torch.sqrt(v) * normals[:, noise_offsets[h]:noise_offsets[h + 1]])
        return pack([torch.cat([new_vals[h][:, None, :], bufs[h][:, :-1]], dim=1) for h in range(H)])

    def transition_sample(generator, particles, t):
        normals = torch.randn((particles.shape[0], noise_offsets[-1]), generator=generator,
                              dtype=particles.dtype, device=particles.device)
        return transition_from_normals(normals, particles, t)

    @torch.no_grad()
    def emission_logpdf(particles, t):
        top = unpack(particles)[-1][:, :cfg.out_win].reshape(particles.shape[0], -1)
        m, v = predict_uncertain(cfg.out_kernel, op["kern"], op["Z"], fl_out, posts[-1], top, None,
                                 include_noise=True)
        y = Y_test[t]
        return (-0.5 * torch.log(2 * torch.pi * v) - 0.5 * (y - m) ** 2 / v).sum(-1)

    def init_sample(generator, n):
        """Every particle starts at the trained variational tail, with
        per-state noise scaled by the trained q(x) standard deviations."""
        bufs, stds = [], []
        for h, spec in enumerate(specs):
            B = buf_lens[h]
            lam_t = torch.exp(params["layers"][h]["log_lam"])
            bufs.append(torch.flip(mus[h][-B:], [0])[None])
            stds.append(torch.sqrt(torch.flip(lam_t[-B:], [0]))[None])
        base, std = pack(bufs), pack(stds)
        return base + std * torch.randn((n, state_dim), generator=generator, dtype=base.dtype,
                                        device=base.device)

    return SSM(transition_sample=transition_sample, transition_from_normals=transition_from_normals,
               emission_logpdf=emission_logpdf, init_sample=init_sample, n_steps=U_test.shape[0],
               state_dim=state_dim, noise_dim=noise_offsets[-1], unpack=unpack)
