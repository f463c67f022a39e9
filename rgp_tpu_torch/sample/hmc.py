"""Hamiltonian Monte Carlo over unconstrained hyperparameters (port of
``rgp_tpu/sample/hmc.py``), with every chain in one ``(C, dim)`` state.

A potential here is batched: ``potential_fn(z)`` maps ``(C, dim)`` positions
to ``(C,)`` energies, rows independent (``make_rgp_potential``'s batched
potential, or any function written on a leading chain axis). Gradients are
``torch.autograd.grad`` of the sum, so one backward gives every chain's.

Randomness: the draws of chain ``c`` at step ``i`` come from a CPU
``torch.Generator`` seeded from ``(seed, i, chain_offset + c)`` alone, and are
then moved to the chains' device. So a run does not depend on how it is cut
into calls, nor on which chains share a batch: chain ``c`` draws the same
numbers alone or among 128 (the JAX package's ``fold_in`` contract). JAX's
stream itself cannot be reproduced.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["hmc_sample", "HMCResult", "value_and_grad", "step_draws"]

_MASK64 = (1 << 64) - 1


class HMCResult(NamedTuple):
    samples: torch.Tensor  # (n_chains, n_samples, dim)
    accept_prob: torch.Tensor  # (n_chains, n_samples)
    potential: torch.Tensor  # (n_chains, n_samples)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _chain_generator(seed: int, step: int, chain: int) -> torch.Generator:
    """A CPU generator for one (seed, step, chain); torch seeds its Mersenne
    twister from 32 bits, so the 64-bit mix is folded to 32."""
    h = _splitmix64(_splitmix64(_splitmix64(seed & _MASK64) ^ step) ^ chain)
    return torch.Generator().manual_seed((h ^ (h >> 32)) & 0xFFFFFFFF)


def step_draws(seed: int, step: int, n_chains: int, chain_offset: int, n_normal: int, n_uniform: int,
               dtype, device):
    """(normals (C, n_normal), uniforms (C, n_uniform)) for one step: row c
    from chain ``chain_offset + c``'s own generator, normals first."""
    normals, uniforms = [], []
    for c in range(n_chains):
        g = _chain_generator(seed, step, chain_offset + c)
        normals.append(torch.randn(n_normal, generator=g, dtype=dtype))
        uniforms.append(torch.rand(n_uniform, generator=g, dtype=dtype))
    return torch.stack(normals).to(device), torch.stack(uniforms).to(device)


def value_and_grad(potential_fn: Callable, z):
    """(U (C,), dU/dz (C, dim)) of a batched potential, both detached."""
    z = z.detach().requires_grad_(True)
    with torch.enable_grad():
        U = potential_fn(z)
        (g,) = torch.autograd.grad(U.sum(), z)
    return U.detach(), g


def _leapfrog(potential_fn, z, r, step_size, n_steps, mass_inv):
    """Leapfrog of ``n_steps`` (an int, or a (C,) tensor of per-chain
    lengths): opening half-kick, then per step a drift, ONE gradient and a
    kick (half on a chain's last step, so adjacent half-kicks are fused).
    Chains past their length stay where they are. Returns (z, r, U, g) at the
    end point."""
    n = torch.as_tensor(n_steps, device=z.device).expand(z.shape[0])
    n_max = int(n.max())
    U, g = value_and_grad(potential_fn, z)
    r = r - 0.5 * step_size * g
    for i in range(n_max):
        live = (i < n)[:, None]
        z = torch.where(live, z + step_size * mass_inv * r, z)
        U_new, g_new = value_and_grad(potential_fn, z)
        U = torch.where(live[:, 0], U_new, U)
        g = torch.where(live, g_new, g)
        kick = step_size * torch.where(i == n - 1, 0.5, 1.0).to(z.dtype)[:, None]
        r = torch.where(live, r - kick * g, r)
    return z, r, U, g


def hmc_sample(
    potential_fn: Callable,
    z0,
    seed: int,
    *,
    n_samples: int = 500,
    n_warmup: int = 0,
    step_size: float = 0.01,
    n_leapfrog: int = 20,
    mass: Optional[torch.Tensor] = None,
    n_chains: int = 1,
) -> HMCResult:
    """Run HMC chains. ``z0``: (dim,) or (n_chains, dim) initial states;
    ``mass``: diagonal mass matrix (dim,). Each step draws, per chain, its
    momentum, its trajectory length uniform in [1, n_leapfrog] (the jitter
    that breaks the periodic resonance of fixed-length HMC on near-Gaussian
    targets, Neal 2011 S3.2) and its accept uniform; every chain runs in the
    same batched leapfrog, masked past its own length. Returns post-warmup
    samples."""
    z = torch.atleast_2d(torch.as_tensor(z0))
    if z.shape[0] != n_chains:
        z = z.expand(n_chains, z.shape[-1])
    z = z.detach().clone()
    dim, dtype, dev = z.shape[-1], z.dtype, z.device
    mass = torch.ones(dim, dtype=dtype, device=dev) if mass is None else torch.as_tensor(mass, dtype=dtype,
                                                                                        device=dev)
    mass_inv = 1.0 / mass
    with torch.no_grad():
        U = potential_fn(z)
    zs, accs, Us = [], [], []
    for i in range(n_warmup + n_samples):
        normals, uniforms = step_draws(seed, i, n_chains, 0, dim, 2, dtype, dev)
        r = torch.sqrt(mass) * normals
        H0 = U + 0.5 * (mass_inv * r * r).sum(-1)
        n_steps = 1 + torch.floor(uniforms[:, 1] * n_leapfrog).long().clamp(max=n_leapfrog - 1)
        z_new, r_new, U_new, _ = _leapfrog(potential_fn, z, r, step_size, n_steps, mass_inv)
        H_new = U_new + 0.5 * (mass_inv * r_new * r_new).sum(-1)
        log_accept = torch.clamp(H0 - H_new, max=0.0)
        log_accept = torch.where(torch.isnan(log_accept), -torch.inf, log_accept)
        accept = torch.log(uniforms[:, 0]) < log_accept
        z = torch.where(accept[:, None], z_new, z)
        U = torch.where(accept, U_new, U)
        if i >= n_warmup:
            zs.append(z)
            accs.append(torch.exp(log_accept))
            Us.append(U)
    return HMCResult(samples=torch.stack(zs, 1), accept_prob=torch.stack(accs, 1), potential=torch.stack(Us, 1))
