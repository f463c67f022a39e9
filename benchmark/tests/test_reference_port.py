"""The plain reference computes what the program's plain CPU path computes,
at a small size in float64: the bound and its gradient at one of the
reference's admissible rungs and an Adam step (with which
``fit_served_model`` fits a served model), and the moment-matched rollout."""

import math

import pytest
import torch

from benchmark import drive, inputs
from benchmark import reference as ref
from benchmark.tests.conftest import small_cell


def _grad(loss, leaves, **kw):
    """The gradient of each leaf, 0 for a leaf the loss does not use (the
    latent means that back-constraint MLPs replace)."""
    g = torch.autograd.grad(loss, leaves, allow_unused=True, **kw)
    return [torch.zeros_like(x) if gi is None else gi for x, gi in zip(leaves, g)]


def _setup(name, cpu, seed=3, jitter=1e-12):
    cell = small_cell(name)
    cfg = dict(cell.config, jitter=jitter)  # the program's float64 jitter base
    rec = inputs.record(cfg, torch.float64, cpu, T=cfg["T"])
    params = inputs.member(inputs.init_params(cfg, rec, 1, inputs.generator(seed, cpu), torch.float64), 0)
    return cell, cfg, rec, params


@pytest.mark.parametrize("name", ["rgp1-rollout-w16384", "rgp2mlp-rollout-w1024"])
def test_bound_and_gradient_match_the_program(name, cpu):
    from rgp_tpu_torch.models import rgp

    _, cfg, rec, params = _setup(name, cpu)
    pc = drive.program_cfg(cfg)
    wh = rgp.compute_whitenings(pc, params, rec.Y, rec.U, block=None)
    leaves = [x.clone().requires_grad_(True) for _, x in ref.tree_leaves(params)]
    loss = -rgp.elbo(pc, ref.tree_with(params, leaves), rec.Y, rec.U, block=None, whitening=wh)
    g_prog = _grad(loss, leaves)

    best = None
    for bases in __import__("itertools").product(*ref.refresh(cfg, params, rec.Y, rec.U, ref.Ladder({"c": [0.2, 4.0]}))):
        rl = [x.clone().requires_grad_(True) for _, x in ref.tree_leaves(params)]
        for _, rloss in ref.neg_elbo(cfg, ref.tree_with(params, rl), rec.Y, rec.U, list(bases), ladder=ref.Ladder({"c": [0.2, 4.0]})):
            gap = abs(float(rloss) - float(loss)) / abs(float(loss))
            if best is None or gap < best[0]:
                best = (gap, _grad(rloss, rl, retain_graph=True))
    assert best[0] < 1e-10
    for a, b in zip(g_prog, best[1]):
        torch.testing.assert_close(a, b, rtol=1e-7, atol=1e-9 * max(1.0, float(b.abs().max())))


def test_adam_step_matches_the_programs_optimizer(cpu):
    from rgp_tpu_torch import train

    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, generator=g, dtype=torch.float64)
    grads = [torch.randn(5, generator=g, dtype=torch.float64) for _ in range(3)]
    sched = train.cosine_decay_schedule(1e-2, 10000, 0.01)
    leaf = x.clone().requires_grad_(True)
    opt = train.OptaxAdam([leaf], sched)
    xs, m, v = [x.clone()], [torch.zeros(5, dtype=torch.float64)], [torch.zeros(5, dtype=torch.float64)]
    for i, gi in enumerate(grads):
        opt.step([gi], i)
        xs, m, v = ref.adam_step(xs, [gi], m, v, i, ref.cosine_lr(1e-2, 10000, 0.01, i))
        torch.testing.assert_close(leaf.detach(), xs[0], rtol=1e-12, atol=1e-14)
    assert math.isclose(ref.cosine_lr(1e-2, 10000, 0.01, 5000), sched(5000))


@pytest.mark.parametrize("name", ["rgp1-rollout-w16384", "rgp2mlp-rollout-w1024"])
def test_rollout_matches_the_program(name, cpu):
    from rgp_tpu_torch.bench import serving

    cell, cfg, rec, params = _setup(name, cpu)
    Us = inputs.candidates(cfg, rec, 6, 4, inputs.generator(5, cpu))
    m, v = serving.batched_freerun(drive.program_cfg(cfg), params, rec.Y, rec.U, Us)
    gaps = [max(float((m - mr).abs().max()), float(((v - vr) / vr).abs().max()))
            for _, mr, vr in ref.rollout_branches(cfg, params, rec.Y, rec.U, Us, ref.Ladder({"c": [0.2, 4.0]}))]
    assert min(gaps) < 1e-8
