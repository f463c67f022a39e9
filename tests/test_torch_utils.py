"""rgp_tpu_torch.utils on the CPU: the JSONL metrics logger, the profiler
helpers, the plotting helpers and the checkpoint module.

The checkpoint tests are tests/test_checkpoint.py's on the port: an Adam run
on narendra (T=60, M=6, f64) checkpointed at step 5 and resumed from the
loaded state bit for bit (losses, parameters, the generator's state), and
NUTS stopped at 23 of 60 warmup steps, its carry saved and loaded
(``torch.load(weights_only=True)``), then resumed, with the draws split 15 +
25: samples, step size and mass bit for bit against one uninterrupted
``nuts_sample``.
"""

import json
import os

import numpy as np
import pytest
import torch

from rgp_tpu_torch.data import datasets
from rgp_tpu_torch.models import rgp
from rgp_tpu_torch.sample import nuts
from rgp_tpu_torch.train import OptaxAdam, leaves_with_paths, with_leaves
from rgp_tpu_torch.utils import checkpoint as ckpt
from rgp_tpu_torch.utils.metrics import MetricsLogger
from rgp_tpu_torch.utils.profiling import annotate, trace


def test_metrics_jsonl_roundtrip(tmp_path):
    path = tmp_path / "metrics.jsonl"
    with MetricsLogger(str(path)) as log:
        log.log(0, elbo=-123.4, grad_norm=torch.tensor(5.0))
        log.log(1, elbo=torch.tensor(-100.0, dtype=torch.float64), rmse=torch.tensor([0.1, 0.2], dtype=torch.float64),
                n=np.int64(3))
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert lines[0]["step"] == 0 and "wall_time" in lines[0]
    assert lines[0]["elbo"] == -123.4 and lines[0]["grad_norm"] == 5.0
    assert lines[1]["elbo"] == -100.0 and lines[1]["rmse"] == [0.1, 0.2] and lines[1]["n"] == 3


def test_annotate_appears_in_the_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        with annotate("psi_stats"):
            x = torch.ones(4).sum()
    assert float(x) == 4.0
    assert "psi_stats" in {e.key for e in prof.key_averages()}
    assert "psi_stats" in (tmp_path / "trace.json").read_text()


def test_annotate_is_recorded_under_a_profiler_started_by_hand():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()  # as a benchmark's tracer starts it, with no ``with`` block
    try:
        with annotate("rgp.freerun.step"):
            x = torch.ones(4).sum()
    finally:
        prof.stop()
    assert float(x) == 4.0
    names = [e.name() for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    assert names.count("rgp.freerun.step") == 1


def test_annotate_without_a_profiler_enters_no_record_function(monkeypatch):
    import contextlib

    from rgp_tpu_torch.utils import profiling

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    region = annotate("psi.per_t")
    assert isinstance(region, contextlib.nullcontext) and region is annotate("rgp.posteriors")
    with region:
        x = torch.ones(4).sum()
    assert float(x) == 4.0


def test_plotting_helpers_render():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from rgp_tpu_torch.utils import plotting

    x = torch.linspace(0, 1, 50, dtype=torch.float64)
    mean = torch.sin(2 * np.pi * x)
    var = np.full(50, 0.04)
    ax = plotting.plot_gp(x, mean, var, X_data=x[::5], Y_data=mean[::5])
    assert len(ax.lines) >= 2 and len(ax.collections) == 1  # mean and data, band
    ax2 = plotting.plot_freerun(mean[:, None], mean + 0.1, torch.tensor(var))
    assert "RMSE" in ax2.get_title() and len(ax2.lines) == 2
    plt.close("all")


def _narendra_model():
    t = datasets.standardized_tensors(datasets.narendra(T=60, seed=0), dtype=torch.float64, device="cpu")
    cfg = rgp.deep_rgp_config(wins=[0, 2], u_win=2, y_dim=1, u_dim=1, num_inducing=6)
    return cfg, rgp.init_params(cfg, t.Y, t.U, dtype=torch.float64, device="cpu"), t.Y, t.U


class _Adam:
    """Adam on -elbo, one step at a time, from ``params`` and an optional
    optimizer state."""

    def __init__(self, cfg, params, Y, U, opt_state=None):
        self.leaves = [x.detach().clone().requires_grad_(True) for _, x in leaves_with_paths(params)]
        self.p = with_leaves(params, self.leaves)
        self.opt = OptaxAdam(self.leaves, 1e-2)
        if opt_state is not None:
            self.opt.opt.load_state_dict(opt_state)
        self.loss = lambda: -rgp.elbo(cfg, self.p, Y, U, block=None)

    def step(self, i):
        loss = self.loss()
        self.opt.step(list(torch.autograd.grad(loss, self.leaves)), i)
        return float(loss.detach())

    def params(self):
        return with_leaves(self.p, [x.detach().clone() for x in self.leaves])


def test_checkpoint_roundtrip_and_deterministic_resume(tmp_path):
    cfg, params, Y, U = _narendra_model()
    run = _Adam(cfg, params, Y, U)
    gen = torch.Generator().manual_seed(42)
    for i in range(5):
        run.step(i)
    state = {"params": run.params(), "opt_state": run.opt.opt.state_dict(), "generator": gen.get_state()}
    ckpt.save_checkpoint(str(tmp_path), state, step=5, config={"model": "rgp", "wins": [0, 2]})
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert json.loads((tmp_path / "config.json").read_text())["wins"] == [0, 2]

    losses_a = [run.step(i) for i in range(5, 10)]
    draws_a = torch.rand(4, generator=gen, dtype=torch.float64)

    restored, at = ckpt.load_checkpoint(str(tmp_path), device="cpu")
    assert at == 5
    resumed = _Adam(cfg, restored["params"], Y, U, restored["opt_state"])
    losses_b = [resumed.step(i) for i in range(5, 10)]
    gen_b = torch.Generator()
    gen_b.set_state(restored["generator"])

    assert losses_a == losses_b
    for (_, a), (_, b) in zip(leaves_with_paths(run.params()), leaves_with_paths(resumed.params())):
        assert torch.equal(a, b)
    assert torch.equal(torch.rand(4, generator=gen_b, dtype=torch.float64), draws_a)


def test_load_checkpoint_against_a_template(tmp_path):
    """A template fixes container types, dtypes and structure; a mismatch
    raises, and so does a device beside a template."""
    carry = nuts.nuts_init(torch.zeros(2, 3, dtype=torch.float64), n_chains=2, step_size=0.2)
    ckpt.save_checkpoint(str(tmp_path), carry._asdict(), step=3)
    template = {**carry._asdict(), "zs": carry.zs.float()}
    restored, _ = ckpt.load_checkpoint(str(tmp_path), template)
    assert isinstance(restored["da"], nuts._DAState) and isinstance(restored["welford"], tuple)
    assert restored["zs"].dtype == torch.float32 and restored["step"] == 0
    with pytest.raises(ValueError):
        ckpt.load_checkpoint(str(tmp_path), {**template, "zs": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="not both"):
        ckpt.load_checkpoint(str(tmp_path), template, device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path / "none"), device="cpu")


def test_nuts_fault_injection_resume_mid_warmup(tmp_path):
    prec = torch.tensor([[2.0, 0.6, 0.0], [0.6, 1.5, 0.3], [0.0, 0.3, 1.0]], dtype=torch.float64)

    def potential(Z):
        return 0.5 * ((Z @ prec) * Z).sum(-1)

    seed, z0 = 7, torch.zeros(4, 3, dtype=torch.float64)
    n_warm, n_samp, cut = 60, 40, 23
    ref = nuts.nuts_sample(potential, z0, seed, n_samples=n_samp, n_warmup=n_warm, n_chains=4, step_size=0.2)

    carry = nuts.nuts_init(z0, n_chains=4, step_size=0.2)
    carry = nuts.nuts_warmup(potential, carry, seed, cut, n_warmup=n_warm)
    ckpt.save_checkpoint(str(tmp_path), carry._asdict(), step=cut)
    del carry
    restored, at = ckpt.load_checkpoint(str(tmp_path), device="cpu")
    assert at == cut and os.path.isdir(tmp_path / f"step_{cut:08d}")
    carry2 = nuts.NUTSCarry(zs=restored["zs"], da=nuts._DAState(*restored["da"]), welford=tuple(restored["welford"]),
                            mass_inv=restored["mass_inv"], step=restored["step"])
    assert carry2.step == cut
    carry2 = nuts.nuts_warmup(potential, carry2, seed, n_warm - cut, n_warmup=n_warm)
    carry2, res_a = nuts.nuts_draw(potential, carry2, seed, 15)
    _, res_b = nuts.nuts_draw(potential, carry2, seed, n_samp - 15)

    assert torch.equal(torch.cat([res_a.samples, res_b.samples], 1), ref.samples)
    assert torch.equal(res_a.step_size, ref.step_size)
    assert torch.equal(res_a.mass_inv, ref.mass_inv)
