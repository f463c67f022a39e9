"""rgp_tpu_torch.bench.sampling and .posterior_check against
rgp_tpu.bench.sampling and .posterior_check on the CPU.

* ``_flagship`` loads the committed anchor ``artifacts/pcheck_params_r5.npz``
  without JAX into the JAX package's leaves, and the frozen-basis float64
  potential there is ``U_f64_frozen`` of ``artifacts/surrogate_check_r5.json``
  (-13.3, two decimals);
* the command line has the JAX benchmark's options and defaults, and nothing
  else;
* ``_jit_scale`` and ``compare_draws`` equal the JAX package's
  ``_jit_scale`` and the statistics of its ``mode_compare``;
* the posterior check's modes: ``fit``'s npz loads in the JAX ``_flagship``;
  on a tiny float64 model behind both seams, ``card`` and ``ref`` start
  from the JAX modes' Hessian mass (rtol 1e-8) and write the JAX modes'
  summary and npz keys, and ``--mass-from`` gives the JAX formula's mass; a
  ``ref`` run killed after one segment resumes to the same bits; the
  ``surrogate-check`` potentials equal the JAX modes' at the same points
  (rtol 1e-10 in float64).
"""

import functools
import json
import os
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgp_tpu.bench import posterior_check as jpc
from rgp_tpu.bench import sampling as jsampling
from rgp_tpu_torch.bench import posterior_check as tpc
from rgp_tpu_torch.bench import sampling as tsampling
from rgp_tpu_torch.params import leaves_with_paths
from rgp_tpu_torch.sample.api import make_rgp_potential

ROOT = Path(__file__).resolve().parents[1]
ANCHOR = ROOT / "artifacts" / "pcheck_params_r5.npz"


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Samplers run many small ops: one intra-op thread each, restored after
    the test. The test workers share the CPU, and with a thread pool per
    worker a sampler test ran ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_flagship_loads_the_anchor_in_jax_leaf_order():
    cfg, params, *_ = tsampling._flagship(0, torch.float32, str(ANCHOR), device="cpu")
    jcfg, jparams, *_ = jsampling._flagship(0, jnp.float32, str(ANCHOR))
    ours = [x.numpy() for _, x in leaves_with_paths(params)]
    ref = [np.asarray(x) for x in jax.tree.leaves(jparams)]
    assert len(ours) == len(ref) == 12
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert cfg.layers[0].num_inducing == jcfg.layers[0].num_inducing == 100


def test_frozen_f64_potential_at_the_anchor_is_the_recorded_one():
    record = json.loads((ROOT / "artifacts" / "surrogate_check_r5.json").read_text())
    u_ref = next(p["U_f64_frozen"] for p in record["points"] if p["point"] == "anchor")
    cfg, p64, Y, U, _, _ = tsampling._flagship(0, torch.float64, str(ANCHOR), device="cpu")
    pot, flat0, _, _ = make_rgp_potential(cfg, p64, Y, U, block=64, psi_prefer="scan", fixed_whitening=True)
    with torch.no_grad():
        assert abs(float(pot(flat0)) - u_ref) <= 0.005 + 1e-9


def _options(parser_main, argv):
    """The argparse namespace a benchmark's ``main`` builds, without running it."""
    import argparse

    seen = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen["ns"] = real(self, args, namespace)
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            parser_main(argv)
    finally:
        argparse.ArgumentParser.parse_args = real
    return vars(seen["ns"])


def test_command_line_is_the_jax_benchmarks():
    for argv in ([], ["--what", "smc", "--particles", "64"], ["--chains", "128", "--warmup", "24", "--draws", "8"]):
        assert _options(tsampling.main, argv) == _options(jsampling.main, argv)


def test_jit_scale_matches_jax():
    mass_inv = np.array([1e-4, 0.5, 3.0, 30.0, 1e4])
    np.testing.assert_allclose(tpc._jit_scale(torch.tensor(mass_inv)).numpy(),
                               np.asarray(jpc._jit_scale(jnp.asarray(mass_inv))), rtol=1e-15)


def test_compare_draws_matches_mode_compare(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((6, 40, 3)) + [0.0, 0.3, 0.0]
    b = rng.standard_normal((4, 60, 3)) * [1.0, 1.0, 2.0]
    div_a, div_b = rng.uniform(size=(6, 40)) < 0.05, np.zeros((4, 60), bool)
    np.savez(tmp_path / "a.npz", draws=a, diverging=div_a)
    np.savez(tmp_path / "b.npz", draws=b, diverging=div_b)
    ref = jpc.mode_compare(str(tmp_path / "a.npz"), str(tmp_path / "b.npz"))
    ours = {"mode": "compare", **tpc.compare_draws(a, div_a, b, div_b)}
    # the port names the JAX record's "tpu" and "cpu_ref" blocks "draws" and "reference"
    ours["tpu"], ours["cpu_ref"] = ours.pop("draws"), ours.pop("reference")
    assert sorted(ours) == sorted(ref)

    def close(x, y):
        if isinstance(x, dict):
            assert sorted(x) == sorted(y)
            for k in x:
                close(x[k], y[k])
        elif isinstance(x, list):
            for u, v in zip(x, y):
                close(u, v)
        elif isinstance(x, str):
            assert x == y
        else:  # the JAX record rounds its numbers
            np.testing.assert_allclose(x, y, atol=1e-3, rtol=1e-3)

    close(ours, ref)


# ------------------------------------------------ posterior_check's modes
#
# Every mode takes its model through ``_flagship``: here both packages' seams
# return one tiny float64 model (narendra, T=40, M=8, wins [0, 2], at init),
# with the parameters of ``params_npz`` when given. JAX's NUTS is never run
# (its compile is what the JAX suite marks slow): its modes run against
# stand-ins that record the initial mass and return shaped draws, so that
# the masses, the summary keys and the npz keys can be held against the
# port's, whose NUTS runs for real at a few steps.


@functools.lru_cache(maxsize=1)
def _tiny_data():
    from rgp_tpu.data import datasets as jd
    from rgp_tpu.data.windows import Standardizer

    d = jd.narendra(T=80, seed=0)
    sy, su = Standardizer.fit(d.y_train), Standardizer.fit(d.u_train)
    return tuple(np.asarray(x, np.float64) for x in (sy.transform(d.y_train), su.transform(d.u_train),
                                                      su.transform(d.u_test), sy.transform(d.y_test)))


def _tiny_jax(fit_iters, dtype, params_npz=None, noise_floor=None):
    from rgp_tpu.models import rgp as jr

    Y, U, Ut, Yt = map(jnp.asarray, _tiny_data())
    cfg = jr.deep_rgp_config(wins=[0, 2], u_win=2, y_dim=1, u_dim=1, num_inducing=8)
    params = jr.init_params(cfg, Y, U, dtype=jnp.float64)
    if params_npz is not None:
        with np.load(params_npz) as z:
            flat = [jnp.asarray(z[f"p{i}"]) for i in range(len(z.files))]
        params = jax.tree.unflatten(jax.tree.structure(params), flat)
    return cfg, params, Y, U, Ut, Yt


def _tiny_torch(fit_iters, dtype, params_npz=None, noise_floor=None, device=None):
    from rgp_tpu_torch.models import rgp as tr
    from rgp_tpu_torch.params import with_leaves

    Y, U, Ut, Yt = (torch.tensor(x) for x in _tiny_data())
    cfg = tr.deep_rgp_config(wins=[0, 2], u_win=2, y_dim=1, u_dim=1, num_inducing=8)
    params = tr.init_params(cfg, Y, U, dtype=torch.float64, device="cpu")
    if params_npz is not None:
        with np.load(params_npz) as z:
            params = with_leaves(params, [torch.tensor(z[f"p{i}"]) for i in range(len(z.files))])
    return cfg, params, Y, U, Ut, Yt


def _tiny_flat0():
    """The tiny model's hyperparameters as one flat vector (the potential's
    anchor)."""
    import jax.flatten_util
    from rgp_tpu.sample import api as japi

    return np.asarray(jax.flatten_util.ravel_pytree(japi.split_hypers(_tiny_jax(0, None)[1]))[0])


class _DA(NamedTuple):
    log_eps: object
    log_eps_avg: object


class _Carry(NamedTuple):
    zs: object
    da: _DA
    step: object


class _Res(NamedTuple):
    samples: object
    diverging: object
    accept_prob: object


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    """Both seams patched, JAX's NUTS replaced by stand-ins; yields
    {"jax_mass": [...], "torch_mass": [...], "params": tiny params npz}."""
    from rgp_tpu.sample import nuts as jnuts
    from rgp_tpu_torch.sample import nuts as tnuts

    seen = {"jax_mass": [], "torch_mass": []}

    def j_init(z0, n_chains=1, mass_inv=None, step_size=0.1):
        seen["jax_mass"].append(np.asarray(mass_inv))
        z0 = jnp.broadcast_to(jnp.atleast_2d(z0), (n_chains, jnp.shape(z0)[-1]))
        return _Carry(z0, _DA(jnp.log(0.1), jnp.log(0.1)), jnp.zeros((), jnp.int32))

    def j_warmup(potential, c, key, n_steps, **kw):
        return c._replace(step=c.step + n_steps)

    def j_draw(potential, c, key, n, **kw):
        shape = c.zs.shape[:1] + (n,)
        return c._replace(step=c.step + n), _Res(jnp.repeat(c.zs[:, None], n, 1), jnp.zeros(shape, bool),
                                                 jnp.ones(shape))

    real_init = tnuts.nuts_init

    def t_init(z0, **kw):
        seen["torch_mass"].append(kw["mass_inv"].numpy().copy())
        return real_init(z0, **kw)

    monkeypatch.setattr(jsampling, "_flagship", _tiny_jax)
    monkeypatch.setattr(tpc, "_flagship", _tiny_torch)
    for name, fn in (("nuts_init", j_init), ("nuts_warmup", j_warmup), ("nuts_draw", j_draw)):
        monkeypatch.setattr(jnuts, name, fn)
    monkeypatch.setattr(tnuts, "nuts_init", t_init)
    seen["params"] = str(tmp_path / "tiny_params.npz")
    assert tpc.mode_fit(seen["params"], 0) == {"mode": "fit", "out": seen["params"], "fit_iters": 0}
    yield seen


def _npz_keys(path):
    with np.load(path) as z:
        return sorted(z.files)


def test_fit_npz_loads_in_jax_flagship(tmp_path):
    out = str(tmp_path / "params.npz")
    tpc.mode_fit(out, 2, device="cpu")
    _, jparams, *_ = jsampling._flagship(0, jnp.float32, out)
    ref = jax.tree.leaves(jparams)
    with np.load(out) as z:
        assert sorted(z.files) == [f"p{i}" for i in sorted(range(len(ref)), key=str)]
        for i, leaf in enumerate(ref):
            np.testing.assert_array_equal(np.asarray(leaf), z[f"p{i}"])


@pytest.mark.parametrize("mode", ["card", "ref"])
def test_modes_give_the_jax_mass_and_keys(tiny, tmp_path, mode):
    """The JAX mode runs once, with the Hessian mass (its compile is the
    cost); the ``--mass-from`` mass is held against the JAX module's formula,
    max(var(draws, ddof=1), 1e-6)."""
    flat0 = _tiny_flat0()
    mass_from = str(tmp_path / "mass_draws.npz")
    draws = flat0 + 0.1 * np.random.default_rng(3).standard_normal((3, 5, flat0.size))
    np.savez(mass_from, draws=draws)
    kw = dict(chains=2, warmup=2, samples=2, max_depth=2, target_accept=0.6, seed=0)
    if mode == "card":
        kw.update(group_size=2, seg=1)
        ref = jpc.mode_tpu(tiny["params"], str(tmp_path / "j.npz"), **kw)
        run = tpc.mode_card
    else:
        kw.update(seg=1, draw_seg=1)
        ref = jpc.mode_cpu_ref(tiny["params"], str(tmp_path / "j.npz"), **kw)
        run = tpc.mode_ref
    ours = run(tiny["params"], str(tmp_path / "t.npz"), **kw, device="cpu")
    assert tiny["jax_mass"] and tiny["torch_mass"]
    for m in tiny["torch_mass"] + tiny["jax_mass"][1:]:
        np.testing.assert_allclose(m, tiny["jax_mass"][0], rtol=1e-8)
    assert sorted(ours) == sorted(ref) and ours["mode"] == mode and ours["mass"] == ref["mass"] == "hessian"
    assert _npz_keys(tmp_path / "t.npz") == _npz_keys(tmp_path / "j.npz")
    with np.load(tmp_path / "t.npz") as z:
        assert z["draws"].shape == (2, 2, flat0.size) and np.isfinite(z["draws"]).all()

    tiny["torch_mass"].clear()
    ours = run(tiny["params"], str(tmp_path / "t2.npz"), **kw, mass_from=mass_from, device="cpu")
    want = np.maximum(draws.reshape(-1, flat0.size).var(axis=0, ddof=1), 1e-6)
    for m in tiny["torch_mass"]:
        np.testing.assert_allclose(m, want, rtol=1e-8)
    assert ours["mass"] == f"emp_var:{mass_from}"


def test_ref_resumes_to_the_same_bits(tiny, tmp_path):
    from rgp_tpu_torch.utils import checkpoint

    kw = dict(chains=2, warmup=2, samples=2, max_depth=2, target_accept=0.6, seed=0, seg=1, draw_seg=1,
              device="cpu")
    whole = tpc.mode_ref(tiny["params"], str(tmp_path / "whole.npz"), **kw)

    real_save, saves = checkpoint.save_checkpoint, []

    def save_then_die(*a, **k):
        real_save(*a, **k)
        saves.append(a[2])
        if len(saves) == 1:
            raise KeyboardInterrupt("killed after one segment")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(checkpoint, "save_checkpoint", save_then_die)
        with pytest.raises(KeyboardInterrupt):
            tpc.mode_ref(tiny["params"], str(tmp_path / "cut.npz"), **kw)
    assert saves == [1]
    resumed = tpc.mode_ref(tiny["params"], str(tmp_path / "cut.npz"), **kw)
    with np.load(tmp_path / "whole.npz") as a, np.load(tmp_path / "cut.npz") as b:
        np.testing.assert_array_equal(a["draws"], b["draws"])
        np.testing.assert_array_equal(a["diverging"], b["diverging"])
    assert resumed["step_size"] == whole["step_size"]
    assert sorted(os.listdir(tmp_path / "cut.npz.ckpt")) == ["step_00000004"]


# The seam's model is float64 at either dtype, so the "float32" column is the
# float64 potential at the point cast to float32, where the two packages
# promote the float32 hyperparameters against float64 leaves at different
# places: 3.4e-7 relative apart at the anchor (461.08 nats).
_F32_POINT_RTOL = 1e-6


def test_surrogate_check_matches_jax(tiny, tmp_path):
    from rgp_tpu.sample import api as japi

    built = []
    real = japi.make_rgp_potential

    def spy(*a, **k):
        out = real(*a, **k)
        built.append(out[0])
        return out

    flat0 = _tiny_flat0()
    rng = np.random.default_rng(5)
    np.savez(tmp_path / "draws.npz", draws=flat0 + 0.05 * rng.standard_normal((4, 6, flat0.size)))
    np.savez(tmp_path / "ref.npz", draws=flat0 + 0.05 * rng.standard_normal((2, 3, flat0.size)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japi, "make_rgp_potential", spy)
        ref = jpc.mode_surrogate_check(tiny["params"], str(tmp_path / "draws.npz"), str(tmp_path / "ref.npz"))
    ours = tpc.mode_surrogate_check(tiny["params"], str(tmp_path / "draws.npz"), str(tmp_path / "ref.npz"),
                                    device="cpu")
    assert sorted(ours) == sorted(ref)
    assert [r["point"] for r in ours["points"]] == [r["point"] for r in ref["points"]]
    assert sorted(ours["points"][0]) == sorted(ref["points"][0])
    fresh, frozen64, frozen32 = (jax.jit(f) for f in built)
    d = np.load(tmp_path / "draws.npz")["draws"].reshape(-1, flat0.size)
    last = np.load(tmp_path / "ref.npz")["draws"][:, -1]
    for row in ours["points"]:
        name = row["point"]
        v = flat0 if name == "anchor" else (d[int(name.split("_")[-1])] if name.startswith("tpu_draw_")
                                            else last[int(name[len("ref_chain")])])
        for key, fn, dtype, rtol in (("U_f64_fresh", fresh, jnp.float64, 1e-10),
                                     ("U_f64_frozen", frozen64, jnp.float64, 1e-10),
                                     ("U_f32_frozen", frozen32, jnp.float32, _F32_POINT_RTOL)):
            np.testing.assert_allclose(row[key], float(fn(jnp.asarray(v, dtype))), rtol=rtol, err_msg=(name, key))
