"""rgp_tpu_torch.utils.checkgrad against rgp_tpu.utils.checkgrad on
``svgp.elbo`` (tests/test_svi.py's ``test_svi_checkgrad``: T=15, Q=2, M=5, 80
random coordinates, float64): the port's autograd agrees with central
differences (max relative error < 3e-4, the reference's own gate), checks the
same coordinates as the JAX one, and its analytic gradient and differences
match the JAX package's (1e-8 of the largest entry; the differences at 1e-6,
as each carries ~1e-16 |f| / eps of rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import rgp_tpu.kernels as jk
from rgp_tpu.models import svgp as jsvgp
from rgp_tpu.utils.checkgrad import checkgrad as jcheckgrad
import rgp_tpu_torch.kernels as tk
from rgp_tpu_torch.convert import params_from_jax
from rgp_tpu_torch.models import svgp as tsvgp
from rgp_tpu_torch.utils.checkgrad import CheckgradResult, checkgrad


def test_checkgrad_svgp_elbo_matches_jax(rng):
    X = rng.standard_normal((15, 2))
    Y = np.sin(X.sum(-1, keepdims=True)) + 0.1 * rng.standard_normal((15, 1))
    cfg = jsvgp.SVGPConfig(jk.RBF(input_dim=2), 5)
    tcfg = tsvgp.SVGPConfig(tk.RBF(input_dim=2), 5)
    jp = jsvgp.init_params(cfg, X, noise=0.2, dtype=jnp.float64)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), dtype=torch.float64, device="cpu")
    ref = jcheckgrad(lambda p: jsvgp.elbo(cfg, p, jnp.asarray(X), jnp.asarray(Y)), jp, eps=1e-5, max_coords=80)
    ours = checkgrad(lambda p: tsvgp.elbo(tcfg, p, torch.tensor(X), torch.tensor(Y)), tp, eps=1e-5,
                     max_coords=80)
    assert isinstance(ours, CheckgradResult)
    assert ours.max_rel_err < 3e-4 and ours.passed(3e-4), ours.max_rel_err
    assert ours.analytic.shape == ref.analytic.shape == (2 * 5 + 2 + 1 + 1 + 5 + 5 + 25,)
    np.testing.assert_array_equal(np.isnan(ours.numeric), np.isnan(ref.numeric))
    scale = np.abs(ref.analytic).max()
    np.testing.assert_allclose(ours.analytic, ref.analytic, rtol=0, atol=1e-8 * scale)
    sel = ~np.isnan(ref.numeric)
    np.testing.assert_allclose(ours.numeric[sel], ref.numeric[sel], rtol=0, atol=1e-6 * scale)
