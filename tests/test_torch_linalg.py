"""rgp_tpu_torch.params / linalg against rgp_tpu.params / linalg, f64 on CPU.

Tolerances: the transforms are the same closed forms (rtol 1e-15, last-ulp
level); the jitter ladder must pick the same rung (jitter equal at 1e-15) and
reproduce XLA's all-NaN factor on failure; LAPACK solves differ only by
rounding (rtol 1e-12).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgp_tpu import linalg as jl
from rgp_tpu import params as jp
from rgp_tpu_torch import linalg as tl
from rgp_tpu_torch import params as tp


@pytest.mark.parametrize("fn", ["softplus", "positive"])
def test_softplus_matches_jax(rng, fn):
    x = np.concatenate([30.0 * rng.standard_normal(500), [-800.0, -30.0, 0.0, 19.9, 20.1, 40.0, 800.0]])
    ours = getattr(tp, fn)(torch.tensor(x)).numpy()
    ref = np.asarray(getattr(jp, fn)(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, rtol=1e-15, atol=0)


def test_softplus_inv_matches_jax(rng):
    y = np.exp(rng.uniform(-10, 5, 300))
    np.testing.assert_allclose(
        tp.softplus_inv(torch.tensor(y)).numpy(), np.asarray(jp.softplus_inv(jnp.asarray(y))),
        rtol=1e-12,
    )
    ours = tp.np_positive_inv(y, torch.float32, "cpu").numpy()
    np.testing.assert_array_equal(ours, np.asarray(jp.np_positive_inv(y, jnp.float32)))


def _spd_with_min_eig(rng, M, lam_min):
    """Symmetric matrix with mean diagonal ~1 and smallest eigenvalue lam_min."""
    Q, _ = np.linalg.qr(rng.standard_normal((M, M)))
    lam = np.concatenate([[lam_min], rng.uniform(0.5, 1.5, M - 1)])
    return (Q * lam) @ Q.T


# smallest eigenvalue -> expected rung of jitter0 * mean(diag): a healthy
# matrix (x1), one that needs x1e3, one past x1e3 (blind x1e7 rescue), and one
# no rung can rescue (lower triangle of the final factor all NaN, as in XLA)
@pytest.mark.parametrize("lam_min,rung", [
    (0.3, 1.0), (-3e-5, 1e3), (-5e-3, 1e7), (-5.0, 1e7),
])
def test_jitchol_rung_and_nan_match_jax(rng, lam_min, rung):
    A = _spd_with_min_eig(rng, 8, lam_min)
    jitter0 = 1e-6
    L, jit = tl.jitchol_with_jitter(torch.tensor(A), jitter0=jitter0)
    Lj, jitj = jl.jitchol_with_jitter(jnp.asarray(A), jitter0=jitter0)
    scale = np.mean(np.diag(A))
    np.testing.assert_allclose(float(jit), rung * jitter0 * scale, rtol=1e-15)
    np.testing.assert_allclose(float(jit), float(jitj), rtol=1e-15)
    L, Lj = L.numpy(), np.asarray(Lj)
    if lam_min == -5.0:
        assert np.isnan(L[np.tril_indices(8)]).all()
        np.testing.assert_array_equal(np.isnan(L), np.isnan(Lj))
    else:
        assert np.isfinite(L).all()
        np.testing.assert_allclose(L, Lj, rtol=1e-12, atol=1e-14)


def test_jitchol_nan_input_fails_like_jax():
    """A NaN input fails in both packages; the port's lower triangle is all NaN
    (LAPACK in the JAX package propagates NaN only into the rows it reaches)."""
    A = np.eye(4)
    A[1, 2] = A[2, 1] = np.nan
    L, jit = tl.jitchol_with_jitter(torch.tensor(A))
    Lj, jitj = jl.jitchol_with_jitter(jnp.asarray(A))
    assert np.isnan(L.numpy()[np.tril_indices(4)]).all()
    assert np.isnan(np.asarray(Lj)).any()
    np.testing.assert_allclose(float(jit), float(jitj), rtol=1e-15)


@pytest.mark.parametrize("trans", [False, True])
def test_solve_triangular_matches_jax(rng, trans):
    L = np.tril(rng.standard_normal((7, 7))) + 4 * np.eye(7)
    B = rng.standard_normal((7, 3))
    ours = tl.solve_triangular(torch.tensor(L), torch.tensor(B), trans=trans).numpy()
    ref = np.asarray(jl.solve_triangular(jnp.asarray(L), jnp.asarray(B), trans=trans))
    np.testing.assert_allclose(ours, ref, rtol=1e-12)


def test_cho_solve_and_logdet_match_jax(rng):
    A = _spd_with_min_eig(rng, 9, 0.2)
    B = rng.standard_normal((9, 2))
    L = tl.jitchol(torch.tensor(A))
    Lj = jl.jitchol(jnp.asarray(A))
    np.testing.assert_allclose(
        tl.cho_solve(L, torch.tensor(B)).numpy(), np.asarray(jl.cho_solve(Lj, jnp.asarray(B))),
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        float(tl.log_det_from_chol(L)), float(jl.log_det_from_chol(Lj)), rtol=1e-12
    )
    np.testing.assert_allclose(
        tl.hdot(torch.tensor(A), torch.tensor(B)).numpy(), A @ B, rtol=1e-12
    )


def test_tf32_is_pinned_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_log_jacobian_softplus_matches_jax(rng):
    x = 10.0 * rng.standard_normal((7, 3))
    np.testing.assert_allclose(float(tp.log_jacobian_softplus(torch.tensor(x))),
                               float(jp.log_jacobian_softplus(jnp.asarray(x))), rtol=1e-13)


def test_tdot_and_pdinv_match_jax(rng):
    A = rng.standard_normal((2, 6, 4))
    np.testing.assert_allclose(tl.tdot(torch.tensor(A)).numpy(), np.asarray(jl.tdot(jnp.asarray(A))), rtol=1e-13)
    S = np.stack([_spd_with_min_eig(rng, 6, 1e-3) for _ in range(2)])
    for a, b in zip(tl.pdinv(torch.tensor(S)), jl.pdinv(jnp.asarray(S))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("transpose", ["left", "right"])
def test_backsub_both_sides_matches_jax(rng, transpose):
    L = np.linalg.cholesky(_spd_with_min_eig(rng, 6, 0.1))
    X = rng.standard_normal((6, 6))
    ours = tl.backsub_both_sides(torch.tensor(L), torch.tensor(X), transpose=transpose).numpy()
    ref = np.asarray(jl.backsub_both_sides(jnp.asarray(L), jnp.asarray(X), transpose=transpose))
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-13)
    with pytest.raises(ValueError):
        tl.backsub_both_sides(torch.tensor(L), torch.tensor(X), transpose="both")


@pytest.mark.parametrize("dtypes", [(torch.float64, jnp.float64), (torch.float32, jnp.float32),
                                    (torch.bfloat16, jnp.bfloat16)], ids=["f64", "f32", "bf16"])
def test_default_jitter_matches_jax(dtypes):
    assert tl.default_jitter(dtypes[0]) == jl.default_jitter(dtypes[1])
