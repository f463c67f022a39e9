"""K3: the RBF Psi2 of each row contracted against the predictive's matrices
on Hopper, without writing Psi2.

    out[t,d] = sum_{m,n} (alpha_d alpha_d^T - W)[m,n] Psi2_t[m,n],
    Psi2_t[m,n] = exp(base[t] - D1[m,n] + E[t,m] + E[t,n] - 1/2 sum_q w[t,q] z[m,q] z[n,q])

with (base, E, D1, w) from :func:`~rgp_tpu_torch.ops.cuda.psi2.rbf_psi2_precompute`,
alpha (M, D) and W (M, M) the sparse posterior's ``alpha`` and
``woodbury_inv``: the moment-matched predictive's quad term minus its trace
term (``inference/collapsed_vi.predict_uncertain``), for every row at once.
The kernel (``rgp_tpu_torch/csrc/psi2_contract.cu``, whose header note says
what bounds it and how it is laid out) is built with K1 and K2 by
:func:`~rgp_tpu_torch.ops.cuda.psi2.build`.

:func:`psi2_contract` is the wrapper: on a CUDA tensor it launches the kernel
(float32) or raises; on a CPU tensor it runs :func:`psi2_contract_plain`, the
same partition of the triangle into element groups, each group's sum taken
in the input's dtype and the groups added in ascending order in float64.
:class:`RBFPsi2Contract` is the ``torch.autograd.Function`` around it, whose
:meth:`~RBFPsi2Contract.vmap` rule folds a vmapped axis into the rows, so a
batch of candidates is one launch; it has no backward (the predictive takes
it only where no gradient is asked for). :func:`rbf_psi2_contract` runs the
precompute and the Function. ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import psi2

__all__ = [
    "psi2_contract",
    "psi2_contract_plain",
    "RBFPsi2Contract",
    "rbf_psi2_contract",
    "element_groups",
    "launches",
]

MAX_D = 4  # kMaxD in psi2_contract.cu: columns of alpha one launch takes; more are cut into launches of 4
_THREADS = 256  # kThreads: a group is a whole number of the block's threads' slots

launches = 0  # times the wrapper launched K3
_lib = None


def _ept(Q, D):
    """Elements a thread takes in a group: as many as the kernel holds in
    registers at Q's compile-time width and D columns (``ept_of`` in
    psi2_contract.cu, which refuses more)."""
    if D == 1:
        return 10 if Q <= 4 else 6 if Q <= 8 else 4 if Q <= 20 else 2 if Q <= 32 else 1
    return 8 if Q <= 4 else 5 if Q <= 8 else 3 if Q <= 20 else 2 if Q <= 32 else 1


def element_groups(M: int, Q: int, D: int):
    """(groups, per_group): the upper triangle's M(M+1)/2 elements, numbered
    row by row, cut into ``groups`` ranges of ``per_group`` elements (the last
    one shorter), as the kernel walks them. The kernel takes the partition
    as arguments and the plain version sums the same groups in the same
    order."""
    n = M * (M + 1) // 2
    groups = psi2._cdiv(n, _THREADS * _ept(Q, D))
    return groups, psi2._cdiv(psi2._cdiv(n, groups), _THREADS) * _THREADS


def _weights(alpha, W, m, n):
    """(elements, D) weights of the upper triangle's elements (m, n):
    alpha_m alpha_n - W[m,m] on the diagonal, 2 alpha_m alpha_n - (W[m,n] +
    W[n,m]) off it, as the kernel forms them."""
    am, an = alpha[m], alpha[n]
    diag = (m == n)[:, None]
    off = 2.0 * (am * an) - (W[m, n] + W[n, m])[:, None]
    return torch.where(diag, am * am - W[m, m][:, None], off)


def psi2_contract_plain(base, E, D1, w, Z, alpha, W):
    """Plain PyTorch version of K3 -> (T, D): per launch's columns (at most 4),
    each element group's sum over its elements in the inputs' dtype, the
    groups added in ascending order in float64, the result in the inputs'
    dtype. Any dtype."""
    T, Q = w.shape
    M, D = Z.shape[0], alpha.shape[1]
    m, n = torch.triu_indices(M, M, device=base.device)
    zz = Z[m] * Z[n]  # (elements, Q)
    d1 = D1[m, n]
    out = torch.zeros((T, D), dtype=torch.float64, device=base.device)
    for j in range(0, D, MAX_D):
        cols = slice(j, min(D, j + MAX_D))
        G = _weights(alpha[:, cols], W, m, n)
        groups, per = element_groups(M, Q, G.shape[1])
        for g in range(groups):
            e = slice(g * per, min(m.numel(), (g + 1) * per))
            c = w @ zz[e].T  # (T, elements)
            logp = ((base[:, None] + E[:, m[e]]) + E[:, n[e]]) - d1[e] - 0.5 * c
            out[:, cols] += (torch.exp(logp) @ G[e]).double()
    return out.to(base.dtype)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(psi2.build()["psi2_contract"]))
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rgp_psi2_contract.argtypes = [vp] * 6 + [cl, vp, vp, cl] + [ci] * 7 + [vp]
        lib.rgp_psi2_contract.restype = ci
        _lib = lib
    return _lib


def _check(base, E, D1, w, Z, alpha, W):
    """Raise unless the arguments are what K3 takes: float32 on one device,
    of matching shapes, dense."""
    T, Q = w.shape
    M, D = Z.shape[0], alpha.shape[-1]
    want = {"base": (T,), "E": (T, M), "D1": (M, M), "w": (T, Q), "Z": (M, Q), "alpha": (M, D), "W": (M, M)}
    args = {"base": base, "E": E, "D1": D1, "w": w, "Z": Z, "alpha": alpha, "W": W}
    for name, x in args.items():
        if x.device != base.device:
            raise ValueError(f"psi2_contract kernel: {name} is on {x.device}, base on {base.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"psi2_contract kernel: the CUDA kernel takes float32, {name} is {x.dtype}")
        if tuple(x.shape) != want[name]:
            raise ValueError(f"psi2_contract kernel: {name} has shape {tuple(x.shape)}, want {want[name]}")
        if not x.is_contiguous():
            raise ValueError(f"psi2_contract kernel: {name} is not contiguous")
    if T < 1 or M < 1 or D < 1 or Q < 1:
        raise ValueError(f"psi2_contract kernel: need T, M, Q, D >= 1; got T={T} M={M} Q={Q} D={D}")


def psi2_contract(base, E, D1, w, Z, alpha, W):
    """sum_{m,n} (alpha_d alpha_d^T - W)[m,n] Psi2_t[m,n] for every row t and
    column d -> (T, D).

    CUDA tensors: launch K3 (float32, dense; one launch for up to 4 columns
    of alpha, one for each 4 more) on the current stream, or raise. CPU
    tensors: the plain version."""
    global launches
    if base.device.type == "cpu":
        return psi2_contract_plain(base, E, D1, w, Z, alpha, W)
    if base.device.type != "cuda":
        raise ValueError(f"psi2_contract: unsupported device {base.device}")
    _check(base, E, D1, w, Z, alpha, W)
    (T, Q), M, D = w.shape, Z.shape[0], alpha.shape[1]
    lib = _load()
    out = torch.empty((T, D), dtype=torch.float32, device=base.device)
    with torch.cuda.device(base.device):
        stream = torch.cuda.current_stream(base.device).cuda_stream
        for j in range(0, D, MAX_D):
            d = min(MAX_D, D - j)
            groups, per = element_groups(M, Q, d)
            err = lib.rgp_psi2_contract(base.data_ptr(), E.data_ptr(), D1.data_ptr(), w.data_ptr(), Z.data_ptr(),
                                        alpha.data_ptr() + 4 * j, D, W.data_ptr(), out.data_ptr() + 4 * j, D,
                                        T, M, Q, d, groups, per, psi2._SMS, stream)
            if err != 0:
                raise RuntimeError(f"psi2_contract kernel: launch refused or failed with CUDA error {err} at "
                                   f"T={T} M={M} Q={Q} D={d} (psi2_contract.cu refuses a Q above its kMaxQ and a "
                                   f"row that does not fit in a block's shared memory)")
            launches += 1
    return out


class RBFPsi2Contract(torch.autograd.Function):
    """``psi2_contract(base, E, D1, w, Z, alpha, W)`` as a Function, for its
    :meth:`vmap` rule: under ``torch.func.vmap`` (a batch of candidates in
    the batched freerun, where alpha and W are shared) the vmapped axis is
    folded into the rows, so the batch is one launch. Where D1, Z, alpha or W
    is batched too, each instance is its own call. It has no backward:
    ``predict_uncertain`` takes it only where no input requires grad or grad
    mode is off."""

    @staticmethod
    def forward(base, E, D1, w, Z, alpha, W):
        return psi2_contract(base, E, D1, w, Z, alpha, W)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("RBFPsi2Contract (K3) has no backward: take gradients of the predictive through its "
                           "materialised path")

    @staticmethod
    def vmap(info, in_dims, base, E, D1, w, Z, alpha, W):
        n = info.batch_size
        xs = psi2._vmapped((base, E, D1, w, Z, alpha, W), in_dims, n)
        if all(d is None for d in (in_dims[2], *in_dims[4:])):
            T = xs[0].shape[1]
            b, e, ww = (x.reshape(n * T, *x.shape[2:]).contiguous() for x in (xs[0], xs[1], xs[3]))
            out = RBFPsi2Contract.apply(b, e, D1, ww, Z, alpha, W)
            return out.unflatten(0, (n, T)), 0
        return torch.stack([RBFPsi2Contract.apply(*(x[i].contiguous() for x in xs)) for i in range(n)]), 0


def rbf_psi2_contract(p, Z, mu, s, alpha, W):
    """``alpha_d^T Psi2_t alpha_d - tr(W Psi2_t)`` for every row of ``mu``
    (T, Q) and ``s`` (T, Q), RBF kernel parameters ``p``, through
    :class:`RBFPsi2Contract`, in float32 -> (T, D)."""
    base, E, D1, w = psi2.rbf_psi2_precompute(p, Z, mu, s)

    def f32(x):
        return x.to(torch.float32).contiguous()

    return RBFPsi2Contract.apply(f32(base), f32(E), f32(D1), f32(w), f32(Z), f32(alpha), f32(W))
