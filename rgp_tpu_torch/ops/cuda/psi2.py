"""K1 and K2: the fused RBF Psi2 time sum and its backward on Hopper (port of
``rgp_tpu/ops/pallas/psi2.py``).

    out[m,n] = sum_t exp(base[t] - D1[m,n] + E[t,m] + E[t,n] - 1/2 C[t,m,n]),
    C[t,m,n] = sum_q w[t,q] z[m,q] z[n,q]

with (base, E, D1, w) from :func:`rbf_psi2_precompute`. K1 computes ``out``
(``rgp_tpu_torch/csrc/psi2_fwd.cu``); K2 computes its VJP with respect to
(base, E, w) and the C term's direct dZ from the symmetrized cotangent
(``rgp_tpu_torch/csrc/psi2_bwd.cu``). Each source's header note says what
bounds it and how it is laid out. Both are compiled with ``nvcc`` for
``sm_90a`` into ``build/kernels/`` of the checkout at first use and bound with
``ctypes``.

:func:`psi2_time_sum` and :func:`psi2_time_sum_bwd` are the wrappers: on a
CUDA tensor they launch the kernel or raise; on a CPU tensor they run
:func:`psi2_time_sum_plain` / :func:`psi2_time_sum_bwd_plain`, the same
split-plus-ordered-reduce arithmetic in plain PyTorch. :class:`RBFPsi2Sum`
joins them into a ``torch.autograd.Function``; :func:`rbf_psi2_sum` runs the
precompute in torch (autograd chains through it) and the Function in float32.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable

from ...params import positive

__all__ = [
    "rbf_psi2_precompute",
    "rbf_psi2_sum",
    "RBFPsi2Sum",
    "psi2_time_sum",
    "psi2_time_sum_plain",
    "psi2_time_sum_bwd",
    "psi2_time_sum_bwd_plain",
    "t_split",
    "bwd_split",
    "build",
    "launches",
    "bwd_launches",
]

CSRC = Path(__file__).resolve().parents[2] / "csrc"
SOURCES = {"psi2_fwd": CSRC / "psi2_fwd.cu", "psi2_bwd": CSRC / "psi2_bwd.cu"}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
MAX_Q = 128  # kMaxQ in both sources
_TILE = 16  # kTile in psi2_fwd.cu
_BWD_TILE_M = 32  # kBM in psi2_bwd.cu: m rows per block
_BWD_STAGE_T = 8  # kWarps in psi2_bwd.cu: timesteps a block takes at a time
# enough blocks for ~4 per SM of an H100 (132 SMs); more splits only add
# partial traffic and reduce work
_TARGET_BLOCKS = 4 * 132
_MIN_T_PER_SPLIT = 8

launches = 0  # times the wrapper launched K1
bwd_launches = 0  # times the wrapper launched K2
_libs = {}


def _cdiv(a, b):
    return -(-a // b)


def t_split(T: int, M: int):
    """(n_split, t_per_split): how K1 cuts the T axis across blocks. Shared by
    the kernel and the plain version so both sum in the same order."""
    tiles = _cdiv(M, _TILE) ** 2
    n_split = max(1, min(_cdiv(T, _MIN_T_PER_SPLIT), _cdiv(_TARGET_BLOCKS, tiles)))
    t_per = _cdiv(T, n_split)
    return _cdiv(T, t_per), t_per


def bwd_split(T: int, M: int):
    """(n_split, t_per_split) for K2: blocks are (m tile, T range), and a T
    range is a whole number of the kernel's 8-timestep stages."""
    m_tiles = _cdiv(M, _BWD_TILE_M)
    n_split = max(1, min(_cdiv(T, _BWD_STAGE_T), _cdiv(_TARGET_BLOCKS, m_tiles)))
    t_per = _cdiv(_cdiv(T, n_split), _BWD_STAGE_T) * _BWD_STAGE_T
    return _cdiv(T, t_per), t_per


def rbf_psi2_precompute(p, Z, mu, s):
    """(base (T,), E (T,M), D1 (M,M), w (T,Q)) of the Psi2 decomposition."""
    var = positive(p["log_var"])
    ls = positive(p["log_ls"])
    l2 = ls * ls
    w = 1.0 / (l2 + 2.0 * s)
    base = (
        2.0 * torch.log(var)
        - 0.5 * torch.log1p(2.0 * s / l2).sum(-1)
        - (w * mu * mu).sum(-1)
    )
    Zs = Z / (2.0 * ls)
    zz = (Zs * Zs).sum(-1)
    D1 = zz[:, None] + zz[None, :] - 2.0 * torch.matmul(Zs, Zs.T)
    A = torch.matmul(w * mu, Z.T)
    B = torch.matmul(w, (Z * Z).T)
    E = A - 0.25 * B
    return base, E, D1, w


def _probabilities(base, E, D1, w, Z):
    """P[t,m,n] for a range of timesteps, materialized."""
    C = torch.einsum("tq,mq,nq->tmn", w, Z, Z)
    return torch.exp(base[:, None, None] - D1[None] + E[:, :, None] + E[:, None, :] - 0.5 * C)


def psi2_time_sum_plain(base, E, D1, w, Z):
    """Plain PyTorch version of K1: per-split partial sums over the same T
    ranges, then summed in ascending split order. Any dtype."""
    T = w.shape[0]
    n_split, t_per = t_split(T, Z.shape[0])
    out = None
    for k in range(n_split):
        sl = slice(k * t_per, min(T, (k + 1) * t_per))
        part = _probabilities(base[sl], E[sl], D1, w[sl], Z).sum(0)
        out = part if out is None else out + part
    return out


def _ordered_sum(parts):
    """parts[0] + parts[1] + ... in this order (the kernels' reduce order)."""
    out = parts[0]
    for x in parts[1:]:
        out = out + x
    return out


def psi2_time_sum_bwd_plain(base, E, D1, w, Z, Gs):
    """Plain PyTorch version of K2 -> (dbase (T,), dE (T,M), dw (T,Q), dzC
    (M,Q)). The same partials as the kernel: dbase and dw per 32-row m tile,
    dzC per T range of :func:`bwd_split`, each summed in ascending order. Any
    dtype."""
    T, Q = w.shape
    M = Z.shape[0]
    n_split, t_per = bwd_split(T, M)
    tiles = [slice(j, min(M, j + _BWD_TILE_M)) for j in range(0, M, _BWD_TILE_M)]
    dbase, dE, dw, dzc_parts = [], [], [], []
    for k in range(n_split):
        sl = slice(k * t_per, min(T, (k + 1) * t_per))
        pgs = _probabilities(base[sl], E[sl], D1, w[sl], Z) * Gs[None]
        de = pgs.sum(2)  # (t, M)
        S = torch.einsum("tmn,nq->tmq", pgs, Z)
        dE.append(de)
        dbase.append(_ordered_sum([0.5 * de[:, ms].sum(1) for ms in tiles]))
        dw.append(_ordered_sum([-0.25 * torch.einsum("mq,tmq->tq", Z[ms], S[:, ms]) for ms in tiles]))
        dzc_parts.append(-0.5 * torch.einsum("tq,tmq->mq", w[sl], S))
    return torch.cat(dbase), torch.cat(dE), torch.cat(dw), _ordered_sum(dzc_parts)


def build():
    """Compile each kernel source that is not built yet, all nvcc runs at
    once, and return ``{name: shared library path}``. Each library is keyed
    by a hash of its source; the ptxas report (registers, shared memory,
    spills) is written beside it with the suffix ``.log``."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    outs, jobs = {}, {}
    for name, src in SOURCES.items():
        out = BUILD_DIR / f"{name}_{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so"
        outs[name] = out
        if out.exists():
            continue
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the Psi2 kernels")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(src),
        ]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs[name] = (proc, tmp)
    errors = []
    for name, (proc, tmp) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {SOURCES[name].name} ({proc.returncode}):\n{stderr}")
            continue
        outs[name].with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, outs[name])  # atomic: a concurrent build never loads a partial file
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def _load(name):
    if name not in _libs:
        lib = ctypes.CDLL(str(build()[name]))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        if name == "psi2_fwd":
            lib.rgp_psi2_fwd.argtypes = [vp] * 7 + [ci] * 5 + [vp]
            lib.rgp_psi2_fwd.restype = ci
            consts = {"rgp_psi2_fwd_max_q": MAX_Q}
        else:
            lib.rgp_psi2_bwd.argtypes = [vp] * 13 + [ci] * 5 + [vp]
            lib.rgp_psi2_bwd.restype = ci
            consts = {"rgp_psi2_bwd_max_q": MAX_Q, "rgp_psi2_bwd_tile_m": _BWD_TILE_M}
        for fn, want in consts.items():
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ci
            if getattr(lib, fn)() != want:
                raise RuntimeError(f"{name}.cu and ops/cuda/psi2.py disagree on {fn}")
        _libs[name] = lib
    return _libs[name]


def _check(base, E, D1, w, Z, Gs=None):
    T, Q = w.shape
    M = Z.shape[0]
    want = {"base": (T,), "E": (T, M), "D1": (M, M), "w": (T, Q), "Z": (M, Q)}
    args = [base, E, D1, w, Z]
    if Gs is not None:
        want["Gs"] = (M, M)
        args.append(Gs)
    dev = base.device
    for name, x in zip(want, args):
        if x.device != dev:
            raise ValueError(f"psi2 kernel: {name} is on {x.device}, base on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"psi2 kernel: the CUDA kernels take float32, {name} is {x.dtype}")
        if tuple(x.shape) != want[name]:
            raise ValueError(f"psi2 kernel: {name} has shape {tuple(x.shape)}, want {want[name]}")
        if not x.is_contiguous():
            raise ValueError(f"psi2 kernel: {name} is not contiguous")
    if T < 1 or M < 1 or not 1 <= Q <= MAX_Q:
        raise ValueError(f"psi2 kernel: need T, M >= 1 and 1 <= Q <= {MAX_Q}; got T={T} M={M} Q={Q}")


def _cuda_device(fn, base):
    if base.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {base.device}")


def psi2_time_sum(base, E, D1, w, Z):
    """sum_t Psi2_t from the precomputed decomposition -> (M, M).

    CUDA tensors: launch K1 (float32 only) or raise. CPU tensors: the plain
    version."""
    global launches
    if base.device.type == "cpu":
        return psi2_time_sum_plain(base, E, D1, w, Z)
    _cuda_device("psi2_time_sum", base)
    _check(base, E, D1, w, Z)
    T, Q = w.shape
    M = Z.shape[0]
    n_split, t_per = t_split(T, M)
    lib = _load("psi2_fwd")
    with torch.cuda.device(base.device):
        partial = torch.empty((n_split, M, M), dtype=torch.float32, device=base.device)
        out = torch.empty((M, M), dtype=torch.float32, device=base.device)
        err = lib.rgp_psi2_fwd(
            base.data_ptr(), E.data_ptr(), D1.data_ptr(), w.data_ptr(), Z.data_ptr(),
            partial.data_ptr(), out.data_ptr(), T, M, Q, n_split, t_per,
            torch.cuda.current_stream(base.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"psi2_fwd kernel launch failed with CUDA error {err}")
    launches += 1
    return out


def psi2_time_sum_bwd(base, E, D1, w, Z, Gs):
    """K2: the VJP of :func:`psi2_time_sum` with respect to (base, E, w) and
    the C term's direct dZ, for the symmetrized cotangent ``Gs = G + G^T``
    -> (dbase (T,), dE (T,M), dw (T,Q), dzC (M,Q)). (dD1 is ``-out * G`` and
    needs no kernel.)

    CUDA tensors: launch K2 (float32 only) or raise. CPU tensors: the plain
    version."""
    global bwd_launches
    if base.device.type == "cpu":
        return psi2_time_sum_bwd_plain(base, E, D1, w, Z, Gs)
    _cuda_device("psi2_time_sum_bwd", base)
    _check(base, E, D1, w, Z, Gs)
    T, Q = w.shape
    M = Z.shape[0]
    n_split, t_per = bwd_split(T, M)
    m_tiles = _cdiv(M, _BWD_TILE_M)
    lib = _load("psi2_bwd")
    with torch.cuda.device(base.device):
        def empty(*shape):
            return torch.empty(shape, dtype=torch.float32, device=base.device)

        dbase, dE, dw, dzc = empty(T), empty(T, M), empty(T, Q), empty(M, Q)
        part_dbase, part_dw, part_dzc = empty(m_tiles, T), empty(m_tiles, T, Q), empty(n_split, M, Q)
        err = lib.rgp_psi2_bwd(
            base.data_ptr(), E.data_ptr(), D1.data_ptr(), w.data_ptr(), Z.data_ptr(), Gs.data_ptr(),
            dbase.data_ptr(), dE.data_ptr(), dw.data_ptr(), dzc.data_ptr(),
            part_dbase.data_ptr(), part_dw.data_ptr(), part_dzc.data_ptr(),
            T, M, Q, n_split, t_per, torch.cuda.current_stream(base.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"psi2_bwd kernel launch failed with CUDA error {err}")
    bwd_launches += 1
    return dbase, dE, dw, dzc


class RBFPsi2Sum(torch.autograd.Function):
    """``psi2_time_sum(base, E, D1, w, Z)`` with K2 as its backward (the
    counterpart of the JAX package's ``custom_vjp`` ``rbf_psi2_sum_pallas``).

    The inputs are treated as independent: ``Z`` here is only the C term's
    factor, and autograd chains (base, E, D1, w) back through
    :func:`rbf_psi2_precompute` by itself."""

    @staticmethod
    def forward(ctx, base, E, D1, w, Z):
        out = psi2_time_sum(base, E, D1, w, Z)
        ctx.save_for_backward(base, E, D1, w, Z, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        base, E, D1, w, Z, out = ctx.saved_tensors
        # a fresh dense tensor: autograd may hand in an expanded or strided g
        Gs = (g + g.T).to(base.dtype).contiguous()
        dbase, dE, dw, dzc = psi2_time_sum_bwd(base, E, D1, w, Z, Gs)
        return dbase, dE, -(out * g), dw, dzc


def rbf_psi2_sum(p, Z, mu, s):
    """sum_t Psi2_t for the RBF kernel through :class:`RBFPsi2Sum`, with the
    decomposition in ``mu``'s dtype and the kernels in float32."""
    base, E, D1, w = rbf_psi2_precompute(p, Z, mu, s)

    def f32(x):
        return x.to(torch.float32).contiguous()

    return RBFPsi2Sum.apply(f32(base), f32(E), f32(D1), f32(w), f32(Z)).to(mu.dtype)
