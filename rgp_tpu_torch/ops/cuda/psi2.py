"""K1: the fused RBF Psi2 time sum on Hopper (port of
``rgp_tpu/ops/pallas/psi2.py``, forward only).

    out[m,n] = sum_t exp(base[t] - D1[m,n] + E[t,m] + E[t,n] - 1/2 C[t,m,n]),
    C[t,m,n] = sum_q w[t,q] z[m,q] z[n,q]

with (base, E, D1, w) from :func:`rbf_psi2_precompute`. The CUDA kernel is
``rgp_tpu_torch/csrc/psi2_fwd.cu`` (its header note says what bounds it and
how it is laid out). It is compiled with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` of the checkout at first use and bound with ``ctypes``.

:func:`psi2_time_sum` is the wrapper: on a CUDA tensor it launches the kernel
or raises; on a CPU tensor it runs :func:`psi2_time_sum_plain`, the same
T-split-plus-ordered-reduce arithmetic in plain PyTorch. The backward kernel
(the Pallas ``_psi2_bwd_kernel``) is not ported yet, so :func:`rbf_psi2_sum`
refuses inputs that require grad.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ...params import positive

__all__ = [
    "rbf_psi2_precompute",
    "rbf_psi2_sum",
    "psi2_time_sum",
    "psi2_time_sum_plain",
    "t_split",
    "build",
    "launches",
]

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "psi2_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
MAX_Q = 128  # kMaxQ in the source
_TILE = 16  # kTile in the source
# enough blocks for ~4 per SM of an H100 (132 SMs); more splits only add
# partial traffic and reduce work
_TARGET_BLOCKS = 4 * 132
_MIN_T_PER_SPLIT = 8

launches = 0  # times the wrapper launched the CUDA kernel
_lib = None


def _cdiv(a, b):
    return -(-a // b)


def t_split(T: int, M: int):
    """(n_split, t_per_split): how the T axis is cut across blocks. Shared by
    the kernel and the plain version so both sum in the same order."""
    tiles = _cdiv(M, _TILE) ** 2
    n_split = max(1, min(_cdiv(T, _MIN_T_PER_SPLIT), _cdiv(_TARGET_BLOCKS, tiles)))
    t_per = _cdiv(T, n_split)
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


def psi2_time_sum_plain(base, E, D1, w, Z):
    """Plain PyTorch version of the kernel: per-split partial sums over the
    same T ranges, then summed in ascending split order. Any dtype."""
    T = w.shape[0]
    n_split, t_per = t_split(T, Z.shape[0])
    out = None
    for k in range(n_split):
        sl = slice(k * t_per, min(T, (k + 1) * t_per))
        C = torch.einsum("tq,mq,nq->tmn", w[sl], Z, Z)
        logp = base[sl, None, None] - D1[None] + E[sl, :, None] + E[sl, None, :] - 0.5 * C
        part = torch.exp(logp).sum(0)
        out = part if out is None else out + part
    return out


def build() -> Path:
    """Compile the kernel source (if this exact source is not built yet) and
    return the shared library's path. The ptxas report (registers, shared
    memory, spills) is written beside it with the suffix ``.log``."""
    src = SOURCE.read_bytes()
    out = BUILD_DIR / f"psi2_fwd_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if out.exists():
        return out
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the Psi2 kernel")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(SOURCE),
    ]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rgp_psi2_fwd.argtypes = [vp] * 7 + [ci] * 5 + [vp]
        lib.rgp_psi2_fwd.restype = ci
        lib.rgp_psi2_fwd_max_q.argtypes = []
        lib.rgp_psi2_fwd_max_q.restype = ci
        if lib.rgp_psi2_fwd_max_q() != MAX_Q:
            raise RuntimeError("psi2_fwd.cu and ops/cuda/psi2.py disagree on MAX_Q")
        _lib = lib
    return _lib


def _check(base, E, D1, w, Z):
    T, Q = w.shape
    M = Z.shape[0]
    want = {"base": (T,), "E": (T, M), "D1": (M, M), "w": (T, Q), "Z": (M, Q)}
    dev = base.device
    for name, x in zip(want, (base, E, D1, w, Z)):
        if x.device != dev:
            raise ValueError(f"psi2_time_sum: {name} is on {x.device}, base on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"psi2_time_sum: the CUDA kernel takes float32, {name} is {x.dtype}")
        if tuple(x.shape) != want[name]:
            raise ValueError(f"psi2_time_sum: {name} has shape {tuple(x.shape)}, want {want[name]}")
        if not x.is_contiguous():
            raise ValueError(f"psi2_time_sum: {name} is not contiguous")
    if T < 1 or M < 1 or not 1 <= Q <= MAX_Q:
        raise ValueError(f"psi2_time_sum: need T, M >= 1 and 1 <= Q <= {MAX_Q}; got T={T} M={M} Q={Q}")


def psi2_time_sum(base, E, D1, w, Z):
    """sum_t Psi2_t from the precomputed decomposition -> (M, M).

    CUDA tensors: launch K1 (float32 only) or raise. CPU tensors: the plain
    version."""
    global launches
    if base.device.type == "cpu":
        return psi2_time_sum_plain(base, E, D1, w, Z)
    if base.device.type != "cuda":
        raise ValueError(f"psi2_time_sum: unsupported device {base.device}")
    _check(base, E, D1, w, Z)
    T, Q = w.shape
    M = Z.shape[0]
    n_split, t_per = t_split(T, M)
    lib = _load()
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


def rbf_psi2_sum(p, Z, mu, s):
    """sum_t Psi2_t for the RBF kernel through :func:`psi2_time_sum`, with the
    decomposition in ``mu``'s dtype and the kernel in float32."""
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (p["log_var"], p["log_ls"], Z, mu, s)
    ):
        raise NotImplementedError(
            "gradients through the CUDA Psi2 kernel are not available: its fused "
            "backward kernel is not ported yet"
        )
    base, E, D1, w = rbf_psi2_precompute(p, Z, mu, s)

    def f32(x):
        return x.to(torch.float32).contiguous()

    return psi2_time_sum(f32(base), f32(E), f32(D1), f32(w), f32(Z)).to(mu.dtype)
