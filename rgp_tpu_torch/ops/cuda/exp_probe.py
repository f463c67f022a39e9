"""The exp-rate probe of the roofline (``rgp_tpu_torch/csrc/exp_probe.cu``):
``y = x`` passed ``k`` times through ``x -> exp(x * 1e-6)``, one kernel that
keeps the chain in registers, so its time is the exp's and not the memory's.
It is a measuring instrument (:func:`rgp_tpu_torch.bench.roofline.calibrate`),
not a port of a TPU kernel.

:func:`exp_chain` launches it on a float32 CUDA tensor or raises; on a CPU
tensor it runs :func:`exp_chain_plain`, the same chain in eager PyTorch. The
library is built with K1 and K2 by :func:`rgp_tpu_torch.ops.cuda.psi2.build`.
"""

from __future__ import annotations

import ctypes

import torch

from .psi2 import build

__all__ = ["exp_chain", "exp_chain_plain", "launches"]

launches = 0  # times the wrapper launched the probe
_lib = None


def exp_chain_plain(x, k: int):
    """``k`` links of ``x -> exp(x * 1e-6)`` in eager PyTorch (one kernel a
    link on the card), in ``x``'s dtype."""
    for _ in range(k):
        x = torch.exp(x * 1e-6)
    return x


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()["exp_probe"]))
        lib.rgp_exp_probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_void_p]
        lib.rgp_exp_probe.restype = ctypes.c_int
        _lib = lib
    return _lib


def exp_chain(x, k: int):
    """The probe on ``x``: CUDA float32 tensors launch the kernel (one launch)
    or raise; CPU tensors run :func:`exp_chain_plain`."""
    global launches
    if x.device.type == "cpu":
        return exp_chain_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"exp_chain: unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError(f"exp_chain: the probe takes a contiguous float32 tensor, got {x.dtype}")
    if k < 0:
        raise ValueError(f"exp_chain: k must be >= 0, got {k}")
    lib = _load()
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        err = lib.rgp_exp_probe(x.data_ptr(), y.data_ptr(), x.numel(), k,
                                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"exp_probe kernel launch failed with CUDA error {err}")
    launches += 1
    return y
