"""K1 and K2: the fused RBF Psi2 time sum and its backward on Hopper (port of
``rgp_tpu/ops/pallas/psi2.py``).

    out[m,n] = sum_t exp(base[t] - D1[m,n] + E[t,m] + E[t,n] - 1/2 C[t,m,n]),
    C[t,m,n] = sum_q w[t,q] z[m,q] z[n,q]

with (base, E, D1, w) from :func:`rbf_psi2_precompute`. K1 computes ``out``
(``rgp_tpu_torch/csrc/psi2_fwd.cu``) from the tile pairs of its upper
triangle; K2 computes its VJP with respect to (base, E, D1, w) and the C
term's direct dZ from the cotangent as autograd hands it in
(``rgp_tpu_torch/csrc/psi2_bwd.cu``). Each is one launch a call, and sums its
T ranges in a fixed order inside that launch. Each source's header note says
what bounds it and how it is laid out. Both are compiled with ``nvcc`` for
``sm_90a`` into ``build/kernels/`` of the checkout at first use and bound with
``ctypes``.

:func:`psi2_time_sum` and :func:`psi2_time_sum_bwd` are the wrappers: on a
CUDA tensor they launch the kernel or raise; on a CPU tensor they run
:func:`psi2_time_sum_plain` / :func:`psi2_time_sum_bwd_plain`, the same
partition and ordered reduce in plain PyTorch. :class:`RBFPsi2Sum`
joins them into a ``torch.autograd.Function``; :func:`rbf_psi2_sum` runs the
precompute in torch (autograd chains through it) and the Function in float32.
"""

from __future__ import annotations

import ctypes
import functools
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
    "RBFPsi2Sum",
    "psi2_time_sum",
    "psi2_time_sum_plain",
    "psi2_time_sum_bwd",
    "psi2_time_sum_bwd_plain",
    "t_split",
    "bwd_split",
    "fwd_tile",
    "bwd_plan",
    "build",
    "launches",
    "bwd_launches",
]

CSRC = Path(__file__).resolve().parents[2] / "csrc"
# every CUDA source of the port, built together by :func:`build`; the exp
# probe (``exp_probe.cu``) is the roofline's instrument, loaded by
# :mod:`rgp_tpu_torch.ops.cuda.exp_probe`
SOURCES = {"psi2_fwd": CSRC / "psi2_fwd.cu", "psi2_bwd": CSRC / "psi2_bwd.cu", "exp_probe": CSRC / "exp_probe.cu"}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
MAX_Q = 128  # kMaxQ in both sources
_SMS = 132  # SMs of an H100 SXM: the partitions are planned for it on every device
_FWD_MIN_T = 8  # timesteps a K1 block takes at least
_BWD_TILE_M = 32  # kBM in psi2_bwd.cu: m rows per block
_BWD_STAGE_T = 8  # kWarps in psi2_bwd.cu: timesteps a block takes at a time
_BWD_BLOCKS_PER_SM = 2  # __launch_bounds__ of psi2_bwd.cu for Q <= 32
_MAX_WAVES = 4  # more splits only add partial traffic and reduce work

launches = 0  # times the wrapper launched K1
bwd_launches = 0  # times the wrapper launched K2
_libs = {}
_tickets = {}  # (device, stream) -> the kernels' ticket counters, 0 between launches


def _cdiv(a, b):
    return -(-a // b)


def fwd_tile(Q: int) -> int:
    """K1's output tile edge (``tile_of`` in psi2_fwd.cu): 32 up to Q = 32,
    where each thread owns a 2 x 2 (Q <= 20) or 1 x 2 patch, and 16 above,
    one element a thread."""
    return 32 if Q <= 32 else 16


def _fwd_blocks_per_sm(Q: int) -> int:
    return 2 if Q <= 20 else 1  # blocks_per_sm in psi2_fwd.cu


@functools.lru_cache(maxsize=256)
def _split(T: int, tiles: int, step: int, min_t: int, slots: int):
    """(n_split, t_per): T cut into ranges of t_per timesteps (a multiple of
    ``step``, at least ``min_t``) so that ``tiles * n_split`` blocks fill whole
    waves of ``slots`` resident blocks as nearly as possible, in at most
    ``_MAX_WAVES`` waves; among equals, the fewest ranges."""
    best = None
    for n in range(1, max(1, min(_cdiv(T, min_t), _cdiv(_MAX_WAVES * slots, tiles))) + 1):
        t_per = _cdiv(_cdiv(T, n), step) * step
        blocks = tiles * _cdiv(T, t_per)
        fill = blocks / (_cdiv(blocks, slots) * slots)
        if best is None or fill > best[0]:
            best = (fill, _cdiv(T, t_per), t_per)
    return best[1], best[2]


def t_split(T: int, M: int, Q: int):
    """(n_split, t_per_split): how K1 cuts the T axis across blocks. Shared by
    the kernel and the plain version so both sum in the same order."""
    n = _cdiv(M, fwd_tile(Q))
    return _split(T, n * (n + 1) // 2, 1, _FWD_MIN_T, _SMS * _fwd_blocks_per_sm(Q))


def bwd_split(T: int, M: int):
    """(n_split, t_per_split) for K2: blocks are (m tile, T range), and a T
    range is a whole number of the kernel's 8-timestep stages."""
    slots = _SMS * _BWD_BLOCKS_PER_SM
    return _split(T, _cdiv(M, _BWD_TILE_M), _BWD_STAGE_T, _BWD_STAGE_T, slots)


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


def _upper(out):
    """out's upper triangle mirrored into the lower one: K1 computes the
    elements with m <= n and writes each to both places."""
    return torch.triu(out) + torch.triu(out, 1).T


def psi2_time_sum_plain(base, E, D1, w, Z):
    """Plain PyTorch version of K1: per-split partial sums over the same T
    ranges, summed in ascending split order, then the upper triangle
    mirrored, as the kernel's symmetric tile plan writes it. Any dtype."""
    T, Q = w.shape
    n_split, t_per = t_split(T, Z.shape[0], Q)
    parts = [_probabilities(base[sl], E[sl], D1, w[sl], Z).sum(0)
             for sl in (slice(k * t_per, min(T, (k + 1) * t_per)) for k in range(n_split))]
    return _upper(_ordered_sum(parts))


def _ordered_sum(parts):
    """parts[0] + parts[1] + ... in this order (the kernels' reduce order)."""
    out = parts[0]
    for x in parts[1:]:
        out = out + x
    return out


def psi2_time_sum_bwd_plain(base, E, D1, w, Z, g, out):
    """Plain PyTorch version of K2 -> (dbase (T,), dE (T,M), dD1 (M,M), dw
    (T,Q), dzC (M,Q)) for the cotangent ``g`` of ``out = psi2_time_sum(...)``,
    with Gs = g + g^T formed as the kernel forms it; dD1 is the VJP of a
    forward that reads D1's upper triangle only. The same partials as the
    kernel: dbase and dw per 32-row m tile, dzC per T range of
    :func:`bwd_split`, each summed in ascending order. Any dtype and any
    strides of ``g``."""
    T, Q = w.shape
    M = Z.shape[0]
    n_split, t_per = bwd_split(T, M)
    Gs = g + g.T
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
    # K1 reads D1 only where m <= n (it mirrors its upper triangle)
    upper = torch.triu(torch.ones_like(out)) - 0.5 * torch.eye(M, dtype=out.dtype, device=out.device)
    dD1 = -(out * Gs) * upper
    return torch.cat(dbase), torch.cat(dE), dD1, torch.cat(dw), _ordered_sum(dzc_parts)


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
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "psi2_fwd":
            lib.rgp_psi2_fwd.argtypes = [vp] * 8 + [ci] * 6 + [vp]
            lib.rgp_psi2_fwd.restype = ci
            consts = {"rgp_psi2_fwd_max_q": MAX_Q}
            for fn, want in (("rgp_psi2_fwd_tile", fwd_tile), ("rgp_psi2_fwd_blocks_per_sm", _fwd_blocks_per_sm)):
                getattr(lib, fn).argtypes = [ci]
                getattr(lib, fn).restype = ci
                if any(getattr(lib, fn)(q) != want(q) for q in range(1, MAX_Q + 1)):
                    raise RuntimeError(f"psi2_fwd.cu and ops/cuda/psi2.py disagree on {fn}")
        else:
            lib.rgp_psi2_bwd.argtypes = [vp] * 6 + [cl] * 2 + [vp] * 10 + [ci] * 6 + [vp]
            lib.rgp_psi2_bwd.restype = ci
            lib.rgp_psi2_bwd_plan.argtypes = [ci, ci, vp]
            lib.rgp_psi2_bwd_plan.restype = ci
            consts = {"rgp_psi2_bwd_max_q": MAX_Q, "rgp_psi2_bwd_tile_m": _BWD_TILE_M}
        for fn, want in consts.items():
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ci
            if getattr(lib, fn)() != want:
                raise RuntimeError(f"{name}.cu and ops/cuda/psi2.py disagree on {fn}")
        _libs[name] = lib
    return _libs[name]


def bwd_plan(M: int, Q: int):
    """K2's shared-memory plan on the current CUDA device: ``{"resident":
    whether the block's Z, D1 and Gs columns are staged once, "n_cols": the
    columns staged at a time, "ring": stage buffers, "smem_bytes": dynamic
    shared memory a block}``."""
    out = (ctypes.c_int * 3)()
    err = _load("psi2_bwd").rgp_psi2_bwd_plan(M, Q, out)
    if err != 0:
        raise RuntimeError(f"psi2_bwd plan failed with CUDA error {err}")
    return {"resident": out[0] >= M, "n_cols": out[0], "ring": out[1], "smem_bytes": out[2]}


def _tickets_for(device, n):
    """The ticket counters for kernels on ``device``'s current stream: zero
    once when made, and each launch leaves them zero."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


def _check(base, E, D1, w, Z, g=None, out=None):
    T, Q = w.shape
    M = Z.shape[0]
    want = {"base": (T,), "E": (T, M), "D1": (M, M), "w": (T, Q), "Z": (M, Q)}
    args = {"base": base, "E": E, "D1": D1, "w": w, "Z": Z}
    if g is not None:
        want["g"] = want["out"] = (M, M)
        args["g"], args["out"] = g, out
    dev = base.device
    for name, x in args.items():
        if x.device != dev:
            raise ValueError(f"psi2 kernel: {name} is on {x.device}, base on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"psi2 kernel: the CUDA kernels take float32, {name} is {x.dtype}")
        if tuple(x.shape) != want[name]:
            raise ValueError(f"psi2 kernel: {name} has shape {tuple(x.shape)}, want {want[name]}")
        # g is read through its strides; every other input densely
        if name != "g" and not x.is_contiguous():
            raise ValueError(f"psi2 kernel: {name} is not contiguous")
    if T < 1 or M < 1 or not 1 <= Q <= MAX_Q:
        raise ValueError(f"psi2 kernel: need T, M >= 1 and 1 <= Q <= {MAX_Q}; got T={T} M={M} Q={Q}")


def _cuda_device(fn, base):
    if base.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {base.device}")


def psi2_time_sum(base, E, D1, w, Z):
    """sum_t Psi2_t from the precomputed decomposition -> (M, M), exactly
    symmetric.

    CUDA tensors: launch K1 (float32 only, one launch) or raise. CPU tensors:
    the plain version."""
    global launches
    if base.device.type == "cpu":
        return psi2_time_sum_plain(base, E, D1, w, Z)
    _cuda_device("psi2_time_sum", base)
    _check(base, E, D1, w, Z)
    T, Q = w.shape
    M = Z.shape[0]
    n_split, t_per = t_split(T, M, Q)
    B = fwd_tile(Q)
    n_pairs = _cdiv(M, B) * (_cdiv(M, B) + 1) // 2
    lib = _load("psi2_fwd")
    with torch.cuda.device(base.device):
        partial = torch.empty((n_split, n_pairs, B, B), dtype=torch.float32, device=base.device)
        out = torch.empty((M, M), dtype=torch.float32, device=base.device)
        tickets = _tickets_for(base.device, n_pairs)
        err = lib.rgp_psi2_fwd(
            base.data_ptr(), E.data_ptr(), D1.data_ptr(), w.data_ptr(), Z.data_ptr(),
            partial.data_ptr(), out.data_ptr(), tickets.data_ptr(), tickets.numel(), T, M, Q,
            n_split, t_per, torch.cuda.current_stream(base.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"psi2_fwd kernel launch failed with CUDA error {err}")
    launches += 1
    return out


def psi2_time_sum_bwd(base, E, D1, w, Z, g, out):
    """K2: the VJP of ``out = psi2_time_sum(base, E, D1, w, Z)`` for its
    cotangent ``g`` -> (dbase (T,), dE (T,M), dD1 (M,M), dw (T,Q), dzC
    (M,Q)), dzC being the C term's direct dZ. ``g`` may have any strides
    (dense, transposed, expanded); the kernel forms ``g + g^T`` itself.

    CUDA tensors: launch K2 (float32 only, one launch) or raise. CPU
    tensors: the plain version."""
    global bwd_launches
    if base.device.type == "cpu":
        return psi2_time_sum_bwd_plain(base, E, D1, w, Z, g, out)
    _cuda_device("psi2_time_sum_bwd", base)
    _check(base, E, D1, w, Z, g, out)
    T, Q = w.shape
    M = Z.shape[0]
    n_split, t_per = bwd_split(T, M)
    m_tiles = _cdiv(M, _BWD_TILE_M)
    lib = _load("psi2_bwd")
    with torch.cuda.device(base.device):
        def empty(*shape):
            return torch.empty(shape, dtype=torch.float32, device=base.device)

        dbase, dE, dD1, dw, dzc = empty(T), empty(T, M), empty(M, M), empty(T, Q), empty(M, Q)
        part_dbase, part_dw, part_dzc = empty(m_tiles, T), empty(m_tiles, T, Q), empty(n_split, M, Q)
        tickets = _tickets_for(base.device, n_split + m_tiles)
        err = lib.rgp_psi2_bwd(
            base.data_ptr(), E.data_ptr(), D1.data_ptr(), w.data_ptr(), Z.data_ptr(),
            g.data_ptr(), g.stride(0), g.stride(1), out.data_ptr(),
            dbase.data_ptr(), dE.data_ptr(), dD1.data_ptr(), dw.data_ptr(), dzc.data_ptr(),
            part_dbase.data_ptr(), part_dw.data_ptr(), part_dzc.data_ptr(), tickets.data_ptr(),
            tickets.numel(), T, M, Q, n_split, t_per, torch.cuda.current_stream(base.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"psi2_bwd kernel launch failed with CUDA error {err}")
    bwd_launches += 1
    return dbase, dE, dD1, dw, dzc


class RBFPsi2Sum(torch.autograd.Function):
    """``psi2_time_sum(base, E, D1, w, Z)`` with K2 as its whole backward (the
    counterpart of the JAX package's ``custom_vjp`` ``rbf_psi2_sum_pallas``):
    one launch gives every input's gradient, whatever the cotangent's strides.

    The inputs are treated as independent: ``Z`` here is only the C term's
    factor, and autograd chains (base, E, D1, w) back through
    :func:`rbf_psi2_precompute` by itself. K2 has no derivative of its own,
    so the Function is differentiable once: a backward that builds a graph
    (``create_graph=True``, as every second derivative does) raises. A
    Hessian takes the plain path, ``psi_statistics(prefer="scan")``.
    ``torch.autograd.function.once_differentiable`` alone is not enough: its
    error node hangs off detached copies, so ``torch.autograd.grad`` with
    ``inputs=`` prunes it and returns a second derivative that silently
    lacks every path through K2.

    Under ``torch.func.vmap`` (a batch of sampler chains) the :meth:`vmap`
    rule applies the Function once per batch instance: one K1 launch each, and
    one K2 launch each in the backward. ``Z`` may be batched or shared."""

    @staticmethod
    def forward(base, E, D1, w, Z):
        return psi2_time_sum(base, E, D1, w, Z)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output)

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            raise RuntimeError("RBFPsi2Sum (K1/K2) is differentiable once; take second derivatives "
                               "through the plain path (psi_statistics(prefer='scan'))")
        base, E, D1, w, Z, out = ctx.saved_tensors
        return psi2_time_sum_bwd(base, E, D1, w, Z, g, out)

    @staticmethod
    def vmap(info, in_dims, *args):
        def instance(i):
            return [x if d is None else x.select(d, i) for x, d in zip(args, in_dims)]

        outs = [RBFPsi2Sum.apply(*(x.contiguous() for x in instance(i))) for i in range(info.batch_size)]
        return torch.stack(outs), 0


def rbf_psi2_sum(p, Z, mu, s):
    """sum_t Psi2_t for the RBF kernel through :class:`RBFPsi2Sum`, with the
    decomposition in ``mu``'s dtype and the kernels in float32."""
    base, E, D1, w = rbf_psi2_precompute(p, Z, mu, s)

    def f32(x):
        return x.to(torch.float32).contiguous()

    return RBFPsi2Sum.apply(f32(base), f32(E), f32(D1), f32(w), f32(Z)).to(mu.dtype)
