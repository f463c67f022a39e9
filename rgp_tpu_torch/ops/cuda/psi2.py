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

The batched forms take a leading batch axis of instances (sampler chains,
particles, restarts) in one launch, the counterpart of ``pallas_call``'s
batching rule under ``jax.vmap``: :func:`psi2_time_sum_batched`,
:func:`psi2_time_sum_bwd_batched` (plain versions
:func:`psi2_time_sum_batched_plain`, :func:`psi2_time_sum_bwd_batched_plain`:
the single ones per instance) and the Function :class:`RBFPsi2SumBatched`,
which :class:`RBFPsi2Sum`'s vmap rule calls. Each instance keeps a single
call's plan, so its bits are a single launch's. A batch larger than the
grid's z limit or :data:`_MAX_WORKSPACE` bytes of scratch is cut into
several launches, each counted.
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
    "psi2_time_sum_batched",
    "psi2_time_sum_batched_plain",
    "psi2_time_sum_bwd_batched",
    "psi2_time_sum_bwd_batched_plain",
    "RBFPsi2SumBatched",
    "t_split",
    "bwd_split",
    "fwd_tile",
    "bwd_plan",
    "build",
    "launches",
    "bwd_launches",
]

CSRC = Path(__file__).resolve().parents[2] / "csrc"
# every CUDA source of the port, built together by :func:`build`; K3
# (``psi2_contract.cu``) is loaded by :mod:`rgp_tpu_torch.ops.cuda.psi2_contract`,
# the exp probe (``exp_probe.cu``), the roofline's instrument, by
# :mod:`rgp_tpu_torch.ops.cuda.exp_probe`
SOURCES = {"psi2_fwd": CSRC / "psi2_fwd.cu", "psi2_bwd": CSRC / "psi2_bwd.cu",
           "psi2_contract": CSRC / "psi2_contract.cu", "exp_probe": CSRC / "exp_probe.cu"}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
MAX_Q = 128  # kMaxQ in both sources
_SMS = 132  # SMs of an H100 SXM: the partitions are planned for it on every device
_FWD_MIN_T = 8  # timesteps a K1 block takes at least
_BWD_TILE_M = 32  # kBM in psi2_bwd.cu: m rows per block
_BWD_STAGE_T = 8  # kWarps in psi2_bwd.cu: timesteps a block takes at a time
_BWD_BLOCKS_PER_SM = 2  # __launch_bounds__ of psi2_bwd.cu for Q <= 32
_MAX_WAVES = 4  # more splits only add partial traffic and reduce work
_MAX_BATCH = 65535  # instances one launch takes: kMaxBatch in both sources (gridDim.z)
# bytes of per-instance scratch (K1's partial tiles, K2's partials) one batched
# launch may take; a larger batch is cut into several launches. K1 at config
# 1's (512, 100, 20) takes 1.06 MB an instance, so 512 particles fit in one.
_MAX_WORKSPACE = 1 << 30

launches = 0  # times the wrappers launched K1 (a batched call counts its launches, not its instances)
bwd_launches = 0  # times the wrappers launched K2
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


def _instances(args):
    """The batch's instances: one tuple of the arguments' slices each."""
    return [tuple(x[i] for x in args) for i in range(args[0].shape[0])]


def psi2_time_sum_batched_plain(base, E, D1, w, Z):
    """Plain PyTorch version of the batched K1: :func:`psi2_time_sum_plain`
    per instance of the leading batch axis -> (B, M, M)."""
    return torch.stack([psi2_time_sum_plain(*xs) for xs in _instances((base, E, D1, w, Z))])


def psi2_time_sum_bwd_batched_plain(base, E, D1, w, Z, g, out):
    """Plain PyTorch version of the batched K2: :func:`psi2_time_sum_bwd_plain`
    per instance of the leading batch axis -> (dbase, dE, dD1, dw, dzC), each
    with the batch axis first."""
    per = [psi2_time_sum_bwd_plain(*xs) for xs in _instances((base, E, D1, w, Z, g, out))]
    return tuple(torch.stack(xs) for xs in zip(*per))


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
            lib.rgp_psi2_fwd.argtypes = [vp] * 8 + [ci] * 7 + [cl] * 5 + [vp]
            lib.rgp_psi2_fwd.restype = ci
            consts = {"rgp_psi2_fwd_max_q": MAX_Q, "rgp_psi2_fwd_max_batch": _MAX_BATCH}
            for fn, want in (("rgp_psi2_fwd_tile", fwd_tile), ("rgp_psi2_fwd_blocks_per_sm", _fwd_blocks_per_sm)):
                getattr(lib, fn).argtypes = [ci]
                getattr(lib, fn).restype = ci
                if any(getattr(lib, fn)(q) != want(q) for q in range(1, MAX_Q + 1)):
                    raise RuntimeError(f"psi2_fwd.cu and ops/cuda/psi2.py disagree on {fn}")
        else:
            lib.rgp_psi2_bwd.argtypes = [vp] * 6 + [cl] * 2 + [vp] * 10 + [ci] * 7 + [cl] * 7 + [vp]
            lib.rgp_psi2_bwd.restype = ci
            lib.rgp_psi2_bwd_plan.argtypes = [ci, ci, vp]
            lib.rgp_psi2_bwd_plan.restype = ci
            consts = {"rgp_psi2_bwd_max_q": MAX_Q, "rgp_psi2_bwd_tile_m": _BWD_TILE_M,
                      "rgp_psi2_bwd_max_batch": _MAX_BATCH}
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


def _check(base, E, D1, w, Z, g=None, out=None, batch=None):
    """Raise unless the arguments are what the kernels take: float32 on one
    device, of matching shapes (with a leading axis of ``batch`` instances
    when given), dense (batched: dense past the batch axis, whose stride may
    be anything, 0 included). ``g`` may have any strides."""
    if batch is not None and batch < 1:
        raise ValueError(f"psi2 kernel: a batch needs at least one instance, got {batch}")
    T, Q = w.shape[-2:]
    M = Z.shape[-2]
    lead = () if batch is None else (batch,)
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
        if tuple(x.shape) != lead + want[name]:
            raise ValueError(f"psi2 kernel: {name} has shape {tuple(x.shape)}, want {lead + want[name]}")
        # g is read through its strides; every other input densely
        if name != "g" and not (x if batch is None else x[0]).is_contiguous():
            raise ValueError(f"psi2 kernel: {name} is not contiguous")
    if T < 1 or M < 1 or not 1 <= Q <= MAX_Q:
        raise ValueError(f"psi2 kernel: need T, M >= 1 and 1 <= Q <= {MAX_Q}; got T={T} M={M} Q={Q}")


def _cuda_device(fn, base):
    if base.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {base.device}")


def _chunks(n, instance_bytes):
    """[lo, hi) ranges of a batch of ``n`` instances, one a launch: at most
    ``_MAX_BATCH`` instances and ``_MAX_WORKSPACE`` bytes of scratch each."""
    step = max(1, min(_MAX_BATCH, _MAX_WORKSPACE // max(1, instance_bytes)))
    return [(lo, min(n, lo + step)) for lo in range(0, n, step)]


def _at(x, lo, stride):
    """Address of instance ``lo`` of a float32 argument whose instances are
    ``stride`` elements apart (0: one instance, or one shared by all)."""
    return x.data_ptr() + 4 * lo * stride


def _fwd(xs, strides, n, out):
    """K1 over ``n`` checked instances: input i of instance b at
    ``_at(xs[i], b, strides[i])``, and ``out`` n dense (M, M) outputs. One
    launch per chunk of the batch (:func:`_chunks`), each counted in
    ``launches``. Returns ``out``."""
    global launches
    T, Q = xs[3].shape[-2:]
    M = xs[4].shape[-2]
    n_split, t_per = t_split(T, M, Q)
    B = fwd_tile(Q)
    n_pairs = _cdiv(M, B) * (_cdiv(M, B) + 1) // 2
    part_n = n_split * n_pairs * B * B
    chunks = _chunks(n, 4 * part_n)
    width = chunks[0][1] - chunks[0][0]
    lib = _load("psi2_fwd")
    dev = out.device
    with torch.cuda.device(dev):
        partial = _empty(dev, width, part_n)
        tickets = _tickets_for(dev, width * n_pairs)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo, hi in chunks:
            err = lib.rgp_psi2_fwd(
                *(_at(x, lo, sb) for x, sb in zip(xs, strides)), partial.data_ptr(), _at(out, lo, M * M),
                tickets.data_ptr(), tickets.numel(), T, M, Q, n_split, t_per, hi - lo, *strides, stream,
            )
            if err != 0:
                raise RuntimeError(f"psi2_fwd kernel launch failed with CUDA error {err}")
            launches += 1
    return out


def _bwd(xs, strides, g_strides, n, grads):
    """K2 over ``n`` checked instances, as :func:`_fwd`: ``xs`` the seven
    inputs (base, E, D1, w, Z, g, out), g read through ``g_strides`` within
    an instance, and ``grads`` the five outputs, n dense instances each. One
    launch per chunk of the batch, each counted in ``bwd_launches``.
    Returns ``grads``."""
    global bwd_launches
    T, Q = xs[3].shape[-2:]
    M = xs[4].shape[-2]
    n_split, t_per = bwd_split(T, M)
    m_tiles = _cdiv(M, _BWD_TILE_M)
    chunks = _chunks(n, 4 * (m_tiles * T * (1 + Q) + n_split * M * Q))
    width = chunks[0][1] - chunks[0][0]
    lib = _load("psi2_bwd")
    dev = grads[0].device
    sizes = (T, T * M, M * M, T * Q, M * Q)  # elements of an instance of each output
    with torch.cuda.device(dev):
        parts = _empty(dev, width, m_tiles, T), _empty(dev, width, m_tiles, T, Q), _empty(dev, width, n_split, M, Q)
        tickets = _tickets_for(dev, width * (n_split + m_tiles))
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo, hi in chunks:
            ptrs = [_at(x, lo, sb) for x, sb in zip(xs, strides)]
            err = lib.rgp_psi2_bwd(
                *ptrs[:6], *g_strides, ptrs[6], *(_at(x, lo, k) for x, k in zip(grads, sizes)),
                *(x.data_ptr() for x in parts), tickets.data_ptr(), tickets.numel(), T, M, Q, n_split, t_per,
                hi - lo, *strides, stream,
            )
            if err != 0:
                raise RuntimeError(f"psi2_bwd kernel launch failed with CUDA error {err}")
            bwd_launches += 1
    return grads


def _empty(dev, *shape):
    return torch.empty(shape, dtype=torch.float32, device=dev)


def _empty_grads(dev, T, M, Q, *lead):
    """K2's five outputs, (*lead, ...) each: dbase, dE, dD1, dw, dzC."""
    return [_empty(dev, *lead, *shape) for shape in ((T,), (T, M), (M, M), (T, Q), (M, Q))]


def psi2_time_sum(base, E, D1, w, Z):
    """sum_t Psi2_t from the precomputed decomposition -> (M, M), exactly
    symmetric.

    CUDA tensors: launch K1 (float32 only, one launch) or raise. CPU tensors:
    the plain version."""
    if base.device.type == "cpu":
        return psi2_time_sum_plain(base, E, D1, w, Z)
    _cuda_device("psi2_time_sum", base)
    _check(base, E, D1, w, Z)
    M = Z.shape[0]
    return _fwd((base, E, D1, w, Z), (0,) * 5, 1, _empty(base.device, M, M))


def psi2_time_sum_batched(base, E, D1, w, Z):
    """:func:`psi2_time_sum` for each instance of a leading batch axis: base
    (B, T), E (B, T, M), D1 (B, M, M), w (B, T, Q), Z (B, M, Q) -> (B, M, M).
    Each input is dense past the batch axis, whose stride may be 0 for an
    input the instances share (``Z.expand(B, M, Q)``).

    CUDA tensors: launch K1 over the batch (float32 only; one launch for up
    to 65535 instances and 1 GiB of scratch, else one a chunk) or raise. CPU
    tensors: the plain version."""
    if base.device.type == "cpu":
        return psi2_time_sum_batched_plain(base, E, D1, w, Z)
    _cuda_device("psi2_time_sum_batched", base)
    _check(base, E, D1, w, Z, batch=base.shape[0])
    n, M = base.shape[0], Z.shape[1]
    args = (base, E, D1, w, Z)
    return _fwd(args, tuple(x.stride(0) for x in args), n, _empty(base.device, n, M, M))


def psi2_time_sum_bwd(base, E, D1, w, Z, g, out):
    """K2: the VJP of ``out = psi2_time_sum(base, E, D1, w, Z)`` for its
    cotangent ``g`` -> (dbase (T,), dE (T,M), dD1 (M,M), dw (T,Q), dzC
    (M,Q)), dzC being the C term's direct dZ. ``g`` may have any strides
    (dense, transposed, expanded); the kernel forms ``g + g^T`` itself.

    CUDA tensors: launch K2 (float32 only, one launch) or raise. CPU
    tensors: the plain version."""
    if base.device.type == "cpu":
        return psi2_time_sum_bwd_plain(base, E, D1, w, Z, g, out)
    _cuda_device("psi2_time_sum_bwd", base)
    _check(base, E, D1, w, Z, g, out)
    (T, Q), M = w.shape, Z.shape[0]
    return tuple(_bwd((base, E, D1, w, Z, g, out), (0,) * 7, g.stride(), 1, _empty_grads(base.device, T, M, Q)))


def psi2_time_sum_bwd_batched(base, E, D1, w, Z, g, out):
    """:func:`psi2_time_sum_bwd` for each instance of a leading batch axis:
    the inputs as :func:`psi2_time_sum_batched` takes them, ``g`` (B, M, M)
    with any strides and ``out`` (B, M, M) dense past the batch axis -> the
    five gradients, each (B, ...).

    CUDA tensors: launch K2 over the batch (float32 only; one launch, or one
    a chunk as the forward) or raise. CPU tensors: the plain version."""
    if base.device.type == "cpu":
        return psi2_time_sum_bwd_batched_plain(base, E, D1, w, Z, g, out)
    _cuda_device("psi2_time_sum_bwd_batched", base)
    _check(base, E, D1, w, Z, g, out, batch=base.shape[0])
    (n, T, Q), M = w.shape, Z.shape[1]
    args = (base, E, D1, w, Z, g, out)
    return tuple(_bwd(args, tuple(x.stride(0) for x in args), g.stride()[1:], n,
                      _empty_grads(base.device, T, M, Q, n)))


def _vmapped(args, in_dims, n):
    """A vmap rule's arguments with the vmapped axis first: moved there, or,
    for an argument that is not batched, expanded to ``n`` (stride 0)."""
    return [x.expand(n, *x.shape) if d is None else x.movedim(d, 0) for x, d in zip(args, in_dims)]


def _dense_trailing(x):
    """``x``, copied if it is not dense past its leading axis."""
    return x if x[0].is_contiguous() else x.contiguous()


def _once():
    """Raise in a backward asked to build a graph: K2 has no derivative."""
    if torch.is_grad_enabled():
        raise RuntimeError("RBFPsi2Sum (K1/K2) is differentiable once; take second derivatives "
                           "through the plain path (psi_statistics(prefer='scan'))")


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

    Under ``torch.func.vmap`` (a batch of sampler chains, particles or
    restarts) the :meth:`vmap` rule is one :class:`RBFPsi2SumBatched` call on
    the stacked arguments: one K1 launch for the batch, and one K2 launch in
    the backward. ``Z`` may be batched or shared."""

    @staticmethod
    def forward(base, E, D1, w, Z):
        return psi2_time_sum(base, E, D1, w, Z)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output)

    @staticmethod
    def backward(ctx, g):
        _once()
        base, E, D1, w, Z, out = ctx.saved_tensors
        return psi2_time_sum_bwd(base, E, D1, w, Z, g, out)

    @staticmethod
    def vmap(info, in_dims, *args):
        return RBFPsi2SumBatched.apply(*map(_dense_trailing, _vmapped(args, in_dims, info.batch_size))), 0


class RBFPsi2SumBatched(torch.autograd.Function):
    """:class:`RBFPsi2Sum` over a leading batch axis of instances:
    ``psi2_time_sum_batched(base, E, D1, w, Z)``, one K1 launch, with
    ``psi2_time_sum_bwd_batched`` (one K2 launch) as its whole backward. An
    input with batch stride 0 (an expanded one) is shared by the instances;
    its gradient comes back per instance, and autograd sums it through the
    expand. Differentiable once, as :class:`RBFPsi2Sum`.

    Its :meth:`vmap` rule folds an outer vmapped axis into the batch axis, so
    a vmap of a vmap (chains on each rank of a sharded sampler, say) is still
    one launch."""

    @staticmethod
    def forward(base, E, D1, w, Z):
        return psi2_time_sum_batched(base, E, D1, w, Z)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output)

    @staticmethod
    def backward(ctx, g):
        _once()
        base, E, D1, w, Z, out = ctx.saved_tensors
        return psi2_time_sum_bwd_batched(base, E, D1, w, Z, g, out)

    @staticmethod
    def vmap(info, in_dims, *args):
        xs = _vmapped(args, in_dims, info.batch_size)
        out = RBFPsi2SumBatched.apply(*(_dense_trailing(x.flatten(0, 1)) for x in xs))
        return out.unflatten(0, xs[0].shape[:2]), 0


def rbf_psi2_sum(p, Z, mu, s):
    """sum_t Psi2_t for the RBF kernel through :class:`RBFPsi2Sum`, with the
    decomposition in ``mu``'s dtype and the kernels in float32."""
    base, E, D1, w = rbf_psi2_precompute(p, Z, mu, s)

    def f32(x):
        return x.to(torch.float32).contiguous()

    return RBFPsi2Sum.apply(f32(base), f32(E), f32(D1), f32(w), f32(Z)).to(mu.dtype)
