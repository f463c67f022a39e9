"""Plain reference of the deep recurrent sparse GP that the cells run.

Plain PyTorch, float64 by default, written from the model's equations: the
REVARB bound of a stack of uncertain-input sparse GPs (Mattos et al. 2016,
"Recurrent Gaussian Processes"), collapsed over q(u) and assembled in a
spectral whitening basis of Kmm; its gradient; Adam with optax's semantics
under a cosine decay; the per-layer posteriors and the moment-matched free
simulation. Each layer's covariance function, its expectations Psi0, Psi1
and Psi2 among them, comes from the kernel file the configuration names
(:func:`kernel_file`). It imports nothing of the program under test and
takes nothing that the program derived: every basis, jitter rung and
posterior is worked out here again from the parameters and the data.

Regularisation is part of the model a configuration states (float32: jitter
ladders from 1e-6 of the mean diagonal, x1 / x1e3 / x1e7; a spectral floor of
1e-6 of the largest eigenvalue, escalated x1e3 and x1e6 until a trial
Cholesky of the whitened Ct passes). Each rung is chosen by whether a
float32 Cholesky of a trial matrix succeeds. Near a rung's edge that outcome
follows the rounding of the trial matrix, so :class:`Ladder` returns every
rung that float32 rounding can reach, judged from a float32 evaluation of
the same trial matrix beside the float64 one. The check compares the
program with the nearest admissible branch (``check.py``). With
``Ladder(None)`` each rung is decided by an actual Cholesky in the tensors'
own dtype, as a program would: the mode of the lower-precision control.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import itertools
import math
from pathlib import Path
from typing import NamedTuple, Optional

import torch

LOG2PI = math.log(2.0 * math.pi)
U32 = 2.0 ** -24  # float32 unit roundoff
FLOOR_RUNGS = (1.0, 1e3, 1e6)
PSI2_BLOCK = 128  # steps of a Psi2 time sum formed at once
JITTER_RUNGS = (1.0, 1e3, 1e7)


# ------------------------------------------------------------------ basics


class _Matmul:
    tf32_on_cpu = False  # set only inside :func:`tf32_matmuls`


def _tf32(x):
    """float32 rounded to TF32's 10-bit mantissa, to nearest; the gradient
    passes through as the card's own TF32 products pass it."""
    i = x.detach().contiguous().view(torch.int32)
    return x + (((i + 0x1000) & ~0x1FFF).view(torch.float32) - x).detach()


def mm(a, b):
    """a @ b; inside :func:`tf32_matmuls` with float32 operands on the CPU,
    of the operands rounded to TF32 (the card does that itself)."""
    if _Matmul.tf32_on_cpu and a.dtype == torch.float32 and a.device.type == "cpu":
        a, b = _tf32(a), _tf32(b)
    return a @ b


@contextlib.contextmanager
def tf32_matmuls():
    """float32 matrix products in TF32: the precision below float32 with
    TF32 off, which the lower-precision control runs in."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    _Matmul.tf32_on_cpu = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
        _Matmul.tf32_on_cpu = False


def softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def softplus_inv(y):
    return y + math.log(-math.expm1(-y))


def _shift(X, k):
    if k == 0:
        return X
    return torch.cat([X.new_zeros((k,) + tuple(X.shape[1:])), X[: X.shape[0] - k]], dim=0)


def lagged(X, L):
    """[x_{t-1}, ..., x_{t-L}], zero before the start."""
    return torch.cat([_shift(X, k) for k in range(1, L + 1)], dim=-1)


def current_window(X, L):
    """[x_t, ..., x_{t-L+1}], zero before the start."""
    return torch.cat([_shift(X, k) for k in range(L)], dim=-1)


def sym(A):
    return 0.5 * (A + A.mT)


class Layout(NamedTuple):
    wins: tuple  # hidden windows, deepest (input-driven) layer first
    q: int
    out_win: int
    u_win: int


def layout(cfg) -> Layout:
    """The stack a configuration file describes: ``wins = [w_out, w_1, ...,
    w_H]`` from the output down, each hidden layer one latent dimension."""
    wins = tuple(cfg["wins"][1:])[::-1]
    return Layout(wins, 1, max(1, cfg["wins"][0]), cfg["u_win"])


def input_dims(cfg):
    """Each layer's input width, hidden layers first, the output layer last."""
    lay = layout(cfg)
    hidden = [L * lay.q + (lay.u_win if h == 0 else L * lay.q) for h, L in enumerate(lay.wins)]
    return hidden + [lay.out_win * lay.q]


# ------------------------------------------------------------ kernel files


KERNELS = Path(__file__).resolve().parent / "kernels"
KERNEL_API = ("program", "init", "hyper", "K", "psi0", "psi1", "psi2", "psi2_sum", "work", "time_sum_work")


def kernel_file(name, where=KERNELS):
    """The kernel file ``<where>/<name>.py``, loaded once. It holds all
    that the benchmark knows of one kernel:

    - ``program(din)``: the program's kernel object for a layer of ``din``
      inputs, the program imported inside it;
    - ``init(n, din, dtype, device)``: ``n`` parameter sets stacked on a
      leading axis, in the program's layout;
    - ``hyper(kp)``: the hyperparameters of one set, which the expectations
      take as ``p``; formed once a layer, so that each leaf's gradient
      passes one transform;
    - the expectations under x_t ~ N(mu_t, diag s_t), plain torch with
      :func:`mm` for matrix products, so that the TF32 control reaches them:
      ``K(p, X, X2)``; ``psi0(p, mu, s)`` (T,); ``psi1(p, Z, mu, s)``
      (T, M); ``psi2(p, Z, mu, s)``, (T, M, M), one matrix a step;
      ``psi2_sum(p, Z, mu, s, block)``, (M, M), summed over the steps
      ``block`` at a time;
    - ``work(M, Q)``: {"psi0", "psi1", "psi2"}, the operations of each at
      one input point of width Q; ``time_sum_work(T, M, Q)``: (operations,
      transcendentals, bytes) of the program's Psi2 time sum.
    """
    return _load_kernel(name, Path(where))


@functools.lru_cache(maxsize=None)
def _load_kernel(name, where):
    there = sorted(f.stem for f in where.glob("*.py"))
    if name not in there:
        raise ValueError(f"unknown kernel {name!r}; {where} has {there}")
    mod_name = f"{__package__}.kernels.{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, where / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [f for f in KERNEL_API if not callable(getattr(mod, f, None))]
    if missing:
        raise ValueError(f"kernel file {name}.py lacks {missing}")
    return mod


def layer_kernels(cfg, where=KERNELS):
    """The kernel file of each layer, hidden layers first: ``"kernel"`` for
    the hidden layers, ``"out_kernel"`` (``"kernel"`` if absent) for the
    output layer."""
    hidden = kernel_file(cfg["kernel"], where)
    return [hidden] * len(layout(cfg).wins) + [kernel_file(cfg.get("out_kernel", cfg["kernel"]), where)]


def mlp(layers, x):
    for lay in layers[:-1]:
        x = torch.tanh(mm(x, lay["w"]) + lay["b"])
    return mm(x, layers[-1]["w"]) + layers[-1]["b"]


# ---------------------------------------------------------------- ladders


class Trial(NamedTuple):
    margin: float  # the multiple of the float32 shift at which the outcome turns
    outcomes: tuple  # subset of (True = passes, False = fails)
    lam: float  # smallest eigenvalue, float64
    lam32: float  # the same of the float32 evaluation


class Ladder:
    """Decides the outcome of a trial Cholesky.

    With ``band = {"c": [lo, hi]}``, from the trial
    matrix in float64 and the same matrix evaluated in float32 (Kmm and Psi2
    computed in float32 from inputs rounded to float32, then the eigh and
    the whitened products in float32, as the configuration computes them).
    float32 moves the smallest eigenvalue from ``lam`` by ``shift = lam32 -
    lam``; the program's own float32 evaluation moves it by ``c * shift``
    for some ``c`` between ``lo`` and ``hi``, so the trial may pass where
    ``lam + c * shift`` exceeds 0 and fail where it falls below, a float32
    Cholesky's own backward error (M units of the largest eigenvalue) aside.
    With ``band=None``: factorize the
    matrix in its own dtype and take what happens (the control's mode).
    Every trial is kept in ``trials``."""

    def __init__(self, band):
        self.band = band
        self.trials = []

    def outcomes(self, A, A32=None):
        if self.band is None:
            L, info = torch.linalg.cholesky_ex(A)
            ok = bool(info == 0) and not bool(torch.isnan(L).any())
            self.trials.append(Trial(float("nan"), (ok,), float("nan"), float("nan")))
            return (ok,)
        ev = torch.linalg.eigvalsh(A.double())
        lam = float(ev[0])
        lam32 = float(torch.linalg.eigvalsh(A32.double())[0])
        unit = U32 * A.shape[-1] * float(ev.abs().max())
        shift = lam32 - lam
        lo, hi = self.band["c"]
        ends = sorted((lam + lo * shift, lam + hi * shift))
        out = tuple(o for o, ok in ((True, ends[1] + unit > 0), (False, ends[0] - unit < 0)) if ok)
        self.trials.append(Trial(-lam / shift if shift else float("inf"), out, lam, lam32))
        return out

    def rungs(self, trial_fn, rungs):
        """Every rung a ladder of three can end on: a trial at each of the
        first two rungs, ``trial_fn(rung) -> outcomes``; the third is taken
        blind."""
        out = []
        o0 = trial_fn(rungs[0])
        if True in o0:
            out.append(rungs[0])
        if False in o0:
            o1 = trial_fn(rungs[1])
            if True in o1:
                out.append(rungs[1])
            if False in o1:
                out.append(rungs[2])
        return out


# --------------------------------------------------------------- whitening


class Basis(NamedTuple):
    W: torch.Tensor
    topup: torch.Tensor
    floor: float
    W32: Optional[torch.Tensor]  # the same basis from a float32 eigh (the ladder's shift)
    topup32: Optional[torch.Tensor]


class Spectrum(NamedTuple):
    lam: torch.Tensor
    V: torch.Tensor
    lam32: Optional[torch.Tensor]
    V32: Optional[torch.Tensor]


def spectrum(Kmm, Kmm32=None):
    """Eigenpairs of Kmm, and of its float32 evaluation ``Kmm32`` if given."""
    lam, V = torch.linalg.eigh(sym(Kmm).detach())
    if Kmm32 is None:
        return Spectrum(lam, V, None, None)
    lam32, V32 = torch.linalg.eigh(sym(Kmm32).detach())
    return Spectrum(lam, V, lam32, V32)


def _basis(lam, V, floor):
    lam_eff = torch.maximum(lam, floor * torch.clamp(lam[-1], min=1e-30))
    return V / torch.sqrt(lam_eff)[None, :], 1.0 - torch.clamp(lam, min=0.0) / lam_eff


def basis(sp: Spectrum, floor):
    W, topup = _basis(sp.lam, sp.V, floor)
    W32, t32 = _basis(sp.lam32, sp.V32, floor) if sp.lam32 is not None else (None, None)
    return Basis(W, topup, floor, W32, t32)


def whitened(Kmm, psi2, beta, W, topup):
    Kt = sym(mm(W.mT, mm(Kmm, W))) + torch.diag(topup)
    At = beta * sym(mm(W.mT, mm(sym(psi2), W)))
    return Kt, At


def _eye_like(A):
    return torch.eye(A.shape[0], dtype=A.dtype, device=A.device)


def floor_options(st, cfg, ladder: Ladder):
    """Every basis the spectral-floor ladder of a layer's statistics ``st``
    can end on (detached)."""
    Kmm, psi2, beta = st.Kmm.detach(), st.psi2.detach(), st.beta.detach()
    f32 = st.f32 if ladder.band is not None else None
    sp = spectrum(Kmm, None if f32 is None else f32.Kmm)
    f0 = cfg["spectral_floor"]

    def trial_matrix(K, P, b, W, topup):
        Kt, At = whitened(K, P, b, W, topup)
        Ct = Kt + At
        return Ct + 1e-6 * torch.diagonal(Ct).mean() * _eye_like(Ct)

    def trial(rung):
        B = basis(sp, f0 * rung)
        A = trial_matrix(Kmm, psi2, beta, B.W, B.topup)
        A32 = None if f32 is None else trial_matrix(f32.Kmm, f32.psi2, f32.beta, B.W32, B.topup32)
        return ladder.outcomes(A, A32)

    return [basis(sp, f0 * r) for r in ladder.rungs(trial, FLOOR_RUNGS)]


def jitter_options(A, A32, j0, ladder: Ladder):
    """Relative jitters the jitter ladder of A can end on."""
    A = A.detach()
    d = torch.clamp(torch.diagonal(A).mean(), min=1e-30)

    def trial(rel):
        B32 = None if A32 is None else A32 + rel * torch.clamp(torch.diagonal(A32).mean(), min=1e-30) * _eye_like(A32)
        return ladder.outcomes(A + rel * d * _eye_like(A), B32)

    return ladder.rungs(trial, tuple(j0 * r for r in JITTER_RUNGS))


def jchol(A, rel):
    d = torch.clamp(torch.diagonal(A).mean(), min=1e-30)
    return torch.linalg.cholesky(A + rel * d * _eye_like(A))


# ------------------------------------------------------------------- model


def noise_of(cfg, log_noise):
    """The floored noise variance softplus(raw) + noise_floor."""
    return softplus(log_noise) + cfg["noise_floor"]


def hidden_moments(cfg, params, Y, U):
    """Each hidden layer's (means, variances) over its initial window and
    the record, (T + L, 1)."""
    lay = layout(cfg)
    mus, lams = [], []
    for h, L in enumerate(lay.wins):
        lp = params["layers"][h]
        mu_t, lam_t = lp["mu"], torch.exp(lp["log_lam"])
        if cfg.get("back_cstr"):
            mu_t = mlp(params["encoder"][h], torch.cat([lagged(Y, L), current_window(U, lay.u_win)], -1))
        mus.append(torch.cat([lp["mu0"], mu_t], 0))
        lams.append(torch.cat([torch.exp(lp["log_lam0"]), lam_t], 0))
    return mus, lams


class LayerData(NamedTuple):
    kf: object  # the layer's kernel file
    kp: dict
    Z: torch.Tensor
    noise: torch.Tensor
    X_mu: torch.Tensor
    X_s: torch.Tensor
    tgt: torch.Tensor
    tgt_var: Optional[torch.Tensor]


def layers_of(cfg, params, Y, U):
    """Every layer's uncertain inputs and targets, hidden layers first."""
    lay = layout(cfg)
    kfs = layer_kernels(cfg)
    mus, lams = hidden_moments(cfg, params, Y, U)
    out, lo_mu, lo_s = [], None, None
    for h, L in enumerate(lay.wins):
        lp = params["layers"][h]
        own_mu, own_s = lagged(mus[h], L)[L:], lagged(lams[h], L)[L:]
        if h == 0:
            low_mu = current_window(U, lay.u_win)
            low_s = torch.zeros_like(low_mu)
        else:
            low_mu, low_s = current_window(lo_mu, L), current_window(lo_s, L)
        out.append(LayerData(kfs[h], lp["kern"], lp["Z"], noise_of(cfg, lp["log_noise"]),
                             torch.cat([own_mu, low_mu], -1), torch.cat([own_s, low_s], -1),
                             mus[h][L:], lams[h][L:]))
        lo_mu, lo_s = mus[h][L:], lams[h][L:]
    op = params["out"]
    out.append(LayerData(kfs[-1], op["kern"], op["Z"], noise_of(cfg, op["log_noise"]),
                         current_window(lo_mu, lay.out_win), current_window(lo_s, lay.out_win), Y, None))
    return out, mus, lams


class Stats32(NamedTuple):
    """Kmm, Psi2 and beta evaluated in float32 from the inputs rounded to
    float32: how far the configuration's own arithmetic moves the ladders'
    trial matrices."""

    Kmm: torch.Tensor
    psi2: torch.Tensor
    beta: torch.Tensor


class Stats(NamedTuple):
    Kmm: torch.Tensor
    psi0: torch.Tensor
    psi1: torch.Tensor
    psi2: torch.Tensor
    beta: torch.Tensor
    f32: Optional[Stats32] = None


def stats_of(d: LayerData, with32: bool = False):
    kf = d.kf
    p = kf.hyper(d.kp)
    f32 = None
    if with32:
        with torch.no_grad():
            p32 = tree_with(p, [x.detach().float() for _, x in tree_leaves(p)])
            Z, mu, s = (x.detach().float() for x in (d.Z, d.X_mu, d.X_s))
            f32 = Stats32(kf.K(p32, Z, Z), kf.psi2_sum(p32, Z, mu, s, PSI2_BLOCK), 1.0 / d.noise.detach().float())
    return Stats(kf.K(p, d.Z, d.Z), kf.psi0(p, d.X_mu, d.X_s), kf.psi1(p, d.Z, d.X_mu, d.X_s),
                 kf.psi2_sum(p, d.Z, d.X_mu, d.X_s, PSI2_BLOCK), 1.0 / d.noise, f32)


def bound_options(cfg, st: Stats, B: Basis, ladder: Ladder):
    """[(kt rung, ct rung)] the bound's two jitter ladders can end on at B."""
    with torch.no_grad():
        Kt, At = whitened(st.Kmm, st.psi2, st.beta, B.W, B.topup)
        Kt32 = At32 = None
        if B.W32 is not None and st.f32 is not None:
            Kt32, At32 = whitened(st.f32.Kmm, st.f32.psi2, st.f32.beta, B.W32, B.topup32)
        j0 = cfg["jitter"]
        return list(itertools.product(jitter_options(Kt, Kt32, j0, ladder),
                                      jitter_options(Kt + At, None if Kt32 is None else Kt32 + At32, j0, ladder)))


def layer_bound(st: Stats, d: LayerData, B: Basis, rungs):
    """The whitened collapsed bound F0 of one layer at jitter rungs
    (Kt's, Ct's), plus for a hidden layer the entropy of q over its targets."""
    T, D = d.tgt.shape
    Kt, At = whitened(st.Kmm, st.psi2, st.beta, B.W, B.topup)
    Lk, Lc = jchol(Kt, rungs[0]), jchol(Kt + At, rungs[1])
    c = torch.linalg.solve_triangular(Lc, mm(B.W.mT, mm(st.psi1.mT, d.tgt)), upper=False)
    tr = torch.trace(torch.cholesky_solve(At, Lk)) / st.beta
    trYY = (d.tgt * d.tgt).sum() + (0.0 if d.tgt_var is None else d.tgt_var.sum())
    logdetB = 2.0 * (torch.log(torch.diagonal(Lc)).sum() - torch.log(torch.diagonal(Lk)).sum())
    beta = st.beta
    F = (-0.5 * T * D * (LOG2PI - torch.log(beta)) - 0.5 * D * logdetB - 0.5 * beta * trYY
         + 0.5 * beta * beta * (c * c).sum() - 0.5 * D * beta * (st.psi0.sum() - tr))
    if d.tgt_var is not None:
        F = F + 0.5 * torch.log(2.0 * math.pi * math.e * d.tgt_var).sum()
    return F


def init_kl(mus, lams, cfg):
    lay = layout(cfg)
    kl = 0.0
    for h, L in enumerate(lay.wins):
        m, v = mus[h][:L], lams[h][:L]
        kl = kl + 0.5 * (m * m + v - torch.log(v) - 1.0).sum()
    return kl


# ------------------------------------------------------------------ training


def adam_step(params, grads, m, v, count, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One optax ``adam`` step on lists of tensors; ``count`` is the step
    index (0 first) and ``lr`` its learning rate."""
    t = count + 1
    out_p, out_m, out_v = [], [], []
    for p, g, mi, vi in zip(params, grads, m, v):
        mi = b1 * mi + (1.0 - b1) * g
        vi = b2 * vi + (1.0 - b2) * g * g
        mh, vh = mi / (1.0 - b1 ** t), vi / (1.0 - b2 ** t)
        out_p.append(p - lr * mh / (torch.sqrt(vh) + eps))
        out_m.append(mi)
        out_v.append(vi)
    return out_p, out_m, out_v


def cosine_lr(init, decay_steps, alpha, i):
    c = min(i, decay_steps)
    return init * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps)) + alpha)


def tree_leaves(tree, prefix=""):
    """[(path, leaf)], dict keys sorted, sequences in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree) for x in tree_leaves(t, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def tree_with(tree, leaves):
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(x) for x in t)
        return next(it)

    return rebuild(tree)


def refresh(cfg, params, Y, U, ladder: Ladder):
    """Each layer's admissible whitening bases at ``params`` (a refresh)."""
    with torch.no_grad():
        layers, _, _ = layers_of(cfg, params, Y, U)
        return [floor_options(stats_of(d, ladder.band is not None), cfg, ladder) for d in layers]


def neg_elbo(cfg, params, Y, U, bases, combo=None, ladder: Optional[Ladder] = None):
    """[(rungs, -ELBO)] at the whitening ``bases`` (one per layer): at the
    jitter rungs ``combo`` ((kt, ct) per layer) if given, else at every
    combination ``ladder`` admits."""
    layers, mus, lams = layers_of(cfg, params, Y, U)
    sts = [stats_of(d, combo is None and ladder.band is not None) for d in layers]
    combos = [combo] if combo is not None else itertools.product(
        *[bound_options(cfg, st, B, ladder) for st, B in zip(sts, bases)])
    kl = init_kl(mus, lams, cfg)
    return [(c, kl - sum(layer_bound(st, d, B, r) for st, d, B, r in zip(sts, layers, bases, c))) for c in combos]


# ------------------------------------------------------------------ serving


class Posterior(NamedTuple):
    alpha: torch.Tensor
    wood: torch.Tensor  # Kmm^{-1} - (Kmm + beta Psi2)^{-1}


def posterior_options(cfg, st: Stats, d: LayerData, ladder: Ladder):
    """Every posterior of q(u) the layer's ladders admit, at bases formed
    from its own statistics."""
    out = []
    for B in floor_options(st, cfg, ladder):
        Kt, At = whitened(st.Kmm, st.psi2, st.beta, B.W, B.topup)
        for rk, rc in bound_options(cfg, st, B, ladder):
            Lk, Lc = jchol(Kt, rk), jchol(Kt + At, rc)
            alpha = st.beta * mm(B.W, torch.cholesky_solve(mm(B.W.mT, mm(st.psi1.mT, d.tgt)), Lc))
            Rc = torch.linalg.solve_triangular(Lc, B.W.mT, upper=False)
            Rk = torch.linalg.solve_triangular(Lk, B.W.mT, upper=False)
            out.append((Posterior(alpha, mm(Rk.mT, Rk) - mm(Rc.mT, Rc)), (B.floor, rk, rc)))
    return out


def predict(kf, kp, Z, noise, post: Posterior, mu, s):
    """Moment-matched predictive (mean, variance + noise) at N(mu, diag s),
    ``kf`` the layer's kernel file and ``kp`` its leaves."""
    p = kf.hyper(kp)
    p1 = kf.psi1(p, Z, mu, s)
    p2 = kf.psi2(p, Z, mu, s)
    mean = mm(p1, post.alpha)
    quad = (mm(p2, post.alpha) * post.alpha[None]).sum(1)
    tr = (p2 * post.wood.mT[None]).sum((1, 2))
    v = quad - mean * mean + (kf.psi0(p, mu, s) - tr)[:, None] + noise
    return mean, torch.clamp(v, min=1e-12)


def freerun(cfg, params, Y, U, posts, mus, lams, Us):
    """Closed-loop simulation of each of the (S, H, Du) input sequences
    ``Us`` from the record's end, every hidden state carried as a mean and a
    variance: (means (S, H, Dy), variances (S, H, Dy))."""
    lay = layout(cfg)
    S, H = Us.shape[0], Us.shape[1]
    nh = len(lay.wins)
    need = [max(L, lay.wins[h + 1] if h + 1 < nh else lay.out_win) for h, L in enumerate(lay.wins)]
    bm = [torch.flip(mus[h][-n:], [0]).reshape(1, n).expand(S, n) for h, n in enumerate(need)]
    bs = [torch.flip(lams[h][-n:], [0]).reshape(1, n).expand(S, n) for h, n in enumerate(need)]
    Lu = lay.u_win
    Ucat = torch.cat([U[-(Lu - 1):][None].expand(S, Lu - 1, U.shape[1]), Us], 1) if Lu > 1 else Us
    layers = list(params["layers"]) + [params["out"]]
    kfs = layer_kernels(cfg)
    means, variances = [], []
    for i in range(H):
        uw = torch.flip(Ucat[:, i:i + Lu], [1]).reshape(S, -1)
        new_m, new_s = [], []
        for h, L in enumerate(lay.wins):
            if h == 0:
                lo_m, lo_s = uw, torch.zeros_like(uw)
            else:
                lo_m = torch.cat([new_m[h - 1], bm[h - 1][:, :L - 1]], 1)
                lo_s = torch.cat([new_s[h - 1], bs[h - 1][:, :L - 1]], 1)
            lp = layers[h]
            m, v = predict(kfs[h], lp["kern"], lp["Z"], noise_of(cfg, lp["log_noise"]), posts[h],
                           torch.cat([bm[h][:, :L], lo_m], 1), torch.cat([bs[h][:, :L], lo_s], 1))
            new_m.append(m)
            new_s.append(v)
        W = lay.out_win
        top_m = torch.cat([new_m[-1], bm[-1][:, :W - 1]], 1)
        top_s = torch.cat([new_s[-1], bs[-1][:, :W - 1]], 1)
        op = params["out"]
        ym, yv = predict(kfs[-1], op["kern"], op["Z"], noise_of(cfg, op["log_noise"]), posts[-1], top_m, top_s)
        bm = [torch.cat([new_m[h], bm[h][:, :-1]], 1) for h in range(nh)]
        bs = [torch.cat([new_s[h], bs[h][:, :-1]], 1) for h in range(nh)]
        means.append(ym)
        variances.append(yv)
    return torch.stack(means, 1), torch.stack(variances, 1)


def rollout_branches(cfg, params, Y, U, Us, ladder: Ladder, max_branches=64):
    """[(rungs, means, variances)] of :func:`freerun` over every combination
    of the layers' admissible posteriors."""
    with torch.no_grad():
        layers, mus, lams = layers_of(cfg, params, Y, U)
        per = []
        for d in layers:
            per.append(posterior_options(cfg, stats_of(d, ladder.band is not None), d, ladder))
        out = []
        for combo in itertools.islice(itertools.product(*per), max_branches):
            m, v = freerun(cfg, params, Y, U, [p for p, _ in combo], mus, lams, Us)
            out.append((tuple(r for _, r in combo), m, v))
        return out
