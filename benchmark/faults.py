"""Faults planted under the timed path, to show that the check catches them.

Each is a context manager that patches the program for as long as it is
open; the tests and ``rehearse.py`` run a cell inside one and expect
``correct`` to come out false:

- ``state_unchanged``: every hidden layer's new state is its previous one.
- ``half_batch``: the first half of a request's candidates is simulated and
  the other half gets the mean of their outputs.
- ``answer_altered``: each candidate is handed the next candidate's
  outputs.

There is one chip, so no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

import torch

NAMES = ("state_unchanged", "half_batch", "answer_altered")


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def plant(name):
    from rgp_tpu_torch.bench import serving
    from rgp_tpu_torch.models import rgp

    if name == "state_unchanged":
        orig, orig_freerun = rgp.predict_uncertain, rgp.freerun
        out_kernel = []

        def freerun(cfg, *a, **kw):
            out_kernel[:] = [cfg.out_kernel]
            return orig_freerun(cfg, *a, **kw)

        def frozen(kern, kp, Z, log_noise, post, mu_star, s_star=None, **kw):
            mean, var = orig(kern, kp, Z, log_noise, post, mu_star, s_star, **kw)
            if kern is out_kernel[0]:
                return mean, var
            q = mean.shape[-1]  # a hidden layer: its own newest state leads its input
            return mu_star[..., :q], s_star[..., :q]

        with _patched(rgp, "predict_uncertain", frozen), _patched(rgp, "freerun", freerun):
            yield
    elif name == "half_batch":
        orig = serving.batched_freerun

        def half(cfg, params, Y, U, Us):
            n = Us.shape[0] // 2
            m, v = orig(cfg, params, Y, U, Us[:n])
            rest = Us.shape[0] - n
            return tuple(torch.cat([x, x.mean(0, keepdim=True).expand(rest, *x.shape[1:])]) for x in (m, v))

        with _patched(serving, "batched_freerun", half):
            yield
    elif name == "answer_altered":
        orig = serving.batched_freerun

        def shifted(*a, **kw):
            m, v = orig(*a, **kw)
            return torch.roll(m, -1, 0), torch.roll(v, -1, 0)

        with _patched(serving, "batched_freerun", shifted):
            yield
    else:
        raise ValueError(f"unknown fault {name!r}")
