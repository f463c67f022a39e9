"""The general traffic generator: reads a traffic file's parameters and drives
the program's own entry points with them.

``rollout`` traffic (an MPC planner's scoring calls): one controller, closed
loop; each request is one ``bench.serving.batched_freerun`` of ``width``
candidate input sequences of ``horizon`` steps, drawn from the seed by the
record's input process, continuing the record. Each request's latency runs
from its call to its results on the host's side of a synchronize. When
asked, ``trace_requests`` more requests run under the profiler once the
window has closed, so that the window's own requests run as in a run
without a trace.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from . import inputs
from .reference import input_dims, layer_kernels


class Window(NamedTuple):
    seconds: float  # the measured window, host clock
    work: int  # sequence-steps completed in it
    steps: int  # requests completed in it
    latencies: list  # seconds of each request of the window, the traced ones left out
    failed: int  # requests with a non-finite output
    record: dict  # what the check compares
    trace: Optional[object]  # the profiler, stopped, or None
    trace_units: int  # freerun steps inside the trace


def program_cfg(cfg):
    """The program's model configuration, each layer's kernel from its
    kernel file."""
    from rgp_tpu_torch.models import rgp

    # hidden layers deepest first, then the output layer; deep_rgp_config
    # takes the hidden ones from the top down
    kern = [kf.program(din) for kf, din in zip(layer_kernels(cfg), input_dims(cfg))]
    return rgp.deep_rgp_config(wins=list(cfg["wins"]), u_win=cfg["u_win"], y_dim=1, u_dim=1,
                               num_inducing=cfg["num_inducing"], kernels=kern[-2::-1], out_kernel=kern[-1],
                               back_cstr=bool(cfg.get("back_cstr")), mlp_hidden=tuple(cfg.get("mlp_hidden", ())),
                               noise_floor=cfg["noise_floor"])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Tracer:
    """torch.profiler over a stretch of requests, started and stopped on a
    synchronized device; ``seconds`` is the stretch's host-clock length,
    set once it is stopped."""

    def __init__(self, dev):
        self.dev, self.prof, self.t0, self.seconds = dev, None, None, None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.dev.type == "cuda" else [])
        _sync(self.dev)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        _sync(self.dev)
        self.seconds = time.perf_counter() - self.t0
        self.prof.stop()


# ----------------------------------------------------------------- rollout


class RolloutState(NamedTuple):
    cfg: object
    params: dict
    rec: object
    gen: torch.Generator


def rollout_setup(cfg, traffic, rec, seed, dtype):
    """The served model (``inputs.served_params``); a warm-up request of the
    window's width and horizon."""
    from rgp_tpu_torch.bench import serving

    pc = program_cfg(cfg)
    gen = inputs.generator(seed, rec.Y.device)
    params = inputs.served_params(cfg, rec, gen, dtype)
    warm = inputs.candidates(cfg, rec, traffic["width"], traffic["horizon"], inputs.generator(~seed, rec.Y.device))
    serving.batched_freerun(pc, params, rec.Y, rec.U, warm)
    _sync(rec.Y.device)
    return RolloutState(pc, params, rec, gen)


def rollout_window(st: RolloutState, cfg, traffic, seconds, trace: bool) -> Window:
    from rgp_tpu_torch.bench import serving

    dev = st.rec.Y.device
    tracer = _Tracer(dev)
    n_trace = traffic["trace_requests"]
    lat, outs, first_traced = [], [], None
    _sync(dev)
    t0 = time.perf_counter()
    while True:
        if trace and first_traced is None and time.perf_counter() - t0 >= seconds:
            first_traced = len(lat)
            tracer.start()
        Us = inputs.candidates(cfg, st.rec, traffic["width"], traffic["horizon"], st.gen)
        _sync(dev)
        ts = time.perf_counter()
        with torch.profiler.record_function("bench.request"):
            m, v = serving.batched_freerun(st.cfg, st.params, st.rec.Y, st.rec.U, Us)
        _sync(dev)
        te = time.perf_counter()
        lat.append(te - ts)
        outs.append((Us, m, v))
        if first_traced is not None and len(lat) - first_traced == n_trace:
            tracer.stop()
            break
        if not trace and te - t0 >= seconds:
            break
    secs = time.perf_counter() - t0
    n = len(lat)
    failed = sum(int(not (torch.isfinite(m).all() and torch.isfinite(v).all())) for _, m, v in outs)
    quiet = lat[:first_traced] if trace else lat
    return Window(secs, n * traffic["width"] * traffic["horizon"], n, quiet, failed, {"outs": outs},
                  tracer if trace else None, n_trace * traffic["horizon"] if trace else 0)


DRIVERS = {"rollout": (rollout_setup, rollout_window)}
