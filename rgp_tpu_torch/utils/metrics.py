"""JSONL metrics logging (port of ``rgp_tpu/utils/metrics.py``): one JSON
object a line (ELBO, gradient norm, RMSE, iterations/s, samples/s), so every
training or benchmark entry point can emit a machine-readable trajectory.
Tensors are read to the host: a 0-d one becomes ``.item()``, any other
``.tolist()``."""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["MetricsLogger"]


def _plain(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v.item() if v.dim() == 0 else v.tolist()
    v = np.asarray(v)
    return v.item() if v.ndim == 0 else v.tolist()


class MetricsLogger:
    """Appends one line per :meth:`log` to ``path`` (if given) and prints it
    when ``echo``."""

    def __init__(self, path: Optional[str] = None, *, echo: bool = False):
        self.path = path
        self.echo = echo
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, step: int, **metrics):
        rec = {"step": int(step), "wall_time": round(time.time() - self._t0, 3)}
        rec.update({k: _plain(v) for k, v in metrics.items()})
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.echo:
            print(line)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
