"""Checkpoint and resume (port of ``rgp_tpu/utils/checkpoint.py``).

A checkpoint is the full state tree (parameters, optimizer state, sampler
carry, generator states) at ``path/step_<8 digits>``, with a JSON config
sidecar at ``path/config.json``. The JAX package writes it with orbax; here
it is one ``torch.save`` of a tree of dicts, lists and tuples holding tensors
and Python scalars, loaded with ``torch.load(weights_only=True)``, so loading
unpickles no class. A named tuple (a ``NUTSCarry``, its dual-averaging
state) is saved as a plain tuple: save ``carry._asdict()`` and rebuild the
carry from it, or load against a template that holds the named tuples.

Resuming from a checkpoint continues bit for bit when the state holds
everything the run draws from: an ``OptaxAdam``'s ``opt.state_dict()``, a
``torch.Generator``'s ``get_state()``, a NUTS carry (its draws are keyed by
(seed, step, chain)).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from ..device import resolve_device

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]

_STATE_FILE = "state.pt"


def _step_dir(path: str, step: int) -> str:
    return os.path.join(os.path.abspath(path), f"step_{step:08d}")


def _plain(tree):
    """The tree with named tuples as plain tuples and tensors detached."""
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_plain(v) for v in tree)
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    return tree


def _like(template, tree, where="state"):
    """``tree`` in ``template``'s structure, container types, tensor dtypes
    and devices; raises where the two differ in structure or shape."""
    if isinstance(template, torch.Tensor):
        if not isinstance(tree, torch.Tensor) or tree.shape != template.shape:
            raise ValueError(f"{where}: checkpoint holds {type(tree).__name__} "
                             f"{tuple(getattr(tree, 'shape', ()))}, template a tensor {tuple(template.shape)}")
        return tree.to(dtype=template.dtype, device=template.device)
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            raise ValueError(f"{where}: checkpoint keys {sorted(map(str, tree))} differ from the template's "
                             f"{sorted(map(str, template))}")
        return {k: _like(v, tree[k], f"{where}/{k}") for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        if not isinstance(tree, (tuple, list)) or len(tree) != len(template):
            raise ValueError(f"{where}: checkpoint holds {len(tree)} entries, the template {len(template)}")
        items = [_like(t, x, f"{where}/{i}") for i, (t, x) in enumerate(zip(template, tree))]
        if isinstance(template, tuple) and hasattr(template, "_fields"):
            return type(template)(*items)
        return type(template)(items)
    return tree


def save_checkpoint(path: str, state, step: int, *, config: Optional[dict] = None):
    """Save ``state`` at ``path/step_<step>`` (and ``config`` as
    ``path/config.json``)."""
    ckpt_dir = _step_dir(path, step)
    os.makedirs(ckpt_dir, exist_ok=True)
    torch.save(_plain(state), os.path.join(ckpt_dir, _STATE_FILE))
    if config is not None:
        with open(os.path.join(os.path.abspath(path), "config.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)


def latest_step(path: str) -> Optional[int]:
    """The highest step saved under ``path``, or None."""
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path) if d.startswith("step_") and d.split("_")[1].isdigit()]
    return max(steps) if steps else None


def load_checkpoint(path: str, template=None, step: Optional[int] = None, *, device=None):
    """Restore the tree saved by :func:`save_checkpoint` at ``step`` (default
    the latest). ``template``, when given (e.g. a freshly initialized state),
    fixes the tree's structure, container types, dtypes and devices; without
    one the tensors load on ``device`` (None: the card; pass ``"cpu"`` for the
    CPU). Returns (state, step)."""
    if template is not None and device is not None:
        raise ValueError("pass a template or a device, not both: the template's tensors fix the devices")
    where = torch.device("cpu") if template is not None else resolve_device(device)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    state = torch.load(os.path.join(_step_dir(path, step), _STATE_FILE), map_location=where, weights_only=True)
    return (state if template is None else _like(template, state)), step
