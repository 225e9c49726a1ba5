"""Carry the JAX package's parameters into the port.

``load_flax_params(model, flat)`` takes the parameters of a
``routeformer_tpu`` model as numpy arrays keyed by their nnx flat-state
paths (``nnx.to_flat_state(nnx.state(model, (nnx.Param, nnx.BatchStat)))``,
joined with dots) and copies them into the port's module of the same
architecture. The mapping is mechanical because the port names its modules
after the flax paths:

- ``kernel`` -> ``weight``: Linear (in, out) -> (out, in), Conv1d
  (k, in, out) -> (out, in, k), Conv2d HWIO -> OIHW;
- LayerNorm/BatchNorm ``scale`` -> ``weight``; BatchNorm ``mean``/``var``
  -> ``running_mean``/``running_var``;
- scanned layer axes are unstacked: ``stacked_layers.X`` (Perceive
  encoders) -> ``stacked_layers.{i}.X``, ``pairs.X`` (SwinV2 stages,
  leading n_pairs axis) -> ``pairs.{i}.X`` and ``blocks.X`` (the ViT's
  vmapped blocks, leading depth axis) -> ``blocks.{i}.X``. No other JAX
  module has an attribute of these names;
- other names pass through (the ViT's ``pos_embed``).

A module shared by several parents (FEDformer's tied frequency blocks) is
one entry, under its first path, in flax's state and here. Buffers that
are not flax state are left alone: non-persistent ones (constant tables
and filters) and those a module names in ``port_only_buffers`` (the
Fourier blocks' mode indices, which the JAX package keeps as a Python
list). Any parameter left unmatched, in either direction, raises.
"""

import itertools
import re
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

_STACKED = "stacked_layers|pairs|blocks"
_SCANNED = re.compile(rf"(^|\.)({_STACKED})\.")
_RENAMES = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
            "var": "running_var"}


def _torch_layout(name: str, arr: np.ndarray) -> np.ndarray:
    if not name.endswith(".kernel"):
        return arr
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 3:
        return arr.transpose(2, 1, 0)
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    return arr


def flax_to_torch_names(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Rename, re-layout and unstack a flat flax parameter dict."""
    out = {}
    pending = list(flat.items())
    while pending:
        name, arr = pending.pop()
        arr = np.asarray(arr)
        m = _SCANNED.search(name)
        if m and not re.search(rf"({_STACKED})\.\d+\.", name):
            head, tail = name[: m.end()], name[m.end():]
            pending.extend((f"{head}{i}.{tail}", arr[i]) for i in range(arr.shape[0]))
            continue
        prefix, _, last = name.rpartition(".")
        key = f"{prefix}.{_RENAMES.get(last, last)}" if prefix else _RENAMES.get(last, last)
        out[key] = _torch_layout(name, arr)
    return out


def flax_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The port's counterpart of flax's parameter and batch-statistic state:
    each parameter and persistent buffer once, under its first path, less
    ``num_batches_tracked`` and the ``port_only_buffers``."""
    skip = set()
    for name, module in model.named_modules():
        prefix = f"{name}." if name else ""
        skip.update(prefix + b for b in module._non_persistent_buffers_set)
        skip.update(prefix + b for b in getattr(module, "port_only_buffers", ()))
    return {k: v for k, v in itertools.chain(model.named_parameters(), model.named_buffers())
            if k not in skip and not k.endswith("num_batches_tracked")}


def load_flax_params(model: nn.Module, flat: Dict[str, np.ndarray]) -> int:
    """Copy flax parameters into ``model``; return the number copied."""
    incoming = flax_to_torch_names(flat)
    state = flax_state(model)
    missing = sorted(set(state) - set(incoming))
    unexpected = sorted(set(incoming) - set(state))
    if missing or unexpected:
        raise KeyError(
            f"unmatched parameters: port-only {missing[:10]} "
            f"({len(missing)}), flax-only {unexpected[:10]} ({len(unexpected)})"
        )
    with torch.no_grad():
        for key, target in state.items():
            src = incoming[key]
            if tuple(src.shape) != tuple(target.shape):
                raise ValueError(
                    f"{key}: flax {tuple(src.shape)} vs port {tuple(target.shape)}"
                )
            target.copy_(torch.from_numpy(np.ascontiguousarray(src)).to(target.dtype))
    return len(state)
