"""Checkpoints of training and sampler state with ``torch.save``.

Counterpart of ``vihmc_tpu/io/checkpoint.py`` (:21-57): one entry per step,
``<directory>/step_<step>.pt``, holding any nest of dicts, lists, tuples,
dataclasses, tensors and numbers (an ``HMCState`` with its dual averaging,
Welford moments, carried metric and momentum; a ``VITrainState`` with its
Adam moments; a ``torch.Generator``'s ``get_state()``). A checkpoint is
written under a temporary name and then renamed with ``os.replace``, so a
step that :func:`latest_step` reports is complete.

The format is the port's own: a JAX (orbax) checkpoint cannot be resumed
here, nor a port checkpoint by the JAX package. Loading unpickles, which can
run code: load only checkpoints this program wrote.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Optional

import torch

_STEP = re.compile(r"^step_(\d+)\.pt$")


def _path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{int(step)}.pt")


def save_checkpoint(directory: str, step: int, state: Any) -> str:
    """Write ``state`` as ``directory/step_<step>.pt`` (atomically)."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    """The highest complete step under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for m in map(_STEP.match, os.listdir(directory)) if m]
    return max(steps) if steps else None


def _first_device(obj):
    if isinstance(obj, torch.Tensor):
        return obj.device
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        for v in obj:
            dev = _first_device(v)
            if dev is not None:
                return dev
    return None


def load_checkpoint(directory: str, step: Optional[int] = None, template: Any = None,
                    map_location=None) -> Any:
    """Restore a checkpoint (the latest step by default). Its tensors go to
    ``map_location``, else to the device of ``template``'s first tensor (a
    state of the same structure), else to the CPU."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    if map_location is None:
        map_location = _first_device(template) if template is not None else None
    return torch.load(_path(directory, step), map_location=map_location or "cpu",
                      weights_only=False)
