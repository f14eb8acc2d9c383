"""Run-uid artifact store: the filesystem contract between pipeline stages.

Counterpart of ``RunStore`` in ``vihmc_tpu/io/artifacts.py`` with the same
on-disk layout -- one directory per run uid, arrays as ``<name>.npy``, the
config as ``<name>.json`` -- so a run directory written by the JAX package
loads here and the other way round. numpy only.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
from typing import Any, Optional

import numpy as np


def make_uid(now: Optional[datetime.datetime] = None) -> str:
    """Timestamp uid ``%d_%m_%Y_%H_%M_%S`` like the reference, plus the SLURM
    job id when running under SLURM."""
    now = now or datetime.datetime.now()
    uid = now.strftime("%d_%m_%Y_%H_%M_%S")
    slurm = os.environ.get("SLURM_JOB_ID")
    return f"{uid}_{slurm}" if slurm else uid


def _to_jsonable(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _to_jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


class RunStore:
    """Artifact directory for one run uid."""

    def __init__(self, root: str, uid: Optional[str] = None):
        self.uid = uid or make_uid()
        self.path = os.path.join(root, self.uid)
        os.makedirs(self.path, exist_ok=True)

    def save_array(self, name: str, array) -> str:
        out = os.path.join(self.path, f"{name}.npy")
        np.save(out, np.asarray(array))
        return out

    def load_array(self, name: str) -> np.ndarray:
        return np.load(os.path.join(self.path, f"{name}.npy"), allow_pickle=False)

    def save_config(self, config: Any, name: str = "config") -> str:
        """Config snapshot (the reference copies config.py next to artifacts)."""
        out = os.path.join(self.path, f"{name}.json")
        with open(out, "w") as f:
            json.dump(_to_jsonable(config), f, indent=2, default=str)
        return out

    def load_config(self, name: str = "config") -> dict:
        with open(os.path.join(self.path, f"{name}.json")) as f:
            return json.load(f)

    def append_metrics_row(self, row, name: str = "output") -> None:
        """Per-epoch metric lines, one file per run (the reference writes
        '<uid>_output.txt')."""
        with open(os.path.join(self.path, f"{name}.txt"), "a") as f:
            f.write(" ".join(f"{v:.8g}" for v in row) + "\n")

    @classmethod
    def open(cls, root: str, uid: str) -> "RunStore":
        store = cls.__new__(cls)
        store.uid = uid
        store.path = os.path.join(root, uid)
        if not os.path.isdir(store.path):
            raise FileNotFoundError(store.path)
        return store
