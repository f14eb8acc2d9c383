"""What the result scripts share: output paths, the Burgers and regression
data of a data seed, and the DeepONet a bundle belongs to."""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from vihmc_torch.data.burgers import (ASSETS, generate_burgers_dataset, get_burgers,
                                      load_port_inputs)
from vihmc_torch.data.synthetic import regression_data
from vihmc_torch.models.deeponet import DeepONetConfig

REPO = os.path.dirname(ASSETS)
RESULTS = os.path.join(REPO, "docs", "results")
#: the committed stage-1/2 bundle the operator scripts fall back to
#: (``scripts/run_operator_stage3.py`` reads it for the data parameters)
STAGE12_BUNDLE = os.path.join(ASSETS, "burgers_stage12.npz")
#: ``--small``: the scripts' CPU-scale DeepONet, 32 + 16 functions on a 17 x 17 grid
SMALL_DEEPONET = DeepONetConfig(in_branch=17, in_trunk=5, width_branch=16, width_trunk=16,
                                depth_branch=3, depth_trunk=3)
SMALL_SIZES = {"n_train": 32, "n_valid": 16, "nx": 17, "nt": 17, "p": 64}


def runs_path(script: str, name: str = "") -> str:
    """``runs/torch_<script>/<name>``: where an output that the JAX script
    writes into a committed file goes instead."""
    return os.path.join("runs", f"torch_{script}", name) if name else os.path.join(
        "runs", f"torch_{script}")


def check_output(path: str) -> str:
    """``path``, unless it lies under ``assets/`` or ``docs/results/`` (the
    committed inputs and the JAX package's results): ValueError there."""
    full = os.path.abspath(path)
    for root in (ASSETS, RESULTS):
        if os.path.commonpath([full, root]) == root:
            raise ValueError(f"{path}: the port writes no output under {root}")
    return path


def write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def deeponet_for(num_params: int) -> DeepONetConfig:
    """The DeepONet of a flat vector of ``num_params``: the reference one
    (172,401) or ``--small``'s; JAX's scripts always take the reference one."""
    for cfg in (DeepONetConfig(), SMALL_DEEPONET):
        if cfg.num_params == num_params:
            return cfg
    raise ValueError(f"no known DeepONet has {num_params} parameters")


def bundle_meta(path: str = STAGE12_BUNDLE) -> dict:
    """The data parameters of a stage-1/2 bundle."""
    with np.load(path) as z:
        return {k: int(z[k]) for k in ("data_seed", "n_train", "n_valid", "nx", "nt")}


def load_bundle(path: str) -> dict:
    """``mu``, ``sigma``, ``indices``, ``scores`` and the data parameters of a bundle."""
    with np.load(path) as z:
        out = {k: z[k] for k in ("mu", "sigma", "indices", "scores")}
    return {**out, **bundle_meta(path)}


def burgers_splits(device, data_seed: int, n_train: int, n_valid: int, nx: int = 101,
                   nt: int = 101):
    """``(train, valid)`` Burgers splits of a bundle's data parameters.

    JAX's scripts regenerate the data from ``jax.random.key(data_seed)``,
    which PyTorch cannot replay. On the exported grid with data seed 0 (every
    committed bundle's) the port solves the exported initial conditions, the
    same functions (``data.burgers.get_burgers``); any other seed or grid
    (``--small``'s 17 x 17) draws new GRF initial conditions from a
    ``torch.Generator`` seeded with ``data_seed``."""
    grid = load_port_inputs()
    if (data_seed == 0 and (nx, nt) == (int(grid["nx"]), int(grid["nt"]))
            and n_train <= int(grid["n_train"]) and n_valid <= int(grid["n_valid"])):
        return get_burgers(device, n_train, n_valid)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(data_seed))
    full = generate_burgers_dataset(gen, n_train + n_valid, nx=nx, nt=nt, device=device)

    def rows(a, b):
        return {"branch_in": full["branch_in"][a:b].contiguous(),
                "trunk_in": full["trunk_in"],
                "solution": full["solution"][a:b].contiguous()}

    return rows(0, n_train), rows(n_train, n_train + n_valid)


def nn_regression_data(device) -> dict:
    """The NN workload's data of ``regression_data(jax.random.key(0), 20,
    300, noise_std=5e-2)``: the exported training targets
    (``assets/nn_port_inputs.npz``, the points ``bench_nn`` closes over;
    PyTorch cannot replay JAX's noise draws) and the noise-free validation
    curve."""
    with np.load(os.path.join(ASSETS, "nn_port_inputs.npz")) as z:
        x_train, y_train = z["x_train"], z["y_train"]
    data = regression_data(20, 300, noise_std=5e-2, noise=np.zeros_like(y_train),
                           device=device)
    if not np.array_equal(data["x_train"].cpu().numpy(), x_train):
        raise ValueError("the exported training points differ from regression_data's")
    data["y_train"] = torch.as_tensor(y_train, device=data["x_val"].device)
    return data


def stage12_artifacts(path: str):
    """``(artifacts, meta, model)`` of a stage-1/2 run store directory
    (``<root>/<uid>``) written by either package, or, when it is missing, of
    the committed bundle ``assets/burgers_stage12.npz``. The data parameters
    and the DeepONet come from the store's ``stage12_data.json`` (the port
    writes it); a JAX store or the bundle has none, and then they are the
    bundle's parameters, as the JAX script takes them, and
    :func:`deeponet_for` the parameter count."""
    from vihmc_torch.io.artifacts import RunStore

    if not os.path.isdir(path):
        print(f"[artifacts] {path} missing; using "
              f"{os.path.relpath(STAGE12_BUNDLE, REPO)}", flush=True)
        b = load_bundle(STAGE12_BUNDLE)
        return ({k: b[k] for k in ("mu", "sigma", "indices", "scores")},
                {k: b[k] for k in ("data_seed", "n_train", "n_valid", "nx", "nt")},
                deeponet_for(len(b["mu"])))
    root, uid = os.path.split(path.rstrip("/"))
    store = RunStore.open(root or ".", uid)
    arts = {"mu": store.load_array("means_flattened"),
            "sigma": store.load_array("stds_flattened"),
            "indices": store.load_array("gradient_indices"),
            "scores": store.load_array("sensitivity_scores")}
    data_json = os.path.join(store.path, "stage12_data.json")
    if not os.path.exists(data_json):
        return arts, bundle_meta(), deeponet_for(len(arts["mu"]))
    with open(data_json) as f:
        meta = json.load(f)
    model = DeepONetConfig(**meta.pop("model"))
    return arts, {k: int(v) for k, v in meta.items()}, model


def json_line(tag: Optional[str], obj) -> None:
    """Print ``obj`` as JSON (indented like the scripts' summaries, or one
    ``[tag] {...}`` line)."""
    if tag is None:
        print(json.dumps(obj, indent=2), flush=True)
    else:
        print(f"[{tag}] {json.dumps(obj)}", flush=True)
