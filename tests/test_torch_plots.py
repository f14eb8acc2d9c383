"""PyTorch port: the plots of ``pipelines.postprocess`` write their files
from the port's own outputs (the Agg backend, files under ``tmp_path``).

The inputs are a short NN VI run, its sensitivity scores, predictive draws
of the VI posterior, and DeepONet predictions from random weights; the
per-layer sensitivity maps take the MLP's flat layout (a config) or a tree
of arrays, one file per parameter tensor, as JAX's.
"""

import os

import numpy as np
import pytest
import torch

from torch_parity_helpers import one_torch_thread  # noqa: F401
from vihmc_torch.models.bayesian import BayesianFlat
from vihmc_torch.models.deeponet import DeepONetConfig, deeponet_apply, unravel_deeponet
from vihmc_torch.models.mlp import MLPConfig
from vihmc_torch.pipelines import configs as TC
from vihmc_torch.pipelines import postprocess as tpost
from vihmc_torch.pipelines import sensitivity as tsens
from vihmc_torch.pipelines import vi_train as tvt
from vihmc_torch.pipelines.common import mlp_vi_apply
from vihmc_torch.vi.train import VIConfig, predictive_samples

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def nn_outputs():
    out = tvt.run_nn(TC.NNVIRunConfig(vi=VIConfig(epochs=30, num_ens=2, lr_start=1e-2)),
                     device="cpu")
    sens = tsens.run_nn(out["best_state"].vp, MLPConfig(), out["data"]["x_val"])
    vp = out["best_state"].vp
    model = BayesianFlat(mlp_vi_apply(MLPConfig()), vp["mu"], vp["rho"])
    preds = predictive_samples(model, {"x": out["data"]["x_val"]}, 12,
                               generator=torch.Generator().manual_seed(0))
    return out, sens, preds


def test_vi_plots_write_files(tmp_path, nn_outputs):
    """plot_metrics (the VI rows), plot_predictions and plot_uq (predictive
    draws of the VI posterior, tensors) each write their file."""
    out, _, preds = nn_outputs
    data = out["data"]
    paths = [tpost.plot_metrics(out["metrics"], path=str(tmp_path / "m.pdf")),
             tpost.plot_predictions(data["x_val"], preds, truth=data["y_val"],
                                    train_xy=(data["x_train"], data["y_train"]),
                                    path=str(tmp_path / "p.pdf")),
             tpost.plot_uq(data["x_val"], preds.mean(0), preds.std(0), truth=data["y_val"],
                           path=str(tmp_path / "uq.pdf"))]
    assert all(os.path.getsize(p) > 0 for p in paths)


def test_sensitivity_plots_write_files(tmp_path, nn_outputs):
    """The score histogram, the captured-variance curve and the per-layer
    maps: one file per parameter tensor of the MLP's flat layout (3 biases,
    3 weights), the same segments as a tree of arrays in ravel order."""
    _, sens, _ = nn_outputs
    scores = sens["scores"]
    assert os.path.exists(tpost.plot_sensitivity_histogram(scores, str(tmp_path / "h.pdf")))
    assert os.path.exists(tpost.plot_captured_variance(scores, str(tmp_path / "cv.pdf")))
    cfg = MLPConfig()
    paths = tpost.plot_sensitivity_layers(scores, cfg, path_prefix=str(tmp_path / "layer"))
    assert len(paths) == 6 and all(os.path.exists(p) for p in paths)
    tree = [{"w": np.zeros((o, i)), "b": np.zeros(o)} for i, o in cfg.layer_dims]
    assert tpost.layout_segments(tree) == tpost.layout_segments(cfg)
    assert tpost.layout_segments(cfg)[-1][1] == cfg.num_params == len(scores)
    dcfg = DeepONetConfig(in_branch=5, in_trunk=5, width_branch=4, width_trunk=4,
                          depth_branch=3, depth_trunk=3)
    segs = tpost.layout_segments(dcfg)
    assert len(segs) == 13 and segs[0] == (0, 1, ()) and segs[-1][1] == dcfg.num_params


def test_operator_plots_write_files(tmp_path):
    """plot_error_sigma_correlation (two files) and animate_solution (an mp4,
    or a GIF without ffmpeg) on DeepONet predictions of 6 random weight
    vectors over a 5 x 8 (t, x) grid."""
    nt, nx = 5, 8
    cfg = DeepONetConfig(in_branch=8, in_trunk=5, width_branch=6, width_trunk=6,
                         depth_branch=3, depth_trunk=3)
    gen = torch.Generator().manual_seed(2)
    flat = 0.3 * torch.randn((6, cfg.num_params), generator=gen)
    bx = torch.randn((3, 8), generator=gen)
    t, x = torch.meshgrid(torch.linspace(0, 1, nt), torch.linspace(0, 1, nx), indexing="ij")
    tx = torch.stack([t.reshape(-1), x.reshape(-1)], -1)
    preds = deeponet_apply(cfg, unravel_deeponet(cfg, flat), bx, tx)   # (6, 3, 40)
    truth = preds.mean(0) + 0.05
    paths = tpost.plot_error_sigma_correlation(preds, truth, nt=nt, nx=nx,
                                               path_prefix=str(tmp_path / "corr"))
    assert len(paths) == 2 and all(os.path.exists(p) for p in paths)
    out = tpost.animate_solution(preds[:, 0], truth[0], nt=nt, nx=nx,
                                 path=str(tmp_path / "sol.mp4"), fps=2)
    assert os.path.exists(out)
