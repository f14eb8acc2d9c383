"""PyTorch port: the command line (``python -m vihmc_torch``) against the JAX
package's (``tests/test_cli.py``), run in process with ``--device cpu``.

The parser has JAX's subcommands and flags plus ``--device``; the flows of
``tests/test_cli.py`` run at their epoch and draw counts; a run that JAX's
``vi-hmc`` wrote is re-scored by the port's ``reevaluate``.
"""

import argparse

import jax
import numpy as np
import pytest

from torch_parity_helpers import one_torch_thread  # noqa: F401 (a fixture)
from vihmc_tpu.pipelines import cli as jcli
from vihmc_torch.pipelines import cli

pytestmark = pytest.mark.usefixtures("one_torch_thread")
CPU = ["--device", "cpu"]


def _flags(parser):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {s for a in p._actions for s in a.option_strings}
            for name, p in sub.choices.items()}


def test_parser_matches_jax():
    """The same subcommands, and every subcommand the same flags, apart from
    the port's --device (on every command but postprocess); the same
    defaults."""
    port, jax_ = _flags(cli.build_parser()), _flags(jcli.build_parser())
    assert sorted(port) == sorted(jax_)
    for name in jax_:
        extra = set() if name == "postprocess" else {"--device"}
        assert port[name] == jax_[name] | extra, name
    for argv in (["vi-hmc", "--artifacts", "x"], ["reevaluate", "--run", "r"], ["bench"],
                 ["vi-nn"], ["predict", "--run", "r"], ["postprocess", "--runs", "a"]):
        got = vars(cli.build_parser().parse_args(argv))
        want = vars(jcli.build_parser().parse_args(argv))
        assert got.pop("device", "cuda") == "cuda"
        assert got == want, argv


def _vi_nn(out, uid, epochs="2", sens=True):
    argv = ["vi-nn", "--epochs", epochs, "--out", out, "--uid", uid] + CPU
    assert cli.main(argv + (["--with-sensitivity"] if sens else [])) == 0


def test_cli_vi_nn_with_sensitivity_then_vi_hmc(tmp_path):
    out = str(tmp_path)
    _vi_nn(out, "demo", "3")
    for name in ("means_flattened", "stds_flattened", "gradient_indices",
                 "vi_mu_flattened", "vi_sigma_flattened", "config"):
        assert any((tmp_path / "demo").glob(f"{name}.*")), name
    assert (tmp_path / "demo" / "output.txt").read_text().count("\n") == 3
    assert cli.main(["vi-hmc", "--artifacts", str(tmp_path / "demo"), "--num-samples", "8",
                     "--num-chains", "1", "--out", out, "--uid", "hmc"] + CPU) == 0
    samples = np.load(tmp_path / "hmc" / "hmc_params.npy")
    assert samples.ndim == 3 and np.isfinite(samples).all()


def test_cli_vi_nn_lrt_and_save_vi_trace(tmp_path):
    """vi-nn --mode lrt; vi-hmc --policy refresh --save-vi-trace stores one
    141-parameter frozen vector per chain and draw, and the draws used them:
    each stored sample's log-density under its draw's stored frozen vector
    is the sampler's record (rtol 1e-5)."""
    out = str(tmp_path)
    assert cli.main(["vi-nn", "--epochs", "2", "--mode", "lrt", "--with-sensitivity",
                     "--out", out, "--uid", "demo"] + CPU) == 0
    rc, res = cli.run(["vi-hmc", "--artifacts", str(tmp_path / "demo"), "--num-samples", "6",
                       "--num-chains", "2", "--policy", "refresh", "--save-vi-trace",
                       "--out", out, "--uid", "hmc"] + CPU)
    assert rc == 0
    trace = np.load(tmp_path / "hmc" / "vi_params.npy")
    assert trace.shape == (2, 6, 141) and np.isfinite(trace).all()
    import torch

    samples = torch.as_tensor(res["result"].samples)
    for s in range(6):
        lp = res["log_prob"](samples[:, s], torch.as_tensor(trace[:, s]))
        np.testing.assert_allclose(lp.numpy(), res["result"].log_probs[:, s], rtol=1e-5)


def test_cli_vi_hmc_algorithm_chees(tmp_path):
    out = str(tmp_path)
    _vi_nn(out, "d")
    assert cli.main(["vi-hmc", "--artifacts", f"{out}/d", "--num-samples", "10",
                     "--num-chains", "2", "--algorithm", "chees", "--out", out,
                     "--uid", "hc"] + CPU) == 0
    samples = np.load(tmp_path / "hc" / "hmc_params.npy")
    assert samples.shape[:2] == (2, 10) and np.isfinite(samples).all()


def test_cli_postprocess_stacks_runs(tmp_path, capsys):
    from vihmc_torch.io import RunStore

    s1 = RunStore(str(tmp_path), uid="a")
    s2 = RunStore(str(tmp_path), uid="b")
    rng = np.random.default_rng(0)
    s1.save_array("hmc_params", rng.normal(size=(10, 3)))
    s2.save_array("hmc_params", rng.normal(size=(2, 10, 3)))
    out = str(tmp_path / "stacked.npy")
    assert cli.main(["postprocess", "--runs", str(tmp_path / "a"), str(tmp_path / "b"),
                     "--burn", "4", "--out", out]) == 0
    assert np.load(out).shape == (6 + 2 * 6, 3)
    assert "stacked 18 post-burn samples (dim 3) from 2 runs" in capsys.readouterr().out


def test_cli_hmc_full(tmp_path):
    assert cli.main(["hmc-full", "--num-samples", "8", "--num-chains", "1", "--step-size",
                     "1e-4", "--out", str(tmp_path), "--uid", "h"] + CPU) == 0
    assert (tmp_path / "h" / "hmc_params.npy").exists()
    assert (tmp_path / "h" / "config.json").exists()


def test_cli_standalone_sensitivity_reevaluate_predict(tmp_path):
    """Every stage standalone: VI, sensitivity against the finished VI run,
    VI-HMC, then reevaluate (the vi-hmc run's own metrics: the same data of
    the seed and the same frozen base) and predict."""
    out = str(tmp_path)
    _vi_nn(out, "vi", "3", sens=False)
    assert (tmp_path / "vi" / "vi_mu_flattened.npy").exists()
    assert cli.main(["sensitivity", "--vi-run", f"{out}/vi", "--out", out,
                     "--uid", "sens"] + CPU) == 0
    for name in ("means_flattened", "stds_flattened", "gradient_indices",
                 "sensitivity_scores"):
        assert (tmp_path / "sens" / f"{name}.npy").exists()
    rc, hmc = cli.run(["vi-hmc", "--artifacts", f"{out}/sens", "--num-samples", "10",
                       "--num-chains", "2", "--policy", "mean", "--out", out,
                       "--uid", "hmc"] + CPU)
    assert rc == 0
    rc, re = cli.run(["reevaluate", "--run", f"{out}/hmc", "--artifacts", f"{out}/sens",
                      "--out", out, "--uid", "reeval"] + CPU)
    assert rc == 0
    for k, v in re["metrics"].items():
        np.testing.assert_allclose(v, hmc["metrics"][k], rtol=1e-6)
    assert cli.main(["predict", "--run", f"{out}/hmc", "--artifacts", f"{out}/sens",
                     "--keep", "5", "--out", out, "--uid", "pred"] + CPU) == 0
    preds = np.load(tmp_path / "pred" / "predictions.npy")
    assert preds.shape[0] == 5 and np.isfinite(preds).all()
    assert np.isfinite(np.load(tmp_path / "pred" / "pred_mean.npy")).all()


def test_cli_vi_hmc_segmented_and_adaptive(tmp_path):
    """--segment/--ckpt/--thin with coupled, continuing dual averaging; a
    second call resumes from the checkpoint and returns the same samples."""
    out = str(tmp_path)
    _vi_nn(out, "d")
    argv = ["vi-hmc", "--artifacts", f"{out}/d", "--num-samples", "12", "--num-chains", "2",
            "--segment", "6", "--thin", "2", "--ckpt", f"{out}/ck", "--adapt-step-size",
            "--da-axis", "--adapt-forever", "--target-accept", "0.7", "--out", out] + CPU
    assert cli.main(argv + ["--uid", "h"]) == 0
    samples = np.load(tmp_path / "h" / "hmc_params.npy")
    assert samples.shape[:2] == (2, 6) and np.isfinite(samples).all()  # thinned
    assert sorted(p.name for p in (tmp_path / "ck").glob("step_*")) == ["step_1.pt",
                                                                      "step_2.pt"]
    assert cli.main(argv + ["--uid", "h2"]) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "h2" / "hmc_params.npy"), samples)


def test_cli_vi_hmc_round4_recipe_flags(tmp_path):
    out = str(tmp_path)
    _vi_nn(out, "d")
    assert cli.main(["vi-hmc", "--artifacts", f"{out}/d", "--num-samples", "10",
                     "--num-chains", "2", "--policy", "draw", "--lowrank-rank", "4",
                     "--init-optimize", "5", "--algorithm", "auto", "--out", out,
                     "--uid", "r4"] + CPU) == 0
    samples = np.load(tmp_path / "r4" / "hmc_params.npy")
    assert samples.shape[:2] == (2, 10) and np.isfinite(samples).all()


def test_cli_operator_cone_is_refused(tmp_path):
    """vi-operator --dataset Cone raises NotImplementedError naming the
    ROADMAP item that ports it."""
    with pytest.raises(NotImplementedError, match="Cone.*ROADMAP Queue 1"):
        cli.main(["vi-operator", "--dataset", "Cone", "--out", str(tmp_path)] + CPU)


def test_reevaluate_of_a_jax_run_matches_jax(tmp_path):
    """JAX's vi-nn and vi-hmc write a run (JAX's CLI); the port re-scores its
    hmc_params with JAX's validation data injected: every metric within rtol
    1e-5 of JAX's reevaluate_nn. The port's own reevaluate command reads the
    same run directories."""
    import torch

    from vihmc_tpu.data.synthetic import regression_data
    from vihmc_tpu.io import RunStore as JStore
    from vihmc_tpu.models import MLPConfig as JMLP
    from vihmc_tpu.pipelines import configs as JC
    from vihmc_tpu.pipelines import vi_hmc as jv
    from vihmc_torch.io import RunStore
    from vihmc_torch.models import MLPConfig
    from vihmc_torch.pipelines import configs as TC
    from vihmc_torch.pipelines import vi_hmc as tv

    out = str(tmp_path)
    assert jcli.main(["vi-nn", "--epochs", "2", "--out", out, "--uid", "vi",
                      "--with-sensitivity"]) == 0
    assert jcli.main(["vi-hmc", "--artifacts", f"{out}/vi", "--num-samples", "6",
                      "--num-chains", "2", "--out", out, "--uid", "hmc"]) == 0
    arts = {"mu": np.load(f"{out}/vi/means_flattened.npy"),
            "sigma": np.load(f"{out}/vi/stds_flattened.npy"),
            "indices": np.load(f"{out}/vi/gradient_indices.npy")}
    saved = JStore.open(out, "hmc").load_config()
    jcfg = JC.VIHMCRunConfig(**{k: v for k, v in saved.items()
                                if k in JC.VIHMCRunConfig.__dataclass_fields__})
    tcfg = TC.VIHMCRunConfig(**{k: v for k, v in saved.items()
                                if k in TC.VIHMCRunConfig.__dataclass_fields__})
    jdata = regression_data(jax.random.key(4), noise_std=0.05)
    want = jv.reevaluate_nn(jcfg, JMLP(), arts, JStore.open(out, "hmc"), data=jdata)
    got = tv.reevaluate_nn(tcfg, MLPConfig(), arts, RunStore.open(out, "hmc"),
                           data={k: np.asarray(v) for k, v in jdata.items()}, device="cpu")
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], np.asarray(v), rtol=1e-5)
    np.testing.assert_allclose(got["diagnostics"]["ess"], np.asarray(want["diagnostics"]["ess"]),
                               rtol=1e-5)
    assert isinstance(got["predictions"], np.ndarray) and torch.isfinite(
        torch.as_tensor(got["mean_prediction"])).all()
    assert cli.main(["reevaluate", "--run", f"{out}/hmc", "--artifacts", f"{out}/vi",
                     "--out", out, "--uid", "re"] + CPU) == 0
