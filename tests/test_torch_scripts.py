"""PyTorch port: the result scripts (``vihmc_torch/scripts/``) against
``scripts/*.py``.

Each module's flags and defaults (read from the script's source with
``ast``, plus ``--device``); the configurations and summary keys each
script's ``main`` resolves (both mains run with their pipelines replaced by
recorders that return stand-in outputs); the analysis scripts' numbers on
the same injected draws (a small DeepONet, a hand-written run directory and
checkpoint); a ``--small`` stage 1-2 -> stage 3 -> analyses chain and
``parity_osf`` on a small ``.mat``, end to end on the CPU.
"""

from __future__ import annotations

import ast
import dataclasses
import glob
import importlib
import importlib.util
import json
import os
import types

import numpy as np
import pytest
import scipy.io
import torch

from torch_parity_helpers import assert_shared_fields_equal, one_torch_thread  # noqa: F401
from vihmc_torch.models.deeponet import DeepONetConfig
from vihmc_torch.scripts import _common
from vihmc_torch.scripts import __all__ as SCRIPT_NAMES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
#: the output defaults that would write into committed files in the JAX scripts
CHANGED_DEFAULTS = {("run_operator_stage12", "--assets"), ("run_nn_stage12", "--out"),
                    ("run_cone_demo", "--out"), ("canonicalize_operator_draws", "--out")}
#: the flags that name an output
OUTPUT_FLAGS = {"run_operator_stage12": ("--out", "--assets"),
                "run_operator_stage3": ("--out", "--ckpt"),
                "run_operator_demo": ("--out",), "run_nn_stage12": ("--out",),
                "run_nn_demo": ("--out",), "run_cone_demo": ("--out", "--store"),
                "fs_diagnostics_operator": ("--out",),
                "canonicalize_operator_draws": ("--out",), "parity_osf": ("--out",)}
SMALL_KW = dict(in_branch=17, in_trunk=5, width_branch=16, width_trunk=16, depth_branch=3,
                depth_trunk=3)


def port(name):
    return importlib.import_module(f"vihmc_torch.scripts.{name}")


def jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _script_flags(name) -> dict:
    """``{flag: (default, choices)}`` of every ``add_argument`` in the script's main."""
    tree = ast.parse(open(os.path.join(ROOT, "scripts", f"{name}.py")).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    flags = {}
    for node in ast.walk(main):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            store_true = "action" in kw and ast.literal_eval(kw["action"]) == "store_true"
            default = (ast.literal_eval(kw["default"]) if "default" in kw
                       else (False if store_true else None))
            choices = ast.literal_eval(kw["choices"]) if "choices" in kw else None
            flags[ast.literal_eval(node.args[0])] = (default, choices)
    return flags


SCRIPT_FLAGS = {name: _script_flags(name) for name in SCRIPT_NAMES}
FLAG_CASES = [(name, flag) for name in SCRIPT_NAMES for flag in sorted(SCRIPT_FLAGS[name])]


def _port_actions(name) -> dict:
    return {s: a for a in port(name).build_parser()._actions for s in a.option_strings
            if s.startswith("--") and s != "--help"}


# ---------------------------------------------------------------------------
# flags, defaults, outputs
# ---------------------------------------------------------------------------

def test_nine_modules_one_per_script():
    assert len(SCRIPT_NAMES) == 9 and len(FLAG_CASES) > 60
    for name in SCRIPT_NAMES:
        assert os.path.exists(os.path.join(ROOT, "scripts", f"{name}.py")), name


@pytest.mark.parametrize("name", SCRIPT_NAMES)
def test_flag_sets_equal_the_script_plus_device(name):
    actions = _port_actions(name)
    assert set(actions) == set(SCRIPT_FLAGS[name]) | {"--device"}
    assert actions["--device"].default == "cuda"


@pytest.mark.parametrize("name,flag", FLAG_CASES, ids=[f"{n}{f}" for n, f in FLAG_CASES])
def test_flag_default_and_choices_equal_the_script(name, flag):
    default, choices = SCRIPT_FLAGS[name][flag]
    action = _port_actions(name)[flag]
    if (name, flag) in CHANGED_DEFAULTS:
        assert action.default == os.path.join("runs", f"torch_{name}",
                                              os.path.basename(default))
    else:
        assert action.default == default
    if choices is not None:
        assert sorted(action.choices) == sorted(choices)


@pytest.mark.parametrize("name", SCRIPT_NAMES)
def test_no_default_output_under_committed_directories(name):
    for flag in OUTPUT_FLAGS[name]:
        default = _port_actions(name)[flag].default
        if default is not None:
            _common.check_output(default)
            full = os.path.abspath(os.path.join(ROOT, default))
            for committed in ("assets", os.path.join("docs", "results")):
                assert not full.startswith(os.path.join(ROOT, committed) + os.sep), (flag,
                                                                                    default)


def test_outputs_under_committed_directories_are_refused():
    for path in ("assets/burgers_stage12.npz", "docs/results/cone_demo_summary.json"):
        with pytest.raises(ValueError, match="no output"):
            _common.check_output(os.path.join(ROOT, path))
    with pytest.raises(ValueError, match="no output"):
        port("run_nn_stage12").main(CPU + ["--out", os.path.join(ROOT, "assets", "x.npz")])


# ---------------------------------------------------------------------------
# both mains with their pipelines recorded
# ---------------------------------------------------------------------------

def _burgers(n_train, n_valid, nx, nt, seed=0):
    rng = np.random.default_rng(seed)
    t, x = np.meshgrid(np.linspace(0, 1, nt), np.linspace(0, 1, nx), indexing="ij")
    trunk = np.stack([t.ravel(), x.ravel()], -1).astype(np.float32)

    def split(n):
        return {"branch_in": rng.normal(size=(n, nx)).astype(np.float32), "trunk_in": trunk,
                "solution": rng.normal(size=(n, nx * nt)).astype(np.float32)}

    return split(n_train), split(n_valid)


def _torch_splits(splits):
    return tuple({k: torch.as_tensor(v) for k, v in s.items()} for s in splits)


class Recorder:
    """Stand-ins for the pipeline calls of both packages: each records its
    config and keywords and returns an output with the keys the mains read."""

    def __init__(self, torch_out: bool):
        self.calls = []
        self.torch_out = torch_out
        self.rng = np.random.default_rng(3)

    def vi(self, kind):
        def f(cfg, *a, **kw):
            self.calls.append((kind, cfg, kw))
            data = kw.get("data")
            metrics = np.array([[3.0, 2.0, 1.0, 0.5], [2.5, 1.5, 0.8, 0.4]], np.float32)
            n = cfg.model.num_params
            vp = {"mu": torch.zeros(n), "rho": torch.zeros(n)} if self.torch_out else None
            return {"metrics": metrics, "best_state": types.SimpleNamespace(vp=vp),
                    "data": data}
        return f

    def sens(self, kind):
        def f(vp, model, inputs, cfg=None, *a, **kw):
            self.calls.append((kind, cfg, {"model": model}))
            n = model.num_params
            k = min(12, n)
            out = {"mu": self.rng.normal(size=n).astype(np.float32) * 0.1,
                   "sigma": np.full(n, 0.05, np.float32), "indices": np.arange(k),
                   "scores": np.linspace(1.0, 0.0, n).astype(np.float32), "num_sensitive": k}
            store = kw.get("store")
            if store is not None:
                store.save_array("means_flattened", out["mu"])
            return out
        return f

    def hmc(self, kind, n_valid_p=None):
        def f(cfg, model, artifacts, *a, **kw):
            self.calls.append((kind, cfg, {k: v for k, v in kw.items()
                                           if k not in ("data", "store", "progress")}))
            d = len(artifacts["indices"])
            c, s = cfg.num_chains, cfg.num_samples // kw.get("sample_thin", 1)
            data = kw.get("data")
            truth = data[1]["solution"] if isinstance(data, tuple) else data["y_val"]
            preds = self.rng.normal(size=(2, *truth.shape)).astype(np.float32)
            res = types.SimpleNamespace(
                samples=self.rng.normal(size=(c, s, d)).astype(np.float32),
                accept_probs=np.full((c, cfg.num_samples), 0.7, np.float32),
                step_sizes=np.full((c, cfg.num_samples), 1e-3, np.float32), aux_trace=None)
            diag = {k: np.linspace(1.0, 2.0, d) for k in ("ess", "ess_bulk", "ess_tail",
                                                          "r_hat", "r_hat_rank")}
            diag["tau_floor_frac"] = 0.0
            metrics = {"acceptance_rate": 0.7, "expected_mse_of_mean": 0.1,
                       "expected_log_prob": np.float32(-1.0), "num_divergent": 0,
                       "final_mse": np.float32(0.2), "min_mse": np.float32(0.1)}
            return {"result": res, "metrics": metrics, "diagnostics": diag, "ess": diag["ess"],
                    "predictions": preds, "data": data, "algorithm": cfg.algorithm,
                    "phases_s": {"sampling_s": 1.0}}
        return f

    def hmc_full(self, cfg, *a, **kw):
        self.calls.append(("hmc_full", cfg, {}))
        rng = np.random.default_rng(5)
        x = np.linspace(-1, 1, 20, dtype=np.float32)[:, None]
        xv = np.linspace(-1.2, 1.2, 300, dtype=np.float32)[:, None]
        data = {"x_train": x, "y_train": np.sin(x), "x_val": xv, "y_val": np.sin(xv)}
        if self.torch_out:
            data = {k: torch.as_tensor(v) for k, v in data.items()}
        return {"metrics": {"acceptance_rate": 1.0, "expected_mse_of_mean": 0.3,
                            "expected_log_prob": np.float32(-2.0)},
                "diagnostics": {"ess": rng.random(5)}, "data": data}


def _patch_jax(monkeypatch, rec, burgers):
    import vihmc_tpu.data
    import vihmc_tpu.data.burgers
    import vihmc_tpu.data.cone
    from vihmc_tpu.pipelines import hmc_full, sensitivity, vi_hmc, vi_train

    def fake_burgers(key, n_train, n_valid, mat_path=None, nx=101, nt=101, **kw):
        if mat_path is not None:   # the port's stand-in .mat has a 4 x 4 grid
            nx = nt = 4
        return burgers(n_train, n_valid, nx, nt)

    def fake_cone(key, n_train, n_valid, path=None, in_branch=101):
        return _cone(n_train, n_valid, in_branch)

    monkeypatch.setattr(vihmc_tpu.data, "get_burgers", fake_burgers)
    monkeypatch.setattr(vihmc_tpu.data.burgers, "get_burgers", fake_burgers)
    monkeypatch.setattr(vihmc_tpu.data.cone, "get_cone", fake_cone)
    monkeypatch.setattr(vi_train, "run_operator", rec.vi("vi"))
    monkeypatch.setattr(vi_train, "run_nn", rec.vi("vi"))
    monkeypatch.setattr(sensitivity, "run_operator", rec.sens("sens"))
    monkeypatch.setattr(sensitivity, "run_nn", rec.sens("sens"))
    monkeypatch.setattr(vi_hmc, "run_operator", rec.hmc("hmc"))
    monkeypatch.setattr(vi_hmc, "run_nn", rec.hmc("hmc"))
    monkeypatch.setattr(hmc_full, "run", rec.hmc_full)


def _patch_port(monkeypatch, rec, name, burgers):
    from vihmc_torch.pipelines import hmc_full, sensitivity, vi_hmc, vi_train

    mod = port(name)
    if hasattr(mod, "burgers_splits"):
        monkeypatch.setattr(mod, "burgers_splits",
                            lambda dev, data_seed, n_train, n_valid, nx=101, nt=101:
                            _torch_splits(burgers(n_train, n_valid, nx, nt)))
    if hasattr(mod, "get_burgers"):
        monkeypatch.setattr(mod, "get_burgers", lambda dev, n_train, n_valid, mat_path=None:
                            _torch_splits(burgers(n_train, n_valid, 4, 4)))
    if hasattr(mod, "get_cone"):
        monkeypatch.setattr(mod, "get_cone", lambda gen, n_train, n_valid, in_branch=101,
                            device=None: _torch_splits(_cone(n_train, n_valid, in_branch)))
    monkeypatch.setattr(vi_train, "run_operator", rec.vi("vi"))
    monkeypatch.setattr(vi_train, "run_nn", rec.vi("vi"))
    monkeypatch.setattr(sensitivity, "run_operator", rec.sens("sens"))
    monkeypatch.setattr(sensitivity, "run_nn", rec.sens("sens"))
    monkeypatch.setattr(vi_hmc, "run_operator", rec.hmc("hmc"))
    monkeypatch.setattr(vi_hmc, "run_nn", rec.hmc("hmc"))
    monkeypatch.setattr(hmc_full, "run", rec.hmc_full)


def _cone(n_train, n_valid, in_branch):
    rng = np.random.default_rng(1)

    def split(n):
        return {"branch_in": rng.normal(size=(n, in_branch)).astype(np.float32),
                "trunk_in": rng.random((n, 1, 2)).astype(np.float32),
                "solution": rng.normal(size=(n, 1)).astype(np.float32)}

    return split(n_train), split(n_valid)


def _summary_files(root) -> dict:
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "**", "*.json"), recursive=True)):
        name = os.path.basename(path)
        if name.endswith("summary.json") or name.startswith(("canonical", "fs_")):
            with open(path) as f:
                out[name] = json.load(f)
    for path in glob.glob(os.path.join(root, "**", "*.npz"), recursive=True):
        with np.load(path) as z:
            out[os.path.basename(path)] = {k: None for k in z.files}
    return out


def _key_tree(obj):
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    return None


def _out_args(name, root):
    """Arguments that keep every output of ``name`` under ``root``."""
    return {"run_operator_stage12": ["--out", f"{root}/s12", "--assets", f"{root}/b.npz"],
            "run_operator_stage3": ["--out", f"{root}/s3", "--uid", "u",
                                    "--artifacts", f"{root}/missing"],
            "run_operator_demo": ["--out", f"{root}/demo"],
            "run_nn_demo": ["--out", f"{root}/nn"],
            "run_cone_demo": ["--out", f"{root}/cone_demo_summary.json", "--store", f"{root}/cs"],
            "parity_osf": ["--out", f"{root}/osf", "--mat", "unused.mat"],
            "run_nn_stage12": ["--out", f"{root}/nn_stage12.npz"]}[name]


RECIPES = [
    ("run_operator_stage12", ["--small"]),
    ("run_operator_stage12", []),
    ("run_operator_stage3", ["--draws", "10", "--chains", "2", "--segment", "5", "--thin", "5",
                             "--adapt", "--da-axis", "--adapt-forever", "--jitter", "l"]),
    ("run_operator_stage3", ["--variant", "gauss", "--draws", "10", "--chains", "2",
                             "--segment", "10", "--thin", "1", "--no-eval"]),
    ("run_operator_stage3", ["--variant", "autodiff", "--draws", "10", "--chains", "2",
                             "--segment", "10", "--step", "0.002", "--laplace-mass",
                             "--frozen-policy", "refresh", "--clip-scale", "0"]),
    ("run_operator_demo", ["--small"]),
    ("run_operator_demo", ["--small", "--gauss-field"]),
    ("run_operator_demo", ["--epochs", "3", "--draws", "10"]),
    ("run_nn_stage12", ["--epochs", "30"]),
    ("run_nn_demo", ["--epochs", "20", "--hmc-draws", "5", "--vihmc-draws", "10",
                     "--converged-draws", "20"]),
    ("run_cone_demo", ["--small"]),
    ("run_cone_demo", ["--epochs", "3", "--draws", "10", "--chains", "2"]),
    ("parity_osf", ["--epochs", "2", "--draws", "10", "--burn", "3", "--chains", "2",
                    "--n-train", "6", "--n-valid", "5"]),
]


@pytest.mark.parametrize("name,argv", RECIPES, ids=[f"{n} {' '.join(a)}" for n, a in RECIPES])
def test_configs_and_summary_keys_equal_the_script(name, argv, monkeypatch, tmp_path,
                                                    capsys, one_torch_thread):
    """Both mains with their pipelines recorded: the same calls in the same
    order with the same configurations (every field the port's config shares
    with JAX's), models and sampler keywords, and the same summary keys."""
    monkeypatch.chdir(ROOT)
    (tmp_path / "jax").mkdir()
    jrec, trec = Recorder(False), Recorder(True)
    _patch_jax(monkeypatch, jrec, _burgers)
    monkeypatch.setattr("sys.argv", [name] + argv + _out_args(name, tmp_path / "jax"))
    jax_script(name).main()
    _patch_port(monkeypatch, trec, name, _burgers)
    port(name).main(argv + _out_args(name, tmp_path / "port") + CPU)
    capsys.readouterr()
    assert [c[0] for c in trec.calls] == [c[0] for c in jrec.calls]
    for (kind, tcfg, tkw), (_, jcfg, jkw) in zip(trec.calls, jrec.calls):
        if tcfg is not None:
            assert_shared_fields_equal(tcfg, jcfg)
        if kind == "sens":
            assert_shared_fields_equal(tkw["model"], jkw["model"])
        if kind == "hmc":
            for k in ("segment_size", "sample_thin", "evaluate", "checkpoint_dir"):
                assert tkw.get(k, _DEFAULTS[k]) == jkw.get(k, _DEFAULTS[k]), k
            # stage 3's density: fused in the port's script, composed in JAX's
            assert tkw.get("use_fused", False) == (name == "run_operator_stage3")
    assert _key_tree(_summary_files(tmp_path / "port")) == _key_tree(
        _summary_files(tmp_path / "jax"))


_DEFAULTS = {"segment_size": None, "sample_thin": 1, "evaluate": True, "checkpoint_dir": None}


# ---------------------------------------------------------------------------
# the analysis scripts' numbers on the same draws
# ---------------------------------------------------------------------------

@pytest.fixture
def small_jax_deeponet(monkeypatch):
    """JAX's scripts take ``DeepONetConfig()``: here the small one."""
    import vihmc_tpu.models as jmodels

    small = jmodels.DeepONetConfig(**SMALL_KW)
    monkeypatch.setattr(jmodels, "DeepONetConfig", lambda: small)
    return small


def _small_bundle(path, indices):
    rng = np.random.default_rng(11)
    n = _common.SMALL_DEEPONET.num_params
    np.savez(path, mu=(0.3 * rng.normal(size=n)).astype(np.float32),
             sigma=np.full(n, 0.05, np.float32), indices=np.asarray(indices, np.int32),
             scores=rng.random(n).astype(np.float32), data_seed=0, n_train=32, n_valid=16,
             nx=17, nt=17, vi_epochs=5, vi_p=64, vi_valid_mse=np.ones(5, np.float32))
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_fs_diagnostics_equal_jax_on_the_same_draws(small_jax_deeponet, monkeypatch, tmp_path,
                                                    capsys):
    """The fs_* numbers within 1e-4 relative (f32 probe forwards in each
    package) and the weight-space evidence exactly (numpy on the same draws),
    with a basin split on the worst coordinate."""
    import vihmc_tpu.data

    idx = np.sort(np.random.default_rng(2).choice(_common.SMALL_DEEPONET.num_params, 40,
                                                  replace=False))
    bundle = _small_bundle(tmp_path / "b.npz", idx)
    rng = np.random.default_rng(4)
    x = (bundle["mu"][idx] + 0.05 * rng.normal(size=(6, 24, 40))).astype(np.float32)
    x[:2, :, 7] += 0.8                                    # two chains in another basin
    run = tmp_path / "run"
    run.mkdir()
    np.save(run / "hmc_params.npy", x)
    with open(run / "demo_summary.json", "w") as f:
        json.dump({"variant": "stride", "draws": 24, "thin": 1, "burn": 4}, f)
    burgers = _burgers(32, 16, 17, 17, seed=9)
    monkeypatch.setattr(vihmc_tpu.data, "get_burgers",
                        lambda key, n_train, n_valid, nx=101, nt=101, **kw: burgers)
    fs_mod = port("fs_diagnostics_operator")
    monkeypatch.setattr(fs_mod, "burgers_splits", lambda *a: _torch_splits(burgers))
    args = ["--run", str(run), "--assets", str(tmp_path / "b.npz"), "--thin", "2",
            "--probe-fns", "5", "--probe-pts", "30"]
    monkeypatch.setattr("sys.argv", ["fs"] + args + ["--out", str(tmp_path / "j.json")])
    jax_script("fs_diagnostics_operator").main()
    got = fs_mod.main(args + ["--out", str(tmp_path / "t.json")] + CPU)
    capsys.readouterr()
    want = json.load(open(tmp_path / "j.json"))
    assert set(got) == set(want)
    for k, v in want.items():
        if k.startswith("fs_") and isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-4), k
        elif k != "weight_space_mode_evidence":
            assert got[k] == v, k
    tw, jw = got["weight_space_mode_evidence"], want["weight_space_mode_evidence"]
    assert jw["basin_split_significant"] and jw["worst_dims_subspace_idx"][0] == 7
    assert set(tw) == set(jw)
    for k in jw:
        if k in ("basin_mean_probe_mse", "probe_mse_per_chain_spread"):
            np.testing.assert_allclose(tw[k], jw[k], rtol=1e-4)
        else:
            assert tw[k] == jw[k], k


def test_canonicalization_equals_jax_on_the_same_draws(small_jax_deeponet, monkeypatch,
                                                       tmp_path, capsys):
    """Chains drawn around two symmetry images of one network: R-hat raw /
    sign / permutation and the per-dimension entries within 1e-6 relative of
    JAX's (both canonicalize in float64 numpy); the raw R-hat max is above
    10 and the canonical one under a tenth of it."""
    from vihmc_torch.models.symmetry import random_orbit_element

    n = _common.SMALL_DEEPONET.num_params
    bundle = _small_bundle(tmp_path / "b.npz", np.arange(n))
    rng = np.random.default_rng(6)
    image = random_orbit_element(3, bundle["mu"], _common.SMALL_DEEPONET).astype(np.float32)
    centers = [bundle["mu"], image, bundle["mu"], image]
    x = np.stack([c + 0.01 * rng.normal(size=(20, n)) for c in centers]).astype(np.float32)
    ck = tmp_path / "ck"
    ck.mkdir()
    np.save(ck / "samples_seg00000.npy", x[:, :10])
    np.save(ck / "samples_seg00001.npy", x[:, 10:])
    args = ["--ckpt", str(ck), "--assets", str(tmp_path / "b.npz"), "--burn-kept", "2",
            "--permute"]
    monkeypatch.setattr("sys.argv", ["canon"] + args + ["--out", str(tmp_path / "j.json")])
    jax_script("canonicalize_operator_draws").main()
    got = port("canonicalize_operator_draws").main(args + ["--out", str(tmp_path / "t.json")]
                                                   + CPU)
    capsys.readouterr()
    want = json.load(open(tmp_path / "j.json"))
    assert set(got) == set(want)
    assert want["rhat_raw_max"] > 10.0 and want["rhat_perm_max"] < 0.1 * want["rhat_raw_max"]
    for k, v in want.items():
        if k == "dims":
            assert [d["subspace_idx"] for d in got[k]] == [d["subspace_idx"] for d in v]
            for td, jd in zip(got[k], v):
                assert set(td) == set(jd)
                for kk in jd:
                    np.testing.assert_allclose(td[kk], jd[kk], rtol=1e-6, atol=1e-3)
        elif isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-6), k
        else:
            assert got[k] == v, k


# ---------------------------------------------------------------------------
# end to end on the CPU
# ---------------------------------------------------------------------------

def test_small_chain_end_to_end(tmp_path, capsys, one_torch_thread):
    """stage12 --small -> stage3 --artifacts (checkpointed, then resumed from
    the finished checkpoint) -> fs diagnostics -> canonicalization, finite;
    stage 3 reads the port's own data parameters and subspace."""
    out = tmp_path / "op"
    s12 = port("run_operator_stage12").main(
        ["--small", "--epochs", "2", "--compare-loop", "1", "--out", str(out / "stage12"),
         "--assets", str(out / "b.npz")] + CPU)
    assert set(s12["vi_path_compare"]) == {"epochs", "loop_seconds", "scan_seconds",
                                           "loop_valid_mse_last", "scan_valid_mse_last"}
    store = out / "stage12" / "stage12"
    assert json.load(open(store / "stage12_data.json"))["nx"] == 17
    assert json.load(open(store / "stage12_summary.json")) == json.loads(json.dumps(s12))
    assert _common.stage12_artifacts(str(store))[2] == _common.SMALL_DEEPONET
    s3_args = ["--artifacts", str(store), "--out", str(out / "stage3"), "--uid", "s3",
               "--ckpt", str(out / "ck"), "--draws", "12", "--segment", "6", "--thin", "1",
               "--chains", "4", "--L", "5"] + CPU
    s3 = port("run_operator_stage3").main(s3_args)
    assert sorted(os.listdir(out / "ck")) == ["samples_seg00000.npy", "samples_seg00001.npy",
                                              "step_1.pt", "step_2.pt"]
    params = np.load(out / "stage3" / "s3" / "hmc_params.npy")
    assert params.shape == (4, 12, s12["num_sensitive"])
    # an interrupted run (the last segment lost) resumes to the same draws
    os.remove(out / "ck" / "step_2.pt")
    os.remove(out / "ck" / "samples_seg00001.npy")
    port("run_operator_stage3").main(s3_args)
    np.testing.assert_array_equal(np.load(out / "stage3" / "s3" / "hmc_params.npy"), params)
    fs = port("fs_diagnostics_operator").main(
        ["--run", str(out / "stage3" / "s3"), "--assets", str(out / "b.npz"), "--thin", "1"]
        + CPU)
    canon = port("canonicalize_operator_draws").main(
        ["--ckpt", str(out / "ck"), "--assets", str(out / "b.npz"), "--burn-kept", "2",
         "--out", str(out / "canon.json")] + CPU)
    capsys.readouterr()
    for v in (s3["acceptance_post_burn"], s3["r_hat_max"], fs["fs_r_hat_max"],
              fs["fs_ess_median"], canon["rhat_raw_max"], canon["rhat_sign_max"]):
        assert np.isfinite(v)
    assert fs["burn"] == s3["burn"] == 2


def test_post_burn_acceptance_counts_burn_from_the_chain_start(monkeypatch):
    """A resumed call holds only its own draws, the last ones of the chain:
    the post-burn acceptance drops the burn draws among them, no more."""
    from vihmc_torch.pipelines import vi_hmc

    accept = np.tile(np.arange(6.0), (2, 1))       # draws 6..11 of 12, run in this call
    res = types.SimpleNamespace(accept_probs=accept, samples=np.ones((2, 12, 3)))
    monkeypatch.setattr(vi_hmc, "run_operator", lambda *a, **k: {
        "result": res, "phases_s": {"sampling_s": 1.0}})
    kw = dict(device="cpu", draws=12, chains=2, thin=1, evaluate=False,
              artifacts={"indices": np.arange(3)}, grid={"nx": 4, "nt": 4, "n_train": 2})
    for burn, want in ((2, 2.5), (6, 2.5), (8, 3.5)):
        summary, _ = vi_hmc.run_stage3(burn=burn, **kw)
        assert summary["acceptance_post_burn"] == want, burn


def test_stage3_falls_back_to_the_committed_bundle(capsys):
    arts, meta, model = _common.stage12_artifacts("runs/no_such_store")
    assert "missing; using assets/burgers_stage12.npz" in capsys.readouterr().out
    assert len(arts["indices"]) == 37_294
    assert meta == {"data_seed": 0, "n_train": 1000, "n_valid": 200, "nx": 101, "nt": 101}
    assert model == DeepONetConfig()


def test_nn_bundle_loads_in_bench_nn(tmp_path, monkeypatch, capsys, one_torch_thread):
    """run_nn_stage12 writes the committed NN bundle's keys, and the NN row
    builds its posterior from it."""
    from vihmc_torch import bench_nn

    path = tmp_path / "nn.npz"
    port("run_nn_stage12").main(["--epochs", "20", "--out", str(path)] + CPU)
    capsys.readouterr()
    with np.load(path) as z, np.load(os.path.join(ROOT, "assets", "nn_stage12.npz")) as ref:
        assert set(z.files) == set(ref.files)
        assert z["mu"].shape == ref["mu"].shape and z["indices"].dtype == ref["indices"].dtype
    monkeypatch.setattr(bench_nn, "NN_STAGE12_ASSET", str(path))
    log_prob, aux0, _, spec = bench_nn.build_nn_problem("cpu")[:4]
    q = spec.sub_mu()[None]
    assert torch.isfinite(log_prob(q, aux0)).all()


def test_parity_osf_on_a_small_mat(tmp_path, capsys, one_torch_thread):
    """The three stages on a .mat written here (8 functions of 101 sensor
    values, a 4 x 4 grid), with reference draws for the moment parity."""
    rng = np.random.default_rng(0)
    t, x = np.meshgrid(np.linspace(0, 1, 4), np.linspace(0, 1, 4), indexing="ij")
    trunk = np.stack([t.ravel(), x.ravel()], -1)
    branch = 0.5 * rng.normal(size=(8, 101))
    sol = np.sin(np.pi * trunk[None, :, 1]) * branch[:, :1] + 0.1 * rng.normal(size=(8, 16))
    scipy.io.savemat(tmp_path / "d.mat", {"branch_in": branch, "trunk_in": trunk,
                                          "solution": sol})
    np.save(tmp_path / "ref.npy", 0.01 * rng.normal(size=(6, 10)))
    np.save(tmp_path / "ref_idx.npy", np.arange(10))
    got = port("parity_osf").main(
        ["--mat", str(tmp_path / "d.mat"), "--epochs", "1", "--draws", "6", "--burn", "2",
         "--n-train", "4", "--n-valid", "4", "--out", str(tmp_path / "osf"),
         "--ref-samples", str(tmp_path / "ref.npy"), "--ref-indices",
         str(tmp_path / "ref_idx.npy")] + CPU)
    capsys.readouterr()
    assert got["L"] == 7 and got["subspace_dim"] > 0
    assert np.isfinite([got["expected_mse_of_mean"], got["final_sample_mse"],
                        got["moment_parity"]["median_mean_z"]]).all()
    assert got["moment_parity"]["ref_draws_used"] == 6
    assert os.path.exists(tmp_path / "osf" / "parity" / "parity_summary.json")


@pytest.mark.parametrize("name", SCRIPT_NAMES)
def test_help_runs(name, capsys):
    with pytest.raises(SystemExit) as exc:
        port(name).main(["--help"])
    assert exc.value.code == 0
    assert "--device" in capsys.readouterr().out


def test_small_config_is_the_scripts(small_jax_deeponet):
    assert dataclasses.asdict(_common.SMALL_DEEPONET) == dataclasses.asdict(small_jax_deeponet)
    assert _common.deeponet_for(172_401).num_params == 172_401
    with pytest.raises(ValueError):
        _common.deeponet_for(5)
