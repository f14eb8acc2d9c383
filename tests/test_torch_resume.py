"""PyTorch port: checkpoints, resumable segmented sampling and the VI
trainer's restart (the counterparts of ``tests/test_resume.py``).

An interrupted run resumed from its checkpoint directory must give the
uninterrupted run's samples bit for bit on the CPU: the segments draw from
generators seeded with ``(seed, segment)`` and the checkpoint carries the
whole sampler state (global draw index, dual averaging, Welford moments,
carried metric, carried momentum).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from torch_parity_helpers import one_torch_thread  # noqa: F401 (a fixture)
from vihmc_torch.chains.resume import sample_chains_resumable
from vihmc_torch.hmc.kernel import HMCConfig, HMCState
from vihmc_torch.io.checkpoint import latest_step, load_checkpoint, save_checkpoint

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _lp(scales):
    s = torch.as_tensor(scales, dtype=torch.float32)

    def log_prob(q, aux=None):
        return -0.5 * ((q / s) ** 2).sum(-1)

    return log_prob


def test_checkpoint_round_trip(tmp_path):
    """A nest of dicts, lists, a dataclass state, tensors, numbers and a
    generator's state round-trips exactly; steps are numbered, the latest is
    found, no temporary file stays, a missing directory has no step."""
    gen = torch.Generator().manual_seed(3)
    torch.randn(4, generator=gen)
    state = HMCState(position=torch.randn(2, 3), log_prob=torch.randn(2), grad=torch.randn(2, 3),
                     da=None, aux={"frozen": torch.randn(5), "tidx": torch.arange(4)},
                     iteration=7)
    payload = {"state": state, "epoch": 4, "rows": [1.5, (2, "a")],
               "generator": gen.get_state()}
    d = str(tmp_path / "ck")
    assert latest_step(d) is None
    save_checkpoint(d, 2, payload)
    save_checkpoint(d, 10, payload)
    assert latest_step(d) == 10
    assert sorted(os.listdir(d)) == ["step_10.pt", "step_2.pt"]
    got = load_checkpoint(d, template={"state": state})
    assert isinstance(got["state"], HMCState) and got["state"].iteration == 7
    for f in ("position", "log_prob", "grad"):
        assert torch.equal(getattr(got["state"], f), getattr(state, f))
    assert torch.equal(got["state"].aux["tidx"], state.aux["tidx"])
    assert got["epoch"] == 4 and got["rows"] == [1.5, (2, "a")]
    g2 = torch.Generator()
    g2.set_state(got["generator"])
    assert torch.equal(torch.randn(3, generator=g2), torch.randn(3, generator=gen))
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"))


CONFIGS = {
    # plain HMC, a fixed step (tests/test_resume.py:19-39)
    "plain": (dict(num_leapfrog=5, step_size=0.3), 20, (1.0, 1.0, 1.0)),
    # the windowed metric and dual averaging across segment boundaries (:42-72)
    "windowed": (dict(num_leapfrog=4, step_size=0.05, burn=60, sampler="hmc_nuts",
                      adapt_mass=True, mass_schedule="windowed"), 30, (0.2, 5.0)),
    # the carried momentum (Horowitz persistence) with step jitter
    "momentum": (dict(num_leapfrog=3, step_size=0.2, momentum_persistence=0.6,
                      jitter_eps=True, jitter_low_frac=0.5), 20, (0.5, 1.0, 2.0)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_resumed_run_equals_uninterrupted(tmp_path, name):
    """Two segments with a checkpoint directory and a shorter num_samples
    (the crash), then a resume into the same directory with the full count:
    the samples equal the uninterrupted run's bit for bit, the info arrays
    cover only the segments run in the resuming call (as in JAX), and the
    segment files have JAX's names."""
    kw, seg, scales = CONFIGS[name]
    n = 3 * seg
    lp = _lp(scales)
    q0 = torch.zeros((2, len(scales)))
    inv0 = torch.ones(len(scales))
    full = sample_chains_resumable(lp, q0, HMCConfig(num_samples=n, **kw), seg, inv0, None,
                                   seed=4)
    d = str(tmp_path / "ck")
    sample_chains_resumable(lp, q0, HMCConfig(num_samples=2 * seg, **kw), seg, inv0, None,
                            seed=4, checkpoint_dir=d)
    assert latest_step(d) == 2
    assert sorted(f for f in os.listdir(d) if f.endswith(".npy")) == [
        "samples_seg00000.npy", "samples_seg00001.npy"]
    resumed = sample_chains_resumable(lp, q0, HMCConfig(num_samples=n, **kw), seg, inv0, None,
                                      seed=4, checkpoint_dir=d)
    np.testing.assert_array_equal(resumed.samples, full.samples)
    assert resumed.accept_probs.shape == (2, seg)
    np.testing.assert_array_equal(resumed.accept_probs, full.accept_probs[:, 2 * seg:])
    assert resumed.final_state.iteration == full.final_state.iteration == n
    if name == "windowed":
        assert torch.equal(resumed.final_state.inv_mass, full.final_state.inv_mass)
        ratio = resumed.final_state.inv_mass[:, 1] / resumed.final_state.inv_mass[:, 0]
        assert bool((ratio > 2.0).all())
    if name == "momentum":
        assert torch.equal(resumed.final_state.momentum, full.final_state.momentum)


def test_progress_that_stops_the_run_leaves_it_resumable(tmp_path):
    """A progress callback that raises after segment 1 (the segment is saved
    before the callback runs), then a resume: equal to the uninterrupted run,
    thinned on the device; ``thin`` must divide the segment."""
    lp = _lp((1.0, 0.5))
    q0 = torch.zeros((3, 2))
    cfg = HMCConfig(num_samples=24, num_leapfrog=3, step_size=0.3, jitter_eps=True)
    full = sample_chains_resumable(lp, q0, cfg, 8, 1.0, None, seed=6, thin=2)

    class Stop(Exception):
        pass

    def stop(seg, n_seg, state):
        raise Stop

    d = str(tmp_path / "ck")
    with pytest.raises(Stop):
        sample_chains_resumable(lp, q0, cfg, 8, 1.0, None, seed=6, thin=2, progress=stop,
                                checkpoint_dir=d)
    assert latest_step(d) == 1
    seen = []
    resumed = sample_chains_resumable(lp, q0, cfg, 8, 1.0, None, seed=6, thin=2,
                                      checkpoint_dir=d,
                                      progress=lambda s, n, st: seen.append((s, n)))
    assert seen == [(2, 3), (3, 3)]
    assert resumed.samples.shape == (3, 12, 2)
    np.testing.assert_array_equal(resumed.samples, full.samples)
    with pytest.raises(ValueError, match="thin"):
        sample_chains_resumable(lp, q0, cfg, 8, 1.0, None, thin=3)


def test_vi_trainer_restart_matches_uninterrupted(tmp_path):
    """The Python-loop trainer with checkpoints every 2 epochs, stopped after
    epoch 4 and restarted: the restarted epochs' metric rows and the final
    state equal the uninterrupted run's (the checkpoint carries the
    generator's state, which draws the minibatches and the ensemble
    normals); the best state and the final checkpoint stand where JAX puts
    them."""
    from vihmc_torch.models.mlp import MLPConfig
    from vihmc_torch.pipelines.common import mlp_vi_apply
    from vihmc_torch.vi import ELBOConfig, VIConfig, init_train_state, train

    cfg = MLPConfig(in_dim=1, widths=(6,), out_dim=1)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(size=(12, 1)), dtype=torch.float32)
    y = torch.sin(x)
    vp = {"mu": torch.as_tensor(0.3 * rng.normal(size=cfg.num_params), dtype=torch.float32),
          "rho": torch.full((cfg.num_params,), -3.0)}
    vi = VIConfig(epochs=6, lr_start=1e-2, num_ens=2, n_save=2, beta_type="linear",
                  elbo=ELBOConfig(reduction="sum", fixed_noise_var=0.01))
    apply_fn = mlp_vi_apply(cfg)

    def batches(g, epoch):
        order = torch.randperm(12, generator=g)
        return [{"x": x[order[:6]], "y": y[order[:6]]}, {"x": x[order[6:]], "y": y[order[6:]]}]

    full_batch = {"x": x, "y": y}

    def run(ck, restart=False, callback=None):
        return train(apply_fn, init_train_state(vp, vi), vi, batches, full_batch, full_batch,
                     12, generator=torch.Generator().manual_seed(5), callback=callback,
                     ckpt_dir=ck, restart=restart)

    final, _, rows = run(str(tmp_path / "a"))
    assert rows.shape == (6, 4) and latest_step(str(tmp_path / "a")) == 6
    assert latest_step(str(tmp_path / "a" / "best")) == 0

    class Stop(Exception):
        pass

    def stop_after_4(epoch, row, state):
        if epoch == 3:
            raise Stop

    ck = str(tmp_path / "b")
    with pytest.raises(Stop):
        run(ck, callback=stop_after_4)
    assert latest_step(ck) == 4
    final2, _, rows2 = run(ck, restart=True)
    np.testing.assert_array_equal(rows2, rows[4:])
    assert final2.epoch == final.epoch == 6
    for k in ("mu", "rho"):
        assert torch.equal(final2.vp[k], final.vp[k])
        assert torch.equal(final2.opt_state.nu[k], final.opt_state.nu[k])
    _, _, rows3 = run(ck, restart=True)   # the final checkpoint: nothing left to run
    assert rows3.shape == (0, 4)


def test_vihmc_pipeline_segmented_resumable(tmp_path):
    """run_nn with segment_size and checkpoint_dir samples in checkpointed
    segments; a rerun against the same directory resumes (returning the
    collected samples) instead of sampling again (tests/test_resume.py:
    test_vihmc_pipeline_segmented_resumable). NUTS ignores the directory, as
    JAX's pipeline does."""
    from vihmc_torch.models.mlp import MLPConfig
    from vihmc_torch.pipelines import vi_hmc
    from vihmc_torch.pipelines.configs import VIHMCRunConfig

    mlp = MLPConfig(in_dim=1, widths=(8, 8), out_dim=1, activation="tanh")
    d = mlp.num_params
    rng = np.random.default_rng(2)
    artifacts = {"mu": rng.normal(size=d).astype(np.float32) * 0.1,
                 "sigma": (0.05 + 0.1 * rng.random(d)).astype(np.float32),
                 "indices": np.sort(rng.choice(d, size=10, replace=False))}
    cfg = VIHMCRunConfig(num_samples=12, step_size=1e-3, post_std=0.05, num_chains=2,
                         frozen_policy="refresh", tau_out=5e-2 ** 2, loss="NLL")
    ck = str(tmp_path / "ck")
    segs = []
    out = vi_hmc.run_nn(cfg, mlp, artifacts, segment_size=5, checkpoint_dir=ck, seed=5,
                        progress=lambda s, n, st: segs.append((s, n)), device="cpu")
    assert segs == [(1, 3), (2, 3), (3, 3)]
    s1 = out["result"].samples
    assert s1.shape == (2, 12, 10) and np.isfinite(s1).all()
    out2 = vi_hmc.run_nn(cfg, mlp, artifacts, segment_size=5, checkpoint_dir=ck, seed=5,
                         device="cpu")
    np.testing.assert_array_equal(out2["result"].samples, s1)
    assert out2["result"].accept_probs.shape == (2, 0)
    nuts_ck = str(tmp_path / "nuts")
    vi_hmc.run_nn(dataclasses.replace(cfg, algorithm="nuts", nuts_max_depth=2, num_samples=4),
                  mlp, artifacts, segment_size=2, checkpoint_dir=nuts_ck, device="cpu",
                  evaluate=False)
    assert not os.path.exists(nuts_ck)
