"""PyTorch port parity: the Burgers solver, the dataset assembly, and the
exported JAX draws the port's operator row reads."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vihmc_tpu.data.burgers import (_grf_initial_conditions,
                                    generate_burgers_dataset)
from vihmc_tpu.data.burgers import solve_burgers as j_solve
from vihmc_tpu.hmc import SubspaceSpec
from vihmc_tpu.hmc.subspace import draw_full
from vihmc_torch.data.burgers import (STAGE12_ASSET, burgers_dataset,
                                      get_burgers_train, load_port_inputs,
                                      solve_burgers)


def test_solve_burgers_matches_jax_on_exported_u0():
    """f32 pseudo-spectral IF-RK4 over the full 2000 steps, same u0: the two
    FFT libraries round differently, so atol 2e-5 on O(1) values. The port
    also reproduces the exported JAX solution rows to the same tolerance."""
    z = load_port_inputs()
    u0 = z["u0"][:4]
    want = np.asarray(j_solve(jnp.asarray(u0)))
    got = solve_burgers(torch.as_tensor(u0)).numpy()
    assert got.shape == want.shape == (4, 101, 100)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    data = get_burgers_train(device="cpu", n_rows=4)
    np.testing.assert_allclose(data["solution"].numpy(), z["solution_rows"],
                               atol=2e-5, rtol=0)


def test_dataset_assembly_matches_generate_burgers_dataset():
    """Layout of branch_in / trunk_in / solution on a small grid, from the
    same GRF draw (atol 1e-6: same solver, short horizon)."""
    key = jax.random.key(5)
    nx, nt = 17, 9
    want = generate_burgers_dataset(key, 3, nx=nx, nt=nt)
    u0 = np.array(_grf_initial_conditions(key, 3, nx - 1))
    got = burgers_dataset(torch.as_tensor(u0), nx=nx, nt=nt)
    np.testing.assert_allclose(got["trunk_in"].numpy(), np.asarray(want["trunk_in"]),
                               atol=1e-7, rtol=0)
    np.testing.assert_allclose(got["branch_in"].numpy(), np.asarray(want["branch_in"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["solution"].numpy(), np.asarray(want["solution"]),
                               atol=1e-6, rtol=0)


def test_exported_inputs_are_the_jax_draws():
    """Exact: u0 is the GRF draw of data_seed 0 and frozen_draw is
    draw_full(jax.random.key(0), spec) of the r2 asset, as bench.py makes them."""
    z = load_port_inputs()
    a = np.load(STAGE12_ASSET)
    assert z["u0"].shape == (int(a["n_train"]) + int(a["n_valid"]), int(a["nx"]) - 1)
    u0 = _grf_initial_conditions(jax.random.key(int(a["data_seed"])), z["u0"].shape[0],
                                 z["u0"].shape[1])
    np.testing.assert_array_equal(z["u0"], np.asarray(u0))
    spec = SubspaceSpec(idx=(0,), mu=jnp.asarray(a["mu"]), sigma=jnp.asarray(a["sigma"]))
    np.testing.assert_array_equal(z["frozen_draw"],
                                  np.asarray(draw_full(jax.random.key(0), spec)))
    assert z["solution_rows"].shape == (4, int(a["nx"]) * int(a["nt"]))


def test_generate_burgers_dataset_with_jax_coefficients():
    """The GRF initial conditions from JAX's own standard-normal coefficients
    (``ka, kb = split(key)``, burgers.py:42-45) and the dataset assembled from
    them: rtol 1e-5, atol 1e-5 on O(1) values (the same solver, a short
    horizon)."""
    from vihmc_torch.data.burgers import generate_burgers_dataset as t_generate

    key = jax.random.key(7)
    n, nx, nt = 3, 17, 9
    ka, kb = jax.random.split(key)
    coeffs = tuple(np.asarray(jax.random.normal(k, (n, 12))) for k in (ka, kb))
    want = generate_burgers_dataset(key, n, nx=nx, nt=nt)
    got = t_generate(None, n, nx=nx, nt=nt, coefficients=coeffs)
    for k in ("branch_in", "trunk_in", "solution"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5)
    drawn = t_generate(torch.Generator().manual_seed(0), n, nx=nx, nt=nt)
    assert drawn["solution"].shape == (n, nx * nt) and torch.isfinite(drawn["solution"]).all()


def test_load_burgers_mat_and_get_burgers_match_jax(tmp_path):
    """A .mat written with scipy.io.savemat loads to the same arrays in both
    packages (exactly), and both get_burgers slice it into the same splits
    (rows [0:n_train] and [n_train:n_train + n_valid], clipped)."""
    import scipy.io

    from vihmc_tpu.data.burgers import get_burgers as j_get
    from vihmc_tpu.data.burgers import load_burgers_mat as j_load
    from vihmc_torch.data.burgers import get_burgers, load_burgers_mat

    rng = np.random.default_rng(3)
    mat = {"branch_in": rng.normal(size=(7, 9)), "trunk_in": rng.random((15, 2)),
           "solution": rng.normal(size=(7, 15))}
    path = str(tmp_path / "DeepOnet_data.mat")
    scipy.io.savemat(path, mat)
    got, want = load_burgers_mat(path), j_load(path)
    for k in mat:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    t_split = get_burgers("cpu", 5, 4, mat_path=path)
    j_split = j_get(jax.random.key(0), 5, 4, path)
    for t_part, j_part in zip(t_split, j_split):
        for k in mat:
            np.testing.assert_array_equal(t_part[k].numpy(), np.asarray(j_part[k]))
    assert t_split[1]["branch_in"].shape[0] == 2
