"""The plain references against the port at a small size on the CPU: the
data, the log density, the trajectory field, the paired MH delta, the
Laplace diagonal and the Hessian-vector products."""

import numpy as np
import pytest
import torch

from port_bench.harness import burgers
from port_bench.harness.cells import ROOT, Cell

torch.manual_seed(0)


def test_burgers_data_matches_the_program():
    from vihmc_torch.data.burgers import get_burgers_train

    cfg = Cell("deeponet-row-top2048").config["data"]
    mine = burgers.dataset(ROOT, {**cfg, "n_functions": 2}, "cpu")
    prog = get_burgers_train("cpu", n_rows=2)
    assert torch.equal(mine["branch_x"], prog["branch_in"])
    assert torch.equal(mine["trunk_x"], prog["trunk_in"])
    assert torch.equal(mine["y"], prog["solution"])
    strided = burgers.dataset(ROOT, {**cfg, "n_functions": 2, "grid_stride": 10}, "cpu")
    assert strided["y"].shape == (2, 121)
    keep = (torch.arange(101)[::10][:, None] * 101 + torch.arange(101)[::10][None, :]).reshape(-1)
    assert torch.equal(strided["y"], prog["solution"][:, keep])
    assert torch.equal(strided["trunk_x"], prog["trunk_in"][keep])


@pytest.fixture(scope="module")
def deeponet():
    from port_bench.tests.conftest import SMALL

    co, wo = SMALL["deeponet-row-top2048"]
    cell = Cell("deeponet-row-top2048", config_over=co, workload_over=wo)
    system = cell.system().build(cell.config, cell.workload, 7, torch.device("cpu"))
    ref = cell.reference().Reference(system.reference_inputs, cell.config["model"],
                                     cell.config["posterior"], cell.workload)
    q = system.inits + 0.01 * torch.randn_like(system.inits)
    return cell, system, ref, q


def test_deeponet_log_density(deeponet):
    _, system, ref, q = deeponet
    prog = system.log_prob(q, system.aux0).double()
    assert torch.allclose(ref.log_prob(q), prog, rtol=0, atol=1e-3)


def test_deeponet_field_against_the_float32_gram_field(deeponet):
    from vihmc_torch.bench_operator import BenchProblem, trajectory_field
    from vihmc_torch.dists.priors import DiagonalGaussianPrior

    cell, system, ref, q = deeponet
    # the row's field in float32 (the cell runs it in bfloat16)
    inp = system.reference_inputs
    from vihmc_torch.hmc.subspace import SubspaceSpec
    from vihmc_torch.models.deeponet import DeepONetConfig
    spec = SubspaceSpec(idx=inp["idx"], mu=inp["mu"], sigma=inp["sigma"])
    prob = BenchProblem(DeepONetConfig(), inp["branch_x"], inp["trunk_x"], inp["y"], spec,
                        inp["eps"], 2, 0, {"posterior": "vi_fit"}, scores=inp["scores"].numpy())
    prior = DiagonalGaussianPrior(loc=spec.sub_mu(), scale=spec.sub_sigma())
    f32 = trajectory_field(prob, prior, ref.inv_mass, stride=1, fn_stride=1)
    got, want = f32(q, system.aux0), ref.field(q)
    assert ((got - want).norm(dim=-1) / want.norm(dim=-1)).max() < 1e-4
    # the bfloat16 field the cell runs stays within its limit of the reference
    bf16 = system.grad_fn(q, system.aux0)
    gap = (ref.inv_mass * (bf16 - want) ** 2).sum(-1).sqrt().max()
    assert gap < cell.workload["limits"]["field_gap"]


def test_deeponet_paired_delta_and_lp1(deeponet):
    _, system, ref, q = deeponet
    q1 = q + 1e-3 * torch.randn_like(q)
    dlp, lp1 = system.delta_fn(q1, q, system.aux0)
    assert torch.allclose(ref.delta(q1, q), dlp.double(), rtol=0, atol=1e-3)
    assert torch.allclose(ref.log_prob(q1), lp1.double(), rtol=0, atol=1e-2)


def test_deeponet_laplace_diagonal(deeponet):
    from vihmc_torch.bench_operator import laplace_inv_mass

    _, system, ref, _ = deeponet
    inp = system.reference_inputs
    prog = laplace_inv_mass(inp["scores"].numpy(), inp["sigma"].numpy(), inp["idx"].numpy(),
                            inp["y"].numel())
    assert np.allclose(ref.inv_mass.numpy(), prog, rtol=1e-6, atol=0)


def test_deeponet_hvp_against_the_program(deeponet):
    from vihmc_torch.hmc.metric import hvp_fn

    _, system, ref, q = deeponet
    center = q[0]
    v = torch.randn(3, q.shape[1])
    prog = hvp_fn(system.log_prob, center, aux=system.aux0)
    want = ref.neg_hvp(center, v)
    got = torch.stack([prog(vi) for vi in v])
    assert torch.allclose(got, want, rtol=1e-3, atol=1e-3 * want.abs().max().item())


def test_deeponet_metric_eigenpairs(deeponet):
    from port_bench.harness.correct import eig_readings

    cell, system, ref, _ = deeponet
    got = eig_readings(system.metric, system.shapes["q_center"], ref)
    assert 0 < got["eig_directions"] <= cell.workload["lanczos"]["rank"]
    assert got["eig_residual"] < cell.workload["limits"]["eig_residual"]


def test_eig_residual_tells_an_eigenvector_from_any_ritz_pair():
    """A pair whose lambda is its own Rayleigh quotient has no gap in its
    curvature whatever the vector; ``eig_residual`` sees that it is no
    eigenvector."""
    import types

    from port_bench.harness.correct import eig_readings

    d = 6
    a = torch.diag(torch.arange(1.0, d + 1) * 3.0)             # S (-H) S, S = 1
    ref = types.SimpleNamespace(inv_mass=torch.ones(d),
                                neg_hvp=lambda c, v, fmt=None: v @ a)

    def metric_of(v):
        lam = (v @ a * v).sum(-1)                               # the Rayleigh quotients
        return types.SimpleNamespace(diag_mass=torch.ones(d), u=v.T * (lam - 1).sqrt())

    eig = torch.eye(d)[[5, 4]]
    mixed = torch.nn.functional.normalize(eig + torch.eye(d)[[0, 1]], dim=-1)
    assert eig_readings(metric_of(eig), None, ref)["eig_residual"] < 1e-6
    assert eig_readings(metric_of(mixed), None, ref)["eig_residual"] > 0.3


def test_reference_counts_its_transition_on_meta_tensors(deeponet):
    from port_bench.harness.runner import transition_flops

    cell, system, _, _ = deeponet
    inp = system.reference_inputs
    m, c = cell.config["model"], 3
    b, p, k = inp["y"].shape[0], inp["y"].shape[1], m["latent"]
    branch = [(101, 100)] + [(100, 100)] * 7 + [(100, 100)]
    trunk = [(5, 100)] + [(100, 100)] * 7 + [(100, 100)]
    fwd = (2 * b * sum(i * o for i, o in branch) + 2 * p * sum(i * o for i, o in trunk)
           + 2 * b * p * k)
    # the backward: every weight's gradient, every input gradient but the
    # first layer's (the data needs none), and the merge product's two
    back = (2 * b * sum(i * o for i, o in branch) + 2 * p * sum(i * o for i, o in trunk)
            + 2 * b * sum(i * o for i, o in branch[1:]) + 2 * p * sum(i * o for i, o in trunk[1:])
            + 2 * 2 * b * p * k)
    num_leapfrog = cell.workload["sampler"]["num_leapfrog"]
    assert transition_flops(cell, inp, c) == c * (num_leapfrog * (fwd + back) + 2 * fwd)
