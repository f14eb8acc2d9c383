"""PyTorch port parity: weight-symmetry canonicalization
(``vihmc_torch.models.symmetry`` against ``vihmc_tpu.models.symmetry``).

The same random draws go through both packages' ``canonicalize_*`` with and
without the permutation stage, with and without the DeepONet's noise head;
the port's map is orbit-invariant (JAX's ``random_orbit_element`` scrambles
the draws) and leaves the network function, computed by the port's forward,
unchanged.
"""

import numpy as np
import pytest
import torch

from torch_parity_helpers import one_torch_thread  # noqa: F401
from vihmc_tpu.models import DeepONetConfig as JDCfg
from vihmc_tpu.models import MLPConfig as JMCfg
from vihmc_tpu.models import symmetry as jsym
from vihmc_torch.models import symmetry as tsym
from vihmc_torch.models.deeponet import DeepONetConfig, deeponet_apply, unravel_deeponet
from vihmc_torch.models.mlp import MLPConfig, mlp_apply

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DEEPONET_KW = dict(in_branch=7, in_trunk=5, width_branch=6, width_trunk=6, depth_branch=3,
                   depth_trunk=3)
MLP_KW = dict(in_dim=1, widths=(6, 5), out_dim=1)


def _draws(d, seed, n=5):
    rng = np.random.default_rng(seed)
    return rng.normal(size=d), rng.normal(size=(n, d))


@pytest.mark.parametrize("permute", [False, True])
@pytest.mark.parametrize("noise_neurons", [0, 2])
def test_canonicalize_deeponet_matches_jax(permute, noise_neurons):
    """Five draws (and one as a (D,) vector) canonicalized against a
    reference: equal to JAX's (atol 1e-12 in float64); the layouts equal."""
    kw = dict(DEEPONET_KW, noise_neurons=noise_neurons)
    jcfg, tcfg = JDCfg(**kw), DeepONetConfig(**kw)
    assert tsym.deeponet_layout(tcfg) == jsym.deeponet_layout(jcfg)
    ref, draws = _draws(tcfg.num_params, 10 + noise_neurons)
    got = tsym.canonicalize_deeponet(draws, ref, tcfg, permute=permute)
    want = jsym.canonicalize_deeponet(draws, ref, jcfg, permute=permute)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got.dtype == np.float64 and not np.array_equal(got, draws)
    one = tsym.canonicalize_deeponet(torch.as_tensor(draws[0]), ref, tcfg, permute=permute)
    np.testing.assert_allclose(one, want[0], rtol=0, atol=1e-12)


@pytest.mark.parametrize("permute", [False, True])
def test_canonicalize_mlp_matches_jax(permute):
    """The MLP's hidden-unit canonicalization equals JAX's (atol 1e-12).
    Without the last layer's bias the port's layout is the model's (it ends
    at ``num_params``); JAX's counts a bias there anyway."""
    jcfg, tcfg = JMCfg(**MLP_KW), MLPConfig(**MLP_KW)
    assert tsym.mlp_layout(tcfg) == jsym.mlp_layout(jcfg)
    no_bias = dict(MLP_KW, last_bias=False)
    assert tsym.mlp_layout(MLPConfig(**no_bias))[-1][1].stop == MLPConfig(**no_bias).num_params
    assert jsym.mlp_layout(JMCfg(**no_bias))[-1][1].stop == JMCfg(**no_bias).num_params + 1
    ref, draws = _draws(tcfg.num_params, 20)
    np.testing.assert_allclose(tsym.canonicalize_mlp(draws, ref, tcfg, permute=permute),
                               jsym.canonicalize_mlp(draws, ref, jcfg, permute=permute),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("noise_neurons", [0, 2])
def test_orbit_invariance_and_function_preserved(noise_neurons):
    """Three random orbit elements of one DeepONet draw (sign flips and
    permutations within each head block, JAX's test utility) canonicalize
    to the same vector as the draw itself (atol 1e-10) -- the port's
    ``random_orbit_element`` gives JAX's elements exactly; the canonical
    vector's forward through the port -- both heads -- equals the draw's
    (rtol 1e-5, atol 1e-6). The MLP's likewise."""
    kw = dict(DEEPONET_KW, noise_neurons=noise_neurons)
    jcfg, tcfg = JDCfg(**kw), DeepONetConfig(**kw)
    ref, draws = _draws(tcfg.num_params, 30)
    base = tsym.canonicalize_deeponet(draws[0], ref, tcfg, permute=True)
    for seed in range(3):
        scrambled = jsym.random_orbit_element(seed, draws[0], jcfg)
        np.testing.assert_array_equal(tsym.random_orbit_element(seed, draws[0], tcfg),
                                      scrambled)
        np.testing.assert_allclose(tsym.canonicalize_deeponet(scrambled, ref, tcfg,
                                                              permute=True),
                                   base, rtol=0, atol=1e-10)
    rng = np.random.default_rng(31)
    bx = torch.as_tensor(rng.normal(size=(4, 7)))
    tx = torch.as_tensor(rng.random(size=(9, 2)))
    flat = torch.as_tensor(np.stack([draws[0], base]))
    out = deeponet_apply(tcfg, unravel_deeponet(tcfg, flat), bx, tx)
    for head in (out if noise_neurons else (out,)):
        np.testing.assert_allclose(head[1].numpy(), head[0].numpy(), rtol=1e-5, atol=1e-6)
    mcfg = MLPConfig(**MLP_KW)
    mref, mdraws = _draws(mcfg.num_params, 32)
    canon = tsym.canonicalize_mlp(mdraws, mref, mcfg, permute=True)
    x = torch.as_tensor(rng.normal(size=(11, 1)))
    np.testing.assert_allclose(mlp_apply(mcfg, torch.as_tensor(canon), x).numpy(),
                               mlp_apply(mcfg, torch.as_tensor(mdraws), x).numpy(),
                               rtol=1e-5, atol=1e-6)
