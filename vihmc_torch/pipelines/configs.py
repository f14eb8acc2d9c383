"""The run configs of the three stages and of the full-parameter baselines.

Counterparts of ``NNHMCRunConfig``, ``NNVIRunConfig``,
``SensitivityRunConfig``, ``VIHMCRunConfig``, ``OperatorVIRunConfig``,
``OperatorHMCRunConfig``, ``SplitHMCRunConfig`` and ``trajectory_length`` in
``vihmc_tpu/pipelines/configs.py`` (:25-53, :56-83, :86-254, :257-331): the
same fields, the same defaults, and the reference's analytic trajectory-length rule
``L = int(pi * post_var / (2 * step_size))``. Every field is kept so that a
JAX run's config means the same here. The field notes are short; the JAX
module documents each option's motivation and measurements.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from vihmc_torch.models.deeponet import DeepONetConfig
from vihmc_torch.models.mlp import MLPConfig
from vihmc_torch.vi.elbo import ELBOConfig
from vihmc_torch.vi.train import VIConfig


def trajectory_length(post_var: float, step_size: float) -> int:
    """Half a period of the harmonic oscillator with the posterior's
    marginal variance (the reference's L rule)."""
    return max(1, int(math.pi * post_var / (2.0 * step_size)))


@dataclasses.dataclass(frozen=True)
class NNHMCRunConfig:
    """Full-parameter HMC for the regression MLP (the reference's
    Neural_network/HMC config)."""

    model: MLPConfig = dataclasses.field(default_factory=MLPConfig)
    n_train: int = 20
    n_val: int = 300
    tau: float = 1.0                 # per-tensor prior precision
    tau_out: float = 1.0 / 0.05**2   # likelihood precision ('regression' loss)
    step_size: float = 1e-4
    num_samples: int = 1000
    post_std: float = 0.2024         # empirical posterior std driving L
    num_chains: int = 1
    loss: str = "regression"

    @property
    def L(self) -> int:
        return trajectory_length(self.post_std**2, self.step_size)

    @property
    def burn(self) -> int:
        return self.num_samples // 5


@dataclasses.dataclass(frozen=True)
class NNVIRunConfig:
    """NN VI training (the reference's Neural_network/VI config)."""

    model: MLPConfig = dataclasses.field(default_factory=MLPConfig)
    n_train: int = 20
    n_val: int = 300
    noise: float = 5e-2
    vi: VIConfig = dataclasses.field(default_factory=lambda: VIConfig(
        epochs=10_000, lr_start=1e-2, patience=100, num_ens=10, beta_type=1.0,
        prior_mu=0.0, prior_sigma=1.0,
        elbo=ELBOConfig(reduction="sum", fixed_noise_var=5e-2**2),
    ))
    posterior_mu_initial: tuple = (0.0, 0.1)
    posterior_rho_initial: tuple = (-3.0, 0.1)
    mode: str = "bbb"
    num_uq_samps: int = 500


@dataclasses.dataclass(frozen=True)
class SensitivityRunConfig:
    """The sensitivity stage (the reference's config_sens modules)."""

    importance_threshold: float = 0.90
    batch_chunk: int = 0     # stream Jacobian batches in chunks (>0)
    p_subsample: int = 100   # trunk points used for operator Jacobians


@dataclasses.dataclass(frozen=True)
class VIHMCRunConfig:
    """Subspace VI-HMC (the reference's VI_HMC config modules)."""

    step_size: float = 5e-4
    num_samples: int = 100
    burn: Optional[int] = None       # default num_samples // 5
    prior_var: float = 1.0
    post_std: float = 0.2501
    loss: str = "NLL"
    tau_out: float = 5e-2**2         # variance under NLL
    num_chains: int = 10
    load_prior: bool = True          # subspace prior = VI posterior
    load_std: bool = True            # use VI stds (else sqrt(prior_var))
    init_prior: bool = True          # init from VI (mean or draw)
    sample_prior: bool = False       # init from a VI draw instead of the mean
    frozen_policy: str = "refresh"   # 'mean' | 'draw' | 'refresh'
    vi_mass: bool = False            # inv_mass = VI sigma^2
    laplace_mass: bool = False       # inv_mass = 1/(prior_prec + n E[J^2]/tau)
    laplace_n_data: Optional[int] = None  # likelihood observation count n
    lowrank_rank: int = 0            # >0: Lanczos low-rank + diagonal metric
    lowrank_iters: Optional[int] = None
    init_optimize: int = 0           # warm-start Adam steps on -log p(q|frozen)
    init_optimize_lr: float = 0.1    # in kinetic-metric sigmas per step
    sample_data: bool = False        # random trunk-point subsampling per draw
    p: int = 10201                   # trunk points kept when sample_data
    adapt_step_size: bool = False    # dual averaging (else a fixed step)
    save_vi_trace: bool = False      # persist the frozen draw of each iteration
    adapt_mass: bool = False         # Welford diagonal mass during warmup
    mass_schedule: str = "half"      # 'half' | 'windowed'
    target_accept: float = 0.8
    algorithm: str = "hmc"           # 'hmc' | 'nuts' | 'chees' | 'auto'
    auto_stiffness_threshold: float = 100.0
    nuts_max_depth: int = 6
    chees_max_steps: int = 256
    num_leapfrog: Optional[int] = None  # explicit L (default: analytic rule)
    jitter_l: bool = False           # per-draw trajectory length ~ U[low, L]
    jitter_low_frac: float = 0.0     # low = max(1, frac*L)
    jitter_eps: bool = False         # per-draw step multiplier ~ U[low, 1]
    clip_grad: Optional[float] = None  # preconditioned norm clip of the
                                     # TRAJECTORY field (MH stays exact)
    coarse_stride: Optional[int] = None  # query-stride Gram surrogate field
    fn_stride: Optional[int] = None  # function-stride Gram surrogate field
    grad_dtype: Optional[str] = None  # 'bfloat16': Gram field stacks in bf16
    gauss_field: Optional[float] = None  # VI-Gaussian trajectory field
    gauss_field_auto: bool = False   # probe the Gaussian field, else fall back
    gauss_field_floor: float = 0.35
    gauss_field_probe_draws: int = 16
    max_step: Optional[float] = None  # clamp the adapted step
    da_axis: Optional[str] = None    # 'chains': one step shared by all chains
    adapt_forever: bool = False      # dual averaging past burn

    @property
    def L(self) -> int:
        if self.num_leapfrog is not None:
            return self.num_leapfrog
        return trajectory_length(self.post_std**2, self.step_size)

    @property
    def burn_(self) -> int:
        return self.num_samples // 5 if self.burn is None else self.burn


@dataclasses.dataclass(frozen=True)
class OperatorVIRunConfig:
    """Operator VI training (the reference's Operator_network/VI config)."""

    model: DeepONetConfig = dataclasses.field(default_factory=DeepONetConfig)
    dataset: str = "Burgers"         # 'Burgers' | 'Cone' (per-example query points)
    n_train: int = 1000
    n_valid: int = 1000
    batch_size: int = 128
    p: int = 10201                   # trunk points per example (subsample if < grid)
    vi: VIConfig = dataclasses.field(default_factory=lambda: VIConfig(
        epochs=1000, lr_start=1e-3, patience=50, num_ens=5, beta_type=1.0,
        prior_mu=0.0, prior_sigma=0.1,
        elbo=ELBOConfig(reduction="mean_x_n", fixed_noise_var=1.0),
    ))
    posterior_mu_initial: tuple = (0.0, 0.1)
    posterior_rho_initial: tuple = (-5.0, 0.1)
    mode: str = "bbb"


@dataclasses.dataclass(frozen=True)
class OperatorHMCRunConfig:
    """Full-parameter DeepONet HMC with dual-averaging step adaptation (the
    reference's Operator_network/HMC config)."""

    model: DeepONetConfig = dataclasses.field(default_factory=DeepONetConfig)
    n_train: int = 10
    n_valid: int = 10
    step_size: float = 1e-4
    num_samples: int = 10
    post_std: float = 0.0214
    prior_var: float = 0.1**2
    loss: str = "NLL"
    tau_out: float = 1.0
    sample_data: bool = False        # random trunk subsampling inside the sampler
    p: int = 10201
    target_accept: float = 0.8

    @property
    def L(self) -> int:
        return trajectory_length(self.post_std**2, self.step_size)

    @property
    def burn(self) -> int:
        return max(1, self.num_samples // 10)


@dataclasses.dataclass(frozen=True)
class SplitHMCRunConfig:
    """Split-Hamiltonian DeepONet HMC (the reference's
    Operator_network/HMC config_splitting)."""

    model: DeepONetConfig = dataclasses.field(default_factory=DeepONetConfig)
    n_train: int = 1000
    n_valid: int = 1000
    num_splits: int = 2
    is_nuts: bool = False
    step_size: float = 3.45e-4
    num_samples: int = 1001
    prior_var: float = 0.1**2
    post_std: float = 0.0214
    loss: str = "NLL"
    tau_out: float = 1.0
    sample_data: bool = False
    p: int = 10201
    target_accept: float = 0.8

    @property
    def L(self) -> int:
        return trajectory_length(self.post_std**2, self.step_size)

    @property
    def burn(self) -> int:
        return self.num_samples // 2
