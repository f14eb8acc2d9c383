"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printed with its wall time:

1. device: the card's name and power limit, and the build of every CUDA
   kernel of the port from ``vihmc_torch/csrc`` (one ``nvcc`` per source, all
   started together);
2. ``paired_sums`` against its plain PyTorch version on the card, at a ragged
   shape, at the operator row's shape and at one chain of it (the unbatched
   form, C = 1, on the small kernel; also the small kernel at C = 3, B = 100
   and at K = 13), on real features at q0 and at q1
   one leapfrog trajectory away, with a float64 evaluation as a third
   reference (at the main shapes the kernel's Delta ll error against float64
   may be at most twice the plain version's plus 1e-3 nats); the kernel's
   time beside both bounds (f32 FMA, and the split tensor-core one of six
   bf16 products) and the plain version's; at C = 1 the small and the tiled
   kernel timed in turns (small, tiled, tiled, small);
3. the operator row at full width through ``bench_operator`` at the recipe
   ``python -m vihmc_torch.bench`` resolves for key 2 (reference
   DeepONet, B = 1000 x P = 10,201, 2048-dim subspace, 48 chains, L = 4,
   bf16 Gram trajectory gradients, the fused paired delta, a low-rank
   metric), with only its depth cut; the kernel launch counts of that run
   must show that every draw went through ``paired_sums`` and every field
   call through the fused stacks (11 launches a call);
4. where a row draw's time goes: the trajectory field, the delta's feature
   forwards and the kernel timed alone at 48 chains, beside the sampling
   wall per draw; the field's cotangent step alone on the merged route and
   on the TF32 one it replaced, in turns, beside its bound, and both
   against float64; the field's fused stacks (``csrc/field_stack.cu``)
   forward and backward against the autograd path they replaced, in turns,
   beside their byte bounds and the plain version's time, their gradient
   against the plain version's; the same for the FNO field's fused
   projection (``csrc/fno_project.cu``) at one function chunk of the FNO
   cell (C 4, 336 functions), beside its byte, instruction and product
   bounds, then one bf16 FNO field call at the cell's shapes (three chunks:
   one forward and one backward launch a chunk) and the f32 density and
   field (none);
5. the stage-3 kernels against their plain versions on the card:
   ``merge_sums`` at a ragged shape and at the stage-3 shape (16 chains,
   B = 1000, P = 10,201, K = 100) on real features at the VI mean and one
   L = 31 trajectory from it, with a float64 evaluation; the ll of
   ``fused_merge_nll`` and its gradient against autograd of the plain f32
   ``merge_nll_reference`` (at the stage-3 shape the ll's error against
   float64 may be at most twice the plain version's plus 1e-3 nats), and the
   small kernel at C = 3, B = 100 and at K = 13;
   ``fused_leapfrog_update`` at (16, 81,131); each kernel's time beside its
   bounds and its plain version's;
6. the stage-3 operator pipeline at full width through ``run_stage3``
   (reference DeepONet, the 81,131-dim 90 % subspace, 16 chains, L = 31,
   the f32 Gram trajectory field, the fused merge-NLL density, validation
   scoring), with only its depth cut; ``merge_sums`` must have run once per
   density evaluation (2 per draw, 1 at init); then a draw's split;
7. the same pipeline with ``use_gram=False`` (autograd through the fused
   density on every leapfrog step) at a small depth, with its launch count;
8. stage 1 of the operator pipeline (Bayes-by-Backprop VI) at full width
   through ``vi_train.run_operator`` (reference DeepONet, 1000 training
   functions, batch 128, 512 trunk points per example, ``num_ens`` 3), a few
   epochs: the wall per epoch, the device time of one step, the peak
   memory, and the valid-MSE curve beside ``burgers_stage12_r2.npz``'s;
9. stage 2 at full width through ``sensitivity.run_operator_flat`` on that
   bundle's mu and sigma (200 validation functions, 100 trunk points each,
   chunks of 8): the wall and the time per chunk, ``num_sensitive`` beside
   the bundle's 81,131, the Jaccard overlap of the index set with the
   bundle's held to the overlap between two seeds of the trunk subsample
   less ``SENS_OVERLAP_MARGIN``, and the Spearman correlation of the scores;
10. stage 3 under the REFRESH policy at full width and a small depth: every
    chain redraws its frozen vector before each draw; ``merge_sums`` must
    still run 1 + 2 x draws times and the Gram field L + 1 times per draw;
    acceptance and draws/s beside phase 6's DRAW run;
11. the NN flow, three stages on ``MLPConfig()``: stage 1 at the
    ``nn_stage12_r2`` settings (depth cut), stage 2 on its result and on the
    bundle's mu and sigma (which must give the bundle's 77 indices exactly),
    stage 3 with a default ``VIHMCRunConfig`` (REFRESH, L = 196);
12. stage 3, variant ``stride`` (the script's default: the Gram field on
    every 3rd query point per grid dimension and every 3rd function) at full
    width and a small depth: ``merge_sums`` 1 + 2 x draws, the Gram field
    1 + L x draws; the stride field's cosine with the full Gram field at the
    VI mean, draws/s beside phase 6 and a draw's split;
13. stage 3, variant ``gauss`` (the VI-Gaussian score field): ``merge_sums``
    1 + 2 x draws, no Gram field call; draws/s and a draw's split;
14. stage 3 ``autodiff`` with a rank-16 Lanczos low-rank metric (HVPs
    through the fused density) at a few draws: the Lanczos wall;
15. ``hmc_nuts`` at ``OperatorHMCRunConfig`` (full-parameter reference
    DeepONet, 10 training functions, L = 7, dual averaging per chain, the
    fused density): ``merge_sums`` held against its plain version at that
    shape (B = 10, the small kernel, timed in turns with the tiled one), then
    at the config's one chain and at 4: 1 + 2 x draws launches, all on the
    small kernel, and every chain's step after burn constant at
    ``exp(log_step_avg)``;
16. ``hmc_split`` at ``SplitHMCRunConfig`` (1000 functions in 2 shards, L =
    2, composed autograd: no kernel launch), depth cut; at the config's step
    every proposal from the random start diverges (as in JAX), so one split
    trajectory on the pipeline's own shard density is held, card against
    CPU, instead;
17. ``hmc_full`` at ``NNHMCRunConfig`` (the regression MLP, L = 643), depth
    cut;
18. the NN bench row through ``bench_nn`` at full width (1024 chains, L = 96,
    the 73-dim subspace of ``nn_stage12.npz``, DRAW, coupled dual averaging
    with step jitter, the clipped autodiff field, the 400-step warm start),
    depth cut to one key and 120 draws: draws/s, fs-ESS/s and the
    acceptance (finite and positive), then one transition at 1024 chains
    under ``torch.profiler``: device time against wall, the per-draw host
    time;
19. stage 3 with ``algorithm='nuts'`` at full width (the stride Gram field,
    the fused density, 16 chains), depth cut (``nuts_max_depth`` 3, a few
    draws): every tree leaf evaluates the density, so ``merge_sums`` runs
    1 + (2^depth - 1) x draws times; the wall per leaf;
20. stage 3 with ``algorithm='chees'`` (a small ``chees_max_steps``): the
    density at the trajectory's end only, ``merge_sums`` 1 + draws times;
21. the adaptive metric on the card: NN stage 3 (``vi_hmc.run_nn`` on the
    row's posterior) with ``adapt_mass`` under the windowed schedule -- the
    adapted inverse mass finite and positive, dual averaging restarted at
    every window's last draw and nowhere else -- and the NN row with
    momentum persistence 0.5.

22. the command line on the card; 23. checkpointed resume at full width; 24.
    query subsampling at full width;
25. the Cone flow at full width on the per-example query path: stage 1 at
    ``DeepONetConfig()`` on 1000 generated training and 1000 validation
    examples (batch 128, a few epochs), stage 2 on the validation examples
    (the 90 % cut), stage 3 with 16 chains under DRAW on the per-example
    composed density, a few draws: no kernel launch (the merge kernels need a
    shared grid, in JAX too); then ``canonicalize_deeponet`` of the chains'
    last draws, and of the same draws moved to a random element of their
    symmetry orbit (one per chain), leaves every draw's validation
    predictions unchanged and maps both to one canonical form; the
    weight-space R-hat is printed before and after;
26. the learned noise at full width on Burgers: stage 1 with ``learn_noise``
    (``noise_type=0``, a scalar log-variance, which must move), then with
    the heteroscedastic head (``noise_neurons=10``, ``noise_type=1``: the
    head's mean log-variance on the validation batch must move), p = 512, a
    few epochs each, finite losses, no kernel launch;
27. the chain mesh on the card: stage 3 (``run_operator(mesh=,
    use_fused=True)``, full width, stride, 16 chains, dual averaging
    coupled over the chains on every draw, a few draws) (a) in a one-rank
    NCCL world, bit-equal to the
    same run without a mesh, ``merge_sums`` 1 + 2 x draws; then
    ``merge_sums`` timed at a rank's C = 8; (b) in two gloo processes sharing
    the card (``python3 chip_smoke.py --mesh-child R``, 8 chains each): each
    rank counts its own 1 + 2 x draws launches, the gathered samples and
    step sizes match (a) within ``MESH_SAMPLE_RTOL`` of their magnitude with
    the same accept decisions, the wall per draw per rank and its share in collectives
    printed; both ranks first ask for NCCL on the one card and must be
    refused; (c) the full-width ``shard_query`` log posterior's value and
    gradient over the two ranks (5,101 / 5,100 points) against the unsharded
    ones; (d) ``python -m vihmc_torch.run_multihost`` on two gloo ranks
    against one rank, at the JAX test's tolerances;
28. ``bench.py``'s operator row through ``python -m vihmc_torch.bench``'s
    entry points at full width, depth cut: (a) the zero-argument recipe on
    keys 2,3,4 (one JSON line with three ``ess_per_s_by_key``;
    ``paired_sums`` once per draw of each key plus the ``mfu`` block's),
    then a short CPU baseline with a finite ``vs_baseline``; (b) ``--subspace
    90pct`` (81,131 dimensions, 32 chains, one key): finite samples, then
    ``paired_sums`` at C = 32 against its plain version and float64, timed
    beside its bounds; (c) ``--extras``' gradient of the full log posterior:
    ``merge_sums`` at C = 1 once per fused gradient, the fused gradient's
    cosine with the composed one, both rates (every launch on the small
    kernel), and ``merge_sums`` at C = 1 against its plain version and
    float64; then both kernels timed in turns at C in {1, 2, 4, 8} x B in
    {10, 1000}, beside both bounds: the wrapper's (C, B) rule must pick the
    faster one (or one within 5 %) in every cell; (d) ``--coupled --stride 5
    --fn-stride 5``, ``--gauss-field``, ``--adaptive``, ``--no-gram``,
    ``--composed-delta`` and ``--no-paired-delta``, a few draws each, finite,
    ``paired_sums`` launched only where the delta is the fused one;
29. the result scripts (``python -m vihmc_torch.scripts.<name>``) through
    their ``main`` at full width (``DeepONetConfig()``, 172,401 parameters,
    1000 + 200 Burgers functions on the 101 x 101 grid), depth cut: (a)
    ``run_operator_stage12`` writes a run store and a bundle with the
    committed asset's keys; (b) ``run_operator_stage3 --artifacts <(a)>
    --ckpt`` samples (a)'s own subspace in segments on the fused density,
    ``merge_sums`` exactly 1 + 2 x draws; (c) ``canonicalize_operator_draws``
    on (b)'s checkpoint and (d) ``fs_diagnostics_operator`` on (b)'s run,
    finite; (e) ``run_operator_demo`` on the composed density, (f)
    ``run_nn_stage12`` (whose bundle ``bench_nn`` loads) and ``run_nn_demo``,
    (g) ``run_cone_demo``: no kernel launch in (a) and (e)-(g).

Phase 3 also prints the operator row's ``mfu`` block and phase 18 the NN
row's, with its CPU baseline (``vs_baseline``): both blocks present with 0 <
``mfu`` <= 1. Before each driven path (3, 6, 7, 8, 9, 10, 11, 12-29) every
kernel count is set to 0, and it is read just after (stages 1 and 2,
``hmc_split``, ``hmc_full``, the NN paths of 18 and 21 and phases 25-26 run
no kernel of the port; stage 3, the row and the 90 % row never take a
small kernel). Every depth cut is printed. The second-to-last line is a JSON object describing every
kernel; the last line is ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits non-zero and prints no result. It needs a CUDA
device and the rest of the repository; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from vihmc_torch import bench_nn
from vihmc_torch.chains import (gather_chains, global_chain_mesh, initialize_distributed,
                                make_chain_mesh, shard_query)
from vihmc_torch.core.mesh import data_parallel_ll
from vihmc_torch.dists.likelihoods import get_likelihood
from vihmc_torch.dists.priors import IsotropicGaussianPrior
from vihmc_torch.hmc.kernel import value_and_grad
from vihmc_torch.chains.diagnostics import potential_scale_reduction_np
from vihmc_torch.models.symmetry import canonicalize_deeponet, random_orbit_element
from vihmc_torch import bench as tbench
from vihmc_torch.bench_operator import (BENCH_L, bench_grad_path, bench_operator,
                                        bench_torch_baseline, build_problem,
                                        grad_path_log_posteriors, log_posterior_grad,
                                        mh_delta, problem_laplace_inv_mass, trajectory_field)
from vihmc_torch.dists.priors import DiagonalGaussianPrior
from vihmc_torch.core import profiling
from vihmc_torch.core.precision import matmul_precision, true_f32
from vihmc_torch.core.ravel import scatter_subspace
from vihmc_torch.data.burgers import (get_burgers, load_port_inputs,
                                      load_stage12_artifacts)
from vihmc_torch.chains.resume import sample_chains_resumable
from vihmc_torch.hmc.integrators import leapfrog_grad_only
from vihmc_torch.hmc.kernel import (clipped_grad_fn, draw_noise, init_state, make_kernel,
                                    mass_window_schedule)
from vihmc_torch.hmc.subspace import make_subspace_grad
from vihmc_torch.models.deeponet import (DeepONetConfig, bc_embedding, deeponet_features,
                                         unravel_deeponet)
from vihmc_torch.ops import cuda_build
from vihmc_torch.ops.field_stacks import (FeatureStacks, _backward_launch,
                                          stacks_backward_reference, stacks_forward_reference)
from vihmc_torch.ops.deeponet_merge import (_merge_launch, _paired_launch, _sums_path,
                                            close_paired_sums, fused_merge_nll,
                                            merge_nll_reference, merge_sums,
                                            merge_sums_reference, paired_sums,
                                            paired_sums_reference, y_sums)
from vihmc_torch.ops.gram_merge import (_gram_cotangents, grid_stride_subset,
                                        infer_grid_shape, make_gram_grad_full, pad_queries)
from vihmc_torch.ops.leapfrog import (fused_leapfrog_update,
                                      leapfrog_update_reference)
from vihmc_torch.ops.fno_project import (project_backward, project_backward_reference,
                                         project_forward, project_reference)
from vihmc_torch.models.fno import FNO2dConfig, _Project, init_fno, unravel_fno
import vihmc_torch.chains.resume as chains_resume
import vihmc_torch.pipelines.vi_hmc as vi_hmc
from vihmc_torch.data.burgers import STAGE12_ASSET, subsample_trunk
from vihmc_torch.data.synthetic import regression_data
from vihmc_torch.models.mlp import MLPConfig
from vihmc_torch.data.burgers import load_burgers_mat
from vihmc_torch.io.artifacts import RunStore
from vihmc_torch.pipelines import cli, hmc_full, hmc_nuts, hmc_split, sensitivity, vi_train
from vihmc_torch.pipelines.common import (conditional_warm_start, fno_chunks,
                                          make_deeponet_nll_log_posterior,
                                          make_flat_deeponet, make_fno_grad_full,
                                          make_fno_nll_log_likelihood)
from vihmc_torch.pipelines.configs import (NNHMCRunConfig, NNVIRunConfig,
                                           OperatorHMCRunConfig, OperatorVIRunConfig,
                                           SensitivityRunConfig,
                                           SplitHMCRunConfig, VIHMCRunConfig)
from vihmc_torch.pipelines.vi_hmc import (build_subspace_posterior, run_stage3,
                                          stage3_config)
from vihmc_torch.sensitivity import mean_squared_jacobian
from vihmc_torch.vi.elbo import ELBOConfig
from vihmc_torch.vi.train import VIConfig

# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
SPLIT_PRODUCTS = 6   # bf16 part products per f32 product in the merge kernels
F64_ERR_FACTOR = 2.0  # kernel's error vs float64 <= this x the plain version's + F64_ERR_NATS
F64_ERR_NATS = 1e-3
DLL_ATOL = 1e-2      # nats: the paired form's stated float error (pipelines/common.py:165-166)
LP1_RTOL = 1e-5
BURGERS_ATOL = 1e-4  # f32 pseudo-spectral solve, 2000 steps, |u| <= ~3.4: cuFFT vs XLA rounding
# merge_sums: each sum within this fraction of the sum of its terms'
# magnitudes (f32 products and per-cell terms round at ~6e-8 of them; the
# sums are f64); the ll within the same fraction of its terms' magnitudes
MERGE_RTOL_MAG = 1e-7
GRAD_REL_TOL = 1e-4          # fused_merge_nll gradient vs autograd of the f32 reference
GRAD_COS_MIN = 1.0 - 1e-6
LEAPFROG_ULPS = 1            # kernel vs plain: the same roundings in the same order
SLEEP_CYCLES = 400_000_000  # ~0.2 s of GPU clock: time for the host to queue the timed calls
SPLIT_REPS = 3               # calls of many-op functions: few enough to stay in the launch queue
L2_ROTATION = 8              # input copies cycled per timing: 8 x 15.6 MB exceeds the 50 MB L2
# stage 2: the index set's Jaccard overlap with the bundle may fall short of
# the overlap between two trunk-subsample seeds by at most this (the bundle's
# scores were computed on a TPU at default matmul precision)
SENS_OVERLAP_MARGIN = 0.05
NN_BUNDLE = STAGE12_ASSET.replace("burgers_stage12_r2", "nn_stage12_r2")
# depth cuts of phases 18-21 (the row's or the config's own value in brackets)
NN_DRAWS, NN_SEGMENT = 120, 120          # NN row draws, segment (2880, 480)
S3_NUTS_DRAWS, NUTS_DEPTH = 4, 3         # stage-3 NUTS draws, max depth (450, 6)
S3_CHEES_DRAWS, CHEES_MAX_STEPS = 4, 8   # stage-3 ChEES draws, step cap (450, 256)
ADAPT_DRAWS, ADAPT_BURN = 60, 40         # NN stage 3, windowed metric (450, 90)
PERSIST_DRAWS = 24                       # NN row with --persist 0.5 (2880)
CLI_DRAWS, CLI_EPOCHS = 40, 200          # phase 22: NN vi-hmc draws (100), vi-nn epochs (10,000)
RESUME_DRAWS, RESUME_SEGMENT = 30, 10    # phase 23 (450 draws in segments of 90)
SUB_DRAWS, SUB_P = 8, 1000               # phase 24: draws (450), query points kept
CONE_EPOCHS, CONE_DRAWS, CONE_KEEP = 3, 16, 4   # phase 25: VI epochs (1000), stage-3
#                                               # draws (450), last draws canonicalized
NOISE_EPOCHS, NOISE_HEAD = 2, 10         # phase 26: VI epochs (1000), head width (our choice)
NN_BASELINE_SECONDS = 20.0               # phase 18: CPU baseline cap (bench: 120 s)
CANON_PRED_RTOL = 1e-4                   # canonical draw's predictions: of max |prediction|
DISPATCH_OPS = 2000                      # one-element adds timed for the host's dispatch cost
MESH_DRAWS = 10                          # phase 27: stage-3 draws on the mesh (450)
MESH_CHILD_TIMEOUT_S = 300               # phase 27: each spawned rank's limit
# phase 27 (b): the two-rank run's samples within this fraction of their
# largest magnitude of the one-rank run's (the Gram field's products at 8
# chains round apart from those at 16; HMC at this step carries the
# differences through 10 draws without growing them past it)
MESH_SAMPLE_RTOL = 1e-4
QUERY_VALUE_RTOL = 1e-5                  # phase 27 (c): the sharded ll (JAX's test tolerance)
QUERY_GRAD_RTOL = 1e-4                   # ... its gradient, of the gradient's largest entry
# phase 28: bench.py's row through python -m vihmc_torch.bench (recipe values in brackets)
ROW_DRAWS, ROW_BURN, ROW_SEGMENT = 60, 12, 30   # (a) per key (2880, 288, 120)
ROW_INIT_OPT, ROW_RANK = 100, 16                # (a), (b) warm-start steps, Lanczos rank (800, 256)
ROW_BASELINE_SECONDS = 10.0                     # (a) CPU baseline cap (bench: 120 s)
NINETY_DRAWS, NINETY_BURN, NINETY_SEGMENT = 24, 6, 12   # (b) the 90 % row (2880, 288, 60)
C32_STEP = 0.01                                 # (b) the kernel check's trajectory step
GRAD_ITERS = 30                                 # (c) gradient evaluations (bench: 30)
GRAD_PATH_COS_MIN = 0.9999                      # (c) fused vs composed gradient
VARIANT_DRAWS = 6                               # (d) draws per recipe (24 where thin 3 needs segments)
# phase 29: the result scripts (their defaults in brackets in the phase's cut line)
SCRIPT_EPOCHS = 2                                   # stage 1 of stage12 / the demos
SCRIPT_DRAWS, SCRIPT_SEGMENT = 12, 6                # (b) stage 3
SCRIPT_DEMO_DRAWS = 8                               # (e), (g)
NN_SCRIPT_EPOCHS, NN_SCRIPT_HMC_DRAWS = 300, 8      # (f)
NN_SCRIPT_VIHMC_DRAWS, NN_SCRIPT_CONV_DRAWS = 20, 40

KERNELS = {
    # the tiled kernels (every launch is counted in `launches`; on the paths
    # that hold them, none takes the small kernel)
    "paired_sums": {"route": "cuda", "source": "vihmc_torch/csrc/paired_sums.cu",
                    "replaces": "vihmc_tpu/ops/deeponet_merge.py:349"},
    # the small-problem kernel of the same source (C <= 2, or B < 128), counted
    # apart by its wrapper
    "paired_sums_small": {"route": "cuda", "source": "vihmc_torch/csrc/paired_sums.cu",
                          "replaces": "vihmc_tpu/ops/deeponet_merge.py:304"},
    "merge_sums": {"route": "cuda", "source": "vihmc_torch/csrc/merge_sums.cu",
                   "replaces": "vihmc_tpu/ops/deeponet_merge.py:108"},
    # the small-problem kernel, on --extras' fused gradient (C = 1) and hmc_nuts (B = 10)
    "merge_sums_small": {"route": "cuda", "source": "vihmc_torch/csrc/merge_sums.cu",
                         "replaces": "vihmc_tpu/ops/deeponet_merge.py:72"},
    "leapfrog_update": {"route": "cuda", "source": "vihmc_torch/csrc/leapfrog_update.cu",
                        "replaces": "vihmc_tpu/ops/leapfrog.py:46"},
    # pack + forward + one backward launch per layer, per bf16 Gram field call
    "field_stacks": {"route": "cuda", "source": "vihmc_torch/csrc/field_stack.cu",
                     "replaces": "none: the JAX field's stacks are XLA matmuls"},
    # forward + backward per function chunk of a bf16 FNO field call
    "fno_project": {"route": "cuda", "source": "vihmc_torch/csrc/fno_project.cu",
                    "replaces": "none: the JAX package has no FNO"},
}
# the recorder's launch counters (core/profiling.py): each wrapper counts its
# launches, those at C = 1 and those of the small kernel apart
COUNTERS = {"paired_sums": "paired_sums.launches",
            "paired_sums_c1": "paired_sums.launches_c1",
            "paired_sums_small": "paired_sums.launches_small",
            "merge_sums": "merge_sums.launches",
            "merge_sums_c1": "merge_sums.launches_c1",
            "merge_sums_small": "merge_sums.launches_small",
            "leapfrog_update": "leapfrog_update.launches",
            "field_stacks": "field_stacks.launches",
            "fno_project": "fno_project.launches",
            "fno_project_fused": "fno.project.fused"}
_COUNTS_AT = {}   # the counters at the last reset_counts()


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def phase(name: str, t0: float):
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def reset_counts():
    torch.cuda.synchronize()
    _COUNTS_AT.clear()
    _COUNTS_AT.update(profiling.counters())


def read_counts() -> dict:
    """The launches since the last :func:`reset_counts`."""
    torch.cuda.synchronize()
    return {k: profiling.counter(c) - _COUNTS_AT.get(c, 0) for k, c in COUNTERS.items()}


def time_device(label: str, fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call of ``fn()`` over ``reps`` calls
    queued back to back behind a GPU sleep (CUDA events around the calls).
    The host enqueues the calls while the card sleeps, so the events bracket
    device work only; one event pair per call would also count the host's
    dispatch, which is longer than a small kernel. When the card reaches the
    first event before the host has queued every call (a full launch queue),
    the time includes host dispatch, and a line says so."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    if a.query():
        print(f"  (timing of {label}: the card caught up with the host; the time "
              f"includes host dispatch)")
    b.synchronize()
    return a.elapsed_time(b) / reps


def profile_device(fn, reps: int, top: int = 4):
    """``reps`` calls of ``fn()`` under ``torch.profiler``: ``(device ms per
    call or None, wall ms per call, [(kernel, device ms per call), ...])``.
    The device time is the sum of the kernels' (and copies') time the
    profiler recorded; None when it recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(e.key, e.self_device_time_total / 1e3 / reps) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda kv: -kv[1])
    dev = sum(ms for _, ms in kernels) or None
    return dev, 1e3 * wall / reps, [(k[:60], ms) for k, ms in kernels[:top]]


def profile_line(label: str, fn, reps: int) -> float:
    """Print the device time, wall and busy share of ``fn`` and its largest
    kernels; returns the device ms per call (nan when not measured)."""
    dev, wall, top = profile_device(fn, reps)
    if dev is None:
        print(f"  {label}: wall {wall:.2f} ms per call; device time not measured (the "
              f"profiler recorded no device activity)")
        return math.nan
    print(f"  {label} (torch.profiler, {reps} calls): device {dev:.2f} ms of {wall:.2f} ms "
          f"wall per call (device busy {100 * dev / wall:.1f} %); largest kernels: "
          + "; ".join(f"{k} {ms:.2f} ms" for k, ms in top))
    return dev


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    """``(ms, 'operations' | 'bytes')``: the larger of the two times."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def split_tc_ms(product_flops: float, nbytes: float) -> float:
    """The split tensor-core bound: six bf16 part products per f32 product at
    the dense bf16 peak, or the bytes if they take longer."""
    return bound(SPLIT_PRODUCTS * product_flops, nbytes, PEAK_BF16_FLOPS)[0]


def bound_line(ms: float, f32_ms: float, tc_ms: float) -> str:
    return (f"bound f32 FMA {f32_ms:.3f} ms ({100 * f32_ms / ms:.1f} % of it reached), split "
            f"tensor core {tc_ms:.3f} ms ({100 * tc_ms / ms:.1f} %)")


def paired_sums_f64(bout1, tout1, bout0, tout0, y) -> torch.Tensor:
    rows = []
    y64 = y.double()
    for c in range(bout1.shape[0]):
        m1 = bout1[c].double() @ tout1[c].double().T
        m0 = bout0[c].double() @ tout0[c].double().T
        dm, sm = m1 - m0, m1 + m0
        rows.append(torch.stack([(dm * (sm - 2 * y64)).sum(), dm.sum(), sm.sum(),
                                 (m1 * m1).sum(), (m1 * y64).sum()]))
    return torch.stack(rows)


def paired_sums_bound_ms(c, b, p, k):
    """``(f32 ms, bound_by, split tensor-core ms)``: two products + the
    epilogue; each input read once, the sums written once."""
    nbytes = 4.0 * (2 * c * b * k + 2 * c * p * k + b * p + 5 * c)
    f32_ms, by = bound(4.0 * c * b * p * k + 12.0 * c * b * p, nbytes)
    return f32_ms, by, split_tc_ms(4.0 * c * b * p * k, nbytes)


def merge_sums_bound_ms(c, b, p, k):
    """``(f32 ms, bound_by, split tensor-core ms)``: the product + the
    epilogue (m - 2y, the product, two adds)."""
    nbytes = 4.0 * (c * b * k + c * p * k + b * p) + 8.0 * 2 * c
    f32_ms, by = bound(2.0 * c * b * p * k + 4.0 * c * b * p, nbytes)
    return f32_ms, by, split_tc_ms(2.0 * c * b * p * k, nbytes)


def leapfrog_bound_ms(n, d_im):
    # q, p, g and the (D,) mass read once, q_new and p_half written once
    return bound(5.0 * n, 4.0 * (5 * n + d_im))


def compare_paired(label, feats, biases, y, tau=1.0, main=False):
    """Kernel vs plain vs f64 on one input set; returns the kernel's max |dDll|
    against the plain version. ``main``: also hold the kernel's error against
    float64 to twice the plain version's plus 1e-3 nats."""
    bout1, tout1, bout0, tout0 = feats
    b1, b0 = biases
    c, b, k = bout1.shape
    p = tout1.shape[1]
    sy = y_sums(y)
    s_k = paired_sums(bout1, tout1, bout0, tout0, y)
    torch.cuda.synchronize()
    s_p = paired_sums_reference(bout1, tout1, bout0, tout0, y)
    s_64 = paired_sums_f64(bout1, tout1, bout0, tout0, y)
    d_k, lp_k = close_paired_sums(s_k, b1, b0, b * p, tau, *sy)
    d_p, lp_p = close_paired_sums(s_p, b1, b0, b * p, tau, *sy)
    d_64, lp_64 = close_paired_sums(s_64, b1, b0, b * p, tau, *sy)
    names = ("D", "Bd", "Sm", "Q1", "C1")
    for i, n in enumerate(names):
        ad = (s_k[:, i].double() - s_p[:, i].double()).abs().max().item()
        rd = ad / max(s_p[:, i].double().abs().max().item(), 1e-30)
        ad64 = (s_k[:, i].double() - s_64[:, i]).abs().max().item()
        print(f"  {label} {n}: kernel-plain max abs {ad:.4g} rel {rd:.3g}; "
              f"kernel-f64 max abs {ad64:.4g}")
    err_dll = (d_k.double() - d_p.double()).abs().max().item()
    err_lp1 = ((lp_k.double() - lp_p.double()).abs() / lp_p.double().abs()).max().item()
    err_k64 = (d_k.double() - d_64.double()).abs().max().item()
    err_p64 = (d_p.double() - d_64.double()).abs().max().item()
    print(f"  {label} dll: kernel-plain max abs {err_dll:.4g} nats, kernel-f64 "
          f"{err_k64:.4g}, plain-f64 {err_p64:.4g} (|dll| up to {d_64.abs().max().item():.4g})")
    if main:
        check(err_k64 <= F64_ERR_FACTOR * err_p64 + F64_ERR_NATS,
              f"{label}: dll kernel-f64 {err_k64} > {F64_ERR_FACTOR} x plain-f64 {err_p64} + "
              f"{F64_ERR_NATS} nats")
    print(f"  {label} lp1: kernel-plain max rel {err_lp1:.3g}, kernel-f64 rel "
          f"{((lp_k.double() - lp_64.double()).abs() / lp_64.abs()).max().item():.3g}")
    check(bool(torch.isfinite(s_k).all()), f"{label}: non-finite kernel sums")
    check(err_dll <= DLL_ATOL, f"{label}: |dll kernel - plain| {err_dll} > {DLL_ATOL} nats")
    check(err_lp1 <= LP1_RTOL, f"{label}: lp1 rel err {err_lp1} > {LP1_RTOL}")
    return err_dll


def merge_f64(bout, tout, bias, y, tau):
    """Per chain: ``(S1, S2)``, their terms' magnitudes, the ll and its
    terms' magnitude, all in float64."""
    var = max(float(tau), 1e-6)
    y64 = y.double()
    s, mag, ll, ll_mag = [], [], [], []
    for c in range(bout.shape[0]):
        m = bout[c].double() @ tout[c].double().T
        s.append(torch.stack([(m * (m - 2 * y64)).sum(), m.sum()]))
        mag.append(torch.stack([(m * m + 2 * (m * y64).abs()).sum(), m.abs().sum()]))
        b = bias[c].double()
        ll.append(-0.5 * (y.numel() * math.log(var) + ((m + b - y64) ** 2).sum() / var))
        ll_mag.append(0.5 * ((m.abs() + b.abs() + y64.abs()) ** 2).sum() / var)
    return torch.stack(s), torch.stack(mag), torch.stack(ll), torch.stack(ll_mag)


def compare_merge(label, bout, tout, bias, y, tau=1.0, main=False):
    """merge_sums and fused_merge_nll vs plain vs f64; returns the max
    |ll kernel - ll plain| in nats. ``main``: also hold the ll's error against
    float64 to twice the plain version's plus 1e-3 nats."""
    s_k = merge_sums(bout, tout, y)
    torch.cuda.synchronize()
    s_p = merge_sums_reference(bout, tout, y)
    s_64, mag, ll_64, ll_mag = merge_f64(bout, tout, bias, y, tau)
    for i, n in enumerate(("S1", "S2")):
        e_p = ((s_k[:, i] - s_p[:, i]).abs() / mag[:, i]).max().item()
        e_64 = ((s_k[:, i] - s_64[:, i]).abs() / mag[:, i]).max().item()
        e_p64 = ((s_p[:, i] - s_64[:, i]).abs() / mag[:, i]).max().item()
        print(f"  {label} {n}: kernel-plain {e_p:.3g}, kernel-f64 {e_64:.3g}, plain-f64 "
              f"{e_p64:.3g} of the terms' magnitudes (|{n}| up to "
              f"{s_64[:, i].abs().max().item():.4g})")
        check(e_p <= MERGE_RTOL_MAG and e_64 <= MERGE_RTOL_MAG,
              f"{label} {n}: kernel differs by {max(e_p, e_64)} of its terms' magnitudes")
    ll_k = fused_merge_nll(bout, tout, bias, y, tau)
    ll_p = merge_nll_reference(bout, tout, bias, y, tau)
    err_p = (ll_k.double() - ll_p.double()).abs().max().item()
    err_64 = (ll_k.double() - ll_64).abs()
    print(f"  {label} ll: kernel-plain max abs {err_p:.4g} nats, kernel-f64 "
          f"{err_64.max().item():.4g}, plain-f64 {(ll_p.double() - ll_64).abs().max().item():.4g}"
          f" (|ll| up to {ll_64.abs().max().item():.4g}, terms' magnitude up to "
          f"{ll_mag.max().item():.4g})")
    check(bool(torch.isfinite(ll_k).all()), f"{label}: non-finite ll")
    check(bool((err_64 <= MERGE_RTOL_MAG * ll_mag).all()),
          f"{label}: ll kernel-f64 {err_64.max().item()} beyond {MERGE_RTOL_MAG} of "
          f"its terms' magnitude")
    if main:
        err_p64 = (ll_p.double() - ll_64).abs().max().item()
        check(err_64.max().item() <= F64_ERR_FACTOR * err_p64 + F64_ERR_NATS,
              f"{label}: ll kernel-f64 {err_64.max().item()} > {F64_ERR_FACTOR} x plain-f64 "
              f"{err_p64} + {F64_ERR_NATS} nats")
    return err_p


def paths_in_turns(label, launch, args, reps, bounds) -> dict:
    """Device ms of the small and the tiled kernel on the same inputs, timed
    in turns (small, tiled, tiled, small) through the wrapper's launch
    ``launch(path, *args)``; prints both beside the f32-FMA and split
    tensor-core bounds. Returns ``{'small': ms, 'tiled': ms}``, each the mean
    of its two timings, and the spread of each."""
    times = {"small": [], "tiled": []}
    for path in ("small", "tiled", "tiled", "small"):
        times[path].append(time_device(f"{label} {path}", lambda: launch(path, *args), reps))
    f32_ms, by, tc_ms = bounds
    ms = {k: sum(v) / 2 for k, v in times.items()}
    print(f"  {label}: small {times['small'][0]:.4f}/{times['small'][1]:.4f} ms, tiled "
          f"{times['tiled'][0]:.4f}/{times['tiled'][1]:.4f} ms (in turns, {reps} queued "
          f"launches each); tiled/small {ms['tiled'] / ms['small']:.2f}x; bounds: f32 FMA "
          f"{f32_ms:.4f} ms ({by}; small {100 * f32_ms / ms['small']:.1f} %, tiled "
          f"{100 * f32_ms / ms['tiled']:.1f} %), split tensor core {tc_ms:.4f} ms (small "
          f"{100 * tc_ms / ms['small']:.1f} %, tiled {100 * tc_ms / ms['tiled']:.1f} %)")
    return dict(ms, spread={k: abs(v[0] - v[1]) for k, v in times.items()})


def merge_paths_grid(bo, to, y, reps) -> dict:
    """``merge_sums`` on both kernels at C in {1, 2, 4, 8} x B in {10, 1000}
    (the B rows are the first of ``bo`` and ``y``; chains past the first are
    the features moved by 1e-3 of a normal draw), P and K of ``to``, timed in
    turns. The wrapper's (C, B) rule rests on this table."""
    gen = torch.Generator(device=bo.device)
    gen.manual_seed(21)
    table = {}
    for c in (1, 2, 4, 8):
        boc = bo[:1] + 1e-3 * torch.randn((c, *bo.shape[1:]), generator=gen, device=bo.device)
        toc = to[:1] + 1e-3 * torch.randn((c, *to.shape[1:]), generator=gen, device=bo.device)
        boc[0], toc[0] = bo[0], to[0]
        for b in (10, 1000):
            args = (boc[:, :b].contiguous(), toc, y[:b].contiguous())
            key = f"C={c} B={b}"
            table[key] = paths_in_turns(f"merge_sums {key} P={to.shape[1]} K={to.shape[2]}",
                                        _merge_launch, args, reps,
                                        merge_sums_bound_ms(c, b, to.shape[1], to.shape[2]))
            table[key]["rule"] = _sums_path(c, b)
    return table


def gram_cotangents_tf32(bout, tout, bias, y, var):
    """The Gram cotangents chain by chain in TF32, phase 4's yardstick for
    the merged route: f32 copies of the bf16 features and data, each chain's
    products in TF32 (exact on bf16 values, f32 sums), the scaled results
    cast back to bf16."""
    f32 = torch.float32
    bo, to, yy, b = bout.to(f32), tout.to(f32), y.to(f32), bias.to(f32)
    sum_t, sum_b = to.sum(-2), bo.sum(-2)
    with matmul_precision("tensorfloat32"):
        gram_t = torch.matmul(to.transpose(-1, -2), to)
        gram_b = torch.matmul(bo.transpose(-1, -2), bo)
        ct_bout = (torch.matmul(yy, to) - torch.matmul(bo, gram_t)
                   - b[:, None, None] * sum_t[:, None, :]) / var
        ct_tout = (torch.matmul(yy.T, bo) - torch.matmul(to, gram_b)
                   - b[:, None, None] * sum_b[:, None, :]) / var
    ct_bias = (yy.sum() - (sum_b * sum_t).sum(-1) - y.numel() * b) / var
    return [ct.to(bout.dtype) for ct in (ct_bout, ct_tout, ct_bias)]


def cotangent_step_times(problem, q, reps):
    """The bf16 Gram field's cotangent step alone on the row's features at
    ``q`` (C 48, B 1000, P 10,201, K 100): the merged route
    (``gram_merge._gram_cotangents``: bf16 operands, f32 products, two wide
    GEMMs) and :func:`gram_cotangents_tf32`, timed in turns (TF32, merged,
    merged, TF32) beside the bound: 4 C B P K + 4 C (B + P) K^2 operations at
    the bf16 peak, or y, the features and the cotangents (bf16) once at
    3.35 TB/s. Chain 0 against float64 on the same bf16 values: the merged
    route's largest error of a row against the row's norm may not exceed
    the TF32 route's. ``field.cotangents.merged`` counts every merged call."""
    bf = torch.bfloat16
    cfg, spec = problem.cfg, problem.spec
    params = unravel_deeponet(cfg, scatter_subspace(problem.frozen, q, spec.idx).to(bf))
    bx, tx, y = (t.to(bf) for t in (problem.branch_x, problem.trunk_x, problem.y))
    with torch.no_grad():
        bout, tout = deeponet_features(cfg, params, bx, tx)
    bias = params["b"].detach()
    c, b, k = bout.shape
    p = tout.shape[1]
    yp, y_sum, bufs = pad_queries(y, bf), float(y.sum(dtype=torch.float32)), {}
    routes = {"tf32": lambda: gram_cotangents_tf32(bout, tout, bias, y, 1.0),
              "merged": lambda out=bf: _gram_cotangents(bout, tout, bias, yp, y_sum, 1.0, 1.0,
                                                        out, bufs)}
    n0 = profiling.counters().get("field.cotangents.merged", 0)
    times = {"tf32": [], "merged": []}
    for label in ("tf32", "merged", "merged", "tf32"):
        times[label].append(time_device(f"cotangents {label}", routes[label], reps))
    n_merged = profiling.counters().get("field.cotangents.merged", 0) - n0
    check(n_merged == 2 * (reps + 2), f"field.cotangents.merged counted {n_merged} of "
          f"{2 * (reps + 2)} merged calls")
    flops = c * (4 * b * p * k + 4 * (b + p) * k * k)
    nbytes = 2 * (b * p + 2 * c * (b + p) * k)
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    ms = {k_: sum(v) / 2 for k_, v in times.items()}
    # chain 0 in float64: ct_tout, the wide one
    f64 = torch.float64
    bo, to, yy = bout[0].to(f64), tout[0].to(f64), y.to(f64)
    want = yy.T @ bo - to @ (bo.T @ bo) - bias[0].to(f64) * bo.sum(0)
    errs = {}
    for label, fn in (("tf32", lambda: gram_cotangents_tf32(bout.float(), tout.float(),
                                                            bias.float(), y.float(), 1.0)),
                      ("merged", lambda: routes["merged"](torch.float32))):
        got = fn()[1][0]       # f32: the TF32 route on f32 copies skips the bf16 cast
        errs[label] = ((got.to(f64) - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
    del want, yy
    print(f"  cotangent step at C={c} B={b} P={p} K={k}: merged {times['merged'][0]:.4f}/"
          f"{times['merged'][1]:.4f} ms, TF32 {times['tf32'][0]:.4f}/{times['tf32'][1]:.4f} ms "
          f"(in turns, {reps} queued calls each; {ms['tf32'] / ms['merged']:.2f}x); bound "
          f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.1f} GFLOP at "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, {nbytes / 1e6:.1f} MB at "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s): merged {100 * bound_ms / ms['merged']:.1f} %, "
          f"TF32 {100 * bound_ms / ms['tf32']:.1f} %; chain 0 ct_tout row error vs float64: "
          f"merged {errs['merged']:.3g}, TF32 {errs['tf32']:.3g}")
    check(errs["merged"] <= errs["tf32"], f"merged cotangents less precise than TF32: {errs}")
    profile_line("cotangents merged", routes["merged"], 5)
    profile_line("cotangents TF32", routes["tf32"], 5)


def stacks_bytes_flops(plan, c):
    """``(forward bytes, backward bytes, forward FLOPs, backward FLOPs)`` of
    one field call's stacks at C chains: each input read once and each output
    written once at the layers' own widths (the flat f32 vector, the shared
    inputs, the tanh outputs and features in bf16; backward: each layer's g
    and y read, g below written, W in bf16 read, the f32 gradient written);
    2 FLOPs per multiply-add of the products (forward; dW and g W)."""
    d4 = 4 * c * plan.num_params
    fb, bb, ff, bf_ = d4, d4 + d4 // 2, 0, 0
    for st in plan.stacks:
        widths = [s.d_out for s in st.slices]
        fb += 2 * st.n * st.d_in + 2 * c * st.n * sum(widths)
        for i, s in enumerate(st.slices):
            y_bytes = 2 * c * st.n * s.d_in if i else 2 * st.n * s.d_in
            bb += 2 * c * st.n * s.d_out + y_bytes + (2 * c * st.n * s.d_in if i else 0)
            ff += 2 * c * st.n * s.d_in * s.d_out
            bf_ += 2 * c * st.n * s.d_in * s.d_out * (2 if i else 1)
    return fb, bb, ff, bf_


def field_stack_times(cfg, branch_x, trunk_x, flat, reps):
    """The bf16 field's stacks at ``flat`` (C, D) on the card: the fused
    kernels (``csrc/field_stack.cu``: pack + forward, then the nine backward
    layers) against the autograd path they replace (``mlp_stack`` in bf16:
    cuBLAS GEMM, bias add and tanh per layer, and autograd's backward), timed
    in turns (autograd, fused, fused, autograd; ``reps`` queued calls each),
    beside the byte and FLOP bounds (:func:`stacks_bytes_flops`) and the plain
    version's time; the kernels' gradient against the plain version's.
    Returns the kernel row."""
    bf = torch.bfloat16
    c = flat.shape[0]
    plan = FeatureStacks(cfg, branch_x, bc_embedding(trunk_x))
    gen = torch.Generator(device=flat.device)
    gen.manual_seed(5)
    leaf = flat.detach().clone().requires_grad_(True)
    with torch.no_grad():
        feats = plan(leaf)
    cts = [torch.randn(f.shape, generator=gen, device=f.device).to(bf) for f in feats]
    with torch.enable_grad():
        outs = plan(leaf)
    saved = outs[0].grad_fn.saved
    bx, tx = branch_x.to(bf), trunk_x.to(bf)
    with torch.enable_grad():
        params = unravel_deeponet(cfg, leaf.to(bf))
        old = (*deeponet_features(cfg, params, bx, tx), params["b"])

    def old_forward():
        with torch.no_grad():
            deeponet_features(cfg, unravel_deeponet(cfg, leaf.detach().to(bf)), bx, tx)

    routes = {"autograd forward": old_forward,
              "fused forward": lambda: plan(leaf.detach()),
              "autograd backward": lambda: torch.autograd.grad(old, leaf, cts, retain_graph=True),
              "fused backward": lambda: _backward_launch(plan, saved, cts[:2])}
    times = {k: [] for k in routes}
    for part in ("forward", "backward"):
        for kind in ("autograd", "fused", "fused", "autograd"):
            label = f"{kind} {part}"
            times[label].append(time_device(label, routes[label], reps))
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    fb, bb, ff, bflops = stacks_bytes_flops(plan, c)
    bounds = {part: bound(f, b, PEAK_BF16_FLOPS) for part, f, b in
              (("forward", ff, fb), ("backward", bflops, bb))}
    n0 = profiling.counter("field_stacks.launches")
    routes["fused backward"]()
    torch.cuda.synchronize()
    per_backward = profiling.counter("field_stacks.launches") - n0
    plain = {"forward": time_device("plain forward",
                                    lambda: stacks_forward_reference(plan, leaf.detach()), 2,
                                    warmup=1)}
    want_feats, acts = stacks_forward_reference(plan, leaf.detach())
    plain["backward"] = time_device(
        "plain backward", lambda: stacks_backward_reference(plan, leaf.detach(), acts, cts[:2]),
        2, warmup=1)
    want = stacks_backward_reference(plan, leaf.detach(), acts, cts[:2])
    got = _backward_launch(plan, saved, cts[:2])
    got[:, 0] = want[:, 0] = 0
    err = ((got - want).norm(dim=1) / want.norm(dim=1)).max().item()
    feat_err = max(((a.float() - b.float()).norm() / b.float().norm()).item()
                   for a, b in zip(outs[:2], want_feats))
    for part in ("forward", "backward"):
        bms, by = bounds[part]
        print(f"  field stacks {part} at C={c} B={plan.stacks[0].n} P={plan.stacks[1].n}: fused "
              f"{times['fused ' + part][0]:.4f}/{times['fused ' + part][1]:.4f} ms, autograd "
              f"{times['autograd ' + part][0]:.4f}/{times['autograd ' + part][1]:.4f} ms (in "
              f"turns, {reps} queued calls each; {ms['autograd ' + part] / ms['fused ' + part]:.2f}"
              f"x); bound {bms:.4f} ms ({by}: {(ff if part == 'forward' else bflops) / 1e9:.1f} "
              f"GFLOP, {(fb if part == 'forward' else bb) / 1e9:.3f} GB): fused "
              f"{100 * bms / ms['fused ' + part]:.1f} %; plain {plain[part]:.3f} ms")
    print(f"  field stacks: {2} forward + {per_backward} backward launches per call; fused vs "
          f"plain: gradient {err:.3g} of each chain's norm (largest), features {feat_err:.3g}")
    check(err < 5e-3 and feat_err < 2e-3, f"fused stacks vs plain: gradient {err}, "
          f"features {feat_err}")
    profile_line("fused stacks forward + backward",
                 lambda: (plan(leaf.detach()), _backward_launch(plan, saved, cts[:2])), 5)
    total = ms["fused forward"] + ms["fused backward"]
    bound_ms = bounds["forward"][0] + bounds["backward"][0]
    return dict(max_abs_err=err, ms=total, forward_ms=ms["fused forward"],
                backward_ms=ms["fused backward"], autograd_ms=ms["autograd forward"]
                + ms["autograd backward"], plain_ms=plain["forward"] + plain["backward"],
                bound_ms=bound_ms, bound_by="bytes" if bounds["backward"][1] == "bytes"
                else "operations")


# FP32-pipe instructions one hidden value costs in csrc/fno_project.cu,
# reckoned from its source and libdevice's erff (~28 with both of its
# branches) and expf (~8): forward the bias, the scale, erff, the GELU's 3,
# half a bf16 round trip and the w2 FMA; backward erff, expf, the cdf, pdf
# and gelu' (5), w2 g and dz1 (2), the GELU (2), the rounds of gelu and dz1,
# the dw2 FMA and the db1 add
FNO_FWD_INSTR, FNO_BWD_INSTR = 35, 58
FNO_CHUNK_FUNCTIONS = 336    # one function chunk of the FNO cell at C = 4 (memory_gb 56)


def fno_project_bounds(c, w, f, n, p1, p2, s1, s2, n_sm, clock_hz):
    """``{part: (bytes, model FLOPs, instruction ms)}`` of the fused
    projection: forward x read and out written, backward x and g read and dx
    written (f32, once each); the model's products at the real points; the
    hidden values at every padded point times their instructions over the
    card's FP32 lanes (128 an SM) at ``clock_hz``."""
    npad, nreal = n * p1 * p2, n * s1 * s2
    lanes = n_sm * 128 * clock_hz
    return {"forward": (4 * c * (w * npad + nreal), 2 * c * nreal * f * (w + 1),
                        1e3 * c * npad * f * FNO_FWD_INSTR / lanes),
            "backward": (4 * c * (2 * w * npad + nreal), 2 * c * nreal * f * (2 * w + 1),
                         1e3 * c * npad * f * FNO_BWD_INSTR / lanes)}


def fno_project_times(dev, reps, n=FNO_CHUNK_FUNCTIONS, c=4):
    """The FNO field's projection at one function chunk of the cell (C 4,
    336 functions, the published widths, the 110 x 110 padded grid) on the
    card: the fused kernels (``csrc/fno_project.cu``) forward and backward
    against the autograd path they replace (``_Project`` in bf16: cuBLAS
    products around elementwise passes over the hidden), timed in turns
    (autograd, fused, fused, autograd), beside their byte, product and
    instruction bounds and the plain version's time; the kernels' output and
    gradients against the plain version's. Returns the kernel row."""
    cfg = FNO2dConfig()
    s, pad = 101, cfg.padding
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    flat = torch.stack([init_fno(cfg, device=dev) for _ in range(c)])
    p = unravel_fno(cfg, flat)
    weights = (p["fc1.weight"], p["fc1.bias"], p["fc2.weight"], p["fc2.bias"])
    w, f = cfg.width, cfg.fc_dim
    x = torch.randn(c, w, n, s + pad, s + pad, generator=gen, device=dev)
    g = torch.randn(c, n, s, s, generator=gen, device=dev)
    xl = x.clone().requires_grad_(True)
    wl = [t.detach().clone().requires_grad_(True) for t in weights]

    def autograd_forward():
        with torch.enable_grad():
            return _Project.apply(xl, *wl, s, s, torch.bfloat16, False)

    held = {}

    def autograd_backward():
        if "out" not in held:
            held["out"] = autograd_forward()
        return torch.autograd.grad(held["out"], [xl, *wl], g, retain_graph=True)

    routes = {"autograd forward": autograd_forward,
              "fused forward": lambda: project_forward(x, *weights, s, s),
              "autograd backward": autograd_backward,
              "fused backward": lambda: project_backward(x, g, *weights, s, s)}
    times = {k: [] for k in routes}
    for part in ("forward", "backward"):
        for kind in ("autograd", "fused", "fused", "autograd"):
            label = f"{kind} {part}"
            times[label].append(time_device(label, routes[label], reps))
        held.clear()
        torch.cuda.empty_cache()
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    n0 = profiling.counter("fno_project.launches")
    out = project_forward(x, *weights, s, s)
    grads = project_backward(x, g, *weights, s, s)
    again = project_backward(x, g, *weights, s, s)
    torch.cuda.synchronize()
    per_call = (profiling.counter("fno_project.launches") - n0) // 3
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          "fused projection: two backward calls differ")
    check(bool((grads[0][..., s:, :] == 0).all() and (grads[0][..., :, s:] == 0).all()),
          "fused projection: dx is not 0 at the pad points")
    del again
    plain = {"forward": time_device("plain forward",
                                    lambda: project_reference(x, *weights, s, s), 1, warmup=0)}
    want_out = project_reference(x, *weights, s, s)
    errs = {"out": ((out - want_out).norm() / want_out.norm()).item()}
    del want_out
    torch.cuda.empty_cache()
    plain["backward"] = time_device(
        "plain backward", lambda: project_backward_reference(x, g, *weights, s, s), 1, warmup=0)
    want = project_backward_reference(x, g, *weights, s, s)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, want):
        errs[name] = ((a - b).norm() / b.norm()).item()
    del want
    torch.cuda.empty_cache()
    props = torch.cuda.get_device_properties(dev)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"], capture_output=True, text=True,
                           timeout=60, check=True).stdout.strip().splitlines()[0]
    clock_hz = float(clock) * 1e6
    bounds = fno_project_bounds(c, w, f, n, s + pad, s + pad, s, s, props.multi_processor_count,
                                clock_hz)
    for part in ("forward", "backward"):
        nbytes, flops, instr_ms = bounds[part]
        bytes_ms, flop_ms = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_BF16_FLOPS
        fused_ms = ms["fused " + part]
        print(f"  fno projection {part} at C={c} n={n} (110 x 110 padded, width {w}, fc_dim "
              f"{f}): fused {times['fused ' + part][0]:.3f}/{times['fused ' + part][1]:.3f} ms, "
              f"autograd {times['autograd ' + part][0]:.3f}/{times['autograd ' + part][1]:.3f} "
              f"ms (in turns, {reps} queued calls each; "
              f"{ms['autograd ' + part] / fused_ms:.2f}x); bounds: bytes {bytes_ms:.3f} ms "
              f"({nbytes / 1e9:.2f} GB, {100 * bytes_ms / fused_ms:.1f} % reached), instructions "
              f"{instr_ms:.3f} ms ({100 * instr_ms / fused_ms:.1f} %; "
              f"{FNO_FWD_INSTR if part == 'forward' else FNO_BWD_INSTR} a hidden value at "
              f"{clock} MHz), products {flop_ms:.3f} ms ({flops / 1e12:.3f} TFLOP); plain "
              f"{plain[part]:.3f} ms")
    print(f"  fno projection: {per_call} launch a direction; fused vs plain (relative norm): "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    check(max(errs.values()) < 1e-3, f"fused projection vs plain: {errs}")
    profile_line("fused projection forward + backward",
                 lambda: (project_forward(x, *weights, s, s),
                          project_backward(x, g, *weights, s, s)), 3)
    total = ms["fused forward"] + ms["fused backward"]
    instr_ms = bounds["forward"][2] + bounds["backward"][2]
    return dict(max_abs_err=max(errs.values()), ms=total, forward_ms=ms["fused forward"],
                backward_ms=ms["fused backward"], autograd_ms=ms["autograd forward"]
                + ms["autograd backward"], plain_ms=plain["forward"] + plain["backward"],
                bound_ms=instr_ms, bound_by="instructions",
                bytes_bound_ms=1e3 * (bounds["forward"][0] + bounds["backward"][0])
                / PEAK_BYTES_PER_S)


def fno_field_counts(dev) -> dict:
    """One bf16 FNO field call at the cell's shapes (C 4, 1000 functions on
    the 101 x 101 grid, ``memory_gb`` 56: three chunks) and the f32 density
    and field of the same chains: the recorder's counts of each. The bf16 call
    must run the projection on the kernels, one forward and one backward a
    chunk; the f32 ones never."""
    cfg, c, b, s = FNO2dConfig(), 4, 1000, 101
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    u0 = torch.randn(b, s, generator=gen, device=dev)
    y = torch.randn(b, s * s, generator=gen, device=dev)
    flat = torch.stack([init_fno(cfg, device=dev) for _ in range(c)])
    max_bytes = int(56 * 2 ** 30)
    chunks = len(fno_chunks(cfg, b, c, s, s, max_bytes))
    reset_counts()
    k0 = profiling.counter("fno.chunks")
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    make_fno_grad_full(cfg, u0, y, 1.0, torch.bfloat16, max_bytes)(flat)
    bf16 = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) - base
    bf16["chunks"] = profiling.counter("fno.chunks") - k0
    reset_counts()
    make_fno_nll_log_likelihood(cfg, u0, y, 1.0, max_bytes)(flat)
    make_fno_grad_full(cfg, u0, y, 1.0, None, max_bytes)(flat[:1])
    f32 = read_counts()
    torch.cuda.empty_cache()
    print(f"  FNO field at C={c}, {b} functions ({chunks} chunks): bf16 call fno_project "
          f"{bf16['fno_project']} launches, fno.project.fused {bf16['fno_project_fused']}, "
          f"peak {peak / 1e9:.2f} GB above its inputs; the f32 density and field: "
          f"{f32['fno_project']} and {f32['fno_project_fused']}")
    check(bf16["chunks"] == chunks and bf16["fno_project"] == 2 * chunks
          and bf16["fno_project_fused"] == 2 * chunks, f"bf16 FNO field counts {bf16}")
    check(f32["fno_project"] == 0 and f32["fno_project_fused"] == 0,
          f"f32 FNO paths launched the fused projection: {f32}")
    return bf16


def stage3_kernels(dev, train, arts, reps):
    """Phase 5: merge_sums, fused_merge_nll and the leapfrog kernel on the
    card against their plain versions; returns the kernel rows' numbers."""
    cfg_d = DeepONetConfig()
    grid = load_port_inputs()
    n_data = int(grid["n_train"]) * int(grid["nx"]) * int(grid["nt"])
    cfg = stage3_config(len(arts["indices"]), n_data)
    bx, tx, y = train["branch_in"], train["trunk_in"], train["solution"]
    lp = make_deeponet_nll_log_posterior(cfg_d, bx, tx, y, cfg.tau_out)
    _, aux, spec, prior, inv_mass = build_subspace_posterior(
        cfg, None, y, arts, seed=0, full_ll=lp, device=dev)
    field = clipped_grad_fn(make_subspace_grad(
        make_gram_grad_full(cfg_d, bx, tx, y, cfg.tau_out), spec, prior=prior),
        cfg.clip_grad, inv_mass=inv_mass)
    c, d = cfg.num_chains, spec.subspace_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    q0 = spec.sub_mu().expand(c, -1).clone()          # the stage-3 inits: the VI mean
    p0 = torch.randn((c, d), generator=gen, device=dev) / torch.sqrt(inv_mass)
    g0 = field(q0, aux)
    q1, p1, g1 = leapfrog_grad_only(lambda q: field(q, aux), q0, p0, g0, cfg.step_size,
                                    cfg.L, inv_mass)

    def feats(q):
        params = unravel_deeponet(cfg_d, scatter_subspace(aux, q, spec.idx))
        with true_f32():
            bo, to = deeponet_features(cfg_d, params, bx, tx)
        return bo.contiguous(), to.contiguous(), params["b"].contiguous()

    err = 0.0
    for name, q in (("VI mean", q0), ("one trajectory", q1)):
        bo, to, b = feats(q)
        if name == "VI mean":
            compare_merge("ragged C=3 B=130 P=301 K=12", bo[:3, :130, :12].contiguous(),
                          to[:3, :301, :12].contiguous(), b[:3], y[:130, :301].contiguous())
            n_small = profiling.counter("merge_sums.launches_small")
            compare_merge("small C=3 B=100 P=301 K=12", bo[:3, :100, :12].contiguous(),
                          to[:3, :301, :12].contiguous(), b[:3], y[:100, :301].contiguous())
            compare_merge("small C=1 B=130 P=301 K=13", bo[:1, :130, :13].contiguous(),
                          to[:1, :301, :13].contiguous(), b[:1], y[:130, :301].contiguous())
            # each compare_merge runs merge_sums twice (the sums, then fused_merge_nll)
            n_small = profiling.counter("merge_sums.launches_small") - n_small
            check(n_small == 4, f"merge_sums took the small kernel {n_small} of 4 times")
        err = max(err, compare_merge(f"{name} C={c} B={bo.shape[1]} P={to.shape[1]} "
                                     f"K={bo.shape[2]}", bo, to, b, y, main=True))
    # the gradient against autograd of the plain f32 reference, at q1
    leaves = [t.clone().requires_grad_(True) for t in (bo, to, b)]
    g_k = torch.autograd.grad(fused_merge_nll(*leaves, y, cfg.tau_out).sum(), leaves)
    ref_leaves = [t.clone().requires_grad_(True) for t in (bo, to, b)]
    g_p = torch.autograd.grad(merge_nll_reference(*ref_leaves, y, cfg.tau_out).sum(),
                              ref_leaves)
    fk = torch.cat([g.flatten().double() for g in g_k])
    fp = torch.cat([g.flatten().double() for g in g_p])
    rel = ((fk - fp).norm() / fp.norm()).item()
    cos = torch.nn.functional.cosine_similarity(fk, fp, dim=0).item()
    bias_rel = ((g_k[2] - g_p[2]).abs() / g_p[2].abs().clamp(min=1e-30)).max().item()
    print(f"  fused_merge_nll gradient vs autograd of merge_nll_reference (f32): relative "
          f"error {rel:.3g}, cosine {cos:.9f}; bias gradient max rel {bias_rel:.3g}")
    check(rel <= GRAD_REL_TOL and cos >= GRAD_COS_MIN, f"gradient rel {rel}, cosine {cos}")
    del leaves, ref_leaves, g_k, g_p, fk, fp

    cb, b_, k = bo.shape
    p = to.shape[1]
    ms = time_device("merge_sums", lambda: merge_sums(bo, to, y), reps)
    plain_ms = time_device("merge_sums plain", lambda: merge_sums_reference(bo, to, y),
                           SPLIT_REPS, warmup=1)
    bound_ms, bound_by, tc_ms = merge_sums_bound_ms(cb, b_, p, k)
    print(f"  merge_sums at C={cb} B={b_} P={p} K={k}: kernel {ms:.3f} ms (mean of {reps} "
          f"queued launches); {bound_line(ms, bound_ms, tc_ms)}; plain {plain_ms:.3f} ms, "
          f"library_ms n/a (no single PyTorch call computes S1 and S2)")
    rows = {"merge_sums": dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, bound_tc_ms=tc_ms)}

    # the leapfrog update at the trajectory's shapes: (C, d) and a (d,) mass
    eps = cfg.step_size
    lf_err = 0.0
    for label, im in (("diagonal", inv_mass), ("scalar", 0.5)):
        qk, pk = fused_leapfrog_update(q1, p1, g1, eps, im)
        torch.cuda.synchronize()
        im_t = torch.as_tensor(im, dtype=torch.float32, device=dev)
        qr, pr = leapfrog_update_reference(q1, p1, g1, eps, im_t)
        for a, r, n in ((qk, qr, "q_new"), (pk, pr, "p_half")):
            diff = (a - r).abs()
            ulp = torch.finfo(torch.float32).eps * r.abs().clamp(
                min=torch.finfo(torch.float32).tiny)
            worst = (diff / ulp).max().item()
            lf_err = max(lf_err, diff.max().item())
            print(f"  leapfrog {label} mass {n}: max abs {diff.max().item():.3g}, "
                  f"{worst:.3g} ulp; bit-equal {bool(torch.equal(a, r))}")
            check(worst <= LEAPFROG_ULPS, f"leapfrog {label} {n}: {worst} ulp")
    # cycle over input copies larger than the L2 in all, so that each call
    # reads its inputs from device memory, as the bound counts them
    sets = itertools.cycle([(q1.clone(), p1.clone(), g1.clone()) for _ in range(L2_ROTATION)])
    lf_ms = time_device("leapfrog_update",
                        lambda: fused_leapfrog_update(*next(sets), eps, inv_mass), reps)
    lf_plain = time_device("leapfrog_update plain",
                           lambda: leapfrog_update_reference(*next(sets), eps, inv_mass), reps)
    lf_bound, lf_by = leapfrog_bound_ms(q1.numel(), d)
    print(f"  leapfrog_update at ({c}, {d}): kernel {lf_ms * 1e3:.2f} us, bound "
          f"{lf_bound * 1e3:.2f} us ({lf_by}), plain {lf_plain * 1e3:.2f} us, library_ms n/a "
          f"(no single PyTorch call computes both outputs)")
    # no products: its tensor-core bound is its byte bound
    rows["leapfrog_update"] = dict(max_abs_err=lf_err, ms=lf_ms, plain_ms=lf_plain,
                                   bound_ms=lf_bound, bound_by=lf_by, bound_tc_ms=lf_bound)
    return rows


def run_stage3_path(label, dev, data, arts, want_launches, **kw):
    """Drive ``run_stage3`` with every count at 0 before and read after;
    check the launches and the outputs. Returns ``(summary, out, counts)``."""
    reset_counts()
    summary, out = run_stage3(device=dev, data=data, artifacts=arts, **kw)
    counts = read_counts()
    print(f"  {label} launches: {counts}; merge_sums expected {want_launches}")
    check(counts["merge_sums"] == want_launches,
          f"{label}: merge_sums launched {counts['merge_sums']} times, expected {want_launches}")
    check(counts["paired_sums"] == 0 and counts["leapfrog_update"] == 0,
          f"{label}: unexpected launches {counts}")
    res, met = out["result"], out["metrics"]
    check(bool(np.isfinite(res.samples).all()), f"{label}: non-finite samples")
    acc = res.acceptance_rate
    check(math.isfinite(acc) and acc > 0.0, f"{label}: acceptance {acc}")
    for k_, v in met.items():
        check(bool(np.isfinite(v).all()), f"{label}: metric {k_} = {v}")
    check(math.isfinite(summary["mean_relative_l2"]), f"{label}: relative L2")
    print(f"  {label}: acceptance {acc:.4f}, draws/s {summary['draws_per_s']:.3f}, "
          f"samples {list(res.samples.shape)}, divergent {res.num_divergent}")
    print(f"  {label} summary: " + json.dumps(
        {k_: v for k_, v in summary.items() if k_ != "phases_s"}))
    print(f"  {label} phases (s): " + ", ".join(f"{k_} {v:.2f}"
                                                 for k_, v in summary["phases_s"].items()))
    return summary, out, counts


def stage3_split_line(label, out, summary, draws, n_lf, merge_ms):
    """Print where a stage-3 draw's time goes: the trajectory field (timed
    alone at C=16), the two densities, the rest of the sampling wall."""
    q, aux = out["result"].final_state.position, out["frozen"]
    dens_ms = time_device(f"{label} density", lambda: out["log_prob"](q, aux), SPLIT_REPS)
    draw_ms = 1e3 * summary["sampling_seconds"] / draws
    parts = {"fused_density_x2": 2 * dens_ms}
    field_ms = None
    if out["grad_fn"] is not None:
        field_ms = time_device(f"{label} field", lambda: out["grad_fn"](q, aux), SPLIT_REPS)
        parts = {f"field_x{n_lf}": n_lf * field_ms, **parts}
    parts["rest_of_draw"] = draw_ms - sum(parts.values())
    print(f"  per {label} draw at C=16 (device time, mean of {SPLIT_REPS} queued calls): "
          f"sampling wall {draw_ms:.2f} ms = "
          + ", ".join(f"{k_} {v:.2f} ms ({100 * v / draw_ms:.1f} %)" for k_, v in parts.items())
          + (f" (one field {field_ms:.3f} ms" if field_ms is not None else " (")
          + f"; one fused density {dens_ms:.3f} ms, of which merge_sums {merge_ms:.3f} ms)")
    return draw_ms


def stride_field_cosine(dev, train, out):
    """Cosine, on the subspace at the VI mean, between the 3/3 stride Gram
    field and the full-grid Gram field (both likelihood-only, f32)."""
    cfg_d = DeepONetConfig()
    bx, tx, y = train["branch_in"], train["trunk_in"], train["solution"]
    spec = out["spec"]
    full = scatter_subspace(out["frozen"], spec.sub_mu()[None], spec.idx)
    g_full = make_gram_grad_full(cfg_d, bx, tx, y, 1.0)(full)[0, spec.idx]
    sub = grid_stride_subset(*infer_grid_shape(tx), 3)
    fns = np.arange(0, bx.shape[0], 3)
    g_stride = make_gram_grad_full(cfg_d, bx, tx, y, 1.0, query_subset=sub,
                                   fn_subset=fns)(full)[0, spec.idx]
    cos = torch.nn.functional.cosine_similarity(g_stride.double(), g_full.double(),
                                                dim=0).item()
    ratio = (g_stride.norm() / g_full.norm()).item()
    print(f"  stride 3/3 field ({len(sub)} of {tx.shape[0]} query points, {len(fns)} of "
          f"{bx.shape[0]} functions) vs the full Gram field on the subspace at the VI mean: "
          f"cosine {cos:.6f}, norm ratio {ratio:.4f}")
    check(math.isfinite(cos) and cos > 0.5, f"stride field cosine {cos}")
    return cos


def baseline_checks(label, out, counts, want_merge, need_accept=True):
    """The launch counts and finite outputs of a full-parameter baseline
    (and some accepted proposal unless ``need_accept`` is off)."""
    print(f"  {label} launches: {counts}; merge_sums expected {want_merge}")
    check(counts["merge_sums"] == want_merge,
          f"{label}: merge_sums launched {counts['merge_sums']} times, expected {want_merge}")
    check(counts["paired_sums"] == 0 and counts["leapfrog_update"] == 0,
          f"{label}: unexpected launches {counts}")
    res, met = out["result"], out["metrics"]
    check(bool(np.isfinite(res.samples).all()) and bool(np.isfinite(res.log_probs).all()),
          f"{label}: non-finite samples or log-densities")
    check(res.acceptance_rate > 0.0 or not need_accept,
          f"{label}: acceptance {res.acceptance_rate}")
    for k_, v in met.items():
        check(bool(np.isfinite(v).all()), f"{label}: metric {k_} = {v}")
    ph = out["phases_s"]
    print(f"  {label}: acceptance {res.acceptance_rate:.4f}, samples {list(res.samples.shape)}, "
          f"expected MSE of the mean {float(met['expected_mse_of_mean']):.5g}, final steps "
          f"{[float('%.4g' % s) for s in res.step_sizes[:, -1]]}; "
          f"{res.samples.shape[1] / ph['sampling_s']:.3f} draws/s; phases (s): "
          + ", ".join(f"{k_} {v:.2f}" for k_, v in ph.items()))


def split_trajectory_check(out, cfg, n_fn=20):
    """One split-leapfrog trajectory on the pipeline's own shard density and
    shards (the config's step and L, at full width, the shards cut to
    ``n_fn`` functions in all): on the card with the density ``hmc_split.run``
    sampled with, against the same pipeline code on the CPU; positions and
    momenta within 1e-4 of their scale."""
    from vihmc_torch.hmc.integrators import split_leapfrog
    from vihmc_torch.hmc.kernel import value_and_grad

    card = out["shard_data"][0].device
    cut = tuple(x[:, :n_fn // cfg.num_splits] for x in out["shard_data"])
    sides = {"card": (out["shard_log_prob"], cut, card),
             "cpu": (hmc_split.make_shard_log_prob(cfg, out["data"][0]["trunk_in"].cpu()),
                     tuple(x.cpu() for x in cut), torch.device("cpu"))}
    gen = torch.Generator().manual_seed(11)
    q0 = 0.1 * torch.randn((1, cfg.model.num_params), generator=gen)
    p0 = torch.randn((1, cfg.model.num_params), generator=gen)
    ends = {}
    for side, (shard_lp, shards, d) in sides.items():
        with true_f32():
            q1, p1 = split_leapfrog(
                lambda q, sh: value_and_grad(lambda x, a: shard_lp(x, sh, a), q, None),
                shards, q0.to(d), p0.to(d), cfg.step_size, cfg.L)
        ends[side] = (q1.cpu(), p1.cpu())
    errs = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(ends["card"], ends["cpu"])]
    print(f"  split leapfrog on the pipeline's shard density ({n_fn} functions, "
          f"{cfg.num_splits} shards, L {cfg.L}, step {cfg.step_size}): card vs CPU max |dq| "
          f"{errs[0]:.3g}, |dp| {errs[1]:.3g} of their scale")
    check(max(errs) < 1e-4, f"split leapfrog card vs CPU {errs}")


def jaccard(a, b) -> float:
    a, b = set(np.asarray(a).tolist()), set(np.asarray(b).tolist())
    return len(a & b) / len(a | b)


def spearman(x, y) -> float:
    """Spearman's rank correlation (ordinal ranks; ties are negligible here)."""
    rx = np.empty(len(x))
    ry = np.empty(len(y))
    rx[np.argsort(x, kind="stable")] = np.arange(len(x))
    ry[np.argsort(y, kind="stable")] = np.arange(len(y))
    return float(np.corrcoef(rx, ry)[0, 1])


def expect_tiled_only(label: str, counts: dict):
    """The paths at C >= 16 (stage 3, the row, the 90 % row) never take the
    small kernels."""
    check(counts["merge_sums_small"] == 0 and counts["paired_sums_small"] == 0,
          f"{label}: small-kernel launches {counts}")


def expect_no_launches(label: str):
    counts = read_counts()
    print(f"  {label} launches: {counts} (no kernel of the port is on this path)")
    check(all(v == 0 for v in counts.values()), f"{label}: unexpected launches {counts}")


def stage1_phase(dev, data, epochs, bundle):
    """Phase 8: stage-1 VI at full width for ``epochs`` epochs."""
    cfg = vi_train.stage12_config(epochs=epochs, n_train=data[0]["branch_in"].shape[0],
                                  n_valid=data[1]["branch_in"].shape[0])
    walls = []
    t_last = [time.perf_counter()]

    def on_epoch(epoch, row, trainer):
        torch.cuda.synchronize()
        now = time.perf_counter()
        walls.append(now - t_last[0])
        t_last[0] = now

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_last[0] = time.perf_counter()
    out = vi_train.run_operator(cfg, seed=0, data=data, device=dev, callback=on_epoch)
    expect_no_launches("stage 1")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    m = out["metrics"]
    ref = np.asarray(bundle["vi_valid_mse"][:epochs], np.float64)
    print(f"  stage 1 (VI) at full width: {epochs} epochs of {cfg.n_train // cfg.batch_size} "
          f"steps (batch {cfg.batch_size}, p {cfg.p}, num_ens {cfg.vi.num_ens}); wall per "
          f"epoch (s): {[round(w, 3) for w in walls]}; peak memory {peak:.2f} GiB")
    for e in range(len(m)):
        print(f"  epoch {e}: train_loss {m[e, 0]:.6g} valid_loss {m[e, 1]:.6g} train_mse "
              f"{m[e, 2]:.5f} valid_mse {m[e, 3]:.5f} (bundle valid_mse {ref[e]:.5f})")
    check(bool(np.isfinite(m).all()), "stage 1: non-finite metrics")
    check(m[-1, 3] < m[0, 3], f"stage 1: valid MSE did not fall ({m[0, 3]} -> {m[-1, 3]})")
    # the device time of one step, at a batch of the training shape
    trainer = out["trainer"]
    train = data[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    idx = torch.randperm(train["branch_in"].shape[0], generator=gen, device=dev)[:cfg.batch_size]
    trunk, y = subsample_trunk({"trunk_in": train["trunk_in"], "solution": train["solution"][idx]},
                               cfg.p, generator=gen)
    batch = {"branch": train["branch_in"][idx], "trunk": trunk, "y": y}
    valid_batch = {"branch": data[1]["branch_in"][:cfg.batch_size],
                   "trunk": data[1]["trunk_in"], "y": data[1]["solution"][:cfg.batch_size]}
    with true_f32():
        step_ms = profile_line(f"stage-1 step (ensemble forward + backward + Adam, "
                               f"{cfg.vi.num_ens} x {cfg.batch_size} x {cfg.p} trunk points)",
                               lambda: trainer.step(batch), 5)
        eval_ms = profile_line("stage-1 validation evaluation (stochastic ELBO + MSE at "
                               f"{cfg.batch_size} x 10,201 points)",
                               lambda: trainer.evaluate(valid_batch), 5)
    n_steps = cfg.n_train // cfg.batch_size
    print(f"  an epoch is {n_steps} steps + 1 evaluation + 1 train MSE: median wall "
          f"{float(np.median(walls)):.3f} s")
    return {"epochs": epochs, "walls": walls, "step_ms": step_ms, "peak_gib": peak,
            "valid_mse": m[:, 3].tolist()}


def stage2_phase(dev, valid, bundle):
    """Phase 9: stage-2 sensitivity at full width on the bundle's mu/sigma."""
    cfg_d = DeepONetConfig()
    scfg = SensitivityRunConfig(importance_threshold=0.90, p_subsample=100, batch_chunk=8)
    n_chunks = -(-valid["branch_in"].shape[0] // scfg.batch_chunk)
    outs, walls = [], []
    for seed in (0, 1):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs.append(sensitivity.run_operator_flat(bundle["mu"], bundle["sigma"], cfg_d, valid,
                                                  scfg, seed=seed))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        expect_no_launches(f"stage 2 (seed {seed})")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # one chunk's device time: 8 examples' Jacobians (8 x 100 x 172,401 f32)
    apply_flat = make_flat_deeponet(cfg_d)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    trunk, _ = subsample_trunk(valid, scfg.p_subsample, generator=gen)
    chunk = {"branch": valid["branch_in"][:scfg.batch_chunk], "trunk": trunk[:scfg.batch_chunk]}
    mu = torch.as_tensor(bundle["mu"], device=dev)
    chunk_ms = time_device("stage-2 chunk", lambda: mean_squared_jacobian(
        lambda f, x: apply_flat(f[None], x["branch"][None, :], x["trunk"][None])[0, 0], mu,
        chunk), 2, warmup=1)
    j_bundle = jaccard(outs[0]["indices"], bundle["indices"])
    j_seeds = jaccard(outs[0]["indices"], outs[1]["indices"])
    j_bundle1 = jaccard(outs[1]["indices"], bundle["indices"])
    rho = spearman(outs[0]["scores"], bundle["scores"])
    rho_seeds = spearman(outs[0]["scores"], outs[1]["scores"])
    print(f"  stage 2 at full width: walls {[round(w, 2) for w in walls]} s for "
          f"{n_chunks} chunks of {scfg.batch_chunk} ({walls[0] / n_chunks * 1e3:.1f} ms per "
          f"chunk of wall); one chunk {chunk_ms:.1f} ms device time; peak memory {peak:.2f} GiB")
    print(f"  num_sensitive: seed 0 {outs[0]['num_sensitive']}, seed 1 "
          f"{outs[1]['num_sensitive']} (bundle {len(bundle['indices'])})")
    print(f"  Jaccard overlap: seed 0 vs bundle {j_bundle:.4f}, seed 1 vs bundle "
          f"{j_bundle1:.4f}, seed 0 vs seed 1 {j_seeds:.4f} (margin {SENS_OVERLAP_MARGIN})")
    print(f"  Spearman correlation of the scores: seed 0 vs bundle {rho:.5f}, seed 0 vs "
          f"seed 1 {rho_seeds:.5f}")
    for o in outs:
        check(bool(np.isfinite(o["scores"]).all()) and o["scores"].shape == bundle["scores"].shape,
              "stage 2: scores not finite or of the wrong shape")
    check(j_bundle >= j_seeds - SENS_OVERLAP_MARGIN,
          f"stage 2: overlap with the bundle {j_bundle} < seed-to-seed {j_seeds} - "
          f"{SENS_OVERLAP_MARGIN}")
    return {"walls": walls, "chunk_ms": chunk_ms, "num_sensitive": outs[0]["num_sensitive"],
            "jaccard_bundle": j_bundle, "jaccard_seeds": j_seeds, "spearman": rho}


def count_gram_calls():
    """Wrap the stage-3 pipeline's Gram field builder so its calls are counted."""
    real = vi_hmc.make_gram_grad_full
    calls = [0]

    def counting(*a, **kw):
        field = real(*a, **kw)

        def wrapped(full):
            calls[0] += 1
            return field(full)

        return wrapped

    vi_hmc.make_gram_grad_full = counting
    return calls, lambda: setattr(vi_hmc, "make_gram_grad_full", real)


def nn_flow_phase(dev, epochs, nn_bundle):
    """Phase 11: VI -> sensitivity -> VI-HMC on the regression MLP."""
    mlp = MLPConfig()
    cfg = NNVIRunConfig(vi=VIConfig(
        epochs=epochs, lr_start=1e-2, patience=5000, num_ens=10, beta_type=1.0,
        prior_mu=0.0, prior_sigma=1.0,
        elbo=ELBOConfig(reduction="sum", fixed_noise_var=5e-2 ** 2)))
    reset_counts()
    t0 = time.perf_counter()
    vi_out = vi_train.run_nn(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    vi_s = time.perf_counter() - t0
    expect_no_launches("NN stage 1")
    m = vi_out["metrics"]
    ref = nn_bundle["vi_valid_mse"]
    print(f"  NN stage 1: {epochs} epochs in {vi_s:.2f} s ({vi_s / epochs * 1e3:.2f} ms per "
          f"epoch); valid_mse {m[0, 3]:.4f} -> {m[-1, 3]:.4f} (best {m[:, 3].min():.4f}); "
          f"bundle at the same epochs {ref[0]:.4f} -> {ref[epochs - 1]:.4f}, after its "
          f"{len(ref)} epochs {ref[-1]:.4f}")
    check(bool(np.isfinite(m).all()) and m[-1, 3] < m[0, 3], "NN stage 1: valid MSE did not fall")
    trainer, d = vi_out["trainer"], vi_out["data"]
    tb, vb = {"x": d["x_train"], "y": d["y_train"]}, {"x": d["x_val"], "y": d["y_val"]}
    with true_f32():
        profile_line("NN VI epoch (step + evaluation + train MSE)",
                     lambda: (trainer.step(tb), trainer.evaluate(vb), trainer.mse(tb)), 20)
    reset_counts()
    x_val = vi_out["data"]["x_val"]
    sens = sensitivity.run_nn(vi_out["best_state"].vp, mlp, x_val)
    ref_sens = sensitivity.run_nn_flat(nn_bundle["mu"], nn_bundle["sigma"], mlp,
                                       torch.linspace(-1.2, 1.2, 300, device=dev)[:, None])
    expect_no_launches("NN stage 2")
    same = np.array_equal(ref_sens["indices"], nn_bundle["indices"])
    print(f"  NN stage 2: {sens['num_sensitive']} of {mlp.num_params} sensitive on the port's "
          f"own posterior; on the bundle's mu and sigma {ref_sens['num_sensitive']} indices, "
          f"equal to the bundle's {len(nn_bundle['indices'])}: {same}; score max rel diff "
          f"{np.abs(ref_sens['scores'] - nn_bundle['scores']).max() / nn_bundle['scores'].max():.3g}")
    check(same, "NN stage 2: the bundle's mu/sigma do not give its indices")
    reset_counts()
    hcfg = VIHMCRunConfig()
    t0 = time.perf_counter()
    out = vi_hmc.run_nn(hcfg, mlp, {k: sens[k] for k in ("mu", "sigma", "indices")},
                        data=vi_out["data"], device=dev)
    torch.cuda.synchronize()
    h_s = time.perf_counter() - t0
    expect_no_launches("NN stage 3")
    res, met = out["result"], out["metrics"]
    print(f"  NN stage 3 (default VIHMCRunConfig: {hcfg.frozen_policy}, L {hcfg.L}, "
          f"{hcfg.num_chains} chains, {hcfg.num_samples} draws): {h_s:.2f} s, acceptance "
          f"{res.acceptance_rate:.4f}, expected MSE of the mean {float(met['expected_mse_of_mean']):.4f}, "
          f"ESS median {float(np.median(out['ess'])):.2f}, frozen vectors "
          f"{tuple(res.final_state.aux.shape)}")
    check(bool(np.isfinite(res.samples).all()) and res.acceptance_rate > 0.0,
          "NN stage 3: non-finite samples or no acceptance")
    check(all(bool(np.isfinite(v).all()) for v in met.values()), "NN stage 3: metrics")
    return {"vi_s": vi_s, "stage3_s": h_s, "acceptance": res.acceptance_rate}


def nn_row_phase(dev):
    """Phase 18: the NN bench row at full width, depth cut."""
    kw = dict(chains=1024, L=96, draws=NN_DRAWS, thin=24, segment=NN_SEGMENT,
              keys=(2,))
    print(f"  depth cut: one key (row: 5 keys after the warm run), draws {kw['draws']}, "
          f"burn {kw['draws'] // 5}, segments of {kw['segment']} (row: 2880, 576, 480); "
          f"chains {kw['chains']}, L {kw['L']}, thin {kw['thin']}; CPU baseline capped at "
          f"{NN_BASELINE_SECONDS:g} s (row: 120 s)")
    reset_counts()
    t0 = time.perf_counter()
    st = bench_nn.bench_nn(device=dev, baseline_seconds=NN_BASELINE_SECONDS, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect_no_launches("NN row")
    print("  NN row: " + json.dumps({k_: st[k_] for k_ in (
        "draws_per_s", "ess_per_s", "ess_median", "ess_min", "rhat_max",
        "ess_weight_median_by_key", "ess_weight_at_chain_floor", "rhat_weight_max",
        "acceptance", "adapted_step", "warm_start_s", "phases_s")}))
    print(f"  NN row: {st['draws_per_s']:.3f} draws/s of {kw['chains']} chains "
          f"({1e3 / st['draws_per_s']:.2f} ms per draw, {1e3 / st['draws_per_s'] / kw['L']:.3f}"
          f" ms per leapfrog step), fs-ESS/s {st['ess_per_s']:.3f}, acceptance "
          f"{st['acceptance']:.4f}; phase wall {wall:.2f} s")
    check(math.isfinite(st["acceptance"]) and st["acceptance"] > 0.0,
          f"NN row: acceptance {st['acceptance']}")
    check(math.isfinite(st["ess_per_s"]) and st["ess_per_s"] > 0.0, "NN row: fs-ESS/s")
    check_mfu("NN row", st)
    print("  NN row CPU baseline (one chain, the same posterior and L, torch on the CPU): "
          + json.dumps({k_: st.get(k_) for k_ in (
              "torch_cpu_samples_per_s", "vs_baseline", "torch_cpu_ess_per_s",
              "vs_baseline_ess_like_for_like")}))
    check(st.get("vs_baseline") is not None and st["vs_baseline"] > 0.0,
          "NN row: no vs_baseline")
    # one transition of the row at 1024 chains: device time against wall
    log_prob, aux0, refresh, spec, *_ = bench_nn.build_nn_problem(dev)
    d = spec.subspace_dim
    inv_mass = spec.sub_sigma() ** 2
    field = clipped_grad_fn(log_prob, bench_nn.CLIP_SCALE * d ** 0.5, inv_mass=inv_mass,
                            is_grad=False)
    cfg = bench_nn.nn_config(kw["draws"], kw["L"], 0.1, False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    q0 = spec.sub_mu() + 0.01 * spec.sub_sigma() * torch.randn(
        (kw["chains"], d), generator=gen, device=dev)
    state = init_state(log_prob, q0, cfg, aux0, field, inv_mass=inv_mass)
    kernel = make_kernel(cfg, inv_mass, field, None, log_prob)
    noise = draw_noise(gen, inv_mass, kw["chains"], d, dev)
    dev_ms = profile_line(f"NN row transition at {kw['chains']} chains (L {kw['L']})",
                          lambda: kernel(state, noise), 5)
    # the wall of a transition without the profiler's per-op cost
    torch.cuda.synchronize()
    tw = time.perf_counter()
    for _ in range(3):
        kernel(state, noise)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - tw) / 3
    host_ms = wall_ms - (0.0 if math.isnan(dev_ms) else dev_ms)
    print(f"  NN row per draw (one transition, no profiler): wall {wall_ms:.2f} ms, device "
          + ("not measured" if math.isnan(dev_ms) else f"{dev_ms:.2f} ms")
          + f"; wall not covered by device work {host_ms:.2f} ms "
          f"({wall_ms / kw['L']:.3f} ms of wall per leapfrog step)")
    host = host_reading(lambda: kernel(state, noise))
    print(f"  NN row host: {host['cpu']}, {host['cores']} usable cores; "
          f"{host['us_per_op']:.2f} us of wall per dispatched one-element op; one transition "
          f"issues {host['device_ops_per_call']:.0f} device ops -> "
          f"{host['us_per_op'] * host['device_ops_per_call'] / 1e3:.2f} ms of dispatch at that "
          f"rate, against {host_ms:.2f} ms of wall not covered by device work")
    return st


def host_reading(fn, reps: int = 3) -> dict:
    """The host side of ``fn``: the CPU's model and usable cores, the wall
    per dispatched operation (``DISPATCH_OPS`` one-element adds on the card,
    issued back to back; their device work is a few microseconds each), and
    the device operations (kernels and copies) one call of ``fn`` issues,
    counted by ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cpu = "unknown"
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            cpu = next((ln.split(":", 1)[1].strip() for ln in f
                        if ln.startswith("model name")), cpu)
    x = torch.zeros(1, device="cuda")
    for _ in range(50):
        x.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DISPATCH_OPS):
        x.add_(1.0)
    torch.cuda.synchronize()
    op_us = 1e6 * (time.perf_counter() - t0) / DISPATCH_OPS
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    n_ops = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0) / reps
    return {"cpu": cpu, "cores": len(os.sched_getaffinity(0)), "us_per_op": op_us,
            "device_ops_per_call": n_ops}


def nuts_chees_phase(label, dev, data, arts, want, **kw):
    """Phases 19-20: stage 3 under NUTS or ChEES, launches held to ``want``."""
    summary, out, counts = run_stage3_path(label, dev, data, arts, want, **kw)
    res = out["result"]
    check(out["algorithm"] == kw["algorithm"], f"{label}: algorithm {out['algorithm']}")
    draw_ms = 1e3 * summary["sampling_seconds"] / kw["draws"]
    if kw["algorithm"] == "nuts":
        leaves = res.aux_trace["tree_leaves"]
        n_leaf = 2 ** kw["nuts_max_depth"] - 1
        check(bool((leaves >= 1).all() and (leaves <= n_leaf).all()),
              f"{label}: tree leaves {leaves}")
        print(f"  {label}: {draw_ms:.2f} ms per draw, {draw_ms / n_leaf:.2f} ms per leaf "
              f"({n_leaf} leaves evaluated per draw, each one fused density and one field); "
              f"leaves merged before the trees stopped: mean {leaves.mean():.2f}")
    else:
        n_steps = res.aux_trace["n_steps"]
        check(bool((n_steps >= 1).all() and (n_steps <= kw["chees_max_steps"]).all()),
              f"{label}: step counts {n_steps}")
        print(f"  {label}: {draw_ms:.2f} ms per draw; leapfrog steps per draw "
              f"{n_steps.tolist()}, trajectory length {res.aux_trace['traj_length'].tolist()}"
              f", {draw_ms / max(float(n_steps.mean()), 1.0):.2f} ms per step")
    del out
    torch.cuda.empty_cache()
    return summary, counts


def adaptive_metric_phase(dev):
    """Phase 21: the windowed adaptive metric and momentum persistence."""
    from vihmc_torch.pipelines.configs import VIHMCRunConfig as Cfg

    with np.load(bench_nn.NN_STAGE12_ASSET) as z:
        arts_nn = {k_: z[k_] for k_ in ("mu", "sigma", "indices")}
    with np.load(bench_nn.NN_PORT_INPUTS) as z:
        x, y = z["x_train"], z["y_train"]
    # the validation grid and its noise-free targets (the training noise is unused)
    grid = regression_data(20, 300, noise=torch.zeros(20, 1), device="cpu")
    data_nn = {"x_train": x, "y_train": y, "x_val": grid["x_val"].numpy(),
               "y_val": grid["y_val"].numpy()}
    cfg = Cfg(num_samples=ADAPT_DRAWS, burn=ADAPT_BURN, num_chains=64,
              num_leapfrog=20, frozen_policy="draw", vi_mass=True, adapt_step_size=True,
              adapt_mass=True, mass_schedule="windowed", init_optimize=400)
    start, ends = mass_window_schedule(cfg.burn_)
    print(f"  NN stage 3, windowed adaptive metric: {cfg.num_samples} draws, burn {cfg.burn_}"
          f" (windows from {start}, ends {list(ends)}), {cfg.num_chains} chains, L {cfg.L}")
    t_seen = []
    reset_counts()
    out = vi_hmc.run_nn(cfg, MLPConfig(), arts_nn, data=data_nn, seed=0, device=dev,
                        segment_size=1,
                        progress=lambda i, n, st: t_seen.append(float(st.da.t[0])))
    expect_no_launches("NN stage 3, adaptive metric")
    res = out["result"]
    im = res.final_state.inv_mass
    restarts = [i for i, t_ in enumerate(t_seen) if t_ == 0.0]
    print(f"  adapted inverse mass {tuple(im.shape)}: min {float(im.min()):.4g}, max "
          f"{float(im.max()):.4g}, against the VI variances' median "
          f"{float(out['spec'].sub_sigma().median() ** 2):.4g}; dual averaging restarted "
          f"after draws {restarts} (window ends {[e - 1 for e in ends]}); acceptance "
          f"{res.acceptance_rate:.4f}")
    check(bool(torch.isfinite(im).all()) and bool((im > 0).all()), "adapted inverse mass")
    check(restarts == [e - 1 for e in ends], f"restarts {restarts} at window ends {ends}")
    check(bool(np.isfinite(res.samples).all()) and res.acceptance_rate > 0.0,
          "adaptive metric: samples or acceptance")
    # momentum persistence: the row's entry point, then the carried momentum
    # across a segment boundary
    pk = dict(chains=1024, L=96, draws=PERSIST_DRAWS, thin=1, segment=PERSIST_DRAWS, keys=(3,), persist=0.5)
    print(f"  NN row with --persist 0.5: draws {pk['draws']} (row 2880), one key")
    reset_counts()
    st = bench_nn.bench_nn(device=dev, skip_baseline=True, **pk)
    expect_no_launches("NN row, persist 0.5")
    print(f"  NN row, persist 0.5: acceptance {st['acceptance']:.4f}, {st['draws_per_s']:.3f}"
          f" draws/s, fs-ESS/s {st['ess_per_s']:.3f}")
    check(math.isfinite(st["acceptance"]) and st["acceptance"] > 0.0, "persist: acceptance")
    log_prob, aux0, _, spec, *_ = bench_nn.build_nn_problem(dev)
    inv_mass = spec.sub_sigma() ** 2
    field = clipped_grad_fn(log_prob, bench_nn.CLIP_SCALE * spec.subspace_dim ** 0.5,
                            inv_mass=inv_mass, is_grad=False)
    pcfg = bench_nn.nn_config(12, 96, 0.1, False, persist=0.5)
    r = sample_chains_resumable(log_prob, spec.sub_mu().expand(1024, -1).clone(), pcfg, 6,
                                inv_mass, aux0, grad_fn=field, seed=4)
    mom = r.final_state.momentum
    print(f"  persistent momentum after 2 segments of 6: {tuple(mom.shape)}, rms "
          f"{float(mom.pow(2).mean().sqrt()):.4g}, acceptance {r.acceptance_rate:.4f}")
    check(bool(torch.isfinite(mom).all()) and float(mom.abs().max()) > 0.0,
          "persistent momentum")


def timed_cli(label: str, argv, walls: dict):
    """``cli.run(argv + --device cuda)``: exit code 0 required; its wall."""
    t0 = time.perf_counter()
    rc, out = cli.run(list(argv) + ["--device", "cuda"] if argv[0] != "postprocess"
                      else list(argv))
    torch.cuda.synchronize()
    walls[label] = time.perf_counter() - t0
    check(rc == 0, f"{label}: exit code {rc}")
    return out


def cli_phase(dev, tmp):
    """Phase 22: the command line on the card, in process."""
    walls = {}
    out = os.path.join(tmp, "runs")
    common = ["--out", out]
    print(f"  depth cut: vi-nn epochs {CLI_EPOCHS} (config 10,000), vi-hmc draws {CLI_DRAWS} "
          f"(config 100), vi-operator epochs 2 (config 1000)")
    reset_counts()
    timed_cli("vi-nn", ["vi-nn", "--epochs", str(CLI_EPOCHS), "--with-sensitivity", "--mode",
                        "lrt", "--uid", "vi"] + common, walls)
    hmc = timed_cli("vi-hmc", ["vi-hmc", "--artifacts", os.path.join(out, "vi"), "--workload",
                               "nn", "--policy", "refresh", "--save-vi-trace", "--num-samples",
                               str(CLI_DRAWS), "--uid", "hmc"] + common, walls)
    res = hmc["result"]
    trace = np.load(os.path.join(out, "hmc", "vi_params.npy"))
    n_chains = res.samples.shape[0]
    check(trace.shape == (n_chains, CLI_DRAWS, 141),
          f"vi_params {trace.shape}: one 141-parameter vector per chain and draw expected")
    samples = torch.as_tensor(res.samples, device=dev)
    worst = 0.0
    for s_ in range(CLI_DRAWS):
        lp = hmc["log_prob"](samples[:, s_], torch.as_tensor(trace[:, s_], device=dev))
        worst = max(worst, float(np.max(np.abs(lp.cpu().numpy() - res.log_probs[:, s_])
                                        / np.abs(res.log_probs[:, s_]))))
    print(f"  vi_params {trace.shape}: each stored sample's log-density under its draw's "
          f"stored frozen vector against the sampler's record, max rel diff {worst:.3g}")
    check(worst <= 1e-5, "vi_params: the stored frozen vectors are not the ones the draws used")
    re = timed_cli("reevaluate", ["reevaluate", "--run", os.path.join(out, "hmc"),
                                  "--artifacts", os.path.join(out, "vi"), "--uid", "re"]
                   + common, walls)
    diffs = {k: float(np.max(np.abs(np.asarray(v) - np.asarray(hmc["metrics"][k]))
                             / np.maximum(np.abs(np.asarray(hmc["metrics"][k])), 1e-30)))
             for k, v in re["metrics"].items()}
    print(f"  reevaluate against the vi-hmc run's metrics, max rel diff per metric: "
          + json.dumps(diffs))
    check(max(diffs.values()) <= 1e-6, "reevaluate: metrics differ from the vi-hmc run's")
    timed_cli("predict", ["predict", "--run", os.path.join(out, "hmc"), "--artifacts",
                          os.path.join(out, "vi"), "--keep", "16", "--uid", "pred"] + common,
              walls)
    preds = np.load(os.path.join(out, "pred", "predictions.npy"))
    check(preds.shape[0] == 16 and bool(np.isfinite(preds).all()), f"predict: {preds.shape}")
    timed_cli("vi-hmc (mean, 4 draws)", ["vi-hmc", "--artifacts", os.path.join(out, "vi"),
                                         "--policy", "mean", "--num-samples", "4",
                                         "--num-chains", "2", "--uid", "hmc2"] + common, walls)
    stacked = os.path.join(tmp, "stacked.npy")
    timed_cli("postprocess", ["postprocess", "--runs", os.path.join(out, "hmc"),
                              os.path.join(out, "hmc2"), "--out", stacked], walls)
    want_rows = n_chains * CLI_DRAWS + 2 * 4   # --burn 0
    check(np.load(stacked).shape == (want_rows, res.samples.shape[-1]), "postprocess rows")
    expect_no_launches("command line, NN")

    import scipy.io

    t0 = time.perf_counter()
    train, valid = get_burgers(dev)
    full = {k: torch.cat([train[k], valid[k]]) if k != "trunk_in" else train[k]
            for k in ("branch_in", "trunk_in", "solution")}
    mat = os.path.join(tmp, "DeepOnet_data.mat")
    scipy.io.savemat(mat, {k: v.cpu().numpy() for k, v in full.items()})
    loaded = load_burgers_mat(mat, dev)
    same = all(torch.equal(loaded[k], full[k]) for k in full)
    print(f"  .mat of the exported Burgers data ({os.path.getsize(mat) / 1e6:.1f} MB, "
          f"{time.perf_counter() - t0:.2f} s): loads to get_burgers's arrays: {same}")
    check(same, ".mat round trip")
    reset_counts()
    op = timed_cli("vi-operator", ["vi-operator", "--mat", mat, "--epochs", "2",
                                   "--uid", "op"] + common, walls)
    expect_no_launches("command line, vi-operator")
    check(op["model"].num_params == DeepONetConfig().num_params == 172_401,
          "vi-operator: the reference DeepONet")
    check(bool(np.isfinite(op["metrics"]).all()), "vi-operator: metrics")
    print("  command walls (s): " + json.dumps({k: round(v, 3) for k, v in walls.items()}))


def resume_phase(dev, data, arts, tmp):
    """Phase 23: resume at full width, bit for bit."""
    grid = load_port_inputs()
    n_data = int(grid["n_train"]) * int(grid["nx"]) * int(grid["nt"])
    cfg = stage3_config(len(arts["indices"]), n_data, variant="stride", draws=RESUME_DRAWS,
                        chains=16, L=31)
    print(f"  depth cut: draws {RESUME_DRAWS}, segments of {RESUME_SEGMENT} (stage-3 config "
          f"450, 90)")
    saves = []
    real_save = chains_resume.save_checkpoint

    def timed_save(directory, step, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = real_save(directory, step, state)
        saves.append((time.perf_counter() - t0, os.path.getsize(path) + os.path.getsize(
            os.path.join(directory, f"samples_seg{step - 1:05d}.npy"))))
        return path

    class Stop(Exception):
        pass

    def stop(seg, n_seg, state):
        raise Stop

    def leg(label, draws_here, **kw):
        reset_counts()
        t0 = time.perf_counter()
        out = None
        try:
            out = vi_hmc.run_operator(cfg, DeepONetConfig(), arts, data=data, use_fused=True,
                                      segment_size=RESUME_SEGMENT, evaluate=False, device=dev,
                                      **kw)
        except Stop:
            pass
        torch.cuda.synchronize()
        check((out is None) == (kw.get("progress") is stop), f"{label}: stopped or not")
        counts = read_counts()
        want = 1 + 2 * draws_here
        print(f"  {label}: {time.perf_counter() - t0:.2f} s, launches {counts}; merge_sums "
              f"expected 1 + 2 x {draws_here} = {want}")
        check(counts["merge_sums"] == want, f"{label}: merge_sums {counts['merge_sums']}")
        check(counts["paired_sums"] == 0 and counts["leapfrog_update"] == 0, f"{label}")
        return out

    full = leg("uninterrupted", RESUME_DRAWS)
    ck = os.path.join(tmp, "stage3_ck")
    chains_resume.save_checkpoint = timed_save
    try:
        leg("stopped after segment 1", RESUME_SEGMENT, checkpoint_dir=ck, progress=stop)
        check(chains_resume.latest_step(ck) == 1, "checkpoint after segment 1")
        resumed = leg("resumed", RESUME_DRAWS - RESUME_SEGMENT, checkpoint_dir=ck)
    finally:
        chains_resume.save_checkpoint = real_save
    a, b = resumed["result"].samples, full["result"].samples
    equal = a.shape == b.shape and np.array_equal(a, b)
    print(f"  resumed samples {a.shape} equal the uninterrupted run's bit for bit: {equal} "
          f"(max |diff| {float(np.max(np.abs(a - b))) if a.shape == b.shape else 'n/a'})")
    check(equal, "resume: samples differ from the uninterrupted run")
    print(f"  checkpoint per segment: {saves[0][1] / 1e6:.2f} MB (state + the segment's "
          f"samples), save " + ", ".join(f"{1e3 * t_:.1f} ms" for t_, _ in saves))
    draw_s = full["phases_s"]["sampling_s"] / RESUME_DRAWS
    del full, resumed
    torch.cuda.empty_cache()
    return draw_s


def subsample_phase(dev, data, arts, tmp, stride_draw_s):
    """Phase 24: query subsampling under REFRESH with the VI trace."""
    grid = load_port_inputs()
    n_data = int(grid["n_train"]) * int(grid["nx"]) * int(grid["nt"])
    cfg = dataclasses.replace(
        stage3_config(len(arts["indices"]), n_data, variant="autodiff", draws=SUB_DRAWS,
                      chains=16, L=31, frozen_policy="refresh"),
        sample_data=True, p=SUB_P, save_vi_trace=True)
    n_points = data[0]["trunk_in"].shape[0]
    print(f"  depth cut: draws {SUB_DRAWS} (stage-3 config 450); p {SUB_P} of {n_points}")
    store = RunStore(tmp, uid="subsample")
    reset_counts()
    t0 = time.perf_counter()
    out = vi_hmc.run_operator(cfg, DeepONetConfig(), arts, data=data, use_fused=True,
                              store=store, evaluate=False, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect_no_launches("stage 3 sample_data")
    res = out["result"]
    trace = res.aux_trace
    check(isinstance(trace, dict) and sorted(trace) == ["frozen", "tidx"],
          f"aux_trace keys {sorted(trace) if isinstance(trace, dict) else type(trace)}")
    tidx = trace["tidx"]
    check(tidx.shape == (16, SUB_DRAWS, SUB_P), f"tidx {tidx.shape}")
    distinct = all(len(np.unique(row)) == SUB_P for row in tidx.reshape(-1, SUB_P))
    changes = all(not np.array_equal(tidx[c, s_], tidx[c, s_ + 1])
                  for c in range(16) for s_ in range(SUB_DRAWS - 1))
    stored = np.load(os.path.join(store.path, "vi_params.npy"))
    print(f"  trace frozen {trace['frozen'].shape}, tidx {tidx.shape}: {SUB_P} distinct "
          f"points in every set {distinct}, every draw a new set {changes}; stored vi_params "
          f"{stored.shape} is the frozen part: {np.array_equal(stored, trace['frozen'])}")
    check(distinct and changes, "tidx: p distinct indices, new every draw")
    check(np.array_equal(stored, trace["frozen"]), "vi_params is not the trace's frozen part")
    check(bool(np.isfinite(res.samples).all()) and res.acceptance_rate > 0.0,
          f"sample_data: acceptance {res.acceptance_rate}")
    draw_s = out["phases_s"]["sampling_s"] / SUB_DRAWS
    print(f"  sample_data draw {1e3 * draw_s:.2f} ms (autograd through the composed density on "
          f"{SUB_P} points, L = {cfg.L}) beside the stride draw's {1e3 * stride_draw_s:.2f} ms "
          f"(phase 23); acceptance {res.acceptance_rate:.4f}; run wall {wall:.2f} s")
    del out
    torch.cuda.empty_cache()


def check_mfu(label: str, stats: dict):
    """A row's ``mfu`` block: present, with 0 < mfu <= 1 against the card's peak."""
    m = stats.get("mfu")
    check(m is not None, f"{label}: no mfu block")
    print(f"  {label} mfu: model_flops_total {m['model_flops_total']:.6g}, "
          f"flops_per_draw_per_chain {m['flops_per_draw_per_chain']}, achieved_tflops "
          f"{m['achieved_tflops']}, peak {m['peak_tflops_bf16']} TFLOP/s bf16 "
          f"({m['device_kind']}), mfu {m['mfu']}")
    check(m["mfu"] is not None and 0.0 < m["mfu"] <= 1.0, f"{label}: mfu {m['mfu']}")


def cone_phase(dev):
    """Phase 25: the Cone flow at full width (DeepONetConfig(), 1000 + 1000
    generated examples, one query point each), depth cut."""
    cfg = OperatorVIRunConfig(dataset="Cone", n_train=1000, n_valid=1000, batch_size=128,
                              vi=dataclasses.replace(OperatorVIRunConfig().vi,
                                                     epochs=CONE_EPOCHS))
    print(f"  depth cut: VI epochs {CONE_EPOCHS} (config {OperatorVIRunConfig().vi.epochs}), "
          f"stage-3 draws {CONE_DRAWS} (450); widths as configured: {cfg.model.num_params} "
          f"parameters, in_branch {cfg.model.in_branch}, batch {cfg.batch_size}")
    walls = []
    t_last = [0.0]

    def on_epoch(epoch, row, trainer):
        torch.cuda.synchronize()
        now = time.perf_counter()
        walls.append(now - t_last[0])
        t_last[0] = now

    reset_counts()
    t_last[0] = time.perf_counter()
    vi_out = vi_train.run_operator(cfg, seed=0, device=dev, callback=on_epoch)
    expect_no_launches("Cone stage 1")
    train, valid = vi_out["data"]
    m = vi_out["metrics"]
    print(f"  Cone data: branch {tuple(train['branch_in'].shape)}, trunk "
          f"{tuple(train['trunk_in'].shape)}, y {tuple(train['solution'].shape)}; valid "
          f"{tuple(valid['solution'].shape)}")
    print(f"  Cone stage 1: s per epoch {[round(w, 3) for w in walls]}; valid MSE "
          f"{m[0, 3]:.5f} -> {m[-1, 3]:.5f}")
    check(train["trunk_in"].shape == (1000, 1, 2) and bool(np.isfinite(m).all()),
          "Cone stage 1: layout or metrics")

    reset_counts()
    t0 = time.perf_counter()
    sens = sensitivity.run_operator(vi_out["best_state"].vp, cfg.model, valid,
                                    SensitivityRunConfig(importance_threshold=0.90,
                                                         batch_chunk=100))
    torch.cuda.synchronize()
    sens_s = time.perf_counter() - t0
    expect_no_launches("Cone stage 2")
    print(f"  Cone stage 2: {sens_s:.2f} s for 1000 per-example Jacobians (chunks of 100); "
          f"subspace {sens['num_sensitive']} of {cfg.model.num_params}")
    check(bool(np.isfinite(sens["scores"]).all()) and sens["num_sensitive"] > 0,
          "Cone stage 2: scores")

    hcfg = VIHMCRunConfig(num_samples=CONE_DRAWS, num_chains=16, frozen_policy="draw",
                          step_size=0.01, num_leapfrog=8, tau_out=1.0, vi_mass=True)
    reset_counts()
    t0 = time.perf_counter()
    out = vi_hmc.run_operator(hcfg, cfg.model, {k: sens[k] for k in ("mu", "sigma", "indices")},
                              data=vi_out["data"], device=dev)
    torch.cuda.synchronize()
    s3_s = time.perf_counter() - t0
    expect_no_launches("Cone stage 3")
    res = out["result"]
    samp_s = out["phases_s"]["sampling_s"]
    print(f"  Cone stage 3: 16 chains x {CONE_DRAWS} draws, L {hcfg.L}, DRAW, composed "
          f"per-example density: {1e3 * samp_s / CONE_DRAWS:.2f} ms per draw "
          f"(sampling {samp_s:.2f} s, run {s3_s:.2f} s), acceptance {res.acceptance_rate:.4f}, "
          f"expected MSE of the mean {float(out['metrics']['expected_mse_of_mean']):.5f}")
    check(bool(np.isfinite(res.samples).all())
          and res.samples.shape == (16, CONE_DRAWS, sens["num_sensitive"]),
          "Cone stage 3: samples")

    # canonicalization of each chain's last draws against the VI mean, and of
    # the same draws moved to another element of their orbit, one per chain
    t0 = time.perf_counter()
    idx = np.asarray(sens["indices"])
    sub = res.samples[:, -CONE_KEEP:, :]
    full = np.repeat(out["frozen"].cpu().numpy().astype(np.float64)[None], 16 * CONE_KEEP, 0)
    full[:, idx] = sub.reshape(-1, sub.shape[-1])
    scrambled = np.stack([random_orbit_element(i // CONE_KEEP, v, cfg.model)
                          for i, v in enumerate(full)])
    canon = canonicalize_deeponet(full, sens["mu"], cfg.model, permute=True)
    canon_s = canonicalize_deeponet(scrambled, sens["mu"], cfg.model, permute=True)
    canon_s_err = float(np.abs(canon_s - canon).max())
    apply_flat = make_flat_deeponet(cfg.model)
    with torch.no_grad(), true_f32():
        preds = [apply_flat(torch.as_tensor(v, dtype=torch.float32, device=dev),
                            valid["branch_in"], valid["trunk_in"])
                 for v in (full, scrambled, canon, canon_s)]
    errs = [(p_ - preds[0]).abs().max().item() for p_ in preds[1:]]
    scale = preds[0].abs().max().item()

    def rhat(v):
        return float(np.nanmax(potential_scale_reduction_np(v[:, idx].reshape(16, CONE_KEEP,
                                                                                -1))))

    print(f"  canonicalize_deeponet (signs and permutations, reference the VI mean) of "
          f"{16 * CONE_KEEP} draws (the last {CONE_KEEP} per chain) and of the same draws "
          f"moved to a random orbit element per chain, in {time.perf_counter() - t0:.2f} s: "
          f"validation predictions max abs change {errs[0]:.3g} (orbit element), "
          f"{errs[1]:.3g} (canonical), {errs[2]:.3g} (canonical of the orbit elements), "
          f"max |prediction| {scale:.3g}, tolerance {CANON_PRED_RTOL} of it; canonical of the "
          f"orbit elements vs canonical: max abs {canon_s_err:.3g}; "
          f"{float(np.mean(canon != full)):.4f} of the draws' coordinates moved")
    print(f"  max R-hat over the subspace coordinates, 16 chains x {CONE_KEEP} draws: the "
          f"draws {rhat(full):.4f}, their orbit elements {rhat(scrambled):.4f} before and "
          f"{rhat(canon_s):.4f} after canonicalization (the draws canonical {rhat(canon):.4f})")
    check(max(errs) <= CANON_PRED_RTOL * scale,
          f"canonicalization changed predictions by {max(errs)}")
    check(canon_s_err <= 1e-9, f"canonical forms of one orbit differ by {canon_s_err}")
    return {"stage3_ms_per_draw": 1e3 * samp_s / CONE_DRAWS}


def noise_phase(dev, data):
    """Phase 26: stage 1 on Burgers with the learned noise, at full width."""
    base = OperatorVIRunConfig()
    print(f"  depth cut: {NOISE_EPOCHS} epochs each (config {base.vi.epochs}); p 512, batch "
          f"{base.batch_size}, num_ens {base.vi.num_ens}; head width {NOISE_HEAD} (our choice)")
    for model, noise_type in ((DeepONetConfig(), 0),
                              (DeepONetConfig(noise_neurons=NOISE_HEAD), 1)):
        elbo = dataclasses.replace(base.vi.elbo, learn_noise=True, noise_type=noise_type)
        cfg = OperatorVIRunConfig(model=model, n_train=data[0]["branch_in"].shape[0],
                                  n_valid=data[1]["branch_in"].shape[0], p=512,
                                  vi=dataclasses.replace(base.vi, epochs=NOISE_EPOCHS,
                                                         elbo=elbo))
        walls, heads = [], []
        t_last = [0.0]
        apply_flat = make_flat_deeponet(model)
        vb = data[1]

        def on_epoch(epoch, row, trainer):
            torch.cuda.synchronize()
            now = time.perf_counter()
            walls.append(now - t_last[0])
            if noise_type:
                # the head's mean log-variance on 128 validation functions
                with torch.no_grad(), true_f32():
                    heads.append(apply_flat(trainer.model.mu[None], vb["branch_in"][:128],
                                            vb["trunk_in"])[1].mean().item())
            t_last[0] = time.perf_counter()

        reset_counts()
        t_last[0] = time.perf_counter()
        out = vi_train.run_operator(cfg, seed=0, data=data, device=dev, callback=on_epoch)
        expect_no_launches(f"learned noise, noise_type {noise_type}")
        m = out["metrics"]
        label = (f"noise_type {noise_type}" + (f", noise_neurons {NOISE_HEAD}"
                                               if noise_type else ""))
        print(f"  {label}: s per epoch {[round(w, 3) for w in walls]}; train loss "
              f"{[float(f'{v:.6g}') for v in m[:, 0]]}; exp(noise_param) "
              f"{[float(f'{v:.6g}') for v in m[:, 4]]}")
        check(m.shape[1] == 5 and bool(np.isfinite(m).all()), f"{label}: metrics {m.shape}")
        if noise_type == 0:
            check(float(out["state"].noise_param) != 0.0, "noise_param did not move")
            continue
        print(f"  {label}: the head's mean log-variance on 128 validation functions after "
              f"each epoch {[float(f'{v:.6g}') for v in heads]}; scalar noise_param "
              f"{float(out['state'].noise_param)} (the head gives the variance)")
        check(len(heads) > 1 and heads[0] != heads[-1], "the noise head did not move")


class CollectiveClock:
    """Host wall and calls of every ``all_reduce``/``all_gather`` inside the
    block (the mesh code calls them through ``torch.distributed``)."""

    def __enter__(self):
        self.seconds, self.calls = 0.0, 0
        self._real = {n: getattr(dist, n) for n in ("all_reduce", "all_gather")}
        for n, fn in self._real.items():
            setattr(dist, n, self._timed(fn))
        return self

    def _timed(self, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1
        return timed

    def __exit__(self, *exc):
        for n, fn in self._real.items():
            setattr(dist, n, fn)
        return False


def mesh_config(arts):
    """Stage 3 of phase 27: stride, 16 chains, dual averaging coupled over
    the chains on every draw (``adapt_forever``), so a chain all-reduce runs
    each draw."""
    grid = load_port_inputs()
    n_data = int(grid["n_train"]) * int(grid["nx"]) * int(grid["nt"])
    return stage3_config(len(arts["indices"]), n_data, variant="stride", draws=MESH_DRAWS,
                         chains=16, L=31, adapt=True, da_axis=True,
                         adapt_forever=True)


def mesh_run(label, dev, data, arts, mesh):
    """``run_operator(mesh=, use_fused=True)`` with every count at 0 before
    and read after; ``merge_sums`` must run 1 + 2 x draws times on this rank.
    Returns ``(out, counts, collective seconds, collective calls)``."""
    reset_counts()
    with CollectiveClock() as clock:
        out = vi_hmc.run_operator(mesh_config(arts), DeepONetConfig(), arts, data=data,
                                  use_fused=True, mesh=mesh, seed=0, device=dev)
    counts = read_counts()
    want = 1 + 2 * MESH_DRAWS
    print(f"  {label}: launches {counts}; merge_sums expected 1 + 2 x {MESH_DRAWS} = {want}")
    check(counts["merge_sums"] == want, f"{label}: merge_sums {counts['merge_sums']}")
    check(counts["paired_sums"] == 0 and counts["leapfrog_update"] == 0, f"{label}: {counts}")
    res = out["result"]
    check(bool(np.isfinite(res.samples).all()), f"{label}: non-finite samples")
    check(res.samples.shape[0] == 16, f"{label}: {res.samples.shape[0]} chains gathered")
    return out, counts, clock.seconds, clock.calls


def query_points(arts, dev):
    """Two full parameter vectors: the VI mean and one VI draw."""
    mu = torch.as_tensor(arts["mu"], dtype=torch.float32, device=dev)
    sigma = torch.as_tensor(arts["sigma"], dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    return torch.stack([mu, mu + sigma * torch.randn(mu.shape, generator=gen, device=dev)])


def query_value_grad(mesh, dev, train, arts):
    """The composed full-width log posterior (NLL over the grid, the prior
    once) and its gradient, the query axis over ``mesh``'s 'data' shards."""
    cfg = DeepONetConfig()
    bx, tx, y = train["branch_in"], train["trunk_in"], train["solution"]
    if mesh is not None:
        tx, y = shard_query(mesh, tx, y)
    apply_flat = make_flat_deeponet(cfg)
    like = get_likelihood("NLL")
    prior = IsotropicGaussianPrior(scale=0.1)

    def ll(flat):
        with true_f32():
            return like(apply_flat(flat, bx, tx), y, 1.0)

    lp = data_parallel_ll(mesh, ll)
    v, g = value_and_grad(lambda q, a: lp(q) + prior.log_prob(q),
                          query_points(arts, dev), None)
    return v, g, tx.shape[0]


def mesh_child(args) -> int:
    """One rank of phase 27 (b)-(c): a gloo rank sharing the card."""
    torch.set_num_threads(4)
    rank = args.mesh_child
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    refusal = ""
    try:
        initialize_distributed(f"localhost:{args.mesh_nccl_port}", 2, rank, 60.0,
                               backend="nccl", device="cuda")
    except RuntimeError as e:
        refusal = str(e)
    check(initialize_distributed(f"localhost:{args.mesh_port}", 2, rank, 120.0,
                                 backend="gloo", device="cuda"), "gloo world of 2")
    cuda_build.build_all()
    data = get_burgers(dev)
    arts = load_stage12_artifacts()
    out, counts, coll_s, coll_n = mesh_run(f"rank {rank}", dev, data, arts,
                                           global_chain_mesh())
    res = out["result"]
    v, g, n_points = query_value_grad(make_chain_mesh(1, 2), dev, data[0], arts)
    np.savez(os.path.join(args.mesh_out, f"rank{rank}.npz"), samples=res.samples,
             accepted=res.accepted, step_sizes=res.step_sizes,
             merge_sums=counts["merge_sums"], sampling_s=out["phases_s"]["sampling_s"],
             gather_s=out["phases_s"]["gather_s"], coll_s=coll_s, coll_n=coll_n,
             refusal=np.asarray(refusal), value=v.cpu().numpy(), grad=g.cpu().numpy(),
             n_points=n_points, mse=out["metrics"]["expected_mse_of_mean"])
    dist.destroy_process_group()
    return 0


def free_ports(n):
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for sk in socks:
            sk.bind(("localhost", 0))
        return [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()


def wait_children(procs, label):
    """Wait for every child (each within its limit); any non-zero exit fails."""
    outs = []
    for p, log in procs:
        p.wait(timeout=MESH_CHILD_TIMEOUT_S)
        log.seek(0)
        text = log.read()
        check(p.returncode == 0, f"{label}: a child exited {p.returncode}:\n{text[-4000:]}")
        outs.append(text)
    return outs


def spawn(cmd, procs):
    log = tempfile.TemporaryFile("w+")
    procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log))


def mesh_phase(dev, data, arts, tmp):
    """Phase 27: the chain mesh on the card."""
    print(f"  depth cut: draws {MESH_DRAWS} (stage-3 config 450); stride, 16 chains, L 31, "
          f"dual averaging coupled over the chains on every draw (da_axis='chains', "
          f"adapt_forever)")
    nccl_port, gloo_port, probe_port, mh_port = free_ports(4)
    # (a) a one-rank NCCL world: bit-equal to the mesh-less run
    check(initialize_distributed(f"localhost:{nccl_port}", 1, 0, 120.0, device="cuda"),
          "one-rank world")
    check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
    a_out, _, a_coll_s, a_coll_n = mesh_run("(a) one-rank NCCL mesh", dev, data, arts,
                                            global_chain_mesh())
    dist.destroy_process_group()
    p_out, _, _, _ = mesh_run("(a) no mesh", dev, data, arts, None)
    a_res, p_res = a_out["result"], p_out["result"]
    same = all(np.array_equal(getattr(a_res, f), getattr(p_res, f))
               for f in ("samples", "accept_probs", "accepted", "step_sizes"))
    print(f"  (a) one-rank NCCL mesh bit-equal to the mesh-less run: {same}; acceptance "
          f"{a_res.acceptance_rate:.4f}; collectives {a_coll_n} calls, {a_coll_s:.3f} s")
    check(same, "(a) the one-rank mesh run differs from the mesh-less run")
    a_draw_ms = 1e3 * a_out["phases_s"]["sampling_s"] / MESH_DRAWS
    print(f"  (a) wall per draw: {a_draw_ms:.2f} ms on the mesh (its first all-reduce sets up "
          f"the NCCL communicator), {1e3 * p_out['phases_s']['sampling_s'] / MESH_DRAWS:.2f} "
          f"ms without")
    # merge_sums at a rank's C = 8 of the two-rank run, on the run's last positions
    cfg_d = DeepONetConfig()
    bx, tx, y = data[0]["branch_in"], data[0]["trunk_in"], data[0]["solution"]
    q8 = torch.as_tensor(a_res.samples[:8, -1], device=dev)
    with true_f32():
        bo, to = deeponet_features(cfg_d, unravel_deeponet(
            cfg_d, scatter_subspace(a_out["frozen"], q8, a_out["spec"].idx)), bx, tx)
    bo, to = bo.contiguous(), to.contiguous()
    ms8 = time_device("merge_sums at C=8", lambda: merge_sums(bo, to, y), 20)
    b8, by8, tc8 = merge_sums_bound_ms(8, bo.shape[1], to.shape[1], bo.shape[2])
    print(f"  merge_sums at C=8 B={bo.shape[1]} P={to.shape[1]} K={bo.shape[2]} (a rank's "
          f"chains on two ranks): {ms8:.3f} ms; {bound_line(ms8, b8, tc8)} ({by8})")
    del bo, to, p_out
    torch.cuda.empty_cache()

    # (b)-(c) two gloo ranks sharing the card
    out_dir = os.path.join(tmp, "mesh")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    try:
        for r in range(2):
            spawn([sys.executable, os.path.abspath(__file__), "--mesh-child", str(r),
                   "--mesh-port", str(gloo_port), "--mesh-nccl-port", str(probe_port),
                   "--mesh-out", out_dir], procs)
        wait_children(procs, "(b) gloo ranks")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    ranks = [np.load(os.path.join(out_dir, f"rank{r}.npz")) for r in range(2)]
    for r, z in enumerate(ranks):
        msg = str(z["refusal"])
        check(msg.startswith("NCCL takes one rank per card"), f"rank {r}: NCCL refusal {msg!r}")
    print(f"  nccl with two ranks on one card refused: {str(ranks[0]['refusal'])!r}")
    b = ranks[0]
    gap = float(np.max(np.abs(b["samples"] - a_res.samples)))
    scale = float(np.max(np.abs(a_res.samples)))
    step_gap = float(np.max(np.abs(b["step_sizes"] - a_res.step_sizes)))
    step_scale = float(np.max(np.abs(a_res.step_sizes)))
    acc_b, acc_a = float(np.mean(b["accepted"])), a_res.acceptance_rate
    print(f"  (b) two gloo ranks x 8 chains: merge_sums per rank "
          f"{[int(z['merge_sums']) for z in ranks]}; gathered samples vs (a): largest gap "
          f"{gap:.3g} (largest |sample| {scale:.3g}, tolerance {MESH_SAMPLE_RTOL:g} of it); "
          f"step sizes vs (a): largest gap {step_gap:.3g} (largest {step_scale:.3g}, same "
          f"tolerance); acceptance {acc_b:.4f} vs {acc_a:.4f}")
    check(all(np.array_equal(z["samples"], b["samples"]) for z in ranks),
          "(b) ranks gathered different samples")
    check(all(np.array_equal(z["step_sizes"], b["step_sizes"]) for z in ranks),
          "(b) ranks gathered different step sizes")
    check(gap <= MESH_SAMPLE_RTOL * scale, f"(b) sample gap {gap}")
    check(step_gap <= MESH_SAMPLE_RTOL * step_scale, f"(b) step-size gap {step_gap}")
    check(acc_b == acc_a and np.array_equal(b["accepted"], a_res.accepted),
          "(b) acceptance differs")
    for r, z in enumerate(ranks):
        draw_ms = 1e3 * float(z["sampling_s"]) / MESH_DRAWS
        print(f"  (b) rank {r}: wall per draw {draw_ms:.2f} ms beside (a)'s {a_draw_ms:.2f} ms; "
              f"collectives {int(z['coll_n'])} calls, {float(z['coll_s']):.3f} s = "
              f"{100 * float(z['coll_s']) / (float(z['sampling_s']) + float(z['gather_s'])):.1f}"
              f" % of sampling + gather (host wall in all_reduce/all_gather); gather "
              f"{float(z['gather_s']):.3f} s")

    # (c) the full-width query-sharded log posterior against the unsharded one
    v, g, n_points = query_value_grad(None, dev, data[0], arts)
    v, g = v.cpu().numpy(), g.cpu().numpy()
    v_err = float(np.max(np.abs(b["value"] - v) / np.abs(v)))
    g_err = float(np.max(np.abs(b["grad"] - g)) / np.max(np.abs(g)))
    print(f"  (c) shard_query over two ranks ({int(ranks[0]['n_points'])} / "
          f"{int(ranks[1]['n_points'])} of {n_points} points): value rel err {v_err:.3g} "
          f"(tolerance {QUERY_VALUE_RTOL:g}), gradient max err {g_err:.3g} of its largest "
          f"entry (tolerance {QUERY_GRAD_RTOL:g})")
    check(v_err <= QUERY_VALUE_RTOL and g_err <= QUERY_GRAD_RTOL, "(c) shard_query")
    check(sorted([int(z["n_points"]) for z in ranks]) == [5100, 5101], "(c) shard sizes")

    # (d) run_multihost on two ranks against one
    procs = []
    mh = [sys.executable, "-m", "vihmc_torch.run_multihost"]
    two = ["--coordinator", f"localhost:{mh_port}", "--num-processes", "2",
           "--init-timeout", "120", "--backend", "gloo"]
    try:
        spawn(mh + two + ["--process-id", "0"], procs)
        spawn(mh + two + ["--process-id", "1"], procs)
        spawn(mh, procs)
        texts = wait_children(procs, "(d) run_multihost")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()

    def result(text):
        lines = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        check(len(lines) == 1, f"run_multihost RESULT lines: {lines}")
        return json.loads(lines[0][len("RESULT "):])

    two_r, one_r = result(texts[0]), result(texts[2])
    print(f"  (d) run_multihost two ranks: {json.dumps(two_r)}")
    print(f"  (d) run_multihost one rank:  {json.dumps(one_r)}")
    check(two_r["distributed"] and two_r["processes"] == 2 and not one_r["distributed"],
          "(d) process counts")
    check(abs(two_r["acceptance"] - one_r["acceptance"]) <= 1e-3
          and abs(two_r["max_rhat"] - one_r["max_rhat"]) <= 1e-2 * one_r["max_rhat"]
          and abs(two_r["median_ess"] - one_r["median_ess"]) <= 5e-2 * one_r["median_ess"],
          "(d) the two-rank diagnostics differ from the one-rank run's")
    return {"merge_sums_c8_ms": ms8, "merge_sums_c8_bound_ms": b8,
            "mesh_launches_per_rank": [int(z["merge_sums"]) for z in ranks]}


def bench_cli(argv) -> dict:
    """One ``python -m vihmc_torch.bench`` invocation in this process, its
    line printed after a label (so that no bare JSON line precedes the
    kernels' line)."""
    line = tbench.run(argv + ["--device", "cuda"])
    print("  bench line: " + json.dumps(line))
    return line


def bench_row_phase(dev, reps: int) -> dict:
    """Phase 28: ``bench.py``'s operator row through ``python -m
    vihmc_torch.bench``'s entry points at full width, depth cut; returns the
    kernel rows and launch counts it measured."""
    out = {}
    # (a) the zero-argument recipe, depth cut, keys 2,3,4
    a_argv = ["--keys", "2,3,4", "--draws", str(ROW_DRAWS), "--burn", str(ROW_BURN),
              "--segment", str(ROW_SEGMENT), "--init-opt", str(ROW_INIT_OPT),
              "--lowrank-mass", str(ROW_RANK), "--skip-baseline"]
    print(f"  (a) depth cut: draws {ROW_DRAWS}, burn {ROW_BURN}, segments of {ROW_SEGMENT}, "
          f"init-opt {ROW_INIT_OPT}, rank {ROW_RANK} (recipe 2880, 288, 120, 800, 256); "
          f"CPU baseline {ROW_BASELINE_SECONDS:.0f} s (bench: 120 s)")
    reset_counts()
    t0 = time.perf_counter()
    line = bench_cli(a_argv)
    wall = time.perf_counter() - t0
    counts = read_counts()
    ex = line["extras"]
    print(f"  (a) launches {counts}; headline {line['value']} ESS/s (median ESS "
          f"{ex['ess_median_by_key']} over median wall {ex['wall_s_median']} s), "
          f"ess_per_s_by_key {ex['ess_per_s_by_key']}, draws/s {ex['draws_per_s']:.3f}, "
          f"acceptance {ex['acceptance']}, phases {ex['phases_s']}; run wall {wall:.2f} s")
    check(len(ex["ess_per_s_by_key"]) == 3, f"(a) ess_per_s_by_key {ex['ess_per_s_by_key']}")
    check(math.isfinite(line["value"]) and line["value"] > 0, f"(a) value {line['value']}")
    check(ex["samples_finite"], "(a) non-finite samples")
    # one launch per draw of each key, one in the mfu block's transition
    check(counts["paired_sums"] == 3 * ROW_DRAWS + 1,
          f"(a) paired_sums {counts['paired_sums']} != 3 x {ROW_DRAWS} + 1")
    check(counts["merge_sums"] == 0 and counts["leapfrog_update"] == 0, f"(a) {counts}")
    expect_tiled_only("(a) the row (C = 48)", counts)
    check_mfu("(a) bench row", ex)
    out["row_paired_sums"] = counts["paired_sums"]
    args = tbench.parse_args(a_argv)
    tbench.resolve(args)
    kw = dict(tbench.baseline_kwargs(args, ex), max_seconds=ROW_BASELINE_SECONDS)
    tb = bench_torch_baseline(**kw)
    fields = tbench.vs_baseline_fields(args, ex["samples_per_s"], tb["samples_per_s"])
    print(f"  (a) CPU baseline (one torch chain, L = {BENCH_L}, step {kw.get('step', 1e-4)}): "
          f"{tb['draws']} draws in {tb['elapsed_s']:.2f} s, {tb['samples_per_s']:.4f} draws/s; "
          f"vs_baseline {fields['vs_baseline']:.2f} ({fields['vs_baseline_kind']})")
    check(math.isfinite(fields["vs_baseline"]) and fields["vs_baseline"] > 0,
          f"(a) vs_baseline {fields['vs_baseline']}")

    # (b) --subspace 90pct at full width, one key
    b_argv = ["--subspace", "90pct", "--keys", "2", "--draws", str(NINETY_DRAWS), "--burn",
              str(NINETY_BURN), "--segment", str(NINETY_SEGMENT), "--init-opt",
              str(ROW_INIT_OPT), "--lowrank-mass", str(ROW_RANK), "--skip-baseline"]
    print(f"  (b) depth cut: one key, draws {NINETY_DRAWS}, burn {NINETY_BURN}, segments of "
          f"{NINETY_SEGMENT} (recipe 2880, 288, 60), init-opt {ROW_INIT_OPT}, rank {ROW_RANK}")
    recipe = tbench.resolve(tbench.parse_args(b_argv))
    reset_counts()
    t0 = time.perf_counter()
    st, prob = bench_operator(device=dev, **recipe["operator"])
    wall = time.perf_counter() - t0
    counts = read_counts()
    d, c = st["subspace_dim"], st["chains"]
    print(f"  (b) 90 % row: {d} dims, {c} chains; launches {counts}; ESS/s {st['ess_per_s']:.4f}"
          f", draws/s {st['draws_per_s']:.3f} ({1e3 / st['draws_per_s']:.2f} ms per draw), "
          f"acceptance {st['acceptance']:.4f}, step quartiles {st['step_quartiles']}, "
          f"phases {st['phases_s']}, segment walls {st.get('seg_wall_s')}; run wall "
          f"{wall:.2f} s")
    check(d == 81131 and c == 32, f"(b) {d} dims, {c} chains")
    check(st["samples_finite"], "(b) non-finite samples")
    check(counts["paired_sums"] == NINETY_DRAWS + 1, f"(b) paired_sums {counts}")
    expect_tiled_only("(b) the 90 % row (C = 32)", counts)
    check_mfu("(b) 90 % row", st)
    out["ninety_draws_per_s"] = st["draws_per_s"]
    # paired_sums at C = 32 on the 90 % problem, held like phase 2's C = 48
    spec, aux = prob.spec, prob.frozen
    prior = DiagonalGaussianPrior(loc=spec.sub_mu(), scale=spec.sub_sigma())
    inv_mass = problem_laplace_inv_mass(prob)
    field = trajectory_field(prob, prior, inv_mass, stride=1, fn_stride=1,
                             grad_dtype="bfloat16")
    # q0 the conditional mode (the warm start without jitter), q1 one L = 4
    # trajectory from it on the diagonal metric at a step it keeps stable
    # (the row's step rides the low-rank metric; on the diagonal alone its
    # stiffest directions diverge to |dll| ~ 1e6 nats, where the f32
    # result's own rounding exceeds DLL_ATOL)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q0 = conditional_warm_start(field, aux, spec.sub_mu(), inv_mass, ROW_INIT_OPT, c, gen,
                                spread=0.0)
    p0 = torch.randn((c, d), generator=gen, device=dev) / torch.sqrt(inv_mass)
    q1, _, _ = leapfrog_grad_only(lambda q: field(q, aux), q0, p0, field(q0, aux),
                                  C32_STEP, 4, inv_mass)
    feats, biases = [], []
    with true_f32():
        for q in (q1, q0):
            params = unravel_deeponet(prob.cfg, scatter_subspace(aux, q, spec.idx))
            bo, to = deeponet_features(prob.cfg, params, prob.branch_x, prob.trunk_x)
            feats += [bo.contiguous(), to.contiguous()]
            biases.append(params["b"].contiguous())
    b, k = feats[0].shape[1:]
    p = feats[1].shape[1]
    out["paired_sums_c32_err"] = compare_paired(f"90 % row C={c} B={b} P={p} K={k}", feats,
                                                biases, prob.y, main=True)
    ms = time_device("paired_sums C=32", lambda: paired_sums(*feats, prob.y), reps)
    plain_ms = time_device("paired_sums C=32 plain",
                           lambda: paired_sums_reference(*feats, prob.y), 2, warmup=1)
    bound_ms, bound_by, tc_ms = paired_sums_bound_ms(c, b, p, k)
    print(f"  paired_sums at C={c} B={b} P={p} K={k}: kernel {ms:.3f} ms (mean of {reps} "
          f"queued launches); {bound_line(ms, bound_ms, tc_ms)}; plain {plain_ms:.3f} ms")
    out.update(paired_sums_c32_ms=ms, paired_sums_c32_bound_ms=bound_ms,
               paired_sums_c32_tc_ms=tc_ms)
    # where a 90 % row draw's time goes (after the counts were read)
    grad_ms = time_device("90 % row Gram field", lambda: field(q0, aux), SPLIT_REPS)

    def feature_forwards():
        with true_f32():
            for q in (q1, q0):
                deeponet_features(prob.cfg, unravel_deeponet(prob.cfg, scatter_subspace(
                    aux, q, spec.idx)), prob.branch_x, prob.trunk_x)

    feat_ms = time_device("90 % row feature forwards", feature_forwards, SPLIT_REPS)
    delta = mh_delta(prob, prior)
    delta_ms = time_device("90 % row delta", lambda: delta(q1, q0, aux), SPLIT_REPS)
    draw_ms = 1e3 / st["draws_per_s"]
    parts = {"gram_field_x4": 4 * grad_ms, "delta_feature_forwards": feat_ms,
             "paired_sums": ms, "delta_rest": delta_ms - feat_ms - ms}
    parts["rest_of_draw"] = draw_ms - sum(parts.values())
    print(f"  per 90 % row draw at C={c} (device time, mean of {SPLIT_REPS} queued calls): "
          f"sampling wall {draw_ms:.2f} ms = "
          + ", ".join(f"{k_} {v:.2f} ms ({100 * v / draw_ms:.1f} %)" for k_, v in parts.items()))
    del prob, feats, field, delta, q0, q1, p0, st
    torch.cuda.empty_cache()

    # (c) --extras' gradient at full width: merge_sums at C = 1
    prob = build_problem(False, device=dev)
    composed, fused, flat0 = grad_path_log_posteriors(prob)
    reset_counts()
    rates = bench_grad_path(False, iters=GRAD_ITERS, device=dev, problem=prob)
    counts = read_counts()
    print(f"  (c) gradient of the full log posterior, {GRAD_ITERS} + 1 evaluations each: "
          f"{json.dumps(rates)}; launches {counts}")
    check(counts["merge_sums"] == GRAD_ITERS + 1 and counts["paired_sums"] == 0,
          f"(c) merge_sums {counts} for {GRAD_ITERS} + 1 fused gradients")
    check(counts["merge_sums_c1"] == counts["merge_sums"] == counts["merge_sums_small"],
          f"(c) the fused gradient runs merge_sums at C = 1 on the small kernel: {counts}")
    out["grad_merge_sums_small"] = counts["merge_sums_small"]
    gc = log_posterior_grad(composed, flat0).double().flatten()
    gf = log_posterior_grad(fused, flat0).double().flatten()
    cos = torch.nn.functional.cosine_similarity(gf, gc, dim=0).item()
    rel = ((gf - gc).norm() / gc.norm()).item()
    print(f"  (c) fused vs composed gradient: cosine {cos:.9f}, relative error {rel:.3g}")
    check(cos >= GRAD_PATH_COS_MIN, f"(c) gradient cosine {cos}")
    with true_f32():
        params = unravel_deeponet(prob.cfg, flat0)
        bo, to = deeponet_features(prob.cfg, params, prob.branch_x, prob.trunk_x)
    bo, to, bias = bo.contiguous(), to.contiguous(), params["b"].contiguous()
    c1, b1, k1 = bo.shape
    p1 = to.shape[1]
    err = compare_merge(f"--extras C={c1} B={b1} P={p1} K={k1}", bo, to, bias, prob.y,
                        main=True)
    a_, b_ = merge_sums(bo, to, prob.y), merge_sums(bo, to, prob.y)
    torch.cuda.synchronize()
    check(torch.equal(a_, b_), "small merge_sums: two launches differ")
    plain_ms = time_device("merge_sums C=1 plain",
                           lambda: merge_sums_reference(bo, to, prob.y), SPLIT_REPS, warmup=1)
    bound_ms, bound_by, tc_ms = merge_sums_bound_ms(c1, b1, p1, k1)
    # both kernels over C in {1, 2, 4, 8} x B in {10, 1000}, in turns
    grid = merge_paths_grid(bo, to, prob.y, reps)
    t1 = grid[f"C=1 B={b1}"]
    print(f"  merge_sums small at C={c1} B={b1} P={p1} K={k1}: {t1['small']:.4f} ms; "
          f"{bound_line(t1['small'], bound_ms, tc_ms)}; plain {plain_ms:.3f} ms, library_ms "
          f"n/a (no single PyTorch call computes S1 and S2)")
    print("  (C, B) grid, ms (small, tiled; the wrapper's rule): " + json.dumps(
        {k_: [round(v["small"], 4), round(v["tiled"], 4), v["rule"]] for k_, v in grid.items()}))
    for k_, v in grid.items():
        faster = "small" if v["small"] < v["tiled"] else "tiled"
        check(v["rule"] == faster or abs(v["small"] - v["tiled"]) <= 0.05 * v["tiled"],
              f"(C, B) rule picks {v['rule']} at {k_}, where {faster} is faster: {v}")
    out["merge_sums_small"] = dict(max_abs_err=err, ms=t1["small"], plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by, bound_tc_ms=tc_ms,
                                   tiled_ms=t1["tiled"])
    del prob, composed, fused, flat0, bo, to, gc, gf
    torch.cuda.empty_cache()

    # (d) the row's other recipes, a few draws each
    short = ["--keys", "2", "--draws", str(VARIANT_DRAWS), "--init-opt", "20",
             "--skip-baseline"]
    variants = {
        "--coupled --stride 5 --fn-stride 5": ["--coupled", "--stride", "5", "--fn-stride", "5"],
        "--gauss-field": ["--gauss-field"],
        "--adaptive": ["--adaptive"],
        "--no-gram (L 4)": ["--no-gram", "--L", "4"],
        # the zero-argument recipe's thin 3 needs segments: 24 draws in 12s
        "--composed-delta": ["--composed-delta", "--draws", "24", "--burn", "6", "--segment",
                             "12", "--lowrank-mass", "8"],
        "--no-paired-delta": ["--no-paired-delta", "--draws", "24", "--burn", "6",
                              "--segment", "12", "--lowrank-mass", "8"],
    }
    for label, extra in variants.items():
        reset_counts()
        line = bench_cli(short + extra)
        draws = line["extras"]["draws"]
        counts = read_counts()
        ex = line["extras"]
        fused = ex["fused_delta"]
        print(f"  (d) {label}: acceptance {ex['acceptance']}, draws/s {ex['draws_per_s']:.3f}, "
              f"fused delta {fused}, paired delta {ex['paired_delta']}; launches {counts}")
        check(ex["samples_finite"], f"(d) {label}: non-finite samples")
        want = draws + 1 if fused else 0
        check(counts["paired_sums"] == want, f"(d) {label}: paired_sums {counts} != {want}")
        check(counts["merge_sums"] == 0, f"(d) {label}: merge_sums {counts}")
    return out


def finite_values(label: str, obj: dict, keys) -> None:
    vals = {k: obj[k] for k in keys}
    print(f"  {label}: " + ", ".join(f"{k} {v:.6g}" for k, v in vals.items()))
    check(all(math.isfinite(v) for v in vals.values()), f"{label}: non-finite {vals}")


def scripts_phase(dev, tmp) -> dict:
    """Phase 29: the result scripts (``python -m vihmc_torch.scripts.<name>``)
    driven in process through their ``main`` at full width, depth cut."""
    from vihmc_torch.scripts import (canonicalize_operator_draws, fs_diagnostics_operator,
                                     run_cone_demo, run_nn_demo, run_nn_stage12,
                                     run_operator_demo, run_operator_stage12,
                                     run_operator_stage3)

    print(f"  depth cuts: stage 1 {SCRIPT_EPOCHS} epochs (2400), stage 3 {SCRIPT_DRAWS} draws "
          f"(450) in segments of {SCRIPT_SEGMENT} (90), thin 1 (3); the demo "
          f"{SCRIPT_EPOCHS} epochs (200), {SCRIPT_DEMO_DRAWS} draws (450); NN "
          f"{NN_SCRIPT_EPOCHS} epochs (10,000), hmc_full {NN_SCRIPT_HMC_DRAWS} draws (1000), "
          f"VI-HMC and NUTS {NN_SCRIPT_VIHMC_DRAWS} (100), converged {NN_SCRIPT_CONV_DRAWS} "
          f"(3000); Cone {SCRIPT_EPOCHS} epochs (1200), {SCRIPT_DEMO_DRAWS} draws (600)")
    walls = {}
    op, ck = os.path.join(tmp, "op"), os.path.join(tmp, "op", "ck")
    bundle = os.path.join(op, "burgers_stage12.npz")

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    # (a) stage 1 + 2 write a run store and a bundle
    reset_counts()
    s12 = timed("stage12", lambda: run_operator_stage12.main(
        ["--epochs", str(SCRIPT_EPOCHS), "--out", os.path.join(op, "stage12"),
         "--assets", bundle]))
    expect_no_launches("(a) run_operator_stage12")
    with np.load(bundle) as z:
        check(set(z.files) == set(np.load(STAGE12_ASSET).files) and len(z["mu"]) == 172_401,
              f"(a) bundle keys {sorted(z.files)}")
    finite_values("(a) stage12", s12, ("valid_mse_best", "subspace_frac", "vi_seconds"))

    # (b) stage 3 on (a)'s own subspace, checkpointed in segments
    reset_counts()
    s3 = timed("stage3", lambda: run_operator_stage3.main(
        ["--artifacts", os.path.join(op, "stage12", "stage12"), "--out",
         os.path.join(op, "stage3"), "--uid", "s3", "--ckpt", ck, "--variant", "stride",
         "--draws", str(SCRIPT_DRAWS), "--segment", str(SCRIPT_SEGMENT), "--thin", "1"]))
    counts = read_counts()
    want = 1 + 2 * SCRIPT_DRAWS
    print(f"  (b) run_operator_stage3 launches: {counts} (merge_sums 1 + 2 x {SCRIPT_DRAWS} = "
          f"{want})")
    check(counts["merge_sums"] == want and counts["paired_sums"] == 0
          and counts["leapfrog_update"] == 0, f"(b) launches {counts}, merge_sums {want} wanted")
    check(len([f for f in os.listdir(ck) if f.startswith("samples_seg")])
          == SCRIPT_DRAWS // SCRIPT_SEGMENT, "(b) segment files")
    finite_values("(b) stage3", s3, ("acceptance_post_burn", "expected_mse_of_mean",
                                     "mean_relative_l2", "ess_median", "r_hat_max"))

    # (c) canonicalization of (b)'s checkpoint, (d) function-space diagnostics of its run
    canon = timed("canonicalize", lambda: canonicalize_operator_draws.main(
        ["--ckpt", ck, "--assets", bundle, "--burn-kept", "2", "--permute",
         "--out", os.path.join(op, "canonicalization.json")]))
    finite_values("(c) canonicalize", canon, ("rhat_raw_max", "rhat_sign_max", "rhat_perm_max"))
    fs = timed("fs_diagnostics", lambda: fs_diagnostics_operator.main(
        ["--run", os.path.join(op, "stage3", "s3"), "--assets", bundle, "--thin", "1"]))
    finite_values("(d) fs diagnostics", fs, ("fs_r_hat_max", "fs_r_hat_rank_max",
                                             "fs_ess_median", "fs_ess_bulk_min"))

    # (e) the three-stage demo on the composed density
    reset_counts()
    demo = timed("operator_demo", lambda: run_operator_demo.main(
        ["--epochs", str(SCRIPT_EPOCHS), "--draws", str(SCRIPT_DEMO_DRAWS),
         "--out", os.path.join(tmp, "demo")]))
    expect_no_launches("(e) run_operator_demo")
    finite_values("(e) operator demo", demo, ("acceptance", "expected_mse_of_mean",
                                              "mean_relative_l2", "ess_median"))

    # (f) the NN bundle (which bench_nn loads) and the NN demo
    reset_counts()
    nn_path = os.path.join(tmp, "nn_stage12.npz")
    timed("nn_stage12", lambda: run_nn_stage12.main(
        ["--epochs", str(NN_SCRIPT_EPOCHS), "--out", nn_path]))
    expect_no_launches("(f) run_nn_stage12")
    prev = bench_nn.NN_STAGE12_ASSET
    bench_nn.NN_STAGE12_ASSET = nn_path
    try:
        problem = bench_nn.build_nn_problem(dev)
    finally:
        bench_nn.NN_STAGE12_ASSET = prev
    print(f"  (f) bench_nn loads the written bundle: {problem[-1]['subspace']}")
    reset_counts()
    nn = timed("nn_demo", lambda: run_nn_demo.main(
        ["--epochs", str(NN_SCRIPT_EPOCHS), "--hmc-draws", str(NN_SCRIPT_HMC_DRAWS),
         "--vihmc-draws", str(NN_SCRIPT_VIHMC_DRAWS), "--converged-draws",
         str(NN_SCRIPT_CONV_DRAWS), "--out", os.path.join(tmp, "demo_nn")]))
    expect_no_launches("(f) run_nn_demo")
    for block in ("hmc_full", "vi_hmc", "vi_hmc_converged", "vi_nuts"):
        finite_values(f"(f) nn demo {block}", nn[block], ("acceptance", "expected_mse_of_mean"))

    # (g) the Cone demo (per-example query points)
    reset_counts()
    cone = timed("cone_demo", lambda: run_cone_demo.main(
        ["--epochs", str(SCRIPT_EPOCHS), "--draws", str(SCRIPT_DEMO_DRAWS),
         "--out", os.path.join(tmp, "cone_demo_summary.json"),
         "--store", os.path.join(tmp, "cone_demo")]))
    expect_no_launches("(g) run_cone_demo")
    finite_values("(g) cone demo", cone, ("acceptance_post_burn", "expected_mse_of_mean",
                                          "fs_r_hat_max", "fs_ess_median"))
    print("  phase 29 walls (s): " + json.dumps({k: round(v, 3) for k, v in walls.items()}))
    return {"stage3_merge_sums": counts["merge_sums"], "walls": walls}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="PyTorch port smoke run on one GPU")
    ap.add_argument("--draws", type=int, default=240, help="operator-row draws")
    ap.add_argument("--segment", type=int, default=120)
    ap.add_argument("--burn", type=int, default=48)
    ap.add_argument("--init-opt", type=int, default=800)
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--s3-draws", type=int, default=30, help="stage-3 draws")
    ap.add_argument("--s3-burn", type=int, default=15)
    ap.add_argument("--s3-segment", type=int, default=15)
    ap.add_argument("--autodiff-draws", type=int, default=6)
    ap.add_argument("--timing-reps", type=int, default=20)
    ap.add_argument("--vi-epochs", type=int, default=4, help="stage-1 epochs (bundle: 400)")
    ap.add_argument("--refresh-draws", type=int, default=12, help="stage-3 REFRESH draws")
    ap.add_argument("--nn-epochs", type=int, default=2000, help="NN VI epochs (bundle: 10,000)")
    ap.add_argument("--stride-draws", type=int, default=30, help="stage-3 stride draws")
    ap.add_argument("--gauss-draws", type=int, default=30, help="stage-3 gauss draws")
    ap.add_argument("--lowrank-rank", type=int, default=16)
    ap.add_argument("--lowrank-draws", type=int, default=4)
    ap.add_argument("--nuts-chains", type=int, default=4, help="hmc_nuts chains (config: 1)")
    ap.add_argument("--split-draws", type=int, default=6, help="hmc_split draws (config: 1001)")
    ap.add_argument("--full-draws", type=int, default=8, help="hmc_full draws (config: 1000)")
    ap.add_argument("--mesh-child", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-nccl-port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if args.mesh_child is not None:
        return mesh_child(args)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- phase 1: device and build ----
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    tb = time.perf_counter()
    built = cuda_build.build_all()
    print(f"build: {time.perf_counter() - tb:.2f} s ({', '.join(built) or 'cached'})")
    for n, log in cuda_build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {n}: {line.strip()}")
    phase("1 device+build", t0)

    # ---- phase 2: paired_sums against its plain version ----
    t0 = time.perf_counter()
    problem = build_problem(False, device=dev)
    torch.cuda.synchronize()
    print(f"problem: Burgers solve + asset load {time.perf_counter() - t0:.2f} s; "
          f"y {tuple(problem.y.shape)}, subspace {problem.spec.subspace_dim}")
    rows = torch.as_tensor(load_port_inputs()["solution_rows"], device=dev)
    burgers_err = (problem.y[:rows.shape[0]] - rows).abs().max().item()
    print(f"  Burgers rows vs JAX solution: max abs {burgers_err:.3g}")
    check(burgers_err <= BURGERS_ATOL, f"Burgers solve differs from JAX by {burgers_err}")

    cfg, spec, aux = problem.cfg, problem.spec, problem.frozen
    # the recipe's field and fused delta on the Laplace diagonal
    prior = DiagonalGaussianPrior(loc=spec.sub_mu(), scale=spec.sub_sigma())
    inv_mass = problem_laplace_inv_mass(problem)
    field = trajectory_field(problem, prior, inv_mass, stride=1, fn_stride=1,
                             grad_dtype="bfloat16")
    delta = mh_delta(problem, prior)
    chains, d = 48, spec.subspace_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    scale = torch.sqrt(inv_mass)
    q0 = spec.sub_mu() + 0.5 * scale * torch.randn((chains, d), generator=gen, device=dev)
    p0 = torch.randn((chains, d), generator=gen, device=dev) / scale
    q1, _, _ = leapfrog_grad_only(lambda q: field(q, aux), q0, p0, field(q0, aux), 0.1, 4,
                                  inv_mass)
    # the bf16 Gram field against autograd of the composed f32 likelihood
    with torch.enable_grad(), true_f32():
        full = scatter_subspace(aux, q0[:1], spec.idx).requires_grad_(True)
        params = unravel_deeponet(cfg, full)
        bo, to = deeponet_features(cfg, params, problem.branch_x, problem.trunk_x)
        pred = bo @ to.transpose(-1, -2) + params["b"][:, None, None]
        (g_auto,) = torch.autograd.grad(-0.5 * ((pred - problem.y) ** 2).sum(), full)
    g_gram = make_gram_grad_full(cfg, problem.branch_x, problem.trunk_x, problem.y, 1.0,
                                 compute_dtype=torch.bfloat16)(full.detach())
    cos = torch.nn.functional.cosine_similarity(g_gram[0, spec.idx], g_auto[0, spec.idx],
                                                dim=0).item()
    print(f"  Gram bf16 field vs f32 autograd on the subspace: cosine {cos:.6f}")
    check(cos > 0.99, f"Gram field cosine {cos}")
    del pred, g_auto
    with true_f32():
        params1 = unravel_deeponet(cfg, scatter_subspace(aux, q1, spec.idx))
        params0 = unravel_deeponet(cfg, scatter_subspace(aux, q0, spec.idx))
        bout1, tout1 = deeponet_features(cfg, params1, problem.branch_x, problem.trunk_x)
        bout0, tout0 = deeponet_features(cfg, params0, problem.branch_x, problem.trunk_x)
    y = problem.y
    biases = (params1["b"].contiguous(), params0["b"].contiguous())
    ragged = [t[:3, :n, :12].contiguous() for t, n in
              ((bout1, 130), (tout1, 301), (bout0, 130), (tout0, 301))]
    compare_paired("ragged C=3 B=130 P=301 K=12", ragged,
                   (biases[0][:3], biases[1][:3]), y[:130, :301].contiguous())
    feats = [t.contiguous() for t in (bout1, tout1, bout0, tout0)]
    c, b, k = feats[0].shape
    p = feats[1].shape[1]
    err_main = compare_paired(f"main C={c} B={b} P={p} K={k}", feats, biases, y, main=True)
    ms = time_device("paired_sums", lambda: paired_sums(*feats, y), args.timing_reps)
    plain_ms = time_device("paired_sums plain", lambda: paired_sums_reference(*feats, y), 2,
                           warmup=1)
    bound_ms, bound_by, tc_ms = paired_sums_bound_ms(c, b, p, k)
    print(f"  paired_sums at C={c} B={b} P={p} K={k}: kernel {ms:.3f} ms (mean of "
          f"{args.timing_reps} queued launches); {bound_line(ms, bound_ms, tc_ms)} (f32 "
          f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s, bf16 {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s); plain {plain_ms:.3f} ms, library_ms n/a (no "
          f"single PyTorch call computes these five sums)")
    kernel_rows = {"paired_sums": dict(max_abs_err=err_main, ms=ms, plain_ms=plain_ms,
                                       bound_ms=bound_ms, bound_by=bound_by,
                                       bound_tc_ms=tc_ms)}
    # the unbatched form (_paired_sums_pallas): the small kernel at C = 1, at
    # small B (C = 3), and with K % 4 != 0 (4-byte loads)
    n_small = profiling.counter("paired_sums.launches_small")
    feats1 = [t[:1].contiguous() for t in feats]
    err_c1 = compare_paired(f"small C=1 B={b} P={p} K={k}", feats1,
                            (biases[0][:1], biases[1][:1]), y, main=True)
    compare_paired("small C=3 B=100 P=301 K=12", [t[:3, :n, :12].contiguous() for t, n in
                                                  ((bout1, 100), (tout1, 301), (bout0, 100),
                                                   (tout0, 301))],
                   (biases[0][:3], biases[1][:3]), y[:100, :301].contiguous())
    compare_paired("small C=1 B=130 P=301 K=13", [t[:1, :n, :13].contiguous() for t, n in
                                                  ((bout1, 130), (tout1, 301), (bout0, 130),
                                                   (tout0, 301))],
                   (biases[0][:1], biases[1][:1]), y[:130, :301].contiguous())
    n_small = profiling.counter("paired_sums.launches_small") - n_small
    check(n_small == 3, f"paired_sums took the small kernel {n_small} of 3 times")
    a_, b_ = paired_sums(*feats1, y), paired_sums(*feats1, y)
    torch.cuda.synchronize()
    check(torch.equal(a_, b_), "small paired_sums: two launches differ")
    t1 = paths_in_turns(f"paired_sums C=1 B={b} P={p} K={k}", _paired_launch, (*feats1, y),
                        args.timing_reps, paired_sums_bound_ms(1, b, p, k))
    plain1 = time_device("paired_sums C=1 plain", lambda: paired_sums_reference(*feats1, y), 2,
                         warmup=1)
    b1_ms, b1_by, tc1_ms = paired_sums_bound_ms(1, b, p, k)
    print(f"  paired_sums small at C=1: {bound_line(t1['small'], b1_ms, tc1_ms)}; plain "
          f"{plain1:.3f} ms")
    kernel_rows["paired_sums_small"] = dict(max_abs_err=err_c1, ms=t1["small"], plain_ms=plain1,
                                            bound_ms=b1_ms, bound_by=b1_by, bound_tc_ms=tc1_ms,
                                            tiled_ms=t1["tiled"])
    del feats, feats1, ragged, bout1, tout1, bout0, tout0
    phase("2 paired_sums vs plain", t0)

    # ---- phase 3: the operator row at full width ----
    t0 = time.perf_counter()
    cuts = {"init_opt": (args.init_opt, 800), "lowrank_rank": (args.rank, 256),
            "draws": (args.draws, 2880), "burn": (args.burn, 288),
            "segment": (args.segment, 120)}
    for key_, (val, full_val) in cuts.items():
        if val != full_val:
            print(f"  depth cut: {key_} {val} (recipe {full_val})")
    # the zero-argument recipe of python -m vihmc_torch.bench, key 2
    recipe = tbench.resolve(tbench.parse_args([
        "--keys", "2", "--draws", str(args.draws), "--burn", str(args.burn), "--segment",
        str(args.segment), "--init-opt", str(args.init_opt), "--lowrank-mass", str(args.rank)]))
    reset_counts()
    stats, _ = bench_operator(device=dev, problem=problem, **recipe["operator"])
    row_counts = read_counts()
    print(f"  launches in the operator row: {row_counts} for {args.draws} draws")
    # one launch per draw, and one in the transition the mfu block counts
    check(row_counts["paired_sums"] == args.draws + 1,
          f"paired_sums launched {row_counts['paired_sums']} times for {args.draws} draws "
          f"+ the FLOP count's transition")
    check(row_counts["merge_sums"] == 0 and row_counts["leapfrog_update"] == 0,
          f"unexpected launches in the row: {row_counts}")
    expect_tiled_only("operator row (C = 48)", row_counts)
    # every bf16 field call (warm start and trajectories) on the fused stacks:
    # pack + forward + one backward launch per layer of the nine
    per_call = 2 + max(cfg.depth_branch, cfg.depth_trunk)
    check(row_counts["field_stacks"] > 0 and row_counts["field_stacks"] % per_call == 0,
          f"field_stacks launched {row_counts['field_stacks']} times, not {per_call} per call")
    print(f"  fused field stacks: {row_counts['field_stacks'] // per_call} field calls")
    acc = stats["acceptance"]
    steps = stats["step_quartiles"]
    check(math.isfinite(acc) and acc > 0.0, f"acceptance {acc}")
    check(len(steps) == 4 and all(math.isfinite(s) and s > 0 for s in steps),
          f"step quartiles {steps}")
    check(stats["samples_finite"], "non-finite samples")
    check(stats["samples_shape"] == [48, args.draws // 3, d],
          f"samples shape {stats['samples_shape']}")
    print(f"  acceptance {acc:.4f}; step quartiles {steps}")
    print(f"  draws/s {stats['draws_per_s']:.3f} (each draw moves 48 chains; "
          f"{48 * stats['draws_per_s']:.1f} chain-draws/s)")
    print("  phases (s): " + ", ".join(f"{k_} {v:.2f}" for k_, v in stats["phases_s"].items()))
    print(f"  segment walls (s): {stats['seg_wall_s']}")
    print(f"  lowrank metric: {stats['lowrank_metric']}")
    check_mfu("operator row", stats)
    print("  diagnostics (reduced depth): " + json.dumps(
        {k_: stats.get(k_) for k_ in ("ess_median", "ess_bulk_median", "ess_min",
                                      "rhat_max")}))
    phase("3 operator row", t0)

    # ---- phase 4: where a row draw's time goes (after the counts were read) ----
    t0 = time.perf_counter()
    grad_ms = time_device("row Gram field", lambda: field(q0, aux), SPLIT_REPS)

    def feature_forwards():
        with true_f32():
            for q in (q1, q0):
                deeponet_features(cfg, unravel_deeponet(cfg, scatter_subspace(aux, q, spec.idx)),
                                  problem.branch_x, problem.trunk_x)

    feat_ms = time_device("row feature forwards", feature_forwards, SPLIT_REPS)
    delta_ms = time_device("row delta", lambda: delta(q1, q0, aux), SPLIT_REPS)
    cotangent_step_times(problem, q0, args.timing_reps)
    kernel_rows["field_stacks"] = field_stack_times(
        cfg, problem.branch_x, problem.trunk_x, scatter_subspace(aux, q0, spec.idx),
        args.timing_reps)
    draw_ms = 1e3 / stats["draws_per_s"]
    parts = {"gram_field_x4": 4 * grad_ms, "delta_feature_forwards": feat_ms,
             "paired_sums": ms, "delta_rest": delta_ms - feat_ms - ms}
    parts["rest_of_draw"] = draw_ms - sum(parts.values())
    print(f"  per draw at C=48 (device time, mean of {SPLIT_REPS} queued calls): sampling "
          f"wall {draw_ms:.2f} ms = "
          + ", ".join(f"{k_} {v:.2f} ms ({100 * v / draw_ms:.1f} %)" for k_, v in parts.items()))
    del problem, delta, field, q0, q1, p0
    torch.cuda.empty_cache()
    # the FNO field's fused projection beside the field stacks
    kernel_rows["fno_project"] = fno_project_times(dev, args.timing_reps)
    fno_counts = fno_field_counts(dev)
    phase("4 row per-draw breakdown", t0)

    # ---- phase 5: the stage-3 kernels against their plain versions ----
    t0 = time.perf_counter()
    data = get_burgers(dev)
    arts = load_stage12_artifacts()
    print(f"  stage-3 data: train y {tuple(data[0]['solution'].shape)}, valid y "
          f"{tuple(data[1]['solution'].shape)}, subspace {len(arts['indices'])}")
    kernel_rows.update(stage3_kernels(dev, data[0], arts, args.timing_reps))
    torch.cuda.empty_cache()
    phase("5 stage-3 kernels vs plain", t0)

    # ---- phase 6: the stage-3 pipeline at full width, reduced depth ----
    t0 = time.perf_counter()
    s3 = dict(variant="autodiff", draws=args.s3_draws, burn=args.s3_burn, chains=16, L=31,
              segment=args.s3_segment, thin=3)
    for key_, full_val in (("draws", 450), ("burn", 90), ("segment", 90)):
        if s3[key_] != full_val:
            print(f"  depth cut: {key_} {s3[key_]} (stage-3 config {full_val})")
    # 1 density at init, then lp0 (recomputed) and lp1 per draw
    summary, out, s3_counts = run_stage3_path("stage 3", dev, data, arts,
                                              1 + 2 * s3["draws"], **s3)
    expect_tiled_only("stage 3 (C = 16)", s3_counts)
    n_lf = s3["L"]
    q, aux = out["result"].final_state.position, out["frozen"]
    grad_ms = time_device("stage-3 Gram field", lambda: out["grad_fn"](q, aux), SPLIT_REPS)
    dens_ms = time_device("stage-3 density", lambda: out["log_prob"](q, aux), SPLIT_REPS)
    draw_ms = 1e3 * summary["sampling_seconds"] / s3["draws"]
    parts = {f"gram_field_x{n_lf}": n_lf * grad_ms, "fused_density_x2": 2 * dens_ms}
    parts["rest_of_draw"] = draw_ms - sum(parts.values())
    print(f"  per stage-3 draw at C=16 (device time, mean of {SPLIT_REPS} queued calls): "
          f"sampling wall {draw_ms:.2f} ms = "
          + ", ".join(f"{k_} {v:.2f} ms ({100 * v / draw_ms:.1f} %)" for k_, v in parts.items())
          + f" (one Gram field {grad_ms:.3f} ms, one fused density {dens_ms:.3f} ms, of "
          f"which merge_sums {kernel_rows['merge_sums']['ms']:.3f} ms)")
    del out
    torch.cuda.empty_cache()
    phase("6 stage-3 pipeline", t0)

    # ---- phase 7: the autograd trajectory through the fused density ----
    t0 = time.perf_counter()
    s3a = dict(variant="autodiff", draws=args.autodiff_draws, burn=2, chains=16, L=4,
               segment=args.autodiff_draws, thin=1, use_gram=False)
    # init: the density and its clipped gradient (2); per draw: lp0, L
    # trajectory gradients (each runs the forward) and lp1
    run_stage3_path("stage 3, use_gram=False", dev, data, arts,
                    2 + s3a["draws"] * (s3a["L"] + 2), **s3a)
    torch.cuda.empty_cache()
    phase("7 autograd trajectory", t0)

    # ---- phase 8: stage 1 (VI) at full width, a few epochs ----
    t0 = time.perf_counter()
    with np.load(STAGE12_ASSET) as z:
        bundle = {k: z[k] for k in z.files}
    print(f"  depth cut: epochs {args.vi_epochs} (bundle {int(bundle['vi_epochs'])})")
    stage1_phase(dev, data, args.vi_epochs, bundle)
    torch.cuda.empty_cache()
    phase("8 stage 1 (VI)", t0)

    # ---- phase 9: stage 2 (sensitivity) at full width ----
    t0 = time.perf_counter()
    stage2_phase(dev, data[1], bundle)
    torch.cuda.empty_cache()
    phase("9 stage 2 (sensitivity)", t0)

    # ---- phase 10: stage 3 under REFRESH at full width, reduced depth ----
    t0 = time.perf_counter()
    s3r = dict(variant="autodiff", draws=args.refresh_draws, burn=args.refresh_draws // 2,
               chains=16, L=31,
               segment=args.refresh_draws // 2, thin=3, frozen_policy="refresh")
    print(f"  depth cut: draws {s3r['draws']}, burn {s3r['burn']}, segment {s3r['segment']} "
          f"(stage-3 config 450, 90, 90)")
    calls, restore = count_gram_calls()
    try:
        # 1 density at init, then per draw lp0 at the new frozen vectors and lp1
        r_summary, r_out, _ = run_stage3_path("stage 3 REFRESH", dev, data, arts,
                                              1 + 2 * s3r["draws"], **s3r)
    finally:
        restore()
    per_draw = (calls[0] - 1) / s3r["draws"]
    aux = r_out["result"].final_state.aux
    print(f"  REFRESH: Gram field calls {calls[0]} = 1 + {per_draw:.2f} per draw (L + 1 = "
          f"{s3r['L'] + 1}); frozen vectors {tuple(aux.shape)}; acceptance "
          f"{r_out['result'].acceptance_rate:.4f} and {r_summary['draws_per_s']:.3f} draws/s "
          f"beside DRAW (phase 6) {summary['acceptance']:.4f} and "
          f"{summary['draws_per_s']:.3f} draws/s")
    check(per_draw == s3r["L"] + 1, f"REFRESH: {per_draw} Gram calls per draw")
    check(aux.shape == (16, arts["mu"].size) and not torch.equal(aux[0], aux[1]),
          "REFRESH: every chain must carry its own frozen vector")
    del r_out
    torch.cuda.empty_cache()
    phase("10 stage 3 REFRESH", t0)

    # ---- phase 11: the NN flow ----
    t0 = time.perf_counter()
    with np.load(NN_BUNDLE) as z:
        nn_bundle = {k: z[k] for k in z.files}
    print(f"  depth cut: NN VI epochs {args.nn_epochs} (bundle {int(nn_bundle['vi_epochs'])})")
    nn_flow_phase(dev, args.nn_epochs, nn_bundle)
    phase("11 NN flow", t0)

    # ---- phase 12: stage 3, variant stride (the script's default) ----
    t0 = time.perf_counter()
    s3s = dict(variant="stride", draws=args.stride_draws, burn=args.stride_draws // 2,
               chains=16, L=31, segment=args.stride_draws // 2, thin=3)
    print(f"  depth cut: draws {s3s['draws']}, burn {s3s['burn']}, segment {s3s['segment']} "
          f"(stage-3 config 450, 90, 90)")
    calls, restore = count_gram_calls()
    try:
        st_summary, st_out, _ = run_stage3_path("stage 3 stride", dev, data, arts,
                                                1 + 2 * s3s["draws"], **s3s)
    finally:
        restore()
    print(f"  stride: Gram field calls {calls[0]} (1 + L x draws = "
          f"{1 + s3s['L'] * s3s['draws']}); {st_summary['draws_per_s']:.3f} draws/s beside "
          f"the autodiff variant's {summary['draws_per_s']:.3f} (phase 6)")
    check(calls[0] == 1 + s3s["L"] * s3s["draws"], f"stride: {calls[0]} Gram calls")
    check(st_summary["trajectory_field"] == "gram_stride_3x3_f32",
          f"stride field {st_summary['trajectory_field']}")
    stride_field_cosine(dev, data[0], st_out)
    stage3_split_line("stage-3 stride", st_out, st_summary, s3s["draws"], s3s["L"],
                      kernel_rows["merge_sums"]["ms"])
    q_st, aux_st = st_out["result"].final_state.position, st_out["frozen"]
    profile_line("stride field (host dispatch against device time)",
                 lambda: st_out["grad_fn"](q_st, aux_st), 10)
    del st_out
    torch.cuda.empty_cache()
    phase("12 stage 3 stride", t0)

    # ---- phase 13: stage 3, variant gauss ----
    t0 = time.perf_counter()
    s3g = dict(variant="gauss", draws=args.gauss_draws, burn=args.gauss_draws // 2,
               chains=16, L=31, segment=args.gauss_draws // 2, thin=3)
    print(f"  depth cut: draws {s3g['draws']}, burn {s3g['burn']}, segment {s3g['segment']} "
          f"(stage-3 config 450, 90, 90)")
    calls, restore = count_gram_calls()
    try:
        g_summary, g_out, _ = run_stage3_path("stage 3 gauss", dev, data, arts,
                                              1 + 2 * s3g["draws"], **s3g)
    finally:
        restore()
    print(f"  gauss: step {g_summary['step']:.5g} (0.8 d^-1/4), Gram field calls {calls[0]}; "
          f"{g_summary['draws_per_s']:.3f} draws/s beside stride {st_summary['draws_per_s']:.3f} "
          f"and autodiff {summary['draws_per_s']:.3f}")
    check(calls[0] == 0, f"gauss: {calls[0]} Gram field calls")
    stage3_split_line("stage-3 gauss", g_out, g_summary, s3g["draws"], s3g["L"],
                      kernel_rows["merge_sums"]["ms"])
    del g_out
    torch.cuda.empty_cache()
    phase("13 stage 3 gauss", t0)

    # ---- phase 14: stage 3 autodiff with the Lanczos low-rank metric ----
    t0 = time.perf_counter()
    s3l = dict(variant="autodiff", draws=args.lowrank_draws, burn=args.lowrank_draws // 2,
               chains=16, L=31, segment=args.lowrank_draws, thin=1,
               lowrank_rank=args.lowrank_rank)
    print(f"  depth cut: draws {s3l['draws']} (stage-3 config 450); rank "
          f"{args.lowrank_rank} (no script default)")
    # the HVP graph's forward (1), the init (1), then lp0 and lp1 per draw
    l_summary, l_out, _ = run_stage3_path("stage 3 low-rank", dev, data, arts,
                                          2 + 2 * s3l["draws"], **s3l)
    im = l_out["inv_mass"]
    print(f"  low-rank metric: Lanczos wall {l_summary['phases_s']['lanczos_s']:.2f} s for rank "
          f"{args.lowrank_rank}; Ritz values floored at 1 -> mass {tuple(im.u.shape)}; "
          f"{l_summary['draws_per_s']:.3f} draws/s")
    check(tuple(im.u.shape) == (len(arts["indices"]), args.lowrank_rank)
          and bool(torch.isfinite(im.u).all()), "low-rank metric")
    del l_out
    torch.cuda.empty_cache()
    phase("14 stage 3 low-rank metric", t0)

    # ---- phase 15: hmc_nuts (full-parameter, dual averaging, fused density) ----
    t0 = time.perf_counter()
    ncfg = OperatorHMCRunConfig()
    print(f"  OperatorHMCRunConfig: n_train {ncfg.n_train}, L {ncfg.L}, draws "
          f"{ncfg.num_samples}, burn {ncfg.burn}; chains {args.nuts_chains} (config 1)")
    n_train, n_valid, _ = hmc_nuts.load_data(ncfg, dev)
    apply_n = make_flat_deeponet(ncfg.model)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    flat_n = 0.1 * torch.randn((args.nuts_chains, ncfg.model.num_params), generator=gen,
                               device=dev)
    with true_f32():
        bo, to = deeponet_features(ncfg.model, unravel_deeponet(ncfg.model, flat_n),
                                   n_train["branch_in"], n_train["trunk_in"])
    bo, to = bo.contiguous(), to.contiguous()
    y_n = n_train["solution"]
    # at B = 10 the small kernel (row 4's B = 10 line), held and timed against the tiled one
    n_small = profiling.counter("merge_sums.launches_small")
    compare_merge(f"hmc_nuts shape C={args.nuts_chains} B={bo.shape[1]} P={to.shape[1]} "
                  f"K={bo.shape[2]}", bo, to, flat_n[:, 0].contiguous(), y_n, ncfg.tau_out,
                  main=True)
    check(profiling.counter("merge_sums.launches_small") == n_small + 2,
          "hmc_nuts shape: not the small kernel")
    n_t = paths_in_turns(f"merge_sums C={bo.shape[0]} B={bo.shape[1]} P={to.shape[1]} "
                         f"K={bo.shape[2]}", _merge_launch, (bo, to, y_n), args.timing_reps,
                         merge_sums_bound_ms(*bo.shape[:2], to.shape[1], bo.shape[2]))
    n_plain = time_device("merge_sums plain at B=10", lambda: merge_sums_reference(bo, to, y_n),
                          SPLIT_REPS, warmup=1)
    print(f"  merge_sums plain at C={bo.shape[0]} B={bo.shape[1]}: {n_plain:.4f} ms")
    del bo, to
    # the config's one chain, then phase 15's chains: every density on the small kernel
    for chains in dict.fromkeys((1, args.nuts_chains)):
        reset_counts()
        n_out = hmc_nuts.run(ncfg, data=(n_train, n_valid), num_chains=chains,
                             use_fused=True, seed=0, device=dev)
        n_counts = read_counts()
        baseline_checks(f"hmc_nuts ({chains} chains)", n_out, n_counts,
                        1 + 2 * ncfg.num_samples)
        check(n_counts["merge_sums_small"] == n_counts["merge_sums"],
              f"hmc_nuts ({chains} chains): merge_sums off the small kernel {n_counts}")
    res = n_out["result"]
    post = res.step_sizes[:, ncfg.burn:]
    frozen_step = torch.exp(res.final_state.da.log_step_avg).cpu().numpy()
    print(f"  hmc_nuts steps after burn {[float('%.6g' % s) for s in post[:, 0]]}, "
          f"exp(log_step_avg) {[float('%.6g' % s) for s in frozen_step]}")
    check(bool((post == post[:, :1]).all()), "hmc_nuts: step not constant after burn")
    check(np.allclose(post[:, 0], frozen_step, rtol=1e-6, atol=0.0),
          "hmc_nuts: step after burn is not exp(log_step_avg)")
    del n_out
    torch.cuda.empty_cache()
    phase("15 hmc_nuts", t0)

    # ---- phase 16: hmc_split (split Hamiltonian over 2 data shards) ----
    t0 = time.perf_counter()
    scfg = dataclasses.replace(SplitHMCRunConfig(), num_samples=args.split_draws)
    print(f"  depth cut: draws {scfg.num_samples}, burn {scfg.burn} (config 1001, 500); "
          f"n_train {scfg.n_train} in {scfg.num_splits} shards, L {scfg.L}")
    s_train, s_valid, used = hmc_nuts.load_data(scfg, dev)
    print(f"  n_valid {scfg.n_valid} capped at the {used} exported validation rows")
    reset_counts()
    s_out = hmc_split.run(scfg, data=(s_train, s_valid), num_chains=1, seed=0, device=dev)
    # from the config's random start (0.1 N(0, 1) over 172,401 parameters)
    # every proposal at its step 3.45e-4 diverges: the chain never moves. JAX
    # does the same: the full-width witness in tests/test_torch_baselines.py
    # gives both packages a non-finite first dH on the 1000 functions and the
    # same divergent draws
    baseline_checks("hmc_split", s_out, read_counts(), 0, need_accept=False)
    print(f"  hmc_split at the config's step: {s_out['result'].num_divergent} of "
          f"{scfg.num_samples} draws divergent (|dH| > 1000 nats from the random start)")
    split_trajectory_check(s_out, scfg)
    del s_out, s_train, s_valid
    torch.cuda.empty_cache()
    phase("16 hmc_split", t0)

    # ---- phase 17: hmc_full (the regression MLP) ----
    t0 = time.perf_counter()
    fcfg = dataclasses.replace(NNHMCRunConfig(), num_samples=args.full_draws)
    print(f"  depth cut: draws {fcfg.num_samples}, burn {fcfg.burn} (config 1000, 200); "
          f"L {fcfg.L}, {fcfg.num_chains} chain")
    reset_counts()
    f_out = hmc_full.run(fcfg, seed=0, device=dev)
    baseline_checks("hmc_full", f_out, read_counts(), 0)
    print(f"  hmc_full: {1e3 * f_out['phases_s']['sampling_s'] / (fcfg.num_samples * fcfg.L):.3f}"
          f" ms per leapfrog step of the {fcfg.model.num_params}-parameter MLP")
    phase("17 hmc_full", t0)

    # ---- phase 18: the NN bench row at full width ----
    t0 = time.perf_counter()
    nn_row_phase(dev)
    torch.cuda.empty_cache()
    phase("18 NN row", t0)

    # ---- phase 19: stage 3 under NUTS (every leaf one fused density) ----
    t0 = time.perf_counter()
    s3n = dict(variant="stride", algorithm="nuts", nuts_max_depth=NUTS_DEPTH,
               draws=S3_NUTS_DRAWS, burn=S3_NUTS_DRAWS // 2, chains=16, L=31,
               segment=S3_NUTS_DRAWS, thin=1)
    print(f"  depth cut: nuts_max_depth {s3n['nuts_max_depth']} (config 6), draws "
          f"{s3n['draws']}, burn {s3n['burn']} (stage-3 config 450, 90)")
    # 1 density at init (NUTS keeps lp0 in its state), then every leaf
    nuts_chees_phase("stage 3 nuts", dev, data, arts,
                     1 + (2 ** s3n["nuts_max_depth"] - 1) * s3n["draws"], **s3n)
    phase("19 stage 3 nuts", t0)

    # ---- phase 20: stage 3 under ChEES (the density at the end point) ----
    t0 = time.perf_counter()
    s3c = dict(variant="stride", algorithm="chees", chees_max_steps=CHEES_MAX_STEPS,
               draws=S3_CHEES_DRAWS, burn=S3_CHEES_DRAWS // 2, chains=16, L=31,
               segment=S3_CHEES_DRAWS, thin=1)
    print(f"  depth cut: chees_max_steps {s3c['chees_max_steps']} (config 256), draws "
          f"{s3c['draws']}, burn {s3c['burn']}")
    nuts_chees_phase("stage 3 chees", dev, data, arts, 1 + s3c["draws"], **s3c)
    phase("20 stage 3 chees", t0)

    # ---- phase 21: the adaptive metric and momentum persistence ----
    t0 = time.perf_counter()
    adaptive_metric_phase(dev)
    torch.cuda.empty_cache()
    phase("21 adaptive metric", t0)

    with tempfile.TemporaryDirectory() as tmp:
        # ---- phase 22: the command line on the card ----
        t0 = time.perf_counter()
        cli_phase(dev, tmp)
        torch.cuda.empty_cache()
        phase("22 command line", t0)

        # ---- phase 23: resume at full width ----
        t0 = time.perf_counter()
        stride_draw_s = resume_phase(dev, data, arts, tmp)
        phase("23 resume", t0)

        # ---- phase 24: query subsampling at full width ----
        t0 = time.perf_counter()
        subsample_phase(dev, data, arts, tmp, stride_draw_s)
        phase("24 query subsampling", t0)

    # ---- phase 25: the Cone flow at full width (per-example query points) ----
    t0 = time.perf_counter()
    cone_phase(dev)
    torch.cuda.empty_cache()
    phase("25 Cone flow", t0)

    # ---- phase 26: the learned noise and the heteroscedastic head ----
    t0 = time.perf_counter()
    noise_phase(dev, data)
    torch.cuda.empty_cache()
    phase("26 learned noise", t0)

    # ---- phase 27: the chain mesh on the card ----
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mesh = mesh_phase(dev, data, arts, tmp)
    torch.cuda.empty_cache()
    phase("27 mesh on the card", t0)

    # ---- phase 28: bench.py's row through python -m vihmc_torch.bench ----
    t0 = time.perf_counter()
    row28 = bench_row_phase(dev, args.timing_reps)
    kernel_rows["merge_sums_small"] = row28["merge_sums_small"]
    phase("28 bench.py row", t0)

    # ---- phase 29: the result scripts ----
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        scripts = scripts_phase(dev, tmp)
    torch.cuda.empty_cache()
    phase("29 result scripts", t0)

    launches = {"paired_sums": row_counts["paired_sums"],
                "paired_sums_small": row_counts["paired_sums_small"],
                "merge_sums": s3_counts["merge_sums"],
                "leapfrog_update": s3_counts["leapfrog_update"],
                "merge_sums_small": row28["grad_merge_sums_small"],
                "field_stacks": row_counts["field_stacks"],
                "fno_project": fno_counts["fno_project"]}
    print("  launches per kernel on its main path: paired_sums and its small kernel and the "
          "fused field stacks in the operator row (phase 3), the fused FNO projection in one "
          "bf16 FNO field call (phase 4), merge_sums and leapfrog_update in stage 3 (phase 6), "
          "merge_sums' small kernel in --extras' fused gradient (phase 28 (c)); each counted "
          "by its wrapper where it launches: " + json.dumps(launches))
    print(f"  merge_sums in the stage-3 script (phase 29 (b)): "
          f"{scripts['stage3_merge_sums']} launches")
    print(f"  paired_sums on bench.py's row (phase 28): {row28['row_paired_sums']} launches in "
          f"(a); at C = 32 on the 90 % row {row28['paired_sums_c32_ms']:.3f} ms (bound "
          f"{row28['paired_sums_c32_bound_ms']:.3f} ms)")
    print(f"  merge_sums on the two-rank mesh path (phase 27): "
          f"{mesh['mesh_launches_per_rank']} launches per rank, "
          f"{mesh['merge_sums_c8_ms']:.3f} ms at C=8 (bound {mesh['merge_sums_c8_bound_ms']:.3f} ms)")
    print(json.dumps({"kernels": [dict(name=n, **KERNELS[n], launches=launches[n],
                                       **kernel_rows[n], library_ms=None)
                                  for n in KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
