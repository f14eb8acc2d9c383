"""PyTorch/CUDA port of the VI-HMC framework (``vihmc_tpu`` is the reference).

Module names follow ``vihmc_tpu`` so each function's counterpart is easy to
find. Chains are a leading batch dimension on every tensor; every random draw
comes from an explicit ``torch.Generator``; entry points take ``device`` and
default to ``"cuda"``. The package imports ``torch`` and never JAX.

The hand-written CUDA kernels (``csrc/``, built with ``nvcc`` at first use):
``ops.deeponet_merge.paired_sums`` (the operator row's paired MH delta),
``ops.deeponet_merge.merge_sums`` (the fused merge-NLL density of the stage-3
pipeline) and ``ops.leapfrog.fused_leapfrog_update``. Entry points: the command line
``python -m vihmc_torch <command>`` (``pipelines.cli``, the JAX package's
subcommands), ``python -m vihmc_torch.bench`` (``bench.py``'s command line:
the operator row of ``bench_operator`` and the NN row of ``bench_nn``),
``pipelines.vi_train`` (stages 1 and 2: VI training and sensitivity) and
``pipelines.vi_hmc`` (stage 3).
"""

__version__ = "0.1.0"
