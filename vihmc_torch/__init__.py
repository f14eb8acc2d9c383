"""PyTorch/CUDA port of the VI-HMC framework (``vihmc_tpu`` is the reference).

Module names follow ``vihmc_tpu`` so each function's counterpart is easy to
find. Chains are a leading batch dimension on every tensor; every random draw
comes from an explicit ``torch.Generator``; entry points take ``device`` and
default to ``"cuda"``. The package imports ``torch`` and never JAX.

The hand-written CUDA kernel of this slice is ``ops.deeponet_merge.paired_sums``
(source ``csrc/paired_sums.cu``), built with ``nvcc`` at first use.
"""

__version__ = "0.1.0"
