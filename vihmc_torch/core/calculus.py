"""Dense derivatives of functions of parameter trees, and the NaN/Inf guard.

Counterpart of ``vihmc_tpu/core/calculus.py``: the reference's vendored
``gradient``/``jacobian``/``hessian`` helpers and its ``has_nan_or_inf`` /
``LogProbError`` pair. Each derivative flattens the input tree to one vector
in ``ravel_pytree`` order (:func:`~vihmc_torch.core.ravel.ravel_pytree`) and
differentiates with ``torch.func``, so the result is one dense array over
every input leaf. The samplers never raise on a non-finite density (the
kernel rejects it); the guard is for host-side code.
"""

from __future__ import annotations

import torch

from vihmc_torch.core.ravel import ravel_pytree, tree_leaves


class LogProbError(RuntimeError):
    """A log-probability evaluation produced NaN or Inf."""


def has_nan_or_inf(value) -> bool:
    """True if any leaf of ``value`` (a tensor, an array, a scalar or a tree
    of them) holds NaN or +-Inf."""
    return any(not bool(torch.isfinite(torch.as_tensor(leaf)).all())
               for leaf in tree_leaves(value))


def _flat_fn(fn, inputs):
    flat0, unravel = ravel_pytree(inputs)
    return (lambda flat: fn(unravel(flat))), flat0


def gradient(fn, inputs) -> torch.Tensor:
    """``(D,)`` gradient of scalar ``fn`` at the tree ``inputs``."""
    flat_fn, flat0 = _flat_fn(fn, inputs)
    return torch.func.grad(flat_fn)(flat0)


def jacobian(fn, inputs) -> torch.Tensor:
    """``(O, D)`` Jacobian of ``fn`` at ``inputs``: the outputs (any tree)
    raveled to one axis of size O, the inputs to D."""
    flat_fn, flat0 = _flat_fn(fn, inputs)
    return torch.func.jacrev(lambda f: ravel_pytree(flat_fn(f))[0])(flat0)


def hessian(fn, inputs) -> torch.Tensor:
    """``(D, D)`` Hessian of scalar ``fn`` at ``inputs``."""
    flat_fn, flat0 = _flat_fn(fn, inputs)
    return torch.func.hessian(flat_fn)(flat0)
