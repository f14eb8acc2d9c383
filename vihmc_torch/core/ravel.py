"""Flat parameter layout and subspace scatter/gather.

Counterpart of ``vihmc_tpu/core/ravel.py``. The JAX package flattens its
parameter pytrees with ``jax.flatten_util.ravel_pytree``, which walks dict
keys in sorted order. For a stack of linear layers stored as ``{'w', 'b'}``
dicts that puts each layer's bias BEFORE its weight, and the weight is
``(out, in)`` row-major. The port keeps that order exactly, so a flat vector
means the same parameters on both sides (``tests/test_torch_core.py`` checks
it against ``ravel_pytree``).

Every function here on flat vectors takes a leading chain dimension: a
flat batch is ``(C, D)``. For parameter trees (nested dicts, lists and
tuples of tensors, as the hamiltorch-style API takes them) there is the same
walk as ``ravel_pytree``: :func:`tree_leaves`, :func:`ravel_pytree` (alias
:func:`ravel_tree`), :func:`segment_sizes`, :func:`segment_slices` and
:func:`per_segment_vector`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LinearSlice:
    """Offsets of one linear layer inside the flat vector (bias, then weight)."""

    b: int
    w: int
    d_in: int
    d_out: int

    @property
    def end(self) -> int:
        return self.w + self.d_in * self.d_out


def stack_slices(dims, start: int, biases=None):
    """Slices of a stack of linear layers ``dims = [(d_in, d_out), ...]``
    laid out from ``start``; ``biases[i]`` False leaves layer i without a
    bias (``b == w``). Returns ``(slices, end)``."""
    out, pos = [], start
    for i, (d_in, d_out) in enumerate(dims):
        n_b = d_out if biases is None or biases[i] else 0
        sl = LinearSlice(b=pos, w=pos + n_b, d_in=d_in, d_out=d_out)
        out.append(sl)
        pos = sl.end
    return out, pos


def unravel_stack(flat: torch.Tensor, slices):
    """Per-layer ``(w (C, out, in), b (C, out) or None)`` views of a ``(C, D)`` batch."""
    c = flat.shape[0]
    return [(flat[:, s.w:s.end].reshape(c, s.d_out, s.d_in),
             flat[:, s.b:s.w] if s.w > s.b else None) for s in slices]


def scatter_subspace(frozen: torch.Tensor, sub: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """Full ``(C, D)`` vectors: ``frozen`` (D,) or (C, D) with ``sub`` (C, d)
    written at ``idx``."""
    full = frozen.expand(sub.shape[0], -1).clone()
    full[:, idx] = sub
    return full


def gather_subspace(full: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Subspace coordinates ``(C, d)`` of full ``(C, D)`` vectors."""
    return full[:, idx]


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list/tuple in ``ravel_pytree`` order
    (dict keys sorted, sequences in order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def map_leaves(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``, leaves visited in
    ``ravel_pytree`` order."""
    if isinstance(tree, dict):
        out = {k: map_leaves(fn, tree[k]) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return fn(tree)


def segment_sizes(tree) -> list:
    """Elements of each leaf of ``tree``, in ``ravel_pytree`` order."""
    return [int(np.prod(np.shape(leaf))) for leaf in tree_leaves(tree)]


def segment_slices(tree) -> list:
    """``(start, stop)`` of each leaf inside the raveled vector."""
    bounds = np.cumsum([0] + segment_sizes(tree))
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def ravel_tree(tree):
    """``(flat (D,), unravel)`` of a tree of tensors: the leaves raveled
    row-major and concatenated in ``ravel_pytree`` order; ``unravel(flat)``
    rebuilds the tree (views into ``flat``)."""
    leaves = [torch.as_tensor(leaf) for leaf in tree_leaves(tree)]
    shapes = [leaf.shape for leaf in leaves]
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves]) if leaves else torch.zeros(0)

    def unravel(vec):
        it = iter(range(len(shapes)))
        offsets = np.cumsum([0] + [int(np.prod(s)) for s in shapes])

        def build(node):
            if isinstance(node, dict):
                return {k: build(node[k]) for k in sorted(node)}
            if isinstance(node, (list, tuple)):
                return type(node)(build(v) for v in node)
            i = next(it)
            return vec[offsets[i]:offsets[i + 1]].reshape(shapes[i])

        return build(tree)

    return flat, unravel


def per_segment_vector(tree, values) -> torch.Tensor:
    """One scalar per leaf of ``tree``, broadcast into a flat ``(D,)`` f32
    vector laid out as :func:`ravel_tree` lays out the tree (the per-tensor
    prior scales of the reference's ``tau_list``)."""
    sizes = segment_sizes(tree)
    vals = list(values)
    if len(vals) != len(sizes):
        raise ValueError(f"{len(vals)} values for {len(sizes)} leaves")
    parts = [torch.full((n,), float(v), dtype=torch.float32) for n, v in zip(sizes, vals)]
    return torch.cat(parts) if parts else torch.zeros(0)


#: JAX's name for :func:`ravel_tree`
ravel_pytree = ravel_tree
