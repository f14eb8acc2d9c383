"""Weight-space symmetry canonicalization for tanh MLPs and DeepONets.

Counterpart of ``vihmc_tpu/models/symmetry.py``. A tanh network computes the
same function when a hidden unit's incoming row and bias and its outgoing
column are negated (tanh(-z) = -tanh(z)), and when the hidden units of a
layer are permuted. The DeepONet's dot-product merge adds a per-channel
symmetry: channel k of the branch's and the trunk's final layers negated (or
permuted) together leaves ``sum_k branch_k trunk_k`` unchanged.

HMC chains can settle in different elements of one function's orbit, and
coordinate-wise R-hat then reports a disagreement the functions do not have.
Canonicalization maps every draw to the element of its orbit best aligned
with a fixed reference vector (the VI mean): sign flips by default, and
with ``permute`` one linear assignment per (draw, layer)
(``scipy.optimize.linear_sum_assignment``). The map is orbit-invariant: a
layer's decision reads only its incoming rows and bias, and layers are
fixed front to back.

Draws are ``(N, D)`` host arrays (numpy, or tensors, which are copied to
the host) in the model's flat layout (per layer the bias, then the row-major
``(out, in)`` weight; the DeepONet's merge bias first), computed in float64.
The MLP layout is the port's (:func:`~vihmc_torch.models.mlp.mlp_slices`),
which leaves out the last layer's bias when ``last_bias`` is False; JAX's
``mlp_layout`` always counts one.
"""

from __future__ import annotations

import numpy as np

from vihmc_torch.models.deeponet import param_slices
from vihmc_torch.models.mlp import mlp_slices


def _layout(slices):
    """``[(b_slice, w_slice, (d_out, d_in)), ...]`` of a stack of
    :class:`~vihmc_torch.core.ravel.LinearSlice`."""
    return [(slice(s.b, s.w), slice(s.w, s.end), (s.d_out, s.d_in)) for s in slices]


def mlp_layout(cfg):
    """Layer slices of the MLP's flat vector."""
    return _layout(mlp_slices(cfg)[0])


def deeponet_layout(cfg):
    """``(branch_layers, trunk_layers)`` slices of the DeepONet's flat vector
    (``flat[0]`` is the merge bias)."""
    sl = param_slices(cfg)
    return _layout(sl["branch"]), _layout(sl["trunk"])


def _host(draws) -> np.ndarray:
    if hasattr(draws, "detach"):
        draws = draws.detach().cpu().numpy()
    return np.asarray(draws)


def _views(draws, layer):
    b_sl, w_sl, (d_out, d_in) = layer
    return (draws[:, b_sl],                                   # (N, d_out) or (N, 0)
            draws[:, w_sl].reshape(draws.shape[0], d_out, d_in))


def _assignment(score):
    """``perm`` with ``perm[v]`` the unit placed at slot v, maximizing the
    summed ``|score[perm[v], v]|``."""
    from scipy.optimize import linear_sum_assignment

    row, col = linear_sum_assignment(-np.abs(score))
    perm = np.empty_like(col)
    perm[col] = row
    return perm


def _signs(values):
    sign = np.sign(values)
    sign[sign == 0] = 1.0
    return sign


def _canonicalize_stack(draws, ref, layers, permute):
    """In place: sign (and with ``permute`` order) canonicalization of the
    hidden layers of one stack, scored on each unit's incoming row and bias
    against ``ref``. The final layer's rows are left to the caller."""
    n = draws.shape[0]
    for i in range(len(layers) - 1):
        b, w = _views(draws, layers[i])
        b_next, w_next = _views(draws, layers[i + 1])
        rb, rw = _views(ref, layers[i])
        if permute:
            a = np.einsum("nui,vi->nuv", w, rw[0]) + b[:, :, None] * rb[0][None, None, :]
            for k in range(n):
                perm = _assignment(a[k])
                sign = _signs(a[k][perm, np.arange(len(perm))])
                w[k] = w[k][perm] * sign[:, None]
                b[k] = b[k][perm] * sign
                w_next[k] = w_next[k][:, perm] * sign[None, :]
        else:
            score = np.einsum("nui,ui->nu", w, rw[0]) + b * rb[0][None]
            sign = np.where(score < 0, -1.0, 1.0)
            w *= sign[:, :, None]
            b *= sign
            w_next *= sign[:, None, :]
        draws[:, layers[i][0]] = b
        draws[:, layers[i][1]] = w.reshape(n, -1)
        draws[:, layers[i + 1][0]] = b_next
        draws[:, layers[i + 1][1]] = w_next.reshape(n, -1)


def canonicalize_mlp(draws, ref, cfg, permute: bool = False) -> np.ndarray:
    """Canonicalize tanh-MLP flat draws ``(N, D)`` or ``(D,)`` against ``ref``
    (e.g. the VI mean); float64, the same shape. Only for odd activations
    (tanh, sine): a relu network has a scaling symmetry, not a sign one."""
    one = np.ndim(draws) == 1
    draws = np.array(np.atleast_2d(_host(draws)), dtype=np.float64, copy=True)
    ref = np.asarray(_host(ref), np.float64)[None]
    _canonicalize_stack(draws, ref, mlp_layout(cfg), permute)
    return draws[0] if one else draws


def canonicalize_deeponet(draws, ref, cfg, permute: bool = False) -> np.ndarray:
    """Canonicalize DeepONet flat draws ``(N, D)`` or ``(D,)`` against ``ref``.

    The hidden units of the branch and trunk stacks, then the merge channels
    (rows of both final layers moved together). A permutation never crosses
    the mean/noise head boundary when ``cfg.noise_neurons > 0``: the two
    heads merge disjoint channel ranges, ``[0, K - n)`` and ``[K - n, K)``, so
    the assignment is solved per head block; sign flips apply to every
    channel.
    """
    one = np.ndim(draws) == 1
    draws = np.array(np.atleast_2d(_host(draws)), dtype=np.float64, copy=True)
    refv = np.asarray(_host(ref), np.float64)[None]
    branch, trunk = deeponet_layout(cfg)
    _canonicalize_stack(draws, refv, branch, permute)
    _canonicalize_stack(draws, refv, trunk, permute)

    n = draws.shape[0]
    bb, wb = _views(draws, branch[-1])
    bt, wt = _views(draws, trunk[-1])
    rbb, rwb = _views(refv, branch[-1])
    rbt, rwt = _views(refv, trunk[-1])
    if permute:
        a = (np.einsum("nki,ji->nkj", wb, rwb[0]) + np.einsum("nki,ji->nkj", wt, rwt[0])
             + bb[:, :, None] * rbb[0][None, None, :] + bt[:, :, None] * rbt[0][None, None, :])
        k_total = wb.shape[1]
        k_main = k_total - cfg.noise_neurons
        blocks = [np.arange(0, k_main)]
        if k_main < k_total:
            blocks.append(np.arange(k_main, k_total))
        for k in range(n):
            perm = np.empty(k_total, dtype=np.int64)
            for blk in blocks:
                perm[blk] = blk[_assignment(a[k][np.ix_(blk, blk)])]
            sign = _signs(a[k][perm, np.arange(k_total)])
            wb[k] = wb[k][perm] * sign[:, None]
            bb[k] = bb[k][perm] * sign
            wt[k] = wt[k][perm] * sign[:, None]
            bt[k] = bt[k][perm] * sign
    else:
        score = (np.einsum("nki,ki->nk", wb, rwb[0]) + bb * rbb[0][None]
                 + np.einsum("nki,ki->nk", wt, rwt[0]) + bt * rbt[0][None])
        sign = np.where(score < 0, -1.0, 1.0)
        wb *= sign[:, :, None]
        bb *= sign
        wt *= sign[:, :, None]
        bt *= sign
    draws[:, branch[-1][0]] = bb
    draws[:, branch[-1][1]] = wb.reshape(n, -1)
    draws[:, trunk[-1][0]] = bt
    draws[:, trunk[-1][1]] = wt.reshape(n, -1)
    return draws[0] if one else draws


def random_orbit_element(seed: int, flat, cfg, kind: str = "deeponet",
                         permute: bool = True) -> np.ndarray:
    """A random element of ``flat``'s symmetry orbit (float64): every hidden
    unit's sign flipped at random and, with ``permute``, the units of each
    layer permuted (the DeepONet's merge channels within each head block).
    It computes the same function. ``numpy.random.default_rng(seed)`` draws
    the flips and permutations in JAX's order (the JAX package's test
    utility of the same name)."""
    rng = np.random.default_rng(seed)
    out = np.array(_host(flat), np.float64, copy=True)[None]

    def scramble_stack(layers):
        for i in range(len(layers) - 1):
            b, w = _views(out, layers[i])
            b_next, w_next = _views(out, layers[i + 1])
            d_out = w.shape[1]
            sign = rng.choice([-1.0, 1.0], size=d_out)
            perm = rng.permutation(d_out) if permute else np.arange(d_out)
            w[0] = w[0][perm] * sign[:, None]
            b[0] = b[0][perm] * sign
            w_next[0] = w_next[0][:, perm] * sign[None, :]
            out[:, layers[i][0]] = b
            out[:, layers[i][1]] = w.reshape(1, -1)
            out[:, layers[i + 1][0]] = b_next
            out[:, layers[i + 1][1]] = w_next.reshape(1, -1)

    if kind == "mlp":
        scramble_stack(mlp_layout(cfg))
        return out[0]
    branch, trunk = deeponet_layout(cfg)
    scramble_stack(branch)
    scramble_stack(trunk)
    bb, wb = _views(out, branch[-1])
    bt, wt = _views(out, trunk[-1])
    k_lat = wb.shape[1]
    sign = rng.choice([-1.0, 1.0], size=k_lat)
    perm = np.arange(k_lat)
    if permute:
        k_main = k_lat - cfg.noise_neurons
        perm[:k_main] = rng.permutation(k_main)
        if k_main < k_lat:
            perm[k_main:] = k_main + rng.permutation(k_lat - k_main)
    wb[0] = wb[0][perm] * sign[:, None]
    bb[0] = bb[0][perm] * sign
    wt[0] = wt[0][perm] * sign[:, None]
    bt[0] = bt[0][perm] * sign
    out[:, branch[-1][0]] = bb
    out[:, branch[-1][1]] = wb.reshape(1, -1)
    out[:, trunk[-1][0]] = bt
    out[:, trunk[-1][1]] = wt.reshape(1, -1)
    return out[0]
