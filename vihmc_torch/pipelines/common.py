"""Flat-vector model closures, log-densities and the MH delta evaluators.

Counterpart of ``vihmc_tpu/pipelines/common.py``: ``make_flat_mlp``
(:27-47), ``make_flat_deeponet`` (:50-66), ``make_log_posterior`` (:69-95), the VI-trainer adapters
``mlp_vi_apply`` and ``deeponet_vi_apply`` (:135-151), ``make_deeponet_nll_log_posterior`` (:98-128, the fused merge-NLL
density of the stage-3 pipeline), ``make_paired_subspace_delta`` (:154-192,
the composed plain path) and ``make_fused_paired_subspace_delta`` (:195-226,
the kernel path the operator row runs on the card), plus the preconditioned
Adam warm start both operator entry points share (``bench.py:883-922``,
``pipelines/vi_hmc.py:364-406``). Every closure takes chain-batched tensors:
flat ``(C, D)``, subspace ``(C, d)``; the frozen vector ``aux`` is ``(D,)``.

The Fourier neural operator (:mod:`vihmc_torch.models.fno`, no JAX
counterpart): ``fno_vi_apply`` (weight-space BBB for the VI trainer), and for
stage 3 ``make_fno_grad_full`` (the chain-batched
autograd field over function chunks), ``make_fno_nll_log_likelihood`` (the
IEEE-f32 density, per-function residual squares summed in float64) and
``make_fno_paired_subspace_delta`` (both endpoints' forwards in one pass, the
paired residuals summed in float64). Their function chunks come from
:func:`fno_chunks`: as many functions at once as ``max_bytes`` holds.
"""

from __future__ import annotations

import math

import torch

from vihmc_torch.core.precision import true_f32
from vihmc_torch.core.profiling import count, detail_span, span
from vihmc_torch.core.ravel import scatter_subspace
from vihmc_torch.dists.likelihoods import GNLL_EPS, get_likelihood, nll_log_likelihood
from vihmc_torch.models.bayesian import (bayesian_deeponet_apply, bayesian_fno_apply,
                                         bayesian_mlp_apply, check_mode)
from vihmc_torch.models.deeponet import (DeepONetConfig, bc_embedding, deeponet_apply,
                                         deeponet_features, unravel_deeponet)
from vihmc_torch.models.fno import (FNO2dConfig, fno_apply_chains, fno_field_bytes,
                                    fno_input)
from vihmc_torch.models.mlp import MLPConfig, mlp_apply, mlp_stack
from vihmc_torch.ops.deeponet_merge import (fused_merge_nll, fused_paired_delta,
                                            merge_nll_reference, y_sums)


def make_flat_mlp(cfg: MLPConfig, compute_dtype=None):
    """``apply_flat(flat (C, D), x (N, in)) -> (C, N, out)`` f32 (see
    :func:`make_flat_deeponet` for ``compute_dtype``)."""

    def apply_flat(flat, x):
        if compute_dtype is None:
            return mlp_apply(cfg, flat, x)
        return mlp_apply(cfg, flat.to(compute_dtype), x.to(compute_dtype)).float()

    return apply_flat


def make_flat_deeponet(cfg: DeepONetConfig, compute_dtype=None):
    """``apply_flat(flat (C, D), branch_x, trunk_x) -> (C, B, P)`` f32.

    With ``compute_dtype`` the forward runs in that dtype (parameters and
    inputs cast) and the result returns as f32, as in JAX.
    """

    def apply_flat(flat, branch_x, trunk_x):
        if compute_dtype is None:
            return deeponet_apply(cfg, unravel_deeponet(cfg, flat), branch_x, trunk_x)
        params = unravel_deeponet(cfg, flat.to(compute_dtype))
        out = deeponet_apply(cfg, params, branch_x.to(compute_dtype),
                             trunk_x.to(compute_dtype))
        return out.float()

    return apply_flat


def subsampled_forward(cfg: DeepONetConfig, flat, branch_x, trunk_pts):
    """``(C, B, p)`` predictions with every chain's own query points
    ``trunk_pts`` (C, p, 2): the branch on the shared inputs, the trunk on
    the (C, p) points (one batched matmul per layer)."""
    params = unravel_deeponet(cfg, flat)
    trunk_in = bc_embedding(trunk_pts) if cfg.impose_bc else trunk_pts
    bout = mlp_stack(params["branch"], branch_x, cfg.activation)
    tout = mlp_stack(params["trunk"], trunk_in, cfg.activation)
    return torch.matmul(bout, tout.transpose(-1, -2)) + params["b"][:, None, None]


def query_index_sets(generator: torch.Generator, n_sets: int, n_points: int, p: int,
                     device) -> torch.Tensor:
    """``(n_sets, p)`` int64: ``p`` distinct query-point indices of
    ``n_points`` per set (JAX's ``random.choice(..., replace=False)``), one
    ``randperm`` per set."""
    return torch.stack([torch.randperm(n_points, generator=generator, device=device)[:p]
                        for _ in range(n_sets)])


def make_log_posterior(forward, y, model_loss, tau_out: float, prior=None,
                       prior_scale: float = 1.0):
    """``log_prob(flat (C, D)) -> (C,)``: the log-likelihood of
    ``forward(flat) -> (C, ...)`` on ``y`` under ``model_loss``
    (:func:`~vihmc_torch.dists.likelihoods.get_likelihood`) plus
    ``prior.log_prob(flat) / prior_scale`` (the reference's splitting
    convention divides the prior across shard potentials). An output with
    ``y``'s size per chain takes ``y``'s shape; classification logits keep
    their class axis."""
    like = get_likelihood(model_loss)

    def log_prob(flat):
        out = forward(flat)
        if out[0].numel() == y.numel() and tuple(out.shape[1:]) != tuple(y.shape):
            out = out.reshape(out.shape[0], *y.shape)
        ll = like(out, y, tau_out)
        if prior is not None:
            ll = ll + prior.log_prob(flat) / prior_scale
        return ll

    return log_prob


def make_deeponet_nll_log_posterior(cfg: DeepONetConfig, branch_x, trunk_x, y,
                                    tau_var: float, prior=None, use_fused: bool = True):
    """``log_prob(flat (C, D)) -> (C,)``: the DeepONet Gaussian-NLL
    log-likelihood (plus ``prior.log_prob(flat)`` when given) through
    :func:`~vihmc_torch.ops.deeponet_merge.fused_merge_nll` -- one
    ``merge_sums`` launch for all chains on the card, the (B, P) prediction
    never materialized in the forward -- or, with ``use_fused=False``,
    through the materialized ``merge_nll_reference``. The feature stacks run
    in IEEE f32. Differentiable by autograd. (The JAX function also returns
    an initial flat vector and its unravel, which the port does not need.)
    """
    tau = float(tau_var)
    y = y.contiguous()
    sums_y = y_sums(y)

    def log_prob(flat):
        params = unravel_deeponet(cfg, flat)
        with true_f32():
            bout, tout = deeponet_features(cfg, params, branch_x, trunk_x)
        if use_fused:
            ll = fused_merge_nll(bout, tout, params["b"], y, tau, y_sum_pair=sums_y)
        else:
            ll = merge_nll_reference(bout, tout, params["b"], y, tau)
        if prior is not None:
            ll = ll + prior.log_prob(flat)
        return ll

    return log_prob


def mlp_vi_apply(cfg: MLPConfig, mode: str = "bbb"):
    """``apply_fn(vp, batch{'x', 'y'}, eps, sample, num_samples, generator) ->
    (E, N, out)`` for the VI trainer: ``eps`` the members' normals in place
    of JAX's key (:func:`~vihmc_torch.models.bayesian.bayesian_mlp_apply`),
    else ``num_samples`` members drawn from ``generator``."""
    check_mode(mode)

    def apply_fn(vp, batch, eps=None, sample=True, num_samples=1, generator=None):
        return bayesian_mlp_apply(cfg, vp, batch["x"], eps, sample, mode, generator,
                                  num_samples)

    return apply_fn


def deeponet_vi_apply(cfg: DeepONetConfig, mode: str = "bbb"):
    """``apply_fn(vp, batch{'branch', 'trunk', 'y'}, eps, sample, num_samples,
    generator) -> (E, B, P)`` for the VI trainer; ``batch['trunk']`` is a
    shared grid or per-example points."""
    check_mode(mode)

    def apply_fn(vp, batch, eps=None, sample=True, num_samples=1, generator=None):
        return bayesian_deeponet_apply(cfg, vp, batch["branch"], batch["trunk"], eps,
                                       sample, mode, generator, num_samples)

    return apply_fn


def conditional_warm_start(grad_fn, aux, q0, inv_mass_diag, n_steps: int,
                           n_chains: int, generator: torch.Generator,
                           spread: float = 0.5, lr: float = 0.1):
    """Chain inits at the conditional's approximate mode: ``n_steps`` of Adam
    (optax defaults b1 0.9, b2 0.999, eps 1e-8) on ``-log p`` in the
    preconditioned space ``q = q0 + scale z``, ``scale = sqrt(inv_mass_diag)``,
    then ``spread * scale`` Gaussian jitter per chain. Returns ``(C, d)``.
    Spans ``vihmc.warm_start`` and, per step, ``vihmc.warm_start.step``
    (host clock); counter ``warm_start.steps``."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    with span("vihmc.warm_start", q0.device):
        scale = torch.sqrt(torch.as_tensor(inv_mass_diag, dtype=q0.dtype, device=q0.device)
                           * torch.ones_like(q0))
        z = torch.zeros_like(q0)[None, :]
        m = torch.zeros_like(z)
        v = torch.zeros_like(z)
        for t in range(1, n_steps + 1):
            with span("vihmc.warm_start.step"):
                g = -(scale * grad_fn(q0 + scale * z, aux))   # gradient of -log p in z
                m = (1 - b1) * g + b1 * m
                v = (1 - b2) * g * g + b2 * v
                m_hat = m / (1 - b1 ** t)
                v_hat = v / (1 - b2 ** t)
                z = z - lr * (m_hat / (torch.sqrt(v_hat) + eps))
            count("warm_start.steps")
        q_star = q0 + scale * z[0]
        jitter = spread * scale * torch.randn((n_chains, q0.shape[0]), generator=generator,
                                              device=q0.device)
    return q_star[None, :] + jitter


def make_paired_subspace_delta(apply_flat, branch_x, trunk_x, y, tau_var,
                               idx, prior):
    """Composed paired MH delta: ``delta_fn(q1, q0, aux) -> (dlp (C,), lp1 (C,))``.

    Both forwards run in IEEE f32 and are materialized; ``dlp`` is one
    reduction of per-cell differences ``-0.5/var sum (e1 - e0)(e1 + e0)``
    plus the prior difference, ``lp1`` the proposal's log-density record
    (torch GaussianNLLLoss convention, no 2 pi constant).
    """
    var = max(float(tau_var), GNLL_EPS)
    const = -0.5 * y.numel() * math.log(var)

    def delta_fn(q1, q0, aux):
        with true_f32():
            p1 = apply_flat(scatter_subspace(aux, q1, idx), branch_x, trunk_x)
            p0 = apply_flat(scatter_subspace(aux, q0, idx), branch_x, trunk_x)
        e1 = p1 - y
        e0 = p0 - y
        dll = (-0.5 / var) * ((e1 - e0) * (e1 + e0)).flatten(1).sum(-1)
        dpr = prior.log_prob(q1) - prior.log_prob(q0)
        lp1 = (-0.5 / var) * (e1 * e1).flatten(1).sum(-1) + const + prior.log_prob(q1)
        return dll + dpr, lp1

    return delta_fn


def make_fused_paired_subspace_delta(cfg: DeepONetConfig, branch_x, trunk_x,
                                     y, tau_var, idx, prior):
    """Kernel variant of :func:`make_paired_subspace_delta`: the feature
    stacks run composed in IEEE f32, then both endpoint merges and their
    paired reduction run in :func:`~vihmc_torch.ops.deeponet_merge.
    fused_paired_delta` (one kernel launch for all chains on the card).
    Spans ``vihmc.mh.features`` (both f32 stacks) and
    ``vihmc.mh.paired_sums`` (the fused merge and sums)."""
    tau = float(tau_var)
    sums_y = y_sums(y)

    def delta_fn(q1, q0, aux):
        params1 = unravel_deeponet(cfg, scatter_subspace(aux, q1, idx))
        params0 = unravel_deeponet(cfg, scatter_subspace(aux, q0, idx))
        with detail_span("vihmc.mh.features"), true_f32():
            bout1, tout1 = deeponet_features(cfg, params1, branch_x, trunk_x)
            bout0, tout0 = deeponet_features(cfg, params0, branch_x, trunk_x)
        with detail_span("vihmc.mh.paired_sums"):
            dll, lp1 = fused_paired_delta(
                bout1.contiguous(), tout1.contiguous(), params1["b"],
                bout0.contiguous(), tout0.contiguous(), params0["b"], y, tau,
                y_sum_pair=sums_y)
        lp_q1 = prior.log_prob(q1)
        return dll + (lp_q1 - prior.log_prob(q0)), lp1 + lp_q1

    return delta_fn


def make_nll_log_likelihood(cfg: DeepONetConfig, branch_x, trunk_x, y, tau_var):
    """Composed f32 log-likelihood ``full_ll(flat (C, D)) -> (C,)``: the
    materialized forward in IEEE f32 and ``-sum`` Gaussian NLL -- the
    ``full_ll`` of ``bench.py:465-481`` (initial state, Lanczos HVPs)."""
    apply_flat = make_flat_deeponet(cfg)

    def full_ll(flat):
        with true_f32():
            pred = apply_flat(flat, branch_x, trunk_x)
        return nll_log_likelihood(pred, y, tau_var)

    return full_ll


# ---------------------------------------------------------------------------
# The Fourier neural operator
# ---------------------------------------------------------------------------

def fno_vi_apply(cfg: FNO2dConfig, mode: str = "bbb"):
    """``apply_fn(vp, batch{'branch', 'trunk', 'y'}, eps, sample, num_samples,
    generator) -> (E, B, P)`` for the VI trainer: ``batch['branch']`` holds the
    initial conditions (B, nx) and ``batch['trunk']`` the shared (P, 2) grid
    of ``P = nt nx`` points, t-major; the FNO predicts the whole grid, so a
    per-example subsample of it is refused."""
    check_mode(mode)

    def apply_fn(vp, batch, eps=None, sample=True, num_samples=1, generator=None):
        u0, trunk = batch["branch"], batch["trunk"]
        if trunk.ndim != 2:
            raise ValueError("the FNO2d predicts the whole grid: train it on the shared "
                             "grid (p equal to the grid's points), not per-example points")
        nt = trunk.shape[0] // u0.shape[-1]
        return bayesian_fno_apply(cfg, vp, u0, nt, eps, sample, mode, generator, num_samples)

    return apply_fn


def fno_chunks(cfg: FNO2dConfig, n_functions: int, n_chains: int, s1: int, s2: int,
               max_bytes=None, grad: bool = True) -> list:
    """``[(lo, hi)]``: the functions in as few equal chunks as
    :func:`~vihmc_torch.models.fno.fno_field_bytes` says ``max_bytes`` holds
    for ``n_chains`` chains (None: one chunk), each a multiple of 8 functions
    but the last (the products' rows then start on 16 bytes)."""
    if max_bytes is None:
        return [(0, n_functions)]
    per = n_chains * fno_field_bytes(cfg, s1, s2, grad)
    fit = max(1, int(max_bytes // per))
    n_chunks = -(-n_functions // fit)
    size = -(-n_functions // n_chunks)
    size = min(fit, -(-size // 8) * 8)
    return [(lo, min(lo + size, n_functions)) for lo in range(0, n_functions, size)]


def make_fno_grad_full(cfg: FNO2dConfig, u0, y, tau_var, compute_dtype=None,
                       max_bytes=None):
    """``grad_full(flat (C, D)) -> (C, D)`` f32: d log-likelihood / d flat of
    the FNO2d on the initial conditions ``u0`` (B, nx) against ``y`` (B, nt
    nx), Gaussian NLL at variance ``tau_var``, by autograd through the
    layers' Functions, one function chunk (:func:`fno_chunks`) at a time, the
    chunks' gradients summed. ``compute_dtype=torch.bfloat16``: bf16 GEMM
    operands, f32 sums and transforms. Per chunk the spans
    ``vihmc.field.forward`` (the forward and the residual cotangent) and
    ``vihmc.field.vjp`` (the backward), with the model's own spans inside;
    counter ``fno.chunks``, the chunks of each call."""
    a = fno_input(u0, y.shape[1] // u0.shape[1])
    s1, s2 = a.shape[1], a.shape[2]
    var = max(float(tau_var), GNLL_EPS)

    def grad_full(flat):
        chunks = fno_chunks(cfg, a.shape[0], flat.shape[0], s1, s2, max_bytes)
        count("fno.chunks", len(chunks))
        g = None
        with torch.enable_grad(), true_f32():
            leaf = flat.detach().to(torch.float32).requires_grad_(True)
            for lo, hi in chunks:
                with detail_span("vihmc.field.forward"):
                    pred = fno_apply_chains(cfg, leaf, a[lo:hi], compute_dtype,
                                            spans=True).flatten(2)
                    ct = (y[lo:hi] - pred.detach()).div_(var)
                with detail_span("vihmc.field.vjp"):
                    (gc,) = torch.autograd.grad(pred, leaf, grad_outputs=ct)
                del pred, ct
                g = gc if g is None else g.add_(gc)
        return g

    return grad_full


def _fno_residual_sums(cfg, flat, a, y, chunks, pair: bool):
    """float64 sums over functions of the per-function residual squares: of
    ``flat`` (C, D) ((C,)); with ``pair`` the rows are ``[q1; q0]`` (2C, D)
    and the sums are ``sum (e1 - e0)(e1 + e0)`` and ``sum e1^2`` ((C,) each)."""
    out = [torch.zeros(flat.shape[0] // (2 if pair else 1), dtype=torch.float64,
                       device=flat.device) for _ in range(2 if pair else 1)]
    for lo, hi in chunks:
        e = (fno_apply_chains(cfg, flat, a[lo:hi]).flatten(2) - y[lo:hi]).double()
        if pair:
            e1, e0 = e.chunk(2)
            out[0] += ((e1 - e0) * (e1 + e0)).sum(-1).sum(-1)
            out[1] += (e1 * e1).sum(-1).sum(-1)
        else:
            out[0] += (e * e).sum(-1).sum(-1)
        del e
    return out


def make_fno_nll_log_likelihood(cfg: FNO2dConfig, u0, y, tau_var, max_bytes=None):
    """``full_ll(flat (C, D)) -> (C,)`` f32: the FNO2d's Gaussian NLL
    log-likelihood (no ``2 pi`` constant) in IEEE f32, each function's
    residual squares summed in float64, chunked over functions (span
    ``vihmc.fno.density``)."""
    a = fno_input(u0, y.shape[1] // u0.shape[1])
    var = max(float(tau_var), GNLL_EPS)
    const = -0.5 * y.numel() * math.log(var)

    def full_ll(flat):
        chunks = fno_chunks(cfg, a.shape[0], flat.shape[0], a.shape[1], a.shape[2],
                            max_bytes, grad=False)
        with detail_span("vihmc.fno.density"), true_f32(), torch.no_grad():
            (ss,) = _fno_residual_sums(cfg, flat, a, y, chunks, pair=False)
        return (-0.5 / var * ss + const).float()

    return full_ll


def make_fno_paired_subspace_delta(cfg: FNO2dConfig, u0, y, tau_var, idx, prior,
                                   max_bytes=None):
    """The FNO2d's paired MH delta ``delta_fn(q1, q0, aux) -> (dlp (C,), lp1
    (C,))``: both endpoints' IEEE-f32 forwards in one chain-batched pass per
    function chunk, the residuals paired cell by cell and summed in float64
    (``-0.5/var sum (e1 - e0)(e1 + e0)``), plus the prior difference; ``lp1``
    the proposal's log density (span ``vihmc.fno.density``)."""
    a = fno_input(u0, y.shape[1] // u0.shape[1])
    var = max(float(tau_var), GNLL_EPS)
    const = -0.5 * y.numel() * math.log(var)

    def delta_fn(q1, q0, aux):
        flat = torch.cat([scatter_subspace(aux, q1, idx), scatter_subspace(aux, q0, idx)])
        chunks = fno_chunks(cfg, a.shape[0], flat.shape[0], a.shape[1], a.shape[2],
                            max_bytes, grad=False)
        with detail_span("vihmc.fno.density"), true_f32(), torch.no_grad():
            dss, ss1 = _fno_residual_sums(cfg, flat, a, y, chunks, pair=True)
        lp_q1 = prior.log_prob(q1)
        dll = (-0.5 / var * dss + (lp_q1 - prior.log_prob(q0)).double()).float()
        return dll, (-0.5 / var * ss1 + const + lp_q1.double()).float()

    return delta_fn
