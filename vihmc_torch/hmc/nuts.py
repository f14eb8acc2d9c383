"""Multinomial No-U-Turn sampler with a static tree depth, chain-batched.

Counterpart of ``vihmc_tpu/hmc/nuts.py`` (:48-369). Every draw builds the
full tree of ``max_depth`` doublings: doubling j runs a subtree of 2^j
leapfrog leaves (the recursive ``build_tree``, :157-169), so a draw costs
``2^max_depth - 1`` leaf evaluations for every chain. A chain whose
trajectory has turned or diverged is only masked -- through ``stopped`` in
the subtree merges and ``stopped``, ``grow`` and ``take`` in the doublings
(:265-305) -- exactly as in JAX, where the per-chain program is vmapped: all
chains advance together here, each with its own directions, merge uniforms
and swap uniforms (:NUTSNoise), and every mask is per chain.

With a ``grad_fn`` the leapfrog dynamics follow that field while every leaf
still evaluates the EXACT log density for its multinomial weight
``exp(h0 - h)`` (:98-115, docstring :184-197): one ``log_prob_fn`` call per
leaf for all chains.

The step: dual averaging during ``burn`` on the tree's mean acceptance
statistic (per chain, or the chain mean under ``da_axis='chains'``), the
averaged step after, clamped by ``max_step``. The metric: fixed diagonal, or
adapted with ``adapt_mass`` under the ``'half'`` or ``'windowed'`` schedule
of the HMC kernel (the ``'half'`` estimate of NUTS is each chain's own, as
in JAX; ``metric_axis`` pools the windowed one). The random numbers come as
a :class:`NUTSNoise` (:func:`draw_nuts_noise` from a generator, or injected
by a test).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from vihmc_torch.core.mesh import ChainAxis, chain_axis
from vihmc_torch.hmc.adaptation import da_init, da_restart, da_update
from vihmc_torch.hmc.kernel import (HMCState, SampleResult, advance_metric,
                                    current_inv_mass, mass_schedule_of, metric_carries,
                                    normalize_log_prob, value_and_grad)

#: energy error above which a leaf counts as divergent
NUTS_DIVERGENCE = 1000.0


@dataclasses.dataclass(frozen=True)
class NUTSConfig:
    """The JAX config's fields and defaults."""

    num_samples: int = 100
    max_depth: int = 6                 # 2^max_depth - 1 leaves per draw
    step_size: float = 0.1
    burn: int = 0
    adapt_step_size: bool = True       # dual averaging during burn
    target_accept: float = 0.8
    adapt_mass: bool = False
    mass_schedule: str = "half"        # 'half' | 'windowed'
    max_step: Optional[float] = None
    da_axis: Optional[str] = None      # None | 'chains'
    metric_axis: Optional[str] = None  # None | 'chains'


def num_merges(max_depth: int) -> int:
    """Subtree merges per draw: doubling j merges ``2^j - 1`` times."""
    return 2 ** max_depth - 1 - max_depth


@dataclasses.dataclass
class NUTSNoise:
    """Every random number of one NUTS transition, per chain."""

    z: torch.Tensor                 # (C, d) momentum normals
    directions: torch.Tensor        # (C, max_depth) +1 / -1
    u_swap: torch.Tensor            # (C, max_depth) U[0, 1): the doubling swaps
    u_merge: torch.Tensor           # (C, num_merges) U[0, 1): subtree merges, doubling
                                    # by doubling, each subtree's in post-order
    z_aux: Optional[torch.Tensor] = None


def draw_nuts_noise(generator: torch.Generator, n_chains: int, dim: int, max_depth: int,
                    device, aux_draw: Optional[Callable] = None) -> NUTSNoise:
    """One transition's draws, in this order: momentum normals, directions,
    swap uniforms, merge uniforms, then the refresh hook's draw."""
    z = torch.randn((n_chains, dim), generator=generator, device=device)
    bits = torch.randint(0, 2, (n_chains, max_depth), generator=generator, device=device)
    u_swap = torch.rand((n_chains, max_depth), generator=generator, device=device)
    u_merge = torch.rand((n_chains, num_merges(max_depth)), generator=generator,
                         device=device)
    z_aux = None if aux_draw is None else aux_draw(generator)
    return NUTSNoise(z=z, directions=2.0 * bits.to(torch.float32) - 1.0, u_swap=u_swap,
                     u_merge=u_merge, z_aux=z_aux)


@dataclasses.dataclass
class _Tree:
    q_minus: torch.Tensor
    p_minus: torch.Tensor
    g_minus: torch.Tensor
    q_plus: torch.Tensor
    p_plus: torch.Tensor
    g_plus: torch.Tensor
    q_prop: torch.Tensor       # multinomial proposal of the subtree
    lp_prop: torch.Tensor
    g_prop: torch.Tensor
    log_w: torch.Tensor        # logsumexp of the leaves' weights
    p_sum: torch.Tensor        # sum of momenta (generalized U-turn)
    turning: torch.Tensor
    diverged: torch.Tensor
    sum_accept: torch.Tensor   # sum over leaves of min(1, exp(h0 - h))
    n_leaves: torch.Tensor


def _where(cond, a, b):
    """``torch.where`` with a per-chain ``(C,)`` condition."""
    if a.ndim > cond.ndim:
        cond = cond[:, None]
    return torch.where(cond, a, b)


def _is_turning(p_minus, p_plus, p_sum, inv_mass):
    """The generalized U-turn: each end's velocity against the span."""
    v_minus, v_plus = inv_mass * p_minus, inv_mass * p_plus
    return (((v_minus * (p_sum - p_minus)).sum(-1) <= 0.0)
            | ((v_plus * (p_sum - p_plus)).sum(-1) <= 0.0))


def _outer(traj: _Tree, direction):
    """The end a doubling grows from: plus for a forward direction."""
    fwd = direction > 0
    return (_where(fwd, traj.q_plus, traj.q_minus), _where(fwd, traj.p_plus, traj.p_minus),
            _where(fwd, traj.g_plus, traj.g_minus))


def _make_build_tree(vag, eps, inv_mass, h0, u_merge):
    """``build_tree(depth, q, p, g, direction)``; the merge uniforms are
    consumed from ``u_merge`` (C, n) in post-order."""
    cursor = [0]

    def leaf(q, p, g, direction):
        e = (eps * direction)[:, None]
        p_half = p + 0.5 * e * g
        q1 = q + e * (inv_mass * p_half)
        lp1, g1 = vag(q1)
        p1 = p_half + 0.5 * e * g1
        h1 = -lp1 + 0.5 * (inv_mass * p1 * p1).sum(-1)
        log_w = h0 - h1
        log_w = torch.where(torch.isfinite(log_w), log_w, torch.full_like(log_w, -torch.inf))
        diverged = (h1 - h0 > NUTS_DIVERGENCE) | ~torch.isfinite(h1)
        accept_p = torch.clamp(torch.exp(torch.clamp(log_w, max=0.0)), max=1.0)
        false = torch.zeros_like(diverged)
        return _Tree(q_minus=q1, p_minus=p1, g_minus=g1, q_plus=q1, p_plus=p1, g_plus=g1,
                     q_prop=q1, lp_prop=lp1, g_prop=g1, log_w=log_w, p_sum=p1,
                     turning=false, diverged=diverged, sum_accept=accept_p,
                     n_leaves=torch.ones_like(lp1))

    def combine(first: _Tree, second: _Tree, direction, u):
        """Merge ``second`` (grown outward from ``first``); a no-op for the
        chains whose ``first`` already stopped."""
        stopped = first.turning | first.diverged
        log_wt = torch.logaddexp(first.log_w, second.log_w)
        take = (torch.log(u) < (second.log_w - log_wt)) & ~stopped & ~second.diverged
        fwd = direction > 0
        # the far end moves to second's unless first stopped
        outer_minus = ~fwd & ~stopped
        outer_plus = fwd & ~stopped
        q_minus = _where(outer_minus, second.q_minus, first.q_minus)
        p_minus = _where(outer_minus, second.p_minus, first.p_minus)
        g_minus = _where(outer_minus, second.g_minus, first.g_minus)
        q_plus = _where(outer_plus, second.q_plus, first.q_plus)
        p_plus = _where(outer_plus, second.p_plus, first.p_plus)
        g_plus = _where(outer_plus, second.g_plus, first.g_plus)
        p_sum = _where(stopped, first.p_sum, first.p_sum + second.p_sum)
        new_turn = _is_turning(p_minus, p_plus, p_sum, inv_mass)
        zero = torch.zeros_like(first.sum_accept)
        return _Tree(
            q_minus=q_minus, p_minus=p_minus, g_minus=g_minus,
            q_plus=q_plus, p_plus=p_plus, g_plus=g_plus,
            q_prop=_where(take, second.q_prop, first.q_prop),
            lp_prop=_where(take, second.lp_prop, first.lp_prop),
            g_prop=_where(take, second.g_prop, first.g_prop),
            log_w=_where(stopped, first.log_w, log_wt),
            p_sum=p_sum,
            turning=_where(stopped, first.turning, second.turning | new_turn),
            diverged=first.diverged | (~stopped & second.diverged),
            sum_accept=first.sum_accept + _where(stopped, zero, second.sum_accept),
            n_leaves=first.n_leaves + _where(stopped, zero, second.n_leaves))

    def build_tree(depth, q, p, g, direction):
        if depth == 0:
            return leaf(q, p, g, direction)
        t1 = build_tree(depth - 1, q, p, g, direction)
        # grow outward from t1's outer end in the SAME direction
        t2 = build_tree(depth - 1, *_outer(t1, direction), direction)
        u = u_merge[:, cursor[0]]
        cursor[0] += 1
        return combine(t1, t2, direction, u)

    return build_tree


def make_nuts_kernel(log_prob_fn: Callable, config: NUTSConfig, inv_mass=1.0,
                     aux_refresh: Optional[Callable] = None,
                     grad_fn: Optional[Callable] = None,
                     chains: Optional[ChainAxis] = None):
    """``kernel(state, noise) -> (state, info)`` for all chains at once
    (nuts.py:208-333); ``chains`` is the axis the coupled statistics reduce
    over (:func:`~vihmc_torch.hmc.kernel.make_kernel`).
    ``log_prob_fn(q (C, d), aux) -> (C,)``, ``grad_fn`` the optional
    trajectory field, ``inv_mass`` a scalar or (d,) diagonal.
    ``info`` has ``accept_prob`` (the tree's mean acceptance statistic),
    ``accepted`` (the chain moved), ``step_size``, ``divergent``,
    ``log_prob`` and ``tree_leaves`` (the leaves merged before the tree
    stopped), each ``(C,)``."""
    for axis in ("da_axis", "metric_axis"):
        if getattr(config, axis) not in (None, "chains"):
            raise ValueError(f"{axis} {getattr(config, axis)!r}: None or 'chains'")
    schedule = mass_schedule_of(config.adapt_mass, config.mass_schedule, config.burn)

    def kernel(state: HMCState, noise: NUTSNoise):
        q0, it = state.position, state.iteration
        axis = ChainAxis(q0.shape[0]) if chains is None else chains
        in_burn = it < config.burn
        if aux_refresh is not None:
            aux = aux_refresh(noise.z_aux)
            if grad_fn is not None:
                lp0, g0 = log_prob_fn(q0, aux), grad_fn(q0, aux)
            else:
                lp0, g0 = value_and_grad(log_prob_fn, q0, aux)
        else:
            aux, lp0, g0 = state.aux, state.log_prob, state.grad

        if grad_fn is not None:
            def vag(q):
                return log_prob_fn(q, aux), grad_fn(q, aux)
        else:
            def vag(q):
                return value_and_grad(log_prob_fn, q, aux)

        if config.adapt_step_size:
            eps = torch.exp(state.da.log_step if in_burn else state.da.log_step_avg)
            if config.max_step is not None:
                eps = torch.clamp(eps, max=config.max_step)
        else:
            eps = torch.full_like(state.da.log_step, config.step_size)

        # no chain pooling in the choice, as in JAX
        inv_mass_t = current_inv_mass(state, schedule, inv_mass) * torch.ones_like(q0)

        p0 = noise.z / torch.sqrt(inv_mass_t)
        h0 = -lp0 + 0.5 * (inv_mass_t * p0 * p0).sum(-1)
        build_tree = _make_build_tree(vag, eps, inv_mass_t, h0, noise.u_merge)

        false = torch.zeros_like(lp0, dtype=torch.bool)
        zero = torch.zeros_like(lp0)
        traj = _Tree(q_minus=q0, p_minus=p0, g_minus=g0, q_plus=q0, p_plus=p0, g_plus=g0,
                     q_prop=q0, lp_prop=lp0, g_prop=g0, log_w=zero, p_sum=p0,
                     turning=false, diverged=false, sum_accept=zero, n_leaves=zero)
        for depth in range(config.max_depth):
            direction = noise.directions[:, depth]
            sub = build_tree(depth, *_outer(traj, direction), direction)
            stopped = traj.turning | traj.diverged
            # progressive swap: the new subtree's proposal w.p. min(1, W_new / W_old),
            # only if the subtree itself is valid
            take = ((torch.log(noise.u_swap[:, depth]) < sub.log_w - traj.log_w)
                    & ~stopped & ~sub.turning & ~sub.diverged)
            fwd = direction > 0
            grow = ~stopped & ~sub.diverged & ~sub.turning
            ext_minus, ext_plus = ~fwd & grow, fwd & grow
            q_minus = _where(ext_minus, sub.q_minus, traj.q_minus)
            p_minus = _where(ext_minus, sub.p_minus, traj.p_minus)
            g_minus = _where(ext_minus, sub.g_minus, traj.g_minus)
            q_plus = _where(ext_plus, sub.q_plus, traj.q_plus)
            p_plus = _where(ext_plus, sub.p_plus, traj.p_plus)
            g_plus = _where(ext_plus, sub.g_plus, traj.g_plus)
            p_sum = _where(grow, traj.p_sum + sub.p_sum, traj.p_sum)
            turn_now = _is_turning(p_minus, p_plus, p_sum, inv_mass_t)
            traj = _Tree(
                q_minus=q_minus, p_minus=p_minus, g_minus=g_minus,
                q_plus=q_plus, p_plus=p_plus, g_plus=g_plus,
                q_prop=_where(take, sub.q_prop, traj.q_prop),
                lp_prop=_where(take, sub.lp_prop, traj.lp_prop),
                g_prop=_where(take, sub.g_prop, traj.g_prop),
                log_w=_where(grow, torch.logaddexp(traj.log_w, sub.log_w), traj.log_w),
                p_sum=p_sum,
                turning=_where(stopped, traj.turning, sub.turning | turn_now),
                diverged=traj.diverged | (~stopped & sub.diverged),
                sum_accept=traj.sum_accept + _where(stopped, zero, sub.sum_accept),
                n_leaves=traj.n_leaves + _where(stopped, zero, sub.n_leaves))

        accept_stat = traj.sum_accept / torch.clamp(traj.n_leaves, min=1.0)
        moved = (traj.q_prop != q0).any(-1)

        welford, carried, is_win_end = advance_metric(state, traj.q_prop, schedule, inv_mass,
                                                      config.metric_axis, axis)

        da = state.da
        if config.adapt_step_size:
            if config.da_axis == "chains":
                # as in JAX, the reported statistic is the chain mean too
                accept_stat = axis.mean(accept_stat).expand_as(accept_stat)
            if in_burn:
                da = da_update(state.da, accept_stat, config.target_accept)
            if is_win_end:
                da = da_restart(da)
        new_state = HMCState(position=traj.q_prop, log_prob=traj.lp_prop, grad=traj.g_prop,
                             da=da, aux=aux, iteration=it + 1, welford=welford,
                             inv_mass=carried)
        info = {"accept_prob": accept_stat, "accepted": moved, "step_size": eps,
                "divergent": traj.diverged, "log_prob": traj.lp_prop,
                "tree_leaves": traj.n_leaves}
        return new_state, info

    return kernel


def init_nuts_state(log_prob_fn: Callable, position: torch.Tensor, config: NUTSConfig,
                    aux=None, inv_mass=1.0, grad_fn: Optional[Callable] = None) -> HMCState:
    """The exact density and the trajectory field at ``position`` (C, d), the
    dual averaging at ``step_size`` and the adaptive-metric carries
    (the ``init_state`` call of nuts.py:351-356)."""
    if grad_fn is None:
        lp, g = value_and_grad(log_prob_fn, position, aux)
    else:
        lp, g = log_prob_fn(position, aux), grad_fn(position, aux)
    welford, carried = metric_carries(config.adapt_mass, config.mass_schedule, position,
                                      inv_mass)
    return HMCState(position=position, log_prob=lp, grad=g,
                    da=da_init(config.step_size, shape=(position.shape[0],),
                               device=position.device),
                    aux=aux, welford=welford, inv_mass=carried)


def nuts_sample(log_prob_fn: Callable, init_position: torch.Tensor, config: NUTSConfig,
                inv_mass=1.0, aux=None, aux_refresh: Optional[Callable] = None,
                grad_fn: Optional[Callable] = None, seed: int = 0, thin: int = 1,
                segment_size: Optional[int] = None,
                progress: Optional[Callable] = None,
                aux_draw: Optional[Callable] = None, mesh=None) -> SampleResult:
    """``config.num_samples`` NUTS draws of every chain of ``init_position``
    ((C, d); a (d,) position runs one chain and returns ``(S, ...)``).
    On a chain ``mesh`` (a ``DeviceMesh``,
    :func:`~vihmc_torch.chains.make_chain_mesh`) this rank runs its rows of
    the C chains and the result holds those rows; every
    draw is drawn for all C chains and sliced, so the chains do not depend
    on the layout.

    The draws run in segments of ``segment_size`` (all in one by default)
    from the generator streams of ``seed``, every ``thin``-th position kept
    on the device (:func:`~vihmc_torch.chains.resume.run_segments`).
    ``aux_refresh(z) -> aux`` redraws each chain's aux before each draw from
    ``aux_draw(generator)`` (default ``(C, D)`` standard normals).
    ``aux_trace`` holds ``{'tree_leaves': (C, S)}``."""
    from vihmc_torch.chains.resume import INFO_KEYS, resolve_aux_draw, run_segments

    single = init_position.ndim == 1
    q0 = init_position[None] if single else init_position
    n_chains, dim = q0.shape
    dev = q0.device
    axis = chain_axis(mesh, n_chains)
    log_prob_fn = normalize_log_prob(log_prob_fn)
    grad_fn = normalize_log_prob(grad_fn)
    kernel = make_nuts_kernel(log_prob_fn, config, inv_mass, aux_refresh, grad_fn, axis)
    state = init_nuts_state(log_prob_fn, axis.local(q0), config, aux, inv_mass, grad_fn)
    aux_draw = resolve_aux_draw(aux_refresh, aux_draw, aux, n_chains, dev)

    def step(st, gen):
        return kernel(st, axis.local(draw_nuts_noise(gen, n_chains, dim, config.max_depth,
                                                     dev, aux_draw)))

    state, samples, out = run_segments(
        step, state, config.num_samples, segment_size or config.num_samples, thin, seed,
        dev, info_keys=INFO_KEYS + ("tree_leaves",), progress=progress)
    res = SampleResult(samples=samples, log_probs=out["log_prob"],
                       accept_probs=out["accept_prob"], accepted=out["accepted"],
                       step_sizes=out["step_size"], divergent=out["divergent"],
                       final_state=state, aux_trace={"tree_leaves": out["tree_leaves"]})
    return res.single_chain() if single else res
