"""The comparison that decides ``correct``.

Every number compares what the window's timed path produced, at the timed
sizes, with the plain reference at the same inputs:

* ``lp_gap_nats``: the widest gap between a log density the program
  recorded (the segment-end states' ``log_prob``, the MH test's ``log p(q1)``,
  the density calls) and the reference's at the same point;
* ``dll_gap_nats``: the widest gap of the MH test's ``log p(q1) - log p(q0)``.
  A proposal that both sides put more than ``REJECTED_NATS`` below its start
  is rejected whatever the rounding (a divergent trajectory reaches log
  densities of -1e12, where float32 alone is off by 1e5 nats): its two
  numbers are left out of both gaps;
* ``field_gap``: the widest per-chain gap between the trajectory field and
  the reference's (the sampled field calls and the segment-end states'
  field), in the norm the field's clip uses, ``sqrt(sum inv_mass (g -
  g_ref)^2)`` with the reference's own inverse mass (a bfloat16 field's
  rounding is absolute: near the posterior's bulk, where the gradient is
  small, a relative gap would read the gradient's size, not the field's);
* ``field_scale_gap``: ``|beta - 1|``, ``beta = sum <g, g_ref> / sum <g_ref,
  g_ref>`` in the same norm, pooled over every sampled field and chain: the
  share of the reference's field that the program's carries. The bfloat16
  rounding is not aligned with the field and averages out of the pooled
  sums; a field that is zero, scaled, negated or summed over part of the
  functions is not;
* ``eig_residual``: for each direction ``(v, lambda)`` of the Lanczos
  low-rank metric, ``||S (-H) S v - lambda v|| / lambda`` with the
  reference's preconditioned negative Hessian (its own Laplace diagonal and
  Hessian-vector products) at the program's centre, the widest over the
  directions: it reads both a curvature that is off and a vector that is no
  eigenvector (a Ritz pair of any Krylov space meets its own Rayleigh
  quotient exactly, so the quotient alone cannot tell);
* ``unmoved_chains_pct``: the share of chains whose position the window
  left unchanged.

A control (``fmt``) puts the reference at a lower precision in the
program's place, at the same inputs.
"""

from __future__ import annotations

import math

# a proposal this far below its start is rejected with probability 1 - e^-50
REJECTED_NATS = 50.0


def _max(xs):
    xs = [float(x) for x in xs]
    if not xs:
        return None
    return math.inf if any(x != x for x in xs) else max(xs)


def _states(window):
    """The sampled segment-end states and the window's last."""
    return window.states.items + ([] if window.last is None else [
        (window.last.position, window.last.aux, window.last.log_prob, window.last.grad)])


def lp_points(rec, window):
    """``(q, lp)`` of the states' and the density calls' log densities (the
    MH test's ``log p(q1)`` goes with its proposal)."""
    pts = [(s[0], s[2]) for s in _states(window)]
    pts += [(q, lp) for q, _, lp in rec.density.items]
    return pts


def field_points(rec, window):
    pts = [(q, g) for q, _, g in rec.field.items]
    pts += [(s[0], s[3]) for s in _states(window)]
    return pts


def readings(rec, window, ref, metric=None, center=None, fmt=None) -> dict:
    """The numbers of the program (``fmt`` None) or of the control."""
    out = {}
    lp_gaps = []
    for q, lp in lp_points(rec, window):
        want = ref.log_prob(q)
        got = lp.double() if fmt is None else ref.log_prob(q, fmt["density"])
        lp_gaps.append((got - want).abs().max())
    if rec.delta.items:
        gaps, left_out = [], 0
        for q1, q0, _, dlp, lp1 in rec.delta.items:
            want = ref.delta(q1, q0)
            got = dlp.double() if fmt is None else ref.delta(q1, q0, fmt["delta"])
            keep = (got >= -REJECTED_NATS) | (want >= -REJECTED_NATS)
            left_out += int((~keep).sum())
            if not keep.any():
                continue
            gaps.append((got - want)[keep].abs().max())
            q1k = q1[keep]
            got1 = lp1[keep].double() if fmt is None else ref.log_prob(q1k, fmt["density"])
            lp_gaps.append((got1 - ref.log_prob(q1k)).abs().max())
        out["dll_gap_nats"] = _max(gaps)
        out["rejected_rows_left_out"] = left_out
    out["lp_gap_nats"] = _max(lp_gaps)
    out.update(_field_numbers(rec, window, ref, (lambda q, g: g) if fmt is None
                              else (lambda q, g: ref.field(q, fmt["field"]))))
    if metric is not None and hasattr(metric, "u"):
        out.update(eig_readings(metric, center, ref, None if fmt is None else fmt["hvp"]))
    if fmt is None and window.last is not None:
        moved = (window.last.position != window.start_position).any(-1)
        out["unmoved_chains_pct"] = 100.0 * float((~moved).double().mean())
    return out


def _field_numbers(rec, window, ref, field_of) -> dict:
    """``field_gap`` and ``field_scale_gap`` of ``field_of(q, g)`` (``g`` the
    program's field at ``q``) against the reference's field."""
    gaps, dot, sq = [], 0.0, 0.0
    inv_mass = ref.inv_mass.double()
    for q, g in field_points(rec, window):
        want = ref.field(q).double()
        got = field_of(q, g).double()
        gaps.append((inv_mass * (got - want) ** 2).sum(-1).sqrt().max())
        dot += float((inv_mass * got * want).sum())
        sq += float((inv_mass * want * want).sum())
    beta = dot / sq if sq > 0 else math.nan
    return {"field_gap": _max(gaps),
            "field_scale_gap": math.inf if beta != beta else abs(beta - 1.0)}


def field_fault_readings(rec, window, ref, faults) -> dict:
    """The field's numbers with a fault planted in the reference put in the
    program's place: ``faults`` maps a name to ``field``'s keywords (such as
    ``{"fn_stride": 2}``: half of the functions, the sum scaled back up)."""
    return {name: _field_numbers(rec, window, ref, lambda q, g, kw=kw: ref.field(q, **kw))
            for name, kw in faults.items()}


def eig_readings(metric, center, ref, fmt=None) -> dict:
    """The low-rank metric ``M = D^-1 + U U^T`` holds ``u_i = D^-1/2 v_i
    sqrt(lambda_i - 1)``: recover ``(v_i, lambda_i)`` and hold them to the
    reference's ``A = S (-H) S``, ``S = diag(sqrt(D_ref))``, at ``center``.
    The control's curvature is its own Rayleigh quotient ``v_i^T A_fmt v_i``.
    ``eig_directions`` (not compared) counts the directions the metric kept."""
    d_prog = 1.0 / metric.diag_mass.double()
    w = metric.u.double() * d_prog.sqrt()[:, None]            # (d, k) = v sqrt(lambda - 1)
    norms = w.norm(dim=0)
    keep = norms > 0
    w, norms = w[:, keep], norms[keep]
    v = (w / norms).T.float()                                   # (k, d)
    lam = 1.0 + norms * norms
    s = ref.inv_mass.sqrt()
    av = (s * ref.neg_hvp(center, v * s)).double()              # (k, d)
    if fmt is not None:
        lam = ((s * ref.neg_hvp(center, v * s, fmt)).double() * v.double()).sum(-1)
    res = (av - lam[:, None] * v.double()).norm(dim=-1) / lam.abs().clamp_min(1e-30)
    return {"eig_residual": float(res.max()), "eig_directions": int(keep.sum())}


def verdict(values: dict, limits: dict):
    """``(correct, checks)``: each number beside its limit; a number that is
    missing, not finite or above its limit makes the run not correct."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name)
        good = v is not None and v == v and v != math.inf and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks
