"""Plain reference of ``deeponet-burgers``: the Bayesian DeepONet posterior
over a sensitivity subspace, written from the published model.

The model (``ponkrshnan/VI-HMC`` ``Operator_network``): a branch MLP over the
initial condition and a trunk MLP over ``[t, sin 2 pi x, sin 4 pi x,
cos 2 pi x, cos 4 pi x]``, tanh after every layer but the last, merged by a
dot product over the latent width plus one scalar bias. The flat vector is
``[b, branch layers, trunk layers]``, each layer its bias and then its
``(out, in)`` weight row-major. The log density of subspace coordinates
``q`` is the Gaussian log likelihood at variance ``tau_var`` (no ``2 pi``
constant) of the full vector ``frozen`` with ``q`` at ``idx``, plus the
VI-posterior prior ``N(mu[idx], sigma[idx]^2)`` on ``q``.

Plain PyTorch in IEEE float32 (TF32 off), sums of the log density in
float64; ``fmt`` ('tf32', 'fp8') rounds every matmul operand instead, the
lower precisions of the controls. It imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from port_bench.harness.lowp import ieee_f32, matmul

LOG_2PI = math.log(2 * math.pi)


class Reference:
    """``inputs``: ``branch_x`` (B, in), ``trunk_x`` (P, 2), ``y`` (B, P),
    ``mu``, ``sigma``, ``scores``, ``eps`` (D,), ``idx`` (d,) int64; the
    frozen vector is ``mu + sigma eps``. ``model``, ``posterior`` and
    ``recipe`` are the config's and the cell's sections."""

    def __init__(self, inputs: dict, model: dict, posterior: dict, recipe: dict,
                 block: int = 8):
        self.bx, self.tx, self.y = inputs["branch_x"], inputs["trunk_x"], inputs["y"]
        self.mu, self.sigma, self.idx = inputs["mu"], inputs["sigma"], inputs["idx"]
        self.frozen = self.mu + self.sigma * inputs["eps"]
        self.var = max(float(posterior["tau_var"]), 1e-6)
        self.model = model
        self.block = block
        d = self.idx.shape[0]
        self.sub_mu, self.sub_sigma = self.mu[self.idx], self.sigma[self.idx]
        # the conditional-Laplace diagonal of the cell's metric (the inverse mass)
        s2 = torch.clamp(self.sub_sigma.double() ** 2, min=1e-30)
        g2 = inputs["scores"][self.idx].double() / s2
        n_eff = self.y.shape[0] * self.y.shape[1]
        self.inv_mass = (1.0 / (1.0 / s2 + n_eff * g2)).float()
        self.clip = recipe["field"]["clip"] * (d / 2048.0) ** 0.5
        self.layers = self._layout()

    # -- the model -----------------------------------------------------------

    def _layout(self):
        m = self.model
        k = m["latent"]
        branch = ([(m["in_branch"], m["width_branch"])]
                  + [(m["width_branch"], m["width_branch"])] * (m["depth_branch"] - 2)
                  + [(m["width_branch"], k)])
        trunk = ([(m["in_trunk"], m["width_trunk"])]
                 + [(m["width_trunk"], m["width_trunk"])] * (m["depth_trunk"] - 2)
                 + [(m["width_trunk"], k)])
        pos, out = 1, {}
        for name, dims in (("branch", branch), ("trunk", trunk)):
            out[name] = []
            for d_in, d_out in dims:
                out[name].append((pos, pos + d_out, d_in, d_out))
                pos += d_out + d_in * d_out
        if pos != m["num_params"]:
            raise ValueError(f"layout gives {pos} parameters, the config {m['num_params']}")
        return out

    def full(self, q: torch.Tensor) -> torch.Tensor:
        flat = self.frozen.expand(q.shape[0], -1).clone()
        flat[:, self.idx] = q
        return flat

    def _stack(self, flat, name, x, fmt):
        n = flat.shape[0]
        h = x.expand(n, *x.shape)
        layers = self.layers[name]
        for i, (b0, w0, d_in, d_out) in enumerate(layers):
            w = flat[:, w0:w0 + d_in * d_out].reshape(n, d_out, d_in)
            h = matmul(h, w.transpose(-1, -2), fmt) + flat[:, b0:w0].unsqueeze(-2)
            if i < len(layers) - 1:
                h = torch.tanh(h)
        return h

    def predict(self, flat: torch.Tensor, fmt=None, fn_stride: int = 1) -> torch.Tensor:
        """``(n, B, P)`` predictions of full vectors ``flat`` (n, D), of
        every ``fn_stride``-th function."""
        x = self.tx[:, 1]
        tw = 2 * math.pi
        emb = torch.stack([self.tx[:, 0], torch.sin(tw * x), torch.sin(2 * tw * x),
                           torch.cos(tw * x), torch.cos(2 * tw * x)], dim=-1)
        bout = self._stack(flat, "branch", self.bx[::fn_stride], fmt)
        tout = self._stack(flat, "trunk", emb, fmt)
        return matmul(bout, tout.transpose(-1, -2), fmt) + flat[:, 0, None, None]

    def _prior64(self, q):
        z = (q.double() - self.sub_mu.double()) / self.sub_sigma.double()
        return (-0.5 * z * z - torch.log(self.sub_sigma.double()) - 0.5 * LOG_2PI).sum(-1)

    def _blocks(self, n):
        return [(i, min(i + self.block, n)) for i in range(0, n, self.block)]

    # -- what the comparison reads ---------------------------------------------

    def log_prob(self, q: torch.Tensor, fmt=None) -> torch.Tensor:
        """float64 ``(n,)`` log densities of subspace points ``q`` (n, d)."""
        out = []
        with ieee_f32(), torch.no_grad():
            for a, b in self._blocks(q.shape[0]):
                r = (self.predict(self.full(q[a:b]), fmt) - self.y).double()
                ll = -0.5 * (r * r).flatten(1).sum(-1) / self.var \
                    - 0.5 * self.y.numel() * math.log(self.var)
                out.append(ll + self._prior64(q[a:b]))
        return torch.cat(out)

    def delta(self, q1: torch.Tensor, q0: torch.Tensor, fmt=None) -> torch.Tensor:
        """float64 ``(n,)`` ``log p(q1) - log p(q0)``, the residuals paired
        cell by cell before the float64 sum."""
        out = []
        with ieee_f32(), torch.no_grad():
            for a, b in self._blocks(q1.shape[0]):
                e1 = (self.predict(self.full(q1[a:b]), fmt) - self.y).double()
                e0 = (self.predict(self.full(q0[a:b]), fmt) - self.y).double()
                dll = (-0.5 / self.var) * ((e1 - e0) * (e1 + e0)).flatten(1).sum(-1)
                out.append(dll + self._prior64(q1[a:b]) - self._prior64(q0[a:b]))
        return torch.cat(out)

    def _lp32(self, q, fmt, fn_stride=1, ll_scale=None):
        r = self.predict(self.full(q), fmt, fn_stride) - self.y[::fn_stride]
        z = (q - self.sub_mu) / self.sub_sigma
        prior = (-0.5 * z * z - torch.log(self.sub_sigma)).sum(-1)
        scale = self.y.shape[0] / r.shape[1] if ll_scale is None else ll_scale
        return -0.5 * scale * (r * r).flatten(1).sum(-1) / self.var + prior

    def grad(self, q: torch.Tensor, fmt=None, fn_stride: int = 1,
             ll_scale=None) -> torch.Tensor:
        """``(n, d)`` gradient of the log density by autograd in float32.
        ``fn_stride`` > 1 (a planted fault) keeps every ``fn_stride``-th
        function, its sum scaled by ``ll_scale`` (by default back to all B)."""
        out = []
        with ieee_f32():
            for a, b in self._blocks(q.shape[0]):
                with torch.enable_grad():
                    x = q[a:b].detach().clone().requires_grad_(True)
                    (g,) = torch.autograd.grad(
                        self._lp32(x, fmt, fn_stride, ll_scale).sum(), x)
                out.append(g)
        return torch.cat(out)

    def field(self, q: torch.Tensor, fmt=None, **fault) -> torch.Tensor:
        """The trajectory field: the gradient, clipped per chain at
        ``clip`` in the norm ``sqrt(sum inv_mass g^2)``."""
        g = self.grad(q, fmt, **fault)
        norm = torch.sqrt((self.inv_mass * g * g).sum(-1, keepdim=True))
        return g * torch.clamp(self.clip / (norm + 1e-30), max=1.0)

    def neg_hvp(self, center: torch.Tensor, v: torch.Tensor, fmt=None) -> torch.Tensor:
        """``-H v`` for each row of ``v`` (k, d), the Hessian of the log
        density at ``center`` (d,), by double backward in float32."""
        out = []
        with ieee_f32():
            for a, b in self._blocks(v.shape[0]):
                with torch.enable_grad():
                    x = center.detach().expand(b - a, -1).clone().requires_grad_(True)
                    (g,) = torch.autograd.grad(self._lp32(x, fmt).sum(), x,
                                               create_graph=True)
                    (hv,) = torch.autograd.grad((g * v[a:b]).sum(), x)
                out.append(-hv)
        return torch.cat(out)

    def transition(self, q: torch.Tensor, num_leapfrog: int):
        """The work of one draw of every chain of ``q`` (n, d): the
        trajectory field at each leapfrog step and the MH test's two log
        densities (counted on meta tensors by the MFU metric)."""
        for _ in range(num_leapfrog):
            self.field(q)
        self.delta(q, q)
