"""Plain reference of ``fno2d-burgers``: the Bayesian FNO2d posterior over a
sensitivity subspace, written from the published model.

The model (Li et al., arXiv 2010.08895; ``fourier_2d.py``'s ``FNO2d``): the
input ``(a, t, x)`` with ``a(t, x) = u0(x)`` on every time row and the grid in
[0, 1]; ``fc0`` to ``width`` channels; zero padding of ``padding`` on the high
side of both axes; ``n_layers`` Fourier layers, each ``irfft2`` of the kept
modes ``[:m1, :m2]`` and ``[-m1:, :m2]`` of ``rfft2(x)`` mixed by the complex
weights (``"bixy,ioxy->boxy"``), plus a 1x1 convolution, GELU after all but
the last; the unpad; ``fc1``, GELU, ``fc2``. The flat vector is
``harness/fno_posterior.layout``. One parameter vector at a time, no chains
batched into the model, and the complex products as real products (so that
``FlopCounterMode`` counts 8 operations per complex multiply-add). The log
density of subspace coordinates ``q`` is the Gaussian log likelihood at
variance ``tau_var`` (no ``2 pi`` constant) of the full vector ``frozen`` with
``q`` at ``idx``, plus the VI-posterior prior ``N(mu[idx], sigma[idx]^2)``.

Plain PyTorch in IEEE float32 (TF32 off), one block of functions at a time,
each function's residual squares summed in float64; ``fmt`` ('tf32', 'fp8')
rounds every matmul operand instead (the transforms stay float32), the lower
precisions of the controls.

The subspace and the metric are the reference's own: :meth:`probe_scores`
draws the recipe's ``sensitivity`` sample of the functions and its
Rademacher probes by the seeded rule both sides are held to, takes one
plain VJP of the forward at ``mu`` per probe and function, and gives
``E[(v^T J)^2] sigma^2`` (float64 sums); ``idx`` is the ``top_k`` highest,
sorted, and the inverse mass the conditional-Laplace diagonal of those
scores. A program whose scores, subspace or mass are off is so held to
another posterior. Where the recipe names no ``sensitivity`` stage (the
model's tests), and on meta tensors (the FLOP count, which reads only the
subspace's size), ``inputs``' ``idx`` and ``scores`` stand in. It imports
nothing of the program.
"""

from __future__ import annotations

import math

import torch

from port_bench.harness.fno_posterior import layout
from port_bench.harness.lowp import ieee_f32, matmul

LOG_2PI = math.log(2 * math.pi)


def _gelu(x):
    return torch.nn.functional.gelu(x)


class Reference:
    """``inputs``: ``u0`` (B, nx), ``y`` (B, nt nx) t-major, ``mu``,
    ``sigma``, ``eps`` (D,), and where the recipe has no ``sensitivity``
    stage ``idx`` (d,) int64 and ``scores`` (D,); the frozen vector is ``mu +
    sigma eps``. ``model``, ``posterior`` and ``recipe`` are the config's and
    the cell's sections."""

    def __init__(self, inputs: dict, model: dict, posterior: dict, recipe: dict,
                 block: int = 100):
        self.u0, self.y = inputs["u0"], inputs["y"]
        self.mu, self.sigma = inputs["mu"], inputs["sigma"]
        self.frozen = self.mu + self.sigma * inputs["eps"]
        self.var = max(float(posterior["tau_var"]), 1e-6)
        self.model = model
        self.block = block
        self.nt = self.y.shape[1] // self.u0.shape[1]
        self.slices = {name: (a, b, shape) for name, a, b, shape in layout(model)}
        if "sensitivity" in recipe and self.u0.device.type != "meta":
            self.scores = self.probe_scores(**recipe["sensitivity"])
            top = torch.argsort(self.scores, descending=True, stable=True)
            self.idx = torch.sort(top[:recipe["subspace"]["top_k"]]).values
        else:
            self.idx = inputs["idx"]
            self.scores = inputs.get("scores", torch.zeros_like(self.mu)).double()
        d = self.idx.shape[0]
        self.sub_mu, self.sub_sigma = self.mu[self.idx], self.sigma[self.idx]
        # the conditional-Laplace diagonal of the cell's metric (the inverse mass)
        s2 = torch.clamp(self.sub_sigma.double() ** 2, min=1e-30)
        g2 = self.scores[self.idx] / s2
        n_eff = self.y.shape[0] * self.y.shape[1]
        self.inv_mass = (1.0 / (1.0 / s2 + n_eff * g2)).float()
        self.clip = recipe["field"]["clip"] * (d / 2048.0) ** 0.5

    # -- the model -----------------------------------------------------------

    def full(self, q: torch.Tensor) -> torch.Tensor:
        """The full vector (D,) of subspace coordinates ``q`` (d,)."""
        flat = self.frozen.clone()
        flat[self.idx] = q
        return flat

    def _param(self, w, name):
        a, b, shape = self.slices[name]
        return w[a:b].reshape(shape)

    def _linear(self, x, w, name, fmt):
        """``x @ W^T + b`` over the last axis of ``x``."""
        weight = self._param(w, f"{name}.weight").reshape(-1, x.shape[-1])
        out = matmul(x.reshape(-1, x.shape[-1]), weight.T, fmt) + self._param(w, f"{name}.bias")
        return out.reshape(*x.shape[:-1], weight.shape[0])

    @staticmethod
    def _mix(a, weights, fmt):
        """``"bixy,ioxy->boxy"`` of ``a`` (b, i, m1, m2) complex and the real
        pairs ``weights`` (i, o, m1, m2, 2), per mode, in real arithmetic."""
        ar = a.real.permute(2, 3, 0, 1)                       # (m1, m2, b, i)
        ai = a.imag.permute(2, 3, 0, 1)
        wr = weights[..., 0].permute(2, 3, 0, 1)              # (m1, m2, i, o)
        wi = weights[..., 1].permute(2, 3, 0, 1)
        re = matmul(ar, wr, fmt) - matmul(ai, wi, fmt)
        im = matmul(ar, wi, fmt) + matmul(ai, wr, fmt)
        return torch.complex(re, im).permute(2, 3, 0, 1)      # (b, o, m1, m2)

    def _spectral(self, x, w, lay, fmt):
        b, _, s1, s2 = x.shape
        m1, m2 = self.model["modes1"], self.model["modes2"]
        w1 = self._param(w, f"conv{lay}.weights1")
        w2 = self._param(w, f"conv{lay}.weights2")
        x_ft = torch.fft.rfft2(x)
        o = w1.shape[1]
        # the half spectrum (b, o, s1, s2 // 2 + 1), zero but at the two corners
        rows = torch.cat([self._mix(x_ft[:, :, :m1, :m2], w1, fmt),
                          x_ft.new_zeros((b, o, s1 - 2 * m1, m2)),
                          self._mix(x_ft[:, :, -m1:, :m2], w2, fmt)], dim=-2)
        out = torch.cat([rows, x_ft.new_zeros((b, o, s1, s2 // 2 + 1 - m2))], dim=-1)
        return torch.fft.irfft2(out, s=(s1, s2))

    def predict(self, w: torch.Tensor, u0: torch.Tensor, fmt=None) -> torch.Tensor:
        """``(b, nt nx)`` predictions of one full vector ``w`` (D,) on the
        initial conditions ``u0`` (b, nx)."""
        b, nx = u0.shape
        nt, pad = self.nt, self.model["padding"]
        gt = torch.linspace(0.0, 1.0, nt, device=u0.device)
        gx = torch.linspace(0.0, 1.0, nx, device=u0.device)
        x = torch.stack([u0[:, None, :].expand(b, nt, nx), gt[None, :, None].expand(b, nt, nx),
                         gx[None, None, :].expand(b, nt, nx)], dim=-1)
        x = self._linear(x, w, "fc0", fmt).permute(0, 3, 1, 2)
        x = torch.nn.functional.pad(x, [0, pad, 0, pad])
        for lay in range(self.model["n_layers"]):
            x1 = self._spectral(x, w, lay, fmt)
            x2 = self._linear(x.permute(0, 2, 3, 1), w, f"w{lay}", fmt).permute(0, 3, 1, 2)
            x = x1 + x2
            if lay < self.model["n_layers"] - 1:
                x = _gelu(x)
        x = x[..., :nt, :nx].permute(0, 2, 3, 1)
        x = self._linear(_gelu(self._linear(x, w, "fc1", fmt)), w, "fc2", fmt)
        return x.reshape(b, nt * nx)

    def probe_scores(self, functions: int, probes: int, seed: int) -> torch.Tensor:
        """float64 ``(D,)`` scores ``E[(dy/dw)^2] sigma^2`` at ``mu`` over
        ``functions`` of the functions with ``probes`` Rademacher probes each.

        The rule: a generator on the functions' device seeded with ``seed``
        draws ``randperm(B)[:functions]``; a second one seeded the same draws
        the probes as one float32 ``randint(0, 2, (probes n, nt, nx)) * 2 - 1``,
        row ``r`` the probe ``r // n`` of picked function ``r % n``. Each row
        is one VJP ``v^T J`` of that function's forward; the mean of ``(v^T
        J)^2`` over rows and outputs estimates the mean squared Jacobian."""
        dev = self.u0.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        pick = torch.randperm(self.u0.shape[0], generator=gen, device=dev)[:functions]
        n = pick.shape[0]
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        v = torch.randint(0, 2, (probes * n, self.nt, self.u0.shape[1]), generator=gen,
                          device=dev, dtype=torch.float32).mul_(2).sub_(1)
        acc = torch.zeros_like(self.mu, dtype=torch.float64)
        with ieee_f32():
            for f in range(n):
                with torch.enable_grad():
                    w = self.mu.detach().clone().requires_grad_(True)
                    out = self.predict(w, self.u0[pick[f]][None])[0]
                    for p in range(probes):
                        (g,) = torch.autograd.grad(out, w, grad_outputs=v[p * n + f].reshape(-1),
                                                   retain_graph=p < probes - 1)
                        acc += g.double() ** 2
        return acc / (n * probes * v[0].numel()) * self.sigma.double() ** 2

    def _prior64(self, q):
        z = (q.double() - self.sub_mu.double()) / self.sub_sigma.double()
        return (-0.5 * z * z - torch.log(self.sub_sigma.double()) - 0.5 * LOG_2PI).sum(-1)

    def _blocks(self, n):
        return [(i, min(i + self.block, n)) for i in range(0, n, self.block)]

    def _sq64(self, w, fmt):
        """float64 sum over functions of each function's residual squares."""
        total = torch.zeros((), dtype=torch.float64, device=w.device)
        for a, b in self._blocks(self.u0.shape[0]):
            r = (self.predict(w, self.u0[a:b], fmt) - self.y[a:b]).double()
            total = total + (r * r).sum(-1).sum()
        return total

    # -- what the comparison reads ---------------------------------------------

    def log_prob(self, q: torch.Tensor, fmt=None) -> torch.Tensor:
        """float64 ``(n,)`` log densities of subspace points ``q`` (n, d)."""
        out = []
        const = -0.5 * self.y.numel() * math.log(self.var)
        with ieee_f32(), torch.no_grad():
            for c in range(q.shape[0]):
                ll = -0.5 * self._sq64(self.full(q[c]), fmt) / self.var + const
                out.append(ll + self._prior64(q[c]))
        return torch.stack(out)

    def delta(self, q1: torch.Tensor, q0: torch.Tensor, fmt=None) -> torch.Tensor:
        """float64 ``(n,)`` ``log p(q1) - log p(q0)``, the residuals paired
        cell by cell before the float64 sum."""
        out = []
        with ieee_f32(), torch.no_grad():
            for c in range(q1.shape[0]):
                w1, w0 = self.full(q1[c]), self.full(q0[c])
                dss = torch.zeros((), dtype=torch.float64, device=q1.device)
                for a, b in self._blocks(self.u0.shape[0]):
                    e1 = (self.predict(w1, self.u0[a:b], fmt) - self.y[a:b]).double()
                    e0 = (self.predict(w0, self.u0[a:b], fmt) - self.y[a:b]).double()
                    dss = dss + ((e1 - e0) * (e1 + e0)).sum(-1).sum()
                out.append(-0.5 * dss / self.var + self._prior64(q1[c]) - self._prior64(q0[c]))
        return torch.stack(out)

    def _ll32(self, x, u0, y, fmt, scale):
        r = self.predict(self.full(x), u0, fmt) - y
        return -0.5 * scale * (r * r).sum() / self.var

    def grad(self, q: torch.Tensor, fmt=None, fn_stride: int = 1,
             ll_scale=None) -> torch.Tensor:
        """``(n, d)`` gradient of the log density by autograd in float32, one
        block of functions at a time. ``fn_stride`` > 1 (a planted fault) keeps
        every ``fn_stride``-th function, its sum scaled by ``ll_scale`` (by
        default back to all B)."""
        u0, y = self.u0[::fn_stride], self.y[::fn_stride]
        scale = self.u0.shape[0] / u0.shape[0] if ll_scale is None else ll_scale
        out = []
        with ieee_f32():
            for c in range(q.shape[0]):
                g = (self.sub_mu - q[c]) / (self.sub_sigma * self.sub_sigma)
                for a, b in self._blocks(u0.shape[0]):
                    with torch.enable_grad():
                        x = q[c].detach().clone().requires_grad_(True)
                        (gb,) = torch.autograd.grad(
                            self._ll32(x, u0[a:b], y[a:b], fmt, scale), x)
                    g = g + gb
                out.append(g)
        return torch.stack(out)

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
            for k in range(v.shape[0]):
                hv = v[k] / (self.sub_sigma * self.sub_sigma)
                for a, b in self._blocks(self.u0.shape[0]):
                    with torch.enable_grad():
                        x = center.detach().clone().requires_grad_(True)
                        (g,) = torch.autograd.grad(
                            self._ll32(x, self.u0[a:b], self.y[a:b], fmt, 1.0), x,
                            create_graph=True)
                        (h,) = torch.autograd.grad((g * v[k]).sum(), x)
                    hv = hv - h
                out.append(hv)
        return torch.stack(out)

    def transition(self, q: torch.Tensor, num_leapfrog: int):
        """The work of one draw of every chain of ``q`` (n, d): the
        trajectory field at each leapfrog step and the MH test's two log
        densities (counted on meta tensors by the MFU metric)."""
        for _ in range(num_leapfrog):
            self.field(q)
        self.delta(q, q)
