"""The manifold continuous normalizing flow on S2 - symbol "c".

PyTorch counterpart of ``jammy_flows_tpu/layers/sphere_cnf.py`` (Neural
Manifold ODEs, arXiv:2006.10254): chart by chart, an MLP vector field
projected onto the sphere's tangent space is integrated in the tangent
plane of the chart's centre, the log-density evolving by the field's
divergence there and corrected by the exponential map's log-det at the
chart's end.

* The fixed-step solvers (euler, midpoint, rk4: classic RK4) step in a
  Python loop; their gradients come by backprop through the steps, each
  step rematerialized in the backward pass
  (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``), so
  only each step's (B, 3) and (B,) carry is kept.
* The adaptive solvers (dopri5, dopri8, bosh3, fehlberg2, adaptive_heun)
  run ``ops.odeint.odeint`` with continuous-adjoint gradients; an unknown
  adaptive name takes dopri5, as in the JAX package.
* The divergence is the exact trace of the 3 x 3 Jacobian of the tangent
  field (the JAX package's jacfwd): the derivatives along e1, e2, e3
  carried forward by hand through the exponential map, the MLP
  (``AmortizableMLP.apply_jvp``), the projection and the log map's
  Jacobian, in plain tensor operations that reverse mode differentiates
  in training.

The field's MLP takes flat parameters (Bp, n), Bp in {1, B}: shared, or one
weight set per row (a conditional pdf predicts the field's weights).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .sphere import SphereLayer
from ..models.amortizable_mlp import AmortizableMLP, list_from_str
from ..ops import manifold
from ..ops.odeint import TABLEAUS, odeint


def _eps(dtype):
    return 1e-8 if dtype == torch.float64 else 1e-4


def sindiv(x):
    """sin(x) / x with its Taylor limit at 0."""
    small = torch.abs(x) < 1e-6
    x_safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 - x**2 / 6.0, torch.sin(x_safe) / x_safe)


def divsin(x):
    """x / sin(x) with its Taylor limit at 0."""
    small = torch.abs(x) < 1e-6
    x_safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 + x**2 / 6.0, x_safe / torch.sin(x_safe))


def _safe_norm(u, keepdim=True):
    """||u|| with a finite gradient at u = 0 (the value off by ~1e-15)."""
    return torch.sqrt(torch.sum(u**2, dim=-1, keepdim=keepdim) + 1e-30)


def sphere_exp(x, u):
    """The exponential map of S2 at x."""
    norm_u = _safe_norm(u)
    return x * torch.cos(norm_u) + u * sindiv(norm_u)


def sphere_log(x, y):
    """The logarithmic map of S2 at x."""
    xy = torch.sum(x * y, dim=-1, keepdim=True)
    xy = torch.clamp(xy, -1.0 + 1e-6, 1.0 - 1e-6)
    return divsin(torch.arccos(xy)) * (y - xy * x)


def sphere_proju(x, u):
    """u projected onto the tangent plane at x."""
    return u - torch.sum(x * u, dim=-1, keepdim=True) * x


def logdetexp(u):
    """log |sin(|u|) / |u||: the exponential map's log-det on S2."""
    return torch.log(torch.abs(sindiv(_safe_norm(u, keepdim=False))))


def _one_minus_sq(z):
    """1 - z^2 as (1 - z)(1 + z): near |z| = 1 the float32 product keeps
    the relative accuracy that 1 - z * z loses (the JAX package's XLA
    contracts 1 - z * z into one fused multiply-add, which keeps it too);
    the functions below divide by its powers."""
    return (1.0 - z) * (1.0 + z)


def _first_jac_terms(z, dtype):
    """The divsin(arccos z) prefactor's derivative g(z) (its limit -1/3
    near z = 1) and dg / dz (0 there)."""
    near = z > 1.0 - _eps(dtype)
    z_safe = torch.where(near, torch.zeros_like(z), z)
    one_m = _one_minus_sq(z_safe)
    acz = torch.arccos(z_safe)
    g = z_safe * acz / one_m**1.5 - 1.0 / one_m
    dg = (acz / one_m**1.5 + 3.0 * z_safe**2 * acz / one_m**2.5
          - 3.0 * z_safe / one_m**2)
    return (torch.where(near, torch.full_like(z, -1.0 / 3.0), g),
            torch.where(near, torch.zeros_like(z), dg))


def _first_jac_scalar(z, dtype):
    """d/dz of the divsin(arccos z) prefactor, its limit -1/3 near z = 1."""
    return _first_jac_terms(z, dtype)[0]


def _sindiv_terms(x):
    """sindiv(x) and its derivative, on sindiv's branches."""
    small = torch.abs(x) < 1e-6
    x_safe = torch.where(small, torch.ones_like(x), x)
    sin, cos = torch.sin(x_safe), torch.cos(x_safe)
    return (torch.where(small, 1.0 - x**2 / 6.0, sin / x_safe),
            torch.where(small, -x / 3.0, cos / x_safe - sin / x_safe**2))


def _divsin_terms(x):
    """divsin(x) and its derivative, on divsin's branches."""
    small = torch.abs(x) < 1e-6
    x_safe = torch.where(small, torch.ones_like(x), x)
    sin = torch.sin(x_safe)
    return (torch.where(small, 1.0 + x**2 / 6.0, x_safe / sin),
            torch.where(small, x / 3.0,
                        1.0 / sin - x_safe * torch.cos(x_safe) / sin**2))


def jacoblog(x, y):
    """The log map's Jacobian with respect to y: (..., 3) -> (..., 3, 3)."""
    z = torch.sum(x * y, dim=-1, keepdim=True)
    z = torch.clamp(z, -1.0 + 1e-4, 1.0 - 1e-4)
    first = (_first_jac_scalar(z[..., None], x.dtype)
             * (y - z * x)[..., :, None] * x[..., None, :])
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    second = divsin(torch.arccos(z))[..., None] * (
        eye - x[..., :, None] * x[..., None, :])
    return first + second


_FIXED_SOLVERS = {"euler": 1, "midpoint": 2, "rk4": 4}


class CNFSphereCharts(SphereLayer):
    """Manifold CNF on S2 with chart switching - symbol "c"."""

    def __init__(self, dimension=2, euclidean_to_sphere_as_first=0,
                 cnf_network_hidden_dims="64-64", cnf_network_rank=0,
                 cnf_network_highway_mode=1, num_charts=6, solver="rk4",
                 atol=1e-7, rtol=1e-7, step_size=1.0 / 32.0, **kwargs):
        super().__init__(2, euclidean_to_sphere_as_first, add_rotation=0,
                         **kwargs)
        # (x, y, z, t) -> the ambient vector field
        rank = cnf_network_rank if cnf_network_rank != -1 else 0
        self.mlp = AmortizableMLP(4, list_from_str(cnf_network_hidden_dims), 3,
                                  highway_mode=cnf_network_highway_mode,
                                  low_rank_approximations=rank)
        self.num_nn_params = self.mlp.num_params
        self.num_params += self.num_nn_params
        self.num_charts = num_charts
        self.step_size = step_size
        self.adaptive = solver not in _FIXED_SOLVERS
        if self.adaptive and solver not in TABLEAUS:
            solver = "dopri5"
        self.solver = solver
        if self.adaptive:
            # low-order pairs take many more (cheap) steps at a tolerance;
            # the loop stops when it reaches the chart's end
            order = TABLEAUS[solver].order
            self._max_steps = 512 if order >= 5 else (
                2048 if order >= 3 else 8192)
        self.atol = float(atol)
        self.rtol = float(rtol)
        # each chart spans 1 / num_charts in time
        self.steps_per_chart = max(1, int(round((1.0 / num_charts)
                                                / step_size)))

    # -- the vector field ---------------------------------------------------
    def _rhs_and_div(self, t, y, loc, flat_params):
        """The tangent-space field jacoblog(loc, exp(loc, y)) @ f (B, 3) and
        its divergence (B,): the trace of its 3 x 3 Jacobian in y, from the
        derivatives along e1, e2, e3 carried forward by hand (the JAX
        package's jacfwd).  A derivative d[b, i, a] is d (.)_a / d y_i."""
        eye = torch.eye(3, dtype=y.dtype, device=y.device)
        # x = exp(loc, y)
        n = _safe_norm(y)
        s, ds = _sindiv_terms(n)
        x = loc * torch.cos(n) + y * s
        dx = s[:, :, None] * eye + (y / n)[:, :, None] * (
            y * ds - loc * torch.sin(n))[:, None, :]
        tr_dx = dx[:, 0, 0] + dx[:, 1, 1] + dx[:, 2, 2]
        # the ambient field f = proju(x, v), v = MLP([x, t])
        t_col = torch.full_like(x[:, :1], float(t))
        v, dv = self.mlp.apply_jvp(
            flat_params, torch.cat([x, t_col], dim=1),
            torch.cat([dx, torch.zeros_like(dx[:, :, :1])], dim=2))
        w = torch.sum(x * v, dim=-1, keepdim=True)
        dw = (dx * v[:, None, :]).sum(-1) + (dv * x[:, None, :]).sum(-1)
        f = v - w * x
        tr_df = (dv[:, 0, 0] + dv[:, 1, 1] + dv[:, 2, 2]
                 - (dw * x).sum(-1) - w[:, 0] * tr_dx)
        # jacoblog(loc, x) = g (x - z loc) loc^T + divsin(acos z) (I - loc
        # loc^T), z = loc . x clipped
        lx = torch.sum(loc * x, dim=-1, keepdim=True)
        ldx = (dx * loc[:, None, :]).sum(-1)
        lo, hi = -1.0 + 1e-4, 1.0 - 1e-4
        z = torch.clamp(lx, lo, hi)
        dz = ((lx > lo) & (lx < hi)).to(y.dtype) * ldx
        g, dg = _first_jac_terms(z, y.dtype)
        r = x - z * loc
        dvs, ddvs = _divsin_terms(torch.arccos(z))
        # jacoblog @ f = g r (loc . f) + divsin(acos z) (f - loc (loc . f))
        q = torch.sum(loc * f, dim=-1, keepdim=True)
        pf = f - loc * q
        rhs = g * r * q + dvs * pf
        # the trace of d rhs / d y
        dq = (dv * loc[:, None, :]).sum(-1) - dw * lx - w * ldx
        ddvs = ddvs * (-1.0 / torch.sqrt(_one_minus_sq(z)))
        div = (dg * q * (dz * r).sum(-1, True)
               + g * q * (tr_dx - (loc * dz).sum(-1))[:, None]
               + g * (r * dq).sum(-1, True)
               + ddvs * (dz * pf).sum(-1, True)
               + dvs * (tr_df - (loc * dq).sum(-1))[:, None])
        return rhs, div[:, 0]

    def _fixed_step(self, y, div, t, h, loc, flat_params):
        def rhs(tt, yy):
            return self._rhs_and_div(tt, yy, loc, flat_params)

        if self.solver == "euler":
            k1, d1 = rhs(t, y)
            return y + h * k1, div + h * d1
        if self.solver == "midpoint":
            k1, _ = rhs(t, y)
            k2, d2 = rhs(t + 0.5 * h, y + 0.5 * h * k1)
            return y + h * k2, div + h * d2
        k1, d1 = rhs(t, y)
        k2, d2 = rhs(t + 0.5 * h, y + 0.5 * h * k1)
        k3, d3 = rhs(t + 0.5 * h, y + 0.5 * h * k2)
        k4, d4 = rhs(t + h, y + h * k3)
        return (y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4),
                div + (h / 6.0) * (d1 + 2 * d2 + 2 * d3 + d4))

    def _integrate_chart(self, t0, t1, loc, flat_params):
        """(y, integrated divergence) from y = 0 over [t0, t1]."""
        y = torch.zeros_like(loc)
        div = torch.zeros_like(loc[:, 0])
        if self.adaptive:
            def func(t, state, args):
                return self._rhs_and_div(t, state[0], *args)

            return odeint(func, (y, div), (loc, flat_params), float(t0),
                          float(t1), self.rtol, self.atol,
                          max_steps=self._max_steps, method=self.solver)
        n = self.steps_per_chart
        h = (t1 - t0) / n
        remat = torch.is_grad_enabled() and (
            loc.requires_grad or flat_params.requires_grad)
        for i in range(n):
            t = t0 + i * h
            if remat:
                y, div = checkpoint(self._fixed_step, y, div, t, h, loc,
                                    flat_params, use_reentrant=False)
            else:
                y, div = self._fixed_step(y, div, t, h, loc, flat_params)
        return y, div

    def _run(self, z, flat_params, reverse):
        """The chart loop; each chart starts from y = 0 (log(loc, loc)) at
        its centre, so the chart's entry log-det vanishes."""
        nch = self.num_charts
        times = [(i / nch, (i + 1) / nch) for i in range(nch)]
        if reverse:
            times = [(t1, t0) for (t0, t1) in reversed(times)]
        loc = z
        logp = torch.zeros_like(z[:, 0])
        for t0, t1 in times:
            y, div = self._integrate_chart(t0, t1, loc, flat_params)
            y = sphere_proju(loc, y)
            logp = logp + div + logdetexp(y)
            loc = sphere_exp(loc, y)
            loc = loc / torch.linalg.norm(loc, dim=-1, keepdim=True)
        return loc, logp

    # -- the mappings ---------------------------------------------------------
    def _map(self, params, x, log_det, reverse):
        emb = self.always_parametrize_in_embedding_space
        if not emb:
            x, log_det = manifold.spherical_to_eucl(x, log_det)
        res, dlogp = self._run(x, params, reverse=reverse)
        log_det = log_det + dlogp
        if not emb:
            res, log_det = manifold.eucl_to_spherical(res, log_det)
        return res, log_det

    def _inverse(self, params, x, log_det, rot=None):
        return self._map(params, x, log_det, reverse=False)

    def _forward(self, params, x, log_det, rot=None):
        return self._map(params, x, log_det, reverse=True)

    def _default_params(self, rng):
        return self.mlp.default_init(rng)

    def _child_param_structure(self):
        return [("vectorfield_nn_pars", self.num_nn_params)]
