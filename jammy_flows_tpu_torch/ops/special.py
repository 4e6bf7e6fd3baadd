"""Numerical special functions shared by the flow layers.

PyTorch counterpart of ``jammy_flows_tpu/ops/special.py``.  ``logaddexp``
and ``softplus`` reproduce JAX's formulations exactly (``torch.nn.functional
.softplus`` switches to the identity above a threshold, JAX's does not).

The regulators are :class:`Regulator` objects rather than closures: the CUDA
block kernel (csrc/gf_common.cuh ``apply_reg``) evaluates the same function
from the option values each one exposes (``kernel_args``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)

# kernel codes of Regulator.kind (csrc/gf_common.cuh, struct Reg)
REG_KINDS = {"identity": 0, "log_softplus": 1, "logaddexp": 2, "bounded": 3}


def _as_like(v, ref):
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def _logaddexp_value(a, b):
    amax = torch.maximum(a, b)
    delta = a - b
    return torch.where(torch.isnan(delta), a + b,
                       amax + torch.log1p(torch.exp(-torch.abs(delta))))


def _replace_inf(x):
    return torch.where(x == math.inf, 0.0, x)


def sum_to(g, shape):
    """A broadcast gradient summed back to its input's shape."""
    return g if g.shape == shape else g.sum_to_size(shape)


class _LogAddExp(torch.autograd.Function):
    """jnp.logaddexp with JAX's tangent rule
    t_a exp(a - out) + t_b exp(b - out) (+inf replaced by 0), rather than the
    derivative of the max/log1p formulation."""

    @staticmethod
    def forward(ctx, a, b):
        out = _logaddexp_value(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        o = _replace_inf(out)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = sum_to(g * torch.exp(_replace_inf(a) - o), a.shape)
        if ctx.needs_input_grad[1]:
            gb = sum_to(g * torch.exp(_replace_inf(b) - o), b.shape)
        return ga, gb


def logaddexp(a, b):
    """log(exp(a) + exp(b)) in JAX's formulation (jnp.logaddexp), values
    and gradients."""
    if not isinstance(a, torch.Tensor):
        a = _as_like(a, b)
    return _LogAddExp.apply(a, _as_like(b, a))


def softplus(x):
    """jax.nn.softplus: logaddexp(x, 0), no identity threshold."""
    return logaddexp(x, 0.0)


def std_normal_log_prob(x):
    """log N(x; 0, 1), summed over the last axis."""
    return (-0.5 * x**2 - LOG_SQRT_2PI).sum(dim=-1)


def log_one_plus_exp_x_to_a_minus_1(x, a):
    """Numerically stable log((1 + exp(x))^a - 1), with the same f32 series
    and f64 expm1 regimes as the JAX package."""
    y = a * softplus(x)
    if y.dtype == torch.float32:
        tiny = torch.finfo(y.dtype).tiny
        ys = torch.where(y < 0.1, y, 0.1)
        series = torch.log(torch.clamp(ys, min=tiny)) + torch.log1p(
            ys * (0.5 + ys * (1.0 / 6.0 + ys * (1.0 / 24.0))))
        yl = torch.where(y < 0.1, 0.1, y)
        large = yl + torch.log1p(-torch.exp(-yl))
        return torch.where(y < 0.1, series, large)
    safe_small = torch.log(torch.expm1(torch.where(y < 0.69, y, 0.69)))
    safe_large = torch.where(y > 1e-10, y, 1e-10) + torch.log1p(
        -torch.exp(-torch.where(y > 0.69, y, 0.69)))
    return torch.where(y < 0.69, safe_small, safe_large)


@dataclasses.dataclass(frozen=True)
class Regulator:
    """Elementwise log-width / log-norm regulator.

    kind "identity":     f(x) = x
    kind "log_softplus": f(x) = log(softplus(clip(x)) + a)
    kind "logaddexp":    f(x) = logaddexp(clip(x), a)
    kind "bounded":      f(x) = logaddexp(b - softplus(-clip(x) + c), a)
    where clip(x) = min(max(x, lo), hi); lo/hi are -inf/inf without a clamp.
    """
    kind: str
    a: float = 0.0
    b: float = 0.0
    c: float = 0.0
    lo: float = -math.inf
    hi: float = math.inf

    def __call__(self, x):
        if self.kind == "identity":
            return x
        if self.lo != -math.inf or self.hi != math.inf:
            x = torch.clamp(x, min=None if self.lo == -math.inf else self.lo,
                            max=None if self.hi == math.inf else self.hi)
        if self.kind == "log_softplus":
            return torch.log(softplus(x) + self.a)
        if self.kind == "logaddexp":
            return logaddexp(x, self.a)
        return logaddexp(self.b - softplus(-x + self.c), self.a)

    def kernel_args(self):
        """(kind code, a, b, c, lo, hi) for the CUDA kernel."""
        return (REG_KINDS[self.kind], self.a, self.b, self.c, self.lo, self.hi)


IDENTITY = Regulator("identity")


def log_bounded_exp_fn(min_val: float, max_val: float, center: bool = False,
                       lo: float = -math.inf, hi: float = math.inf):
    """f(x) ~ log of a smooth function bounded in [min_val, max_val]:
    logaddexp(ln_max - softplus(-x + center_val), ln_min)."""
    if min_val <= 0:
        raise ValueError("min_val must be positive")
    ln_max = math.log(max_val)
    return Regulator("bounded", a=math.log(min_val), b=ln_max,
                     c=ln_max if center else 0.0, lo=lo, hi=hi)


def width_regulator_fn(softplus_for_width: int,
                       width_smooth_saturation: int,
                       lower_bound: float,
                       upper_bound: float,
                       clamp_widths: int = 0):
    """The log-width -> log-width' regulator of the `g` flow (same option
    surface as the JAX package)."""
    width_min = lower_bound
    width_max = upper_bound if upper_bound > 0 else None
    log_min_clamp = math.log(0.01 * width_min)
    log_max_clamp = math.log(width_max) * 3.0 if width_max is not None else None

    if softplus_for_width or width_smooth_saturation == 0:
        lo = hi = None
        if clamp_widths:
            lo = log_min_clamp
            hi = math.log(width_max) if width_max is not None else None
        clamp = dict(lo=-math.inf if lo is None else lo,
                     hi=math.inf if hi is None else hi)
        if softplus_for_width:
            return Regulator("log_softplus", a=width_min, **clamp)
        return Regulator("logaddexp", a=math.log(width_min), **clamp)

    if width_max is None:
        raise ValueError("smooth saturation requires an upper bound")
    if clamp_widths:
        return log_bounded_exp_fn(width_min, width_max, center=True,
                                  lo=log_min_clamp, hi=log_max_clamp)
    return log_bounded_exp_fn(width_min, width_max, center=True)
