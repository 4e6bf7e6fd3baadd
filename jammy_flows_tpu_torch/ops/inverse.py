"""Numerical inversion of a monotone elementwise map: bisection + Newton.

PyTorch counterpart of ``make_inverse_fn`` in
``jammy_flows_tpu/ops/inverse.py``: fixed trip counts, where-masked repair of
non-finite Newton steps and a clip to the bracket.  The solve itself is not
differentiated; the gradient is the implicit-function one of the JAX package
(``inverse.py:86-99``): for x = f^-1(y; p), dL/dy = g / f'(x) and dL/dp is
the VJP of f(x, .) at the root applied to -dL/dy.
"""
from __future__ import annotations

import torch


def _bisection_newton_solve(value_fn, target, params, lo, hi,
                            num_bisection_iter, num_newton_iter,
                            value_and_grad_fn):
    lo_c = torch.full_like(target, lo)
    hi_c = torch.full_like(target, hi)
    for _ in range(num_bisection_iter):
        mid = 0.5 * (lo_c + hi_c)
        go_right = value_fn(mid, params) < target
        lo_c, hi_c = torch.where(go_right, mid, lo_c), \
            torch.where(go_right, hi_c, mid)
    x = 0.5 * (lo_c + hi_c)
    for _ in range(num_newton_iter):
        val, deriv = value_and_grad_fn(x, params)
        x_new = x - (val - target) / deriv
        x_new = torch.where(torch.isfinite(x_new), x_new, x)
        x = torch.clamp(x_new, lo, hi)
    return x


class _ImplicitInverse(torch.autograd.Function):
    """forward: the solve, with no graph; backward: the implicit-function
    gradient with respect to the target and every parameter tensor."""

    @staticmethod
    def forward(ctx, solve, value_fn, value_and_grad_fn, target, *params):
        x = solve(target, params)
        ctx.value_fn = value_fn
        ctx.value_and_grad_fn = value_and_grad_fn
        ctx.save_for_backward(x, *params)
        return x

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        with torch.no_grad():
            _, deriv = ctx.value_and_grad_fn(x, tuple(params))
            cot = g / deriv
        wanted = [i for i, p in enumerate(params)
                  if ctx.needs_input_grad[4 + i]]
        grads = [None] * len(params)
        if wanted:
            with torch.enable_grad():
                leaves = [p.detach().requires_grad_(i in wanted)
                          for i, p in enumerate(params)]
                val = ctx.value_fn(x, tuple(leaves))
                got = torch.autograd.grad(val, [leaves[i] for i in wanted],
                                          -cot, allow_unused=True)
            for i, gi in zip(wanted, got):
                grads[i] = torch.zeros_like(params[i]) if gi is None else gi
        return (None, None, None, cot if ctx.needs_input_grad[3] else None,
                *grads)


def make_inverse_fn(value_fn, value_and_grad_fn, lo=-1e5, hi=1e5,
                    num_bisection_iter=25, num_newton_iter=20, solver=None):
    """Build ``inv(target, params) -> x`` for a strictly increasing
    elementwise ``value_fn(x, params)``; ``value_and_grad_fn`` returns
    (value, d value / dx); ``params`` is a tuple of tensors.  ``solver(target,
    params) -> x`` optionally replaces the bisection + Newton solve (e.g. the
    per-layer inverse kernel); the implicit-function backward through
    ``value_and_grad_fn`` is the same either way.  The result is
    differentiable in the target and the parameters."""
    def solve(target, params):
        with torch.no_grad():
            if solver is not None:
                return solver(target, params)
            return _bisection_newton_solve(value_fn, target, params, lo, hi,
                                           num_bisection_iter,
                                           num_newton_iter,
                                           value_and_grad_fn)

    def inverse(target, params):
        return _ImplicitInverse.apply(solve, value_fn, value_and_grad_fn,
                                      target, *params)
    return inverse
