"""Numerical inversion of a monotone elementwise map: bisection + Newton.

PyTorch counterpart of ``make_inverse_fn`` in
``jammy_flows_tpu/ops/inverse.py``: fixed trip counts, where-masked repair of
non-finite Newton steps and a clip to the bracket.  Values only; the
implicit-function gradient comes with the training slice.
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


def make_inverse_fn(value_fn, value_and_grad_fn, lo=-1e5, hi=1e5,
                    num_bisection_iter=25, num_newton_iter=20):
    """Build ``inv(target, params) -> x`` for a strictly increasing
    elementwise ``value_fn(x, params)``; ``value_and_grad_fn`` returns
    (value, d value / dx)."""
    def inverse(target, params):
        with torch.no_grad():
            return _bisection_newton_solve(value_fn, target, params, lo, hi,
                                           num_bisection_iter,
                                           num_newton_iter,
                                           value_and_grad_fn)
    return inverse
