"""Numerical inversion: a monotone elementwise map by bisection + Newton,
and a diffeomorphism of the 2-sphere by damped Newton steps along great
circles.

PyTorch counterpart of ``make_inverse_fn`` and ``make_sphere_inverse_cols_fn``
in ``jammy_flows_tpu/ops/inverse.py``.  The elementwise solve has fixed trip
counts, where-masked repair of non-finite Newton steps and a clip to the
bracket; the sphere solve runs until every row has converged or ``max_iter``
(the JAX package's ``lax.while_loop``).  Neither solve is differentiated;
the gradients are the implicit-function ones of the JAX package: for x =
f^-1(y; p), dL/dy = g / f'(x) and dL/dp is the VJP of f(x, .) at the root
applied to -dL/dy; on the sphere dL/dy = P (P^T P)^-1 B^T g with P = J B the
map's Jacobian on a tangent basis B at the root.
"""
from __future__ import annotations

import collections

import torch

from .manifold import sphere_tangent_basis_cols

# every sphere solve appends (iterations run, rows still active at the end),
# the latest 4096 kept; a caller that reads it clears it first
SPHERE_SOLVES = collections.deque(maxlen=4096)


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


def _sphere_newton(exp_map, tx, ty, tz, prepared, max_iter, damping, tol):
    """The damped sphere-Newton walk from (0, 0, -1) towards phi(x) = t, row
    by row until |step| < tol_eff or ``max_iter``; J^T t from three
    directional derivatives (``exp_map`` along e_x, e_y, e_z)."""
    finfo = torch.finfo(tx.dtype)
    edge = max(1e-15, 8.0 * finfo.eps)
    tiny = finfo.tiny
    tol_eff = max(tol, 30.0 * finfo.eps)
    x = torch.zeros_like(tx)
    y = torch.zeros_like(tx)
    z = torch.full_like(tx, -1.0)
    eye = torch.eye(3, dtype=tx.dtype, device=tx.device)[:, :, None]
    active = torch.ones(tx.shape, dtype=torch.bool, device=tx.device)
    i = 0
    while i < max_iter and bool(active.any()):
        (phx, phy, phz), (jx, jy, jz) = exp_map(
            (x, y, z), prepared, (eye[0], eye[1], eye[2]))
        fn_eval = 1.0 - (phx * tx + phy * ty + phz * tz)
        # res_vec = -J^T t: row j of the tangents is d phi / d x_j
        gx, gy, gz = -(jx * tx + jy * ty + jz * tz)
        gn = torch.sqrt(torch.clamp(gx * gx + gy * gy + gz * gz, min=tiny))
        dx, dy, dz = -gx / gn, -gy / gn, -gz / gn
        cos_a = dx * x + dy * y + dz * z
        converged = cos_a >= 1.0 - edge
        cos_s = torch.clamp(cos_a, -1.0 + edge, 1.0 - edge)
        sin_a = torch.sqrt(torch.clamp(1.0 - cos_s * cos_s, min=tiny))
        vx = (dx - x * cos_s) / sin_a
        vy = (dy - y * cos_s) / sin_a
        vz = (dz - z * cos_s) / sin_a
        gpnew = vx * gx + vy * gy + vz * gz
        safe = torch.where(torch.abs(gpnew) < tiny, 1.0, gpnew)
        proj = torch.where(converged, 0.0, -fn_eval / safe)
        step = torch.where(active, damping * proj, 0.0)
        cv, sv = torch.cos(step), torch.sin(step)
        nx, ny, nz = x * cv + vx * sv, y * cv + vy * sv, z * cv + vz * sv
        nrm = torch.sqrt(nx * nx + ny * ny + nz * nz)
        nx, ny, nz = nx / nrm, ny / nrm, nz / nrm
        # NaN repair: a poisoned row keeps its previous iterate and stops
        bad = ~(torch.isfinite(nx) & torch.isfinite(ny) & torch.isfinite(nz))
        x = torch.where(bad, x, nx)
        y = torch.where(bad, y, ny)
        z = torch.where(bad, z, nz)
        active = active & (torch.abs(proj) >= tol_eff) & ~bad
        i += 1
    SPHERE_SOLVES.append((i, int(active.sum())))
    return x, y, z


class _SphereInverse(torch.autograd.Function):
    """forward: the sphere solve, with no graph; backward: the implicit
    gradient with respect to the target columns and every parameter."""

    @staticmethod
    def forward(ctx, solve, exp_map, prepare, tx, ty, tz, *params):
        x, y, z = solve(tx, ty, tz, params)
        ctx.exp_map = exp_map
        ctx.prepare = prepare
        ctx.save_for_backward(x, y, z, *params)
        return x, y, z

    @staticmethod
    def backward(ctx, gx, gy, gz):
        x, y, z, *params = ctx.saved_tensors
        with torch.no_grad():
            t1, t2 = sphere_tangent_basis_cols(x, y, z)
            tang = tuple(torch.stack([a, b]) for a, b in zip(t1, t2))
            _, (px, py, pz) = ctx.exp_map((x, y, z),
                                          ctx.prepare(tuple(params)), tang)
            a, b = (px[0], py[0], pz[0]), (px[1], py[1], pz[1])
            aa = a[0] * a[0] + a[1] * a[1] + a[2] * a[2]
            bb = b[0] * b[0] + b[1] * b[1] + b[2] * b[2]
            ab = a[0] * b[0] + a[1] * b[1] + a[2] * b[2]
            u1 = t1[0] * gx + t1[1] * gy + t1[2] * gz      # B^T g
            u2 = t2[0] * gx + t2[1] * gy + t2[2] * gz
            det = aa * bb - ab * ab
            w1 = (bb * u1 - ab * u2) / det
            w2 = (aa * u2 - ab * u1) / det
            ybar = tuple(ai * w1 + bi * w2 for ai, bi in zip(a, b))
        wanted = [i for i, p in enumerate(params)
                  if ctx.needs_input_grad[6 + i]]
        grads = [None] * len(params)
        if wanted:
            with torch.enable_grad():
                leaves = [p.detach().requires_grad_(i in wanted)
                          for i, p in enumerate(params)]
                phi = ctx.exp_map((x, y, z), ctx.prepare(tuple(leaves)))
                got = torch.autograd.grad(
                    phi, [leaves[i] for i in wanted],
                    tuple(-c for c in ybar), allow_unused=True)
            for i, gi in zip(wanted, got):
                grads[i] = torch.zeros_like(params[i]) if gi is None else gi
        return (None, None, None, *ybar, *grads)


def make_sphere_inverse_fn(exp_map, prepare=lambda p: p, max_iter=1000,
                           damping=0.4, tol=1e-12):
    """Build ``inv(tx, ty, tz, params) -> (x, y, z)`` solving phi(x; params)
    = t on the unit sphere, on (B,) columns.  ``exp_map(x3, prepare(params),
    t3=None)`` returns phi's three columns, and with tangents t3 (three
    tensors broadcasting to (n, B)) also its directional derivatives along
    them (three (n, B) tensors); ``prepare`` makes once per call what does
    not depend on the point.  The result is differentiable in the target
    and the parameters (a tuple of tensors).  The dtype-aware guards are the
    JAX package's: edge = max(1e-15, 8 eps), tol_eff = max(tol, 30 eps)."""
    def solve(tx, ty, tz, params):
        with torch.no_grad():
            return _sphere_newton(exp_map, tx, ty, tz, prepare(params),
                                  max_iter, damping, tol)

    def inverse(tx, ty, tz, params):
        return _SphereInverse.apply(solve, exp_map, prepare, tx, ty, tz,
                                    *params)
    return inverse
