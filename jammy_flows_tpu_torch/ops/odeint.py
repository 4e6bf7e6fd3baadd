"""Adaptive ODE integration with continuous-adjoint gradients.

PyTorch counterpart of ``jammy_flows_tpu/ops/odeint.py``: the embedded
Runge-Kutta pairs the manifold CNF `c` accepts (dopri5, dopri8, bosh3,
fehlberg2, adaptive_heun), the same step control, and reverse-mode
gradients by the continuous adjoint method as a ``torch.autograd.Function``
(the JAX package's ``custom_vjp``).

The JAX package runs the step loop as a ``lax.while_loop`` whose condition
the device reads; here each attempted step reads its error norm on the host
once (one sync a step) and decides there.  Time, step size and error are
scalars of the state's dtype (numpy float32 / float64), as the JAX package
keeps them in the state's dtype.  Each integration appends (kind, accepted
steps, rejected steps, whether it stopped at ``max_steps``) to
``ODE_SOLVES``, kind "forward" or "adjoint".

A state or argument is a tuple of tensors; the error norm runs over all of
them flattened into one vector in tuple order (the JAX package's
``ravel_pytree`` order: the state's leaves, then in the adjoint the
cotangents' and the arguments' gradients).
"""
from __future__ import annotations

import collections
from typing import NamedTuple, Tuple

import numpy as np
import torch

# every integration appends (kind, accepted, rejected, reached max_steps),
# the latest 4096 kept; a caller that reads it clears it first
ODE_SOLVES = collections.deque(maxlen=4096)


class Tableau(NamedTuple):
    c: Tuple[float, ...]
    a: Tuple[Tuple[float, ...], ...]
    b_sol: Tuple[float, ...]       # the propagating (higher-order) weights
    b_err: Tuple[float, ...]       # b_sol - b_low: the error estimate's
    order: int                     # order of the propagating solution


def _make(c, a, b_sol, b_low, order):
    b_err = tuple(s - l for s, l in zip(b_sol, b_low))
    return Tableau(tuple(c), tuple(tuple(r) for r in a), tuple(b_sol),
                   b_err, order)


# Dormand-Prince 5(4)
_DOPRI5 = _make(
    c=(0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0),
    a=(
        (),
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    ),
    b_sol=(35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0),
    b_low=(5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
           187 / 2100, 1 / 40),
    order=5,
)

# Bogacki-Shampine 3(2)
_BOSH3 = _make(
    c=(0.0, 1 / 2, 3 / 4, 1.0),
    a=((), (1 / 2,), (0.0, 3 / 4), (2 / 9, 1 / 3, 4 / 9)),
    b_sol=(2 / 9, 1 / 3, 4 / 9, 0.0),
    b_low=(7 / 24, 1 / 4, 1 / 3, 1 / 8),
    order=3,
)

# Runge-Kutta-Fehlberg 2(1)
_FEHLBERG2 = _make(
    c=(0.0, 1 / 2, 1.0),
    a=((), (1 / 2,), (1 / 256, 255 / 256)),
    b_sol=(1 / 512, 255 / 256, 1 / 512),
    b_low=(1 / 256, 255 / 256, 0.0),
    order=2,
)

# Heun-Euler 2(1)
_ADAPTIVE_HEUN = _make(
    c=(0.0, 1.0),
    a=((), (1.0,)),
    b_sol=(1 / 2, 1 / 2),
    b_low=(1.0, 0.0),
    order=2,
)

# Prince-Dormand 8(7)13M
_DOPRI8 = _make(
    c=(0.0, 1 / 18, 1 / 12, 1 / 8, 5 / 16, 3 / 8, 59 / 400, 93 / 200,
       5490023248 / 9719169821, 13 / 20, 1201146811 / 1299019798, 1.0, 1.0),
    a=(
        (),
        (1 / 18,),
        (1 / 48, 1 / 16),
        (1 / 32, 0.0, 3 / 32),
        (5 / 16, 0.0, -75 / 64, 75 / 64),
        (3 / 80, 0.0, 0.0, 3 / 16, 3 / 20),
        (29443841 / 614563906, 0.0, 0.0, 77736538 / 692538347,
         -28693883 / 1125000000, 23124283 / 1800000000),
        (16016141 / 946692911, 0.0, 0.0, 61564180 / 158732637,
         22789713 / 633445777, 545815736 / 2771057229,
         -180193667 / 1043307555),
        (39632708 / 573591083, 0.0, 0.0, -433636366 / 683701615,
         -421739975 / 2616292301, 100302831 / 723423059,
         790204164 / 839813087, 800635310 / 3783071287),
        (246121993 / 1340847787, 0.0, 0.0, -37695042795 / 15268766246,
         -309121744 / 1061227803, -12992083 / 490766935,
         6005943493 / 2108947869, 393006217 / 1396673457,
         123872331 / 1001029789),
        (-1028468189 / 846180014, 0.0, 0.0, 8478235783 / 508512852,
         1311729495 / 1432422823, -10304129995 / 1701304382,
         -48777925059 / 3047939560, 15336726248 / 1032824649,
         -45442868181 / 3398467696, 3065993473 / 597172653),
        (185892177 / 718116043, 0.0, 0.0, -3185094517 / 667107341,
         -477755414 / 1098053517, -703635378 / 230739211,
         5731566787 / 1027545527, 5232866602 / 850066563,
         -4093664535 / 808688257, 3962137247 / 1805957418,
         65686358 / 487910083),
        (403863854 / 491063109, 0.0, 0.0, -5068492393 / 434740067,
         -411421997 / 543043805, 652783627 / 914296604,
         11173962825 / 925320556, -13158990841 / 6184727034,
         3936647629 / 1978049680, -160528059 / 685178525,
         248638103 / 1413531060, 0.0),
    ),
    b_sol=(14005451 / 335480064, 0.0, 0.0, 0.0, 0.0,
           -59238493 / 1068277825, 181606767 / 758867731,
           561292985 / 797845732, -1041891430 / 1371343529,
           760417239 / 1151165299, 118820643 / 751138087,
           -528747749 / 2220607170, 1 / 4),
    b_low=(13451932 / 455176623, 0.0, 0.0, 0.0, 0.0,
           -808719846 / 976000145, 1757004468 / 5645159321,
           656045339 / 265891186, -3867574721 / 1518517206,
           465885868 / 322736535, 53011238 / 667516719, 2 / 45, 0.0),
    order=8,
)

TABLEAUS = {
    "dopri5": _DOPRI5,
    "dopri8": _DOPRI8,
    "bosh3": _BOSH3,
    "fehlberg2": _FEHLBERG2,
    "adaptive_heun": _ADAPTIVE_HEUN,
}


def _rk_step(tab, f, t, y, h):
    """One embedded RK step on a flat state: (y_new, error estimate).  t
    and h are scalars of the state's dtype; zero coefficients make no
    operation."""
    dt = type(h)
    ks = []
    for i in range(len(tab.c)):
        yi = y
        for j, aij in enumerate(tab.a[i]):
            if aij != 0.0:
                yi = yi + (h * dt(aij)) * ks[j]
        ks.append(f(t + dt(tab.c[i]) * h, yi))
    y_new = y
    err = torch.zeros_like(y)
    for b, e, k in zip(tab.b_sol, tab.b_err, ks):
        if b != 0.0:
            y_new = y_new + (h * dt(b)) * k
        if e != 0.0:
            err = err + (h * dt(e)) * k
    return y_new, err


def _odeint_flat(tab, f, y0, t0, t1, rtol, atol, max_steps, kind):
    """Adaptive integration of a flat state from t0 to t1 (either
    direction): each loop attempts one step, a rejected one shrinks h and
    retries (both count toward max_steps), an overshooting step is clipped
    onto t1.  Returns y(t1)."""
    dt = np.float32 if y0.dtype == torch.float32 else np.float64
    t0, t1 = dt(t0), dt(t1)
    span = t1 - t0
    direction = np.sign(span)
    h = span / dt(16.0)
    tol_t = np.abs(span) * dt(1e-10) + dt(1e-12)
    h_min = tol_t * dt(10.0)
    exponent = dt(-1.0 / tab.order)
    rtol, atol = dt(rtol), dt(atol)
    t, y = t0, y0
    steps = rejected = 0
    while direction * (t1 - t) > tol_t and steps < max_steps:
        h_try = t1 - t if direction * (t + h - t1) > 0 else h
        y_new, y_err = _rk_step(tab, f, t, y, h_try)
        scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y_new))
        err = dt(torch.sqrt(torch.mean((y_err / scale) ** 2)).item())
        if not np.isfinite(err):
            err = dt(2.0)
        factor = min(max(dt(0.9) * max(err, dt(1e-10)) ** exponent,
                         dt(0.2)), dt(5.0))
        h = h_try * factor
        if np.abs(h) < h_min:
            h = direction * h_min
        if err <= dt(1.0):
            t, y = t + h_try, y_new
        else:
            rejected += 1
        steps += 1
    ODE_SOLVES.append((kind, steps - rejected, rejected, steps >= max_steps))
    return y


def _ravel(leaves):
    return torch.cat([t.reshape(-1) for t in leaves])


def _unravel(flat, like):
    sizes = [t.numel() for t in like]
    return tuple(p.view(t.shape)
                 for p, t in zip(torch.split(flat, sizes), like))


class _Odeint(torch.autograd.Function):
    """forward: the adaptive solve with no graph; backward: the continuous
    adjoint, the augmented state (y, a = dL/dy, dL/dargs) integrated from t1
    back to t0 with the same step control."""

    @staticmethod
    def forward(ctx, func, opts, n_y, *leaves):
        y0, args = leaves[:n_y], leaves[n_y:]
        tab, t0, t1, rtol, atol, max_steps = opts

        def f_flat(t, y):
            return _ravel(func(t, _unravel(y, y0), args))

        y1 = _unravel(_odeint_flat(tab, f_flat, _ravel(y0), t0, t1, rtol,
                                   atol, max_steps, "forward"), y0)
        ctx.func, ctx.opts, ctx.n_y = func, opts, n_y
        ctx.save_for_backward(*y1, *args)
        return y1

    @staticmethod
    def backward(ctx, *ct):
        tab, t0, t1, rtol, atol, max_steps = ctx.opts
        saved = ctx.saved_tensors
        y1, args = saved[:ctx.n_y], saved[ctx.n_y:]
        ct = [torch.zeros_like(y) if c is None else c
              for c, y in zip(ct, y1)]
        n_y = sum(y.numel() for y in y1)
        func = ctx.func

        def aug_f(t, state):
            y = _unravel(state[:n_y], y1)
            a = _unravel(state[n_y:2 * n_y], y1)
            with torch.enable_grad():
                yl = [v.detach().requires_grad_() for v in y]
                al = [v.detach().requires_grad_() for v in args]
                out = func(t, tuple(yl), tuple(al))
                grads = torch.autograd.grad(out, yl + al, a,
                                            allow_unused=True)
            grads = [torch.zeros_like(v) if g is None else g
                     for g, v in zip(grads, yl + al)]
            return torch.cat([_ravel(out).detach(), -_ravel(grads)])

        state1 = torch.cat([_ravel(y1), _ravel(ct)]
                           + [torch.zeros(a.numel(), dtype=y1[0].dtype,
                                          device=y1[0].device) for a in args])
        state0 = _odeint_flat(tab, aug_f, state1, t1, t0, rtol, atol,
                              max_steps, "adjoint")
        ct_y0 = _unravel(state0[n_y:2 * n_y], y1)
        ct_args = _unravel(state0[2 * n_y:], args)
        return (None, None, None, *ct_y0, *ct_args)


def odeint(func, y0, args, t0, t1, rtol=1e-7, atol=1e-7, max_steps=1000,
           method="dopri5"):
    """Integrate dy/dt = func(t, y, args) from t0 to t1.  y0 and args are
    tuples of tensors, func returns a tuple shaped as y0; t0 / t1 are
    floats (t1 < t0 integrates backward in time).  Differentiable with
    respect to y0 and args by the continuous adjoint."""
    opts = (TABLEAUS[method], t0, t1, rtol, atol, max_steps)
    return _Odeint.apply(func, opts, len(y0), *y0, *args)


def odeint_dopri5(func, y0, args, t0, t1, rtol=1e-7, atol=1e-7,
                  max_steps=1000):
    """dopri5 through :func:`odeint`."""
    return odeint(func, y0, args, t0, t1, rtol, atol, max_steps, "dopri5")
