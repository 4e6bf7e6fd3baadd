"""The port's circle and interval ops against the JAX package in float64:
values and gradients.

* ``ops/splines.py`` ``rq_spline`` (with and without the bounded bin
  ratio), ``rq_spline_smooth`` (K = 2, both solutions, and the mirrored
  K = 3) and ``rq_spline_smooth_circular``, in both directions, on rows
  exactly on the bin edges and inside the box;
* the bin search: the port's ``_searchsorted`` has no top-edge margin, and
  puts ties on every edge, values above the top edge and NaN in the bins
  the JAX package's search with its margin (``eps=1e-6``) gives;
* ``layers/sphere.py`` ``moebius_trafo`` and ``moebius_trafo_deriv``, both
  parametrizations, shared and per-row parameters;
* ``ops/manifold.py``: the circle's and the interval's projections from
  the real line, and the circle's embedding.

Values are held at 1e-10, gradients at 1e-8.  Inputs are made with numpy
from a seed and handed to both packages."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jammy_flows_tpu.layers import sphere as jsph
from jammy_flows_tpu.ops import manifold as jman, splines as jspl
from jammy_flows_tpu_torch.layers import sphere as tsph
from jammy_flows_tpu_torch.ops import manifold as tman, splines as tspl
from torch_one_thread import _one_torch_thread  # noqa: F401

B, D = 24, 2
# the same float64 expressions: libm and summation-order differences only
TOL = 1e-10
TOL_GRAD = 1e-8
TWO_PI = 2.0 * math.pi
# the JAX reference is compiled once and run once on a small batch, so its
# compile time is the file's: at XLA's lowest backend optimization level
# (less LLVM optimization of the same HLO) it compiles ~10% faster
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})


def _close(a, b, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.broadcast_to(np.asarray(b), a.shape),
                               rtol=tol, atol=tol)


def _check(fn_t, fn_j, args, seed, skip_rows=0):
    """Values of fn_t and fn_j on args, and the gradients of sum(w_i *
    out_i) with respect to every argument, w from a seed and 0 on the first
    ``skip_rows`` rows (rows on a bin edge, where each package's own edges,
    equal to ~1 ulp, may put a row in either bin)."""
    rng = np.random.default_rng(seed)
    got = fn_t(*[torch.as_tensor(a) for a in args])
    ws = [rng.normal(size=o.shape) for o in got]
    for w in ws:
        w[:skip_rows] = 0.0

    def ref(*a):
        outs, vjp = jax.vjp(fn_j, *a)
        return outs, vjp(tuple(jnp.asarray(w) for w in ws))

    outs, g_j = _jit(ref)(*[jnp.asarray(a) for a in args])
    for a, r in zip(got, outs):
        _close(a, r)
    leaves = [torch.as_tensor(a).requires_grad_() for a in args]
    tot = sum((torch.as_tensor(w) * o).sum()
              for w, o in zip(ws, fn_t(*leaves)))
    for g, r in zip(torch.autograd.grad(tot, leaves), g_j):
        _close(g, r, TOL_GRAD)


def _both(fn, x_fwd, x_inv, *params, **kw):
    """fn forward on x_fwd and inverse on x_inv, as one tuple."""
    return (*fn(x_fwd, *params, inverse=False, **kw),
            *fn(x_inv, *params, inverse=True, **kw))


def _on_edges(u, k, lo, hi, seed):
    """Rows exactly on every bin edge of the logits u (the box's ends
    included), then rows inside the box; (B, D)."""
    _, edges = tspl._bin_positions(torch.as_tensor(u), k, 1e-3, lo, hi)
    e = np.broadcast_to(edges.numpy(), (B, D, k + 1))
    x = np.random.default_rng(seed).uniform(lo, hi, size=(B, D))
    for i in range(k + 1):
        x[i] = e[i, :, i]
    return x


@pytest.mark.parametrize("bp,ratio", [(1, -1.0), (B, 10.0)],
                         ids=["shared", "per-row-ratio"])
def test_rq_spline_matches_jax(bp, ratio):
    """Both directions, the bounded bin ratio or not."""
    k, lo, hi = 5, -1.5, 4.0
    rng = np.random.default_rng(1 + bp)
    uw, uh = rng.normal(size=(2, bp, D, k))
    ud = rng.normal(size=(bp, D, k + 1))
    xf = _on_edges(tspl._restrict_ratio(torch.as_tensor(uw), k, ratio), k,
                   lo, hi, seed=2)
    xi = _on_edges(tspl._restrict_ratio(torch.as_tensor(uh), k, ratio), k,
                   lo, hi, seed=3)
    box = dict(left=lo, right=hi, bottom=lo, top=hi,
               restrict_max_min_width_height_ratio=ratio)
    _check(lambda *a: _both(tspl.rq_spline, *a, **box),
           lambda *a: _both(jspl.rq_spline, *a, **box),
           (xf, xi, uw, uh, ud), seed=4, skip_rows=k + 1)


@pytest.mark.parametrize("k,solution", [(2, 0), (2, 1), (3, 0)])
def test_rq_spline_smooth_matches_jax(k, solution):
    """Both directions; K = 3 mirrored, as the interval layer passes it."""
    rng = np.random.default_rng(5 + k + solution)
    uw, uh = rng.normal(size=(2, B, D, k))
    if k == 3:
        uw[..., 2], uh[..., 2] = uw[..., 0], uh[..., 0]
    ubd = rng.normal(size=(B, D, 2))
    xf = _on_edges(uw, k, 0.0, 1.0, seed=6)
    xi = _on_edges(uh, k, 0.0, 1.0, seed=7)
    kw = dict(solution_index=solution)
    _check(lambda *a: _both(tspl.rq_spline_smooth, *a, **kw),
           lambda *a: _both(jspl.rq_spline_smooth, *a, **kw),
           (xf, xi, uw, uh, ubd), seed=8, skip_rows=k + 1)


@pytest.mark.parametrize("bp", [1, B], ids=["shared", "per-row"])
def test_rq_spline_smooth_circular_matches_jax(bp):
    """Both directions; rows at exactly 0 and 2 pi map to themselves."""
    rng = np.random.default_rng(9 + bp)
    uw, uh = rng.normal(size=(2, bp, 1, 2))
    x = rng.uniform(0.0, TWO_PI, size=(2, B, 1))
    x[:, 0], x[:, 1] = 0.0, TWO_PI
    got = _both(tspl.rq_spline_smooth_circular, *map(torch.as_tensor, x),
                torch.as_tensor(uw), torch.as_tensor(uh))
    for out in got[0::2]:
        assert out[0].item() == 0.0 and out[1].item() == TWO_PI
    _check(lambda *a: _both(tspl.rq_spline_smooth_circular, *a),
           lambda *a: _both(jspl.rq_spline_smooth_circular, *a),
           (x[0], x[1], uw, uh), seed=10, skip_rows=2)


def test_bin_search_without_the_top_margin_matches_jax():
    k = 5
    rng = np.random.default_rng(9)
    _, edges = tspl._bin_positions(torch.as_tensor(rng.normal(size=(B, D, k))),
                                   k, 1e-3, -1.0, 2.0)
    e = edges.numpy()
    x = rng.uniform(-2.0, 3.0, size=(B, D))
    for i in range(k + 1):
        x[i] = e[i, :, i]                       # ties with every edge
    top = e[..., -1]
    x[k + 1] = top[k + 1] + 5e-7                # above, inside the margin
    x[k + 2] = top[k + 2] + 1e-6                # on the margin
    x[k + 3] = top[k + 3] + 1e-3                # above the margin
    x[k + 4] = np.nan
    x[k + 5, 0], x[k + 5, 1] = -np.inf, np.inf
    got = tspl._searchsorted(edges, torch.as_tensor(x)).numpy()
    ref = np.asarray(_jit(jspl._searchsorted)(jnp.asarray(e),
                                                 jnp.asarray(x)))
    np.testing.assert_array_equal(got, ref)
    assert (got[k + 1:k + 4] == k - 1).all() and (got[k + 4] == 0).all()


@pytest.mark.parametrize("use_xyz", [True, False], ids=["xyz", "angle"])
@pytest.mark.parametrize("bp", [1, B], ids=["shared", "per-row"])
def test_moebius_trafo_and_derivative_match_jax(use_xyz, bp):
    nop = 4 if use_xyz else 3
    rng = np.random.default_rng(10 + bp + nop)
    mp = rng.normal(size=(bp, 5, nop))
    # not at +-pi itself: there each component's arctan2 is at its branch
    # cut, where rounding picks the side (the map's seam in both packages)
    x = rng.uniform(-math.pi, math.pi, size=(B, 1))
    x[0], x[1] = -math.pi + 1e-6, math.pi - 1e-6

    def fn_t(x, p):
        return (tsph.moebius_trafo(x, p, use_xyz),
                tsph.moebius_trafo_deriv(x, p, use_xyz))

    def fn_j(x, p):
        return (jsph.moebius_trafo(x, p, use_xyz),
                jsph.moebius_trafo_deriv(x, p, use_xyz))

    _check(fn_t, fn_j, (x, mp), seed=11)
    assert (fn_t(torch.as_tensor(x), torch.as_tensor(mp))[1] > 0).all()


def test_circle_and_interval_maps_match_jax():
    """plane <-> circle (both signs, 0, far tails), real line <-> interval
    and the circle's embedding and its inverse; the log-det accumulators
    start from a non-zero value."""
    rng = np.random.default_rng(12)
    r = rng.normal(size=(B, 1)) * 2.0
    r[0], r[1], r[2] = 0.0, 9.0, -9.0
    ang = rng.uniform(0.0, TWO_PI, size=(B, 1))
    ang[0], ang[1], ang[2] = 0.0, math.pi, TWO_PI - 1e-9
    ld = rng.normal(size=B)
    lo, hi = -5.5, 10.0
    iv = rng.uniform(lo, hi, size=(B, 1))
    e = np.concatenate([np.cos(ang), np.sin(ang)], axis=1) * 1.3

    def fn_t(r, ang, ld, iv, e):
        return (*tman.plane_to_circle(r, ld), *tman.circle_to_plane(ang, ld),
                *tman.real_line_to_interval(r, ld, lo, hi),
                *tman.interval_to_real_line(iv, ld, lo, hi),
                tman.spherical_to_eucl(ang), tman.circle_eucl_to_spherical(e))

    def fn_j(r, ang, ld, iv, e):
        return (*jman.plane_to_circle(r, ld), *jman.circle_to_plane(ang, ld),
                *jman.real_line_to_interval(r, ld, lo, hi),
                *jman.interval_to_real_line(iv, ld, lo, hi),
                jman.spherical_to_eucl(1, ang, 0.0)[0],
                jman.eucl_to_spherical(1, e, 0.0)[0])

    # gradients away from the folds (0, the circle's seam at pi, the clamp
    # at 2 pi)
    _check(fn_t, fn_j, (r, ang, ld, iv, e), seed=13, skip_rows=3)
