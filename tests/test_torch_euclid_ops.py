"""The port's spline, triangular-matrix and rotation ops against the JAX
package in float64: values and gradients.

* ``ops/splines.py`` ``rq_spline_linear_ext`` in both directions (the
  density direction with one shared set of parameters, the sampling
  direction with per-row ones), on rows below, inside and above the box,
  exactly on its edges and on inner bin edges, and NaN; the bin search
  puts ties and NaN where the JAX package's does;
* ``ops/matrix.py`` ``triangular_apply`` for every covariance type and
  ``triangular_combination_apply``, shared (Bp = 1) and per-row (Bp = B)
  matrices, both directions;
* ``ops/rotations.py`` ``givens_matrix``, ``cayley_matrix`` and
  ``apply_rotation``.

Inputs are made with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jammy_flows_tpu.ops import matrix as jmat, rotations as jrot, \
    splines as jspl
from jammy_flows_tpu_torch.ops import matrix as tmat, rotations as trot, \
    splines as tspl
from torch_one_thread import _one_torch_thread  # noqa: F401

B, D, K = 24, 3, 5
# the same float64 expressions: libm and summation-order differences only
TOL = 1e-10
TOL_GRAD = 1e-10


def _close(a, b, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


def _grads(fn_t, fn_j, args, seed):
    """Gradients of sum(w_i * out_i) in both packages, w from a seed, with
    respect to every argument."""
    outs = fn_t(*[torch.as_tensor(a) for a in args])
    rng = np.random.default_rng(seed)
    ws = [rng.normal(size=o.shape) for o in outs]
    leaves = [torch.as_tensor(a).requires_grad_() for a in args]
    tot = sum((torch.as_tensor(w) * o).sum()
              for w, o in zip(ws, fn_t(*leaves)))
    got = torch.autograd.grad(tot, leaves)
    ref = jax.jit(jax.grad(
        lambda *a: sum(jnp.sum(jnp.asarray(w) * o)
                       for w, o in zip(ws, fn_j(*a))),
        argnums=tuple(range(len(args)))))(*[jnp.asarray(a) for a in args])
    for g, r in zip(got, ref):
        _close(g, r, TOL_GRAD)


def _spline_args(bp, seed):
    rng = np.random.default_rng(seed)
    uw = rng.normal(size=(bp, D, K))
    uh = rng.normal(size=(bp, D, K))
    ud = rng.normal(size=(bp, D, K + 1))
    left = rng.normal(size=(bp, D)) - 1.0
    right = left + np.exp(rng.normal(size=(bp, D))) + 0.5
    bottom = rng.normal(size=(bp, D)) - 1.0
    top = bottom + np.exp(rng.normal(size=(bp, D))) + 0.5
    return uw, uh, ud, left, right, bottom, top


def _spline_inputs(params, inverse, seed):
    """Rows exactly on the box's edges and its inner bin edges (of the
    direction's input axis), then one row below and one above the box,
    then rows inside it."""
    uw, uh, _, left, right, bottom, top = [torch.as_tensor(p) for p in params]
    u, lo, hi = (uh, bottom, top) if inverse else (uw, left, right)
    _, edges = tspl._bin_positions(u, K, tspl.MIN_BIN_WIDTH,
                                   lo[..., None], hi[..., None])
    edges = np.broadcast_to(edges.numpy(), (B, D, K + 1))
    u = np.random.default_rng(seed).uniform(0.0, 1.0, size=(B, D))
    x = edges[..., 0] + u * (edges[..., -1] - edges[..., 0])
    for i in range(K + 1):          # every edge, the box's ends included
        x[i] = edges[i, :, i]
    x[K + 1] = edges[K + 1, :, 0] - 3.0
    x[K + 2] = edges[K + 2, :, -1] + 3.0
    return x


@pytest.mark.parametrize("inverse,bp", [(False, 1), (True, B)],
                         ids=["forward-shared", "inverse-per-row"])
def test_rq_spline_linear_ext_matches_jax(inverse, bp):
    params = _spline_args(bp, seed=1 + bp)
    x = _spline_inputs(params, inverse, seed=2)

    def fn_t(x, *p):
        return tspl.rq_spline_linear_ext(x, *p, inverse=inverse)

    def fn_j(x, *p):
        return jspl.rq_spline_linear_ext(x, *p, inverse=inverse)

    xn = x.copy()
    xn[-1, 1] = np.nan
    got = fn_t(torch.as_tensor(xn), *[torch.as_tensor(p) for p in params])
    ref = jax.jit(fn_j)(jnp.asarray(xn), *[jnp.asarray(p) for p in params])
    for a, r in zip(got, ref):
        a = a.numpy()
        assert np.array_equal(np.isnan(a), np.isnan(np.asarray(r)))
        assert np.isnan(a[-1, 1]) and not np.isnan(a[:-1]).any()
        _close(a, r)
    # gradients away from the edges: on an edge each package's own edges
    # (equal to ~1 ulp) may put a row in either bin, whose parameters then
    # take its gradient
    inside, outside = slice(K + 3, None), slice(K + 1, K + 3)
    _grads(fn_t, fn_j, (x[inside],) + tuple(
        p if bp == 1 else p[inside] for p in params), seed=3)
    sub = (x[outside],) + tuple(p if bp == 1 else p[outside] for p in params)
    if not inverse:
        _grads(fn_t, fn_j, sub, seed=3)
        return
    # rows outside the box in the sampling direction: the JAX package's
    # gradient is NaN wherever the unused bin branch's discriminant is
    # negative (its clamp's tangent multiplies the square root's infinite
    # one by 0); the port's is the tail's own, held against central
    # differences
    ref = jax.jit(jax.grad(lambda *a: jnp.sum(fn_j(*a)[0]),
                           argnums=tuple(range(len(sub)))))(
        *[jnp.asarray(a) for a in sub])
    assert any(np.isnan(np.asarray(r)).any() for r in ref)
    leaves = [torch.as_tensor(a).requires_grad_() for a in sub]
    got = torch.autograd.grad(fn_t(*leaves)[0].sum(), leaves)
    for i, g in enumerate(got):
        fd = np.zeros(sub[i].shape)
        for j in np.ndindex(sub[i].shape):
            hi, lo = [np.array(a) for a in sub], [np.array(a) for a in sub]
            hi[i][j] += 1e-6
            lo[i][j] -= 1e-6
            fd[j] = (fn_t(*map(torch.as_tensor, hi))[0].sum()
                     - fn_t(*map(torch.as_tensor, lo))[0].sum()) / 2e-6
        _close(g, fd, 1e-6)


def test_spline_bin_search_puts_ties_and_nan_in_the_jax_bins():
    rng = np.random.default_rng(4)
    _, edges = tspl._bin_positions(
        torch.as_tensor(rng.normal(size=(B, D, K))), K, 1e-3,
        torch.full((B, D, 1), -1.0, dtype=torch.float64),
        torch.full((B, D, 1), 2.0, dtype=torch.float64))
    e = edges.numpy()
    x = rng.uniform(-2.0, 3.0, size=(B, D))
    for i in range(K + 1):
        x[i] = e[i, :, i]                     # ties with every edge
    x[K + 1] = np.nan
    x[K + 2, 0] = -np.inf
    x[K + 2, 1] = np.inf
    # the linear-extension form's search, eps = 0 (jammy_flows_tpu
    # ops/splines.py rq_spline_linear_ext)
    got = tspl._searchsorted(edges, torch.as_tensor(x)).numpy()
    ref = np.asarray(jax.jit(jspl._searchsorted, static_argnums=2)(
        jnp.asarray(e), jnp.asarray(x), 0.0))
    np.testing.assert_array_equal(got, ref)
    assert (got[K + 1] == 0).all()


def _both(fn, *args):
    """fn's outputs in both directions, as one tuple."""
    return tuple(fn(*args, inverse=False)) + tuple(fn(*args, inverse=True))


def _values_and_grads(fn_t, fn_j, args, seed, tol=TOL):
    got = fn_t(*[torch.as_tensor(a) for a in args])
    ref = jax.jit(fn_j)(*[jnp.asarray(a) for a in args])
    for a, r in zip(got, ref):
        _close(a, np.broadcast_to(np.asarray(r), a.shape), tol)
    _grads(fn_t, fn_j, args, seed)


@pytest.mark.parametrize("bp", [1, B], ids=["shared", "per-row"])
@pytest.mark.parametrize("cov_type", ["identity", "diagonal_symmetric",
                                      "diagonal", "full"])
def test_triangular_apply_matches_jax(cov_type, bp):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, D))
    single = 0.3 * rng.normal(size=(bp, 1))
    full = 0.3 * rng.normal(size=(bp, D))
    off = rng.normal(size=(bp, D * (D - 1) // 2))
    pick = {"identity": (), "diagonal_symmetric": (0,), "diagonal": (1,),
            "full": (1, 2)}[cov_type]
    args = (x,) + tuple((single, full, off)[i] for i in pick)

    def tup(p):
        out = [None, None, None]
        for i, v in zip(pick, p):
            out[i] = v
        return tuple(out)

    def fn_t(x, *p):
        return _both(lambda *a, inverse: tmat.triangular_apply(
            D, cov_type, tup(p), x, inverse))

    def fn_j(x, *p):
        return _both(lambda *a, inverse: jmat.triangular_apply(
            D, cov_type, tup(p), x, inverse))

    if cov_type == "identity":
        got, ref = fn_t(torch.as_tensor(x)), fn_j(jnp.asarray(x))
        for a, r in zip(got, ref):
            _close(a, r)
        return
    _values_and_grads(fn_t, fn_j, args, seed=6)


@pytest.mark.parametrize("bp", [1, B], ids=["shared", "per-row"])
def test_triangular_combination_matches_jax(bp):
    rng = np.random.default_rng(7)
    n_tri = D * (D - 1) // 2
    args = (rng.normal(size=(B, D)), rng.normal(size=(bp, n_tri)),
            0.3 * rng.normal(size=(bp, D - 1)), rng.normal(size=(bp, n_tri)))

    def fn_t(x, l, dg, r):
        return _both(lambda inverse: (tmat.triangular_combination_apply(
            D, l, dg, r, x, inverse),))

    def fn_j(x, l, dg, r):
        return _both(lambda inverse: (jmat.triangular_combination_apply(
            D, l, dg, r, x, inverse),))

    _values_and_grads(fn_t, fn_j, args, seed=8)
    # the map preserves volume and its inverse undoes it
    y, _ = fn_t(*[torch.as_tensor(a) for a in args])
    back = tmat.triangular_combination_apply(
        D, *[torch.as_tensor(a) for a in args[1:]], y, inverse=True)
    _close(back, args[0])


@pytest.mark.parametrize("bp", [1, B], ids=["shared", "per-row"])
def test_givens_and_cayley_rotations_match_jax(bp):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(B, 4))
    args = (x, rng.normal(size=(bp, 6)), x[:, :2], rng.normal(size=(bp, 1)))

    def fn_t(x4, angles, x2, t):
        g, c = trot.givens_matrix(angles, 4), trot.cayley_matrix(t)
        return (g, c) + _both(lambda inverse: (
            trot.apply_rotation(g, x4, inverse),
            trot.apply_rotation(c, x2, inverse)))

    def fn_j(x4, angles, x2, t):
        g, c = jrot.givens_matrix(angles, 4), jrot.cayley_matrix(t)
        return (g, c) + _both(lambda inverse: (
            jrot.apply_rotation(g, x4, inverse),
            jrot.apply_rotation(c, x2, inverse)))

    _values_and_grads(fn_t, fn_j, args, seed=10)
    for mat in fn_t(*[torch.as_tensor(a) for a in args])[:2]:
        d = mat.shape[-1]
        _close(mat @ mat.transpose(1, 2),
               torch.eye(d, dtype=torch.float64).expand(bp, d, d))
