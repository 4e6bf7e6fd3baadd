"""The port's skewed logistic mixture against the JAX package.

* ``skew_mixture_logs`` (the float32 chain the per-layer kernels share):
  values and gradients (plain autograd of the same expressions, as JAX
  differentiates them), on rows on both sides of the y = 0.1 seam of
  log((1 + e^x)^a - 1) and far in both tails;
* the float64 log-space chain of ``logistic_mixture_log_quantities`` and
  ``gaussianize_forward`` / ``gaussianize_value`` with skewness, values and
  gradients;
* the kernel bodies of ops/gf.py: the raw-parameter prep with its sign
  pattern, the skewed component-quantile bracket and the solve.

Inputs are made with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jammy_flows_tpu.ops import logistic_kde as jkde
from jammy_flows_tpu.ops import pallas_gf as jpg
from jammy_flows_tpu.ops import special as jspecial
from jammy_flows_tpu_torch.ops import gf as tgf
from jammy_flows_tpu_torch.ops import logistic_kde as tkde
from jammy_flows_tpu_torch.ops import special as tspecial
from torch_one_thread import _one_torch_thread  # noqa: F401

K, D = 10, 3
# float64: the same formulas, rounding only.  float32: a few ulp of exp /
# log per term, amplified by the iCDF tails' slope: 2e-5 relative + 2e-5
# absolute on values; gradients as relative norms, 1e-5.
TOL = {np.float64: 1e-10, np.float32: 2e-5}
TOL_GRAD = {np.float64: 1e-10, np.float32: 1e-5}


def _skew_inputs(dtype, seed=0, b=300):
    """common (K, D, B) spanning the bulk and both far tails, per-row
    log_inv_widths / log_norm_w / log_skew, and the +1-prefix signs.  The
    exponents range so that y = a softplus(+-c) falls on both sides of 0.1."""
    rng = np.random.default_rng(seed)
    c = np.concatenate([rng.normal(size=(K, D, b - 60)),
                        -12.0 - 10.0 * rng.uniform(size=(K, D, 30)),
                        12.0 + 10.0 * rng.uniform(size=(K, D, 30))], axis=2)
    liw = 0.3 * rng.normal(size=(K, D, b))
    ln = rng.normal(size=(K, D, b))
    lnw = ln - np.log(np.exp(ln).sum(axis=0, keepdims=True))
    ls = rng.uniform(-2.2, 2.2, size=(K, D, b))
    signs = np.where(np.arange(K) < K // 2, 1.0, -1.0).reshape(K, 1, 1)
    return [a.astype(dtype) for a in (c, liw, lnw, ls, signs)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _grads_torch(fn, arrays, cts, n_diff):
    leaves = [torch.as_tensor(a).requires_grad_(i < n_diff)
              for i, a in enumerate(arrays)]
    outs = fn(*leaves)
    got = torch.autograd.grad(outs, leaves[:n_diff],
                              [torch.as_tensor(c) for c in cts],
                              allow_unused=True)
    return ([o.detach().numpy() for o in outs],
            [np.zeros(a.shape) if g is None else g.numpy()
             for a, g in zip(arrays, got)])


def _grads_jax(fn, arrays, cts, n_diff):
    diff = [jnp.asarray(a) for a in arrays[:n_diff]]
    rest = [jnp.asarray(a) for a in arrays[n_diff:]]
    outs, vjp = jax.vjp(lambda *d: fn(*d, *rest), *diff)
    return outs, vjp(tuple(jnp.asarray(c) for c in cts))


def test_seam_and_tails_are_covered():
    c, _, _, ls, signs = _skew_inputs(np.float64)
    y = np.exp(ls) * np.logaddexp(np.where(signs > 0, -c, c), 0.0)
    assert (y < 0.1).mean() > 0.05 and (y > 0.1).mean() > 0.5
    assert (c < -12).any() and (c > 12).any()


@pytest.mark.parametrize("need_pdf", [True, False])
def test_skew_mixture_logs_values_and_grads(need_pdf):
    """The f32 chain: (log_cdf, log_sf, log_pdf) and the VJP to (common,
    log_inv_widths, log_norm_w, log_skew)."""
    arrs = _skew_inputs(np.float32)
    rng = np.random.default_rng(1)
    n_out = 3 if need_pdf else 2
    cts = [rng.normal(size=(D, arrs[0].shape[2])).astype(np.float32)
           for _ in range(n_out)]
    tv, tg = _grads_torch(
        lambda *a: tkde.skew_mixture_logs(*a, need_pdf)[:n_out], arrs, cts, 4)
    jv, jg = _grads_jax(
        lambda *a: jkde.skew_mixture_logs(*a, need_pdf)[:n_out], arrs, cts, 4)
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a, b, rtol=TOL[np.float32],
                                   atol=TOL[np.float32])
    for a, b in zip(tg, jg):
        assert _rel(a, b) < TOL_GRAD[np.float32]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_skewed_log_quantities_values_and_grads(dtype):
    """logistic_mixture_log_quantities with skewness: float64 through the
    log-space chain (expm1 regime), float32 through skew_mixture_logs."""
    rng = np.random.default_rng(2)
    b = 200
    x = np.concatenate([rng.normal(size=(b - 40, D)),
                        25.0 * np.sign(rng.normal(size=(40, D)))])
    means = rng.normal(size=(K, D, 1))
    lw = np.log(0.3 + rng.uniform(size=(K, D, 1)))
    ln = rng.normal(size=(K, D, 1))
    ls = rng.uniform(-2.2, 2.2, size=(K, D, 1))
    signs = np.where(np.arange(K) < K // 2, 1.0, -1.0).reshape(K, 1, 1)
    arrs = [a.astype(dtype) for a in (x, means, lw, ln, ls)]
    sg = signs.astype(dtype)
    cts = [rng.normal(size=(b, D)).astype(dtype) for _ in range(3)]
    tv, tg = _grads_torch(
        lambda xx, m, w, n, s: tkde.logistic_mixture_log_quantities(
            xx, m, w, n, True, s, torch.as_tensor(sg)), arrs, cts, 5)
    jv, jg = _grads_jax(
        lambda xx, m, w, n, s: jkde.logistic_mixture_log_quantities(
            xx, m, w, n, s, jnp.asarray(sg), add_skewness=True,
            calculate_pdf=True), arrs, cts, 5)
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a, b, rtol=TOL[dtype], atol=TOL[dtype])
    for a, b in zip(tg, jg):
        assert _rel(a, b) < TOL_GRAD[dtype]


@pytest.mark.parametrize("dtype,ift", [(np.float64, "isigmoid"),
                                       (np.float32, "inormal_partly_precise")])
def test_gaussianize_skewed(ift, dtype):
    rng = np.random.default_rng(3)
    x = (1.5 * rng.normal(size=(150, D))).astype(dtype)
    means = rng.normal(size=(K, D, 150)).astype(dtype)
    lw = np.log(0.3 + rng.uniform(size=(K, D, 150))).astype(dtype)
    ln = rng.normal(size=(K, D, 150)).astype(dtype)
    ls = rng.uniform(-1.5, 1.5, size=(K, D, 150)).astype(dtype)
    signs = np.where(np.arange(K) < K // 2, 1.0, -1.0).reshape(
        K, 1, 1).astype(dtype)
    jargs = [jnp.asarray(a) for a in (x, means, lw, ln, ls, signs)]
    targs = [torch.as_tensor(a) for a in (x, means, lw, ln)]
    tskew = [torch.as_tensor(ls), torch.as_tensor(signs)]
    jv, jd = jkde.gaussianize_forward(*jargs, True, ift)
    tv, td = tkde.gaussianize_forward(*targs, ift, *tskew)
    # float32 values in the iCDF's tails: 10x the mixture's limit (the
    # tail slope amplifies the few-ulp differences of the logs)
    tol = TOL[dtype] * (1 if dtype == np.float64 else 10)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=tol, atol=tol)
    np.testing.assert_allclose(td.numpy(), jd, rtol=tol, atol=tol)
    np.testing.assert_allclose(
        tkde.gaussianize_value(*targs, ift, *tskew).numpy(),
        jkde.gaussianize_value(*jargs, True, ift), rtol=tol, atol=tol)


def test_exponent_regulator_is_the_bounded_kind():
    """log_bounded_exp_fn(0.1, 9.0, center=True): a Regulator of kind
    "bounded" (the kernels' apply_reg / reg_deriv code 3) with the JAX
    closure's values and derivatives."""
    reg = tspecial.log_bounded_exp_fn(0.1, 9.0, center=True)
    assert reg.kernel_args()[0] == tspecial.REG_KINDS["bounded"] == 3
    x = np.linspace(-12.0, 12.0, 301)
    jreg = jspecial.log_bounded_exp_fn(0.1, 9.0, center=True)
    xt = torch.as_tensor(x).requires_grad_()
    val = reg(xt)
    g, = torch.autograd.grad(val.sum(), xt)
    np.testing.assert_allclose(val.detach().numpy(), jreg(jnp.asarray(x)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(g.numpy(), jax.vmap(jax.grad(jreg))(
        jnp.asarray(x)), rtol=1e-12, atol=1e-12)


def _raw_slabs(rng, per_row, b):
    cols = b if per_row else 1
    return [rng.normal(size=(K, D, cols)),
            -1.0 + 0.5 * rng.normal(size=(K, D, cols)),
            rng.normal(size=(K, D, cols)),
            0.8 * rng.normal(size=(K, D, cols))]


@pytest.mark.parametrize("ift", ["isigmoid", "inormal_full_pade"])
def test_skewed_bracket_and_solve(ift):
    """The raw prep (regulators, log-softmax, exponents, signs from their
    +1 count), the skewed component-quantile bracket (the log(1 - e^u)
    series above u = -0.1) and the solve (regula-falsi start for every iCDF
    type), f32, against the JAX kernel bodies."""
    rng = np.random.default_rng(4)
    b = 256
    slabs = [a.astype(np.float32) for a in _raw_slabs(rng, True, b)]
    reg_w = tspecial.width_regulator_fn(0, 1, 0.01, 100, 0)
    reg_e = tspecial.log_bounded_exp_fn(0.1, 9.0, center=True)
    signs = tuple([1.0] * (K // 2) + [-1.0] * (K - K // 2))
    tprep = (reg_w, None, True, reg_e, signs)
    jprep = (jspecial.width_regulator_fn(0, 1, 0.01, 100, 0), None, True,
             jspecial.log_bounded_exp_fn(0.1, 9.0, center=True), signs)
    tmix = tgf.prep_raw_params([torch.as_tensor(a) for a in slabs], tprep)
    jmix = jpg._prep_raw_params(tuple(jnp.asarray(a) for a in slabs), jprep)
    for a, bb in zip(tmix, jmix):
        np.testing.assert_allclose(a.numpy(), bb, rtol=2e-6, atol=2e-6)
    # targets in the bulk and in both tails (logit-space targets reach
    # -1 + 1e-?: the series branch of the bracket)
    target = np.concatenate([rng.normal(size=(D, b - 32)),
                             np.full((D, 16), 9.0), np.full((D, 16), -9.0)],
                            axis=1).astype(np.float32)
    tlo, thi, _ = tgf.component_bracket(torch.as_tensor(target), tmix, ift)
    jlo, jhi, _ = jpg._component_bracket(jnp.asarray(target), jmix, ift)
    np.testing.assert_allclose(tlo.numpy(), jlo, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(thi.numpy(), jhi, rtol=1e-4, atol=1e-4)
    # the roots (not the residuals: 4 Newton steps need not converge on a
    # random mixture, in either package)
    xs_t = tgf.solve(torch.as_tensor(target), tmix, ift)
    xs_j = jpg._solve(jnp.asarray(target), jmix, ift)
    np.testing.assert_allclose(xs_t.numpy(), xs_j, rtol=1e-3, atol=1e-3)
    for mode in ("log", "exp"):
        jv, jd = jpg._mixture_value_deriv_solve(xs_j, jmix, mode, ift)
        tv, td = tgf.mixture_value_deriv_solve(
            torch.as_tensor(np.array(xs_j)), tmix, mode, ift)
        np.testing.assert_allclose(tv.numpy(), jv, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(td.numpy(), jd, rtol=2e-4, atol=2e-4)
