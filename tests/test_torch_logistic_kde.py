"""The port's mixture and iCDF math against the JAX package, in both the f64
branch and the f32 branch (the formulation the CUDA block kernel shares),
including the far-tail fallback lanes of the linear mixture."""
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

IFTS = ["isigmoid", "inormal_partly_precise", "inormal_partly_crude",
        "inormal_full_pade"]
# f64: the same expressions in both frameworks, libm-level differences only.
# f32: exp/log of XLA and of PyTorch's CPU kernels round differently (a few
# ulp); the iCDF tails amplify that by their slope, so values are held at
# 2e-5 relative to their magnitude (plus 2e-5 absolute).
TOL = {np.float64: (1e-10, 1e-10), np.float32: (2e-5, 2e-5)}
K, D, B = 10, 3, 400


def _mixture(dtype, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(K, D, 1))
    log_widths = np.log(0.3 + rng.uniform(size=(K, D, 1)))
    log_norms = rng.normal(size=(K, D, 1))
    # bulk, moderate tails, and far tails beyond every component (the
    # fallback lanes: all |common| > 55)
    x = np.concatenate([rng.normal(size=(B - 80, D)),
                        8.0 * rng.normal(size=(40, D)),
                        np.sign(rng.normal(size=(40, D))) * (40.0 + 30.0 *
                                                            rng.uniform(size=(40, D)))])
    return [a.astype(dtype) for a in (x, means, log_widths, log_norms)]


def _close(a, b, dtype):
    rel, ab = TOL[dtype]
    a, b = np.asarray(a), np.asarray(b)
    assert np.all(np.isfinite(a) == np.isfinite(b))
    m = np.isfinite(b)
    np.testing.assert_allclose(a[m], b[m], rtol=rel, atol=ab)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_mixture_log_quantities(dtype):
    arrs = _mixture(dtype)
    j = jkde.logistic_mixture_log_quantities(
        *[jnp.asarray(a) for a in arrs], jnp.zeros((1, 1, 1), dtype),
        jnp.ones((1, 1, 1), dtype), add_skewness=False, calculate_pdf=True)
    t = tkde.logistic_mixture_log_quantities(*[torch.as_tensor(a) for a in arrs])
    for a, b in zip(t, j):
        _close(a.numpy(), b, dtype)


def test_mixture_linear_logs_far_tail_lanes():
    x, means, log_widths, log_norms = _mixture(np.float32)
    common = (x.T[None] - means) * np.exp(-log_widths)
    lnw = log_norms - np.log(np.exp(log_norms).sum(0, keepdims=True))
    args = (common, np.exp(lnw), lnw, np.exp(-log_widths), -log_widths)
    far = np.abs(common).min(0) > 55.0
    assert far.sum() > 20, "the inputs must reach the fallback lanes"
    j = jkde.mixture_linear_logs(*[jnp.asarray(a) for a in args], True)
    t = tkde.mixture_linear_logs(*[torch.as_tensor(a) for a in args], True)
    for a, b in zip(t, j):
        _close(a.numpy(), b, np.float32)
    jv = jkde.mixture_linear_logs(*[jnp.asarray(a) for a in args], False)
    tv = tkde.mixture_linear_logs(*[torch.as_tensor(a) for a in args], False)
    assert tv[2] is None
    for a, b in zip(tv[:2], jv[:2]):
        _close(a.numpy(), b, np.float32)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("ift", IFTS)
def test_gaussianize_forward_and_value(ift, dtype):
    x, means, log_widths, log_norms = _mixture(dtype, seed=1)
    jargs = [jnp.asarray(a) for a in (x, means, log_widths, log_norms)]
    targs = [torch.as_tensor(a) for a in (x, means, log_widths, log_norms)]
    skew = (jnp.zeros((1, 1, 1), dtype), jnp.ones((1, 1, 1), dtype))
    jv, jd = jkde.gaussianize_forward(*jargs, *skew, False, ift)
    tv, td = tkde.gaussianize_forward(*targs, ift)
    _close(tv.numpy(), jv, dtype)
    _close(td.numpy(), jd, dtype)
    _close(tkde.gaussianize_value(*targs, ift).numpy(),
           jkde.gaussianize_value(*jargs, *skew, False, ift), dtype)


@pytest.mark.parametrize("ift", IFTS)
def test_icdf_on_log_grid(ift):
    """icdf_pass / icdf_log_derivative straight from (log_cdf, log_sf)
    pairs from the centre out to the pade tails, f64 and f32."""
    lc = np.concatenate([-np.logspace(-8, 2.3, 300), np.log(0.5) +
                         np.linspace(-0.3, 0.3, 21)])
    ls = np.log(-np.expm1(lc))
    lpdf = np.full_like(lc, -1.3)
    for dtype in (np.float64, np.float32):
        for a, b in ((lc, ls), (ls, lc)):
            args = [v.astype(dtype) for v in (a, b, lpdf)]
            _close(tkde.icdf_pass(*map(torch.as_tensor, args[:2]), ift).numpy(),
                   jkde.icdf_pass(*map(jnp.asarray, args[:2]), ift), dtype)
            _close(tkde.icdf_log_derivative(*map(torch.as_tensor, args),
                                            ift).numpy(),
                   jkde.icdf_log_derivative(*map(jnp.asarray, args), ift),
                   dtype)
            if dtype == np.float32:
                _close(tgf.icdf_pass_kernel(*map(torch.as_tensor, args[:2]),
                                            ift).numpy(),
                       jpg._icdf_pass_kernel(*map(jnp.asarray, args[:2]), ift),
                       dtype)
                _close(tgf.icdf_log_deriv_kernel(*map(torch.as_tensor, args),
                                                 ift).numpy(),
                       jpg._icdf_log_deriv_kernel(*map(jnp.asarray, args),
                                                  ift), dtype)


@pytest.mark.parametrize("ift", IFTS)
def test_kernel_solve_matches(ift):
    """Bracketed Newton solve of the kernel formulation (f32), and the
    mixture evaluations it calls."""
    rng = np.random.default_rng(2)
    means = rng.normal(size=(K, D, 1)).astype(np.float32)
    iw = (1.0 / (0.3 + rng.uniform(size=(K, D, 1)))).astype(np.float32)
    ln = rng.normal(size=(K, D, 1))
    lnw = (ln - np.log(np.exp(ln).sum(0, keepdims=True))).astype(np.float32)
    target = (1.5 * rng.normal(size=(D, B))).astype(np.float32)
    jmix = (jnp.asarray(means), jnp.asarray(iw), jnp.asarray(lnw), None, None)
    tmix = (torch.as_tensor(means), torch.as_tensor(iw), torch.as_tensor(lnw))
    xs_j = jpg._solve(jnp.asarray(target), jmix, ift)
    xs_t = tgf.solve(torch.as_tensor(target), tmix, ift)
    np.testing.assert_allclose(xs_t.numpy(), xs_j, rtol=1e-4, atol=1e-4)
    for mode in ("log", "exp"):
        jv, jd = jpg._mixture_value_deriv_solve(xs_j, jmix, mode, ift)
        tv, td = tgf.mixture_value_deriv_solve(torch.as_tensor(np.array(xs_j)),
                                               tmix, mode, ift)
        _close(tv.numpy(), jv, np.float32)
        _close(td.numpy(), jd, np.float32)
        jv, jd = jpg._mixture_value_deriv(xs_j, jmix, mode, ift)
        tv, td = tgf.mixture_value_deriv(torch.as_tensor(np.array(xs_j)),
                                         tmix, mode, ift)
        _close(tv.numpy(), jv, np.float32)
        _close(td.numpy(), jd, np.float32)
    # the solve inverts the density-direction pass
    val, _ = tgf.mixture_value_deriv(xs_t, tmix, None, ift)
    assert float((val - torch.as_tensor(target)).abs().max()) < 1e-3


@pytest.mark.parametrize("opts", [
    (0, 1, 0.01, 100, 0), (0, 1, 0.01, 100, 1), (1, 1, 0.01, 100, 0),
    (1, 0, 0.05, 100, 1), (0, 0, 0.01, 100, 0), (0, 0, 0.01, -1, 1)])
def test_regulators(opts):
    rng = np.random.default_rng(3)
    x = (4.0 * rng.normal(size=1000)).astype(np.float64)
    jr = jspecial.width_regulator_fn(*opts)
    tr = tspecial.width_regulator_fn(*opts)
    np.testing.assert_allclose(tr(torch.as_tensor(x)).numpy(),
                               jr(jnp.asarray(x)), rtol=1e-12, atol=1e-12)
    jn = jspecial.log_bounded_exp_fn(1, 10)
    tn = tspecial.log_bounded_exp_fn(1, 10)
    np.testing.assert_allclose(tn(torch.as_tensor(x)).numpy(), jn(jnp.asarray(x)),
                               rtol=1e-12, atol=1e-12)
    a = np.exp(0.5 * rng.normal(size=1000))
    for dtype in (np.float64, np.float32):
        got = tspecial.log_one_plus_exp_x_to_a_minus_1(
            torch.as_tensor(x.astype(dtype)), torch.as_tensor(a.astype(dtype)))
        want = jspecial.log_one_plus_exp_x_to_a_minus_1(
            jnp.asarray(x.astype(dtype)), jnp.asarray(a.astype(dtype)))
        _close(got.numpy(), want, dtype)
