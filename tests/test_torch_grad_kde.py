"""Gradients of the port's mixture and special functions against the JAX
package's tangent rules.

* ``logistic_kde.mixture_linear_logs`` with the pdf: the port's
  ``torch.autograd.Function`` against ``jax.vjp`` of the JAX package's
  custom-JVP ``_linear_logs_pdf``, on rows in the bulk and rows far in the
  tail that take the ``neg_all``, ``pos_all`` and ``far`` fallback lanes
  (one-hot of the dominant term, not normalized over ties; only the
  coordinate cotangent, none for log_norm_w / log_inv_widths);
* ``special.logaddexp`` and the four regulator kinds against ``jax.grad``.

Inputs are made with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jammy_flows_tpu.ops import logistic_kde as jkde
from jammy_flows_tpu.ops import special as jspecial
from jammy_flows_tpu_torch.ops import logistic_kde as tkde
from jammy_flows_tpu_torch.ops import special as tspecial
from torch_one_thread import _one_torch_thread  # noqa: F401

# float64: the same formulas in both packages, rounding only
TOL_F64 = 1e-10
# float32: relative to each cotangent's largest entry; sums of up to K
# terms in a different order
TOL_F32 = 1e-5


def _mixture(dtype, seed=0, k=6, d=3, b=64, per_row=False):
    """common (K, D, B) with bulk rows and tail rows in every fallback lane,
    and normalized weights / inverse widths (K, D, 1|B)."""
    rng = np.random.default_rng(seed)
    cols = b if per_row else 1
    means = rng.normal(size=(k, d, cols))
    log_iw = 0.3 * rng.normal(size=(k, d, cols))
    ln = rng.normal(size=(k, d, cols))
    lnw = ln - np.log(np.exp(ln).sum(axis=0, keepdims=True))
    x = rng.normal(size=(1, d, b))
    x[0, :, 0:8] = -150.0 + 10.0 * rng.normal(size=(d, 8))    # neg_all
    x[0, :, 8:16] = 150.0 + 10.0 * rng.normal(size=(d, 8))    # pos_all
    x[0, :, 16:24] = 58.0 * rng.choice([-1.0, 1.0], size=(d, 8))  # boundary
    common = (x - means) * np.exp(log_iw)
    # far lanes with components on both sides of the row
    common[:, :, 24:32] = rng.choice([-1.0, 1.0], size=(k, d, 8)) * (
        70.0 + 20.0 * rng.random(size=(k, d, 8)))
    # a tie of the dominant term (the one-hot is not normalized)
    common[:2, :, 32] = -100.0
    arrs = (common, np.exp(lnw), lnw, np.exp(log_iw), log_iw)
    return tuple(a.astype(dtype) for a in arrs)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_mixture_linear_logs_vjp_matches_jax_rule(dtype, per_row):
    arrs = _mixture(dtype, seed=1, per_row=per_row)
    rng = np.random.default_rng(2)
    cts = tuple(rng.normal(size=arrs[0].shape[1:]).astype(dtype)
                for _ in range(3))
    outs_j, vjp = jax.vjp(jkde._linear_logs_pdf, *map(jnp.asarray, arrs))
    grads_j = vjp(tuple(map(jnp.asarray, cts)))
    ins = [torch.as_tensor(a).requires_grad_() for a in arrs]
    outs_t = tkde.mixture_linear_logs(*ins, need_pdf=True)
    grads_t = torch.autograd.grad(outs_t, ins, tuple(map(torch.as_tensor,
                                                         cts)),
                                  allow_unused=True)
    tol = TOL_F64 if dtype == np.float64 else TOL_F32
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=tol, atol=tol)
    for name, gt, gj in zip(("common", "norm_w", "log_norm_w", "inv_widths",
                             "log_inv_widths"), grads_t, grads_j):
        gj = np.asarray(gj)
        gt = np.zeros_like(gj) if gt is None else gt.numpy()
        scale = max(1.0, float(np.abs(gj).max()))
        err = float(np.abs(gt - gj).max()) / scale
        assert err < tol, (name, err)


def test_mixture_tail_lanes_carry_the_coordinate_gradient():
    """In the fallback lanes the gradient reaches the coordinate (an
    outlier still pulls the mixture) and nothing reaches the log-weights."""
    arrs = _mixture(np.float64, seed=3)
    ins = [torch.as_tensor(a).requires_grad_() for a in arrs]
    log_cdf, log_sf, log_pdf = tkde.mixture_linear_logs(*ins, need_pdf=True)
    g = torch.autograd.grad((log_cdf[:, :8].sum() + log_sf[:, 8:16].sum()
                             + log_pdf[:, 24:32].sum()), ins,
                            allow_unused=True)
    assert float(g[0][:, :, :8].abs().sum()) > 0
    assert float(g[0][:, :, 8:16].abs().sum()) > 0
    assert float(g[0][:, :, 24:32].abs().sum()) > 0
    assert g[2] is None or float(g[2].abs().sum()) == 0.0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_logaddexp_and_regulator_gradients_match_jax(dtype):
    rng = np.random.default_rng(4)
    a = (20.0 * rng.normal(size=257)).astype(dtype)
    b = (20.0 * rng.normal(size=257)).astype(dtype)
    a[:3] = b[:3]                      # ties
    ga_j, gb_j = jax.grad(lambda u, v: jnp.logaddexp(u, v).sum(),
                          argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.as_tensor(a).requires_grad_(), \
        torch.as_tensor(b).requires_grad_()
    ga_t, gb_t = torch.autograd.grad(tspecial.logaddexp(ta, tb).sum(),
                                     (ta, tb))
    tol = 1e-12 if dtype == np.float64 else 1e-6
    np.testing.assert_allclose(ga_t.numpy(), np.asarray(ga_j), atol=tol)
    np.testing.assert_allclose(gb_t.numpy(), np.asarray(gb_j), atol=tol)
    x = np.linspace(-40.0, 40.0, 321).astype(dtype)
    regs = (
        (jspecial.width_regulator_fn(1, 0, 0.01, 100, 0),
         tspecial.width_regulator_fn(1, 0, 0.01, 100, 0)),
        (jspecial.width_regulator_fn(0, 0, 0.01, 100, 1),
         tspecial.width_regulator_fn(0, 0, 0.01, 100, 1)),
        (jspecial.width_regulator_fn(0, 1, 0.01, 100, 0),
         tspecial.width_regulator_fn(0, 1, 0.01, 100, 0)),
        (jspecial.log_bounded_exp_fn(1, 10), tspecial.log_bounded_exp_fn(1, 10)),
    )
    assert {r.kind for _, r in regs} == {"log_softplus", "logaddexp",
                                          "bounded"}
    for jr, tr in regs:
        gj = np.asarray(jax.grad(lambda u: jr(u).sum())(jnp.asarray(x)))
        tx = torch.as_tensor(x).requires_grad_()
        gt, = torch.autograd.grad(tr(tx).sum(), tx)
        np.testing.assert_allclose(gt.numpy(), gj, atol=tol, rtol=tol)
    ti = torch.as_tensor(x).requires_grad_()
    gi, = torch.autograd.grad(tspecial.IDENTITY(ti).sum(), ti)
    assert torch.equal(gi, torch.ones_like(ti))
