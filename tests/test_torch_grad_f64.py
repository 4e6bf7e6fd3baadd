"""Float64 gradients of the port against the JAX package's f64 CPU path:
``log_prob`` and ``all_layer_forward`` of the flagship's manifolds and
layer kinds with two-layer Euclidean flows, ``e4+s2+e4`` / ``gg+f+gg`` (the
per-layer bisection/Newton solve differentiates by the implicit function,
as in JAX: the repair of the detached root), and the s2 `f` layer's
(z, phi) column path at the poles (float32 too).

Inputs are made with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch.utils.convert import params_from_jax, to_numpy
from test_torch_grad_pdf import _data, _j, _jittered, _pair, _rel, _t
from torch_one_thread import _one_torch_thread  # noqa: F401

# the flagship's manifolds, normal and logistic iCDF layers, offset and
# conditional MLPs, with two layers per Euclidean block: JAX's f64 compile
# of the four-layer flagship takes most of these tests' time
DEFS, FLOWS = "e4+s2+e4", "gg+f+gg"
B64 = 128
# float64: the same algorithms, rounding and libm only
TOL_F64 = 1e-7
# float32 (the pole test): the relative norm of tests/test_torch_grad_pdf.py
TOL_F32 = 1e-4


@pytest.mark.parametrize("cond", [None, 3])
def test_f64_log_prob_gradient_matches_jax(cond):
    jp, tp = _pair(DEFS, FLOWS, cond)
    par = _jittered(jp, np.float64, seed=3)
    x, ci = _data(tp, B64, cond, seed=4, dtype=np.float64)
    lt, gt = tp.nll_value_and_grad(params_from_jax(par), _t(x), _t(ci))
    lj, gj = jax.jit(jax.value_and_grad(lambda pp: -jp.log_prob(
        pp, _j(x), conditional_input=_j(ci))[0].mean()))(
        {k: jnp.asarray(v) for k, v in par.items()})
    assert abs(float(lt) - float(lj)) < TOL_F64
    for key, g in to_numpy(gt).items():
        assert _rel(g, gj[key]) < TOL_F64, key


@pytest.mark.parametrize("cond", [None, 3])
def test_f64_sample_gradient_matches_jax(cond):
    """d/dparams of (x**2).mean() + 0.1 * logq.mean() through
    all_layer_forward on shared base draws: the per-layer Newton solve
    differentiates by the implicit function, as in JAX."""
    jp, tp = _pair(DEFS, FLOWS, cond)
    par = _jittered(jp, np.float64, seed=5)
    rng = np.random.default_rng(6)
    z = rng.normal(size=(B64, tp.total_base_dim))
    ci = None if cond is None else rng.normal(size=(B64, cond))
    log_base = -0.5 * (z**2).sum(axis=1) - 0.5 * z.shape[1] * np.log(
        2.0 * np.pi)

    def objective_j(pp):
        xs, ld = jp.all_layer_forward(pp, _j(z), jnp.zeros(B64), _j(ci))
        return (xs**2).mean() + 0.1 * (jnp.asarray(log_base) - ld).mean()

    def objective_t(pp):
        xs, ld = tp.all_layer_forward(pp, _t(z), torch.zeros(
            B64, dtype=torch.float64), _t(ci))
        return (xs**2).mean() + 0.1 * (_t(log_base) - ld).mean()

    vj, gj = jax.jit(jax.value_and_grad(objective_j))(
        {k: jnp.asarray(v) for k, v in par.items()})
    vt, gt = tp._value_and_grad(objective_t, params_from_jax(par))
    assert abs(float(vt) - float(vj)) < TOL_F64
    for key, g in to_numpy(gt).items():
        assert _rel(g, gj[key]) < TOL_F64, key


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_s2_column_gradients_at_the_poles(dtype):
    """The `f` layer's (z, phi) column path with rows at and next to the
    poles: the angle and cos(theta) clamps give finite gradients equal to
    JAX's, in both directions."""
    jp, tp = jpdf("s2", "f"), tpdf("s2", "f", device="cpu")
    par = {k: np.asarray(v).astype(dtype) for k, v in jp.init_params(
        seed=0, dtype=jnp.float64).items()}
    th = np.array([0.0, 1e-9, 1e-5, 0.3, 1.5, np.pi - 1e-5, np.pi - 1e-9,
                   np.pi])
    x = np.stack([th, np.linspace(0.0, 2.0 * np.pi, len(th))], 1).astype(dtype)
    z = np.array([[0.0, 0.0], [1e-6, 0.0], [9.0, 0.1], [-12.0, 3.0],
                  [0.3, -0.2]], dtype=dtype)
    tol = TOL_F64 if dtype == np.float64 else TOL_F32
    jpar = {k: jnp.asarray(v) for k, v in par.items()}
    gj = (jax.jit(jax.grad(lambda pp: -jp.log_prob(pp, _j(x))[0].mean()))(
        jpar), jax.jit(jax.grad(lambda pp: (jp.all_layer_forward(
            pp, _j(z), jnp.zeros(len(z), dtype))[0]**2).mean()))(jpar))
    tpar = params_from_jax(par)
    gt = (tp._value_and_grad(lambda pp: -tp.log_prob(pp, _t(x))[0].mean(),
                             tpar)[1],
          tp._value_and_grad(lambda pp: (tp.all_layer_forward(
              pp, _t(z), torch.zeros(len(z), dtype=_t(z).dtype))[0]**2
          ).mean(), tpar)[1])
    for got, ref in zip(gt, gj):
        g = got["flow_0"].numpy()
        assert np.isfinite(g).all()
        assert _rel(g, ref["flow_0"]) < tol
