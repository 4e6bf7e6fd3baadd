"""Float64 values and gradients of the skewed and the mean-centred
flagship of the port against the JAX package (see test_torch_layer_pdf.py
for the models): log_prob, all_layer_forward on shared base draws, and the
gradients of -log_prob().mean() and of a sample objective, on ``gg+f+gg``
stacks (JAX's float64 compile of the four-layer stacks is most of such a
test's time; the two-layer stacks run the same layers and options; the
float32 route, tests/test_torch_layer_f32.py, runs the four-layer ones).

Inputs are made with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch.utils.convert import params_from_jax
from torch_one_thread import _one_torch_thread  # noqa: F401

SKEW = {"g": {"add_skewness": 1}}
CENTRE = {"g": {"center_mean": 1}}
B = 256
# float64: identical algorithms (fixed trip counts), libm differences only;
# gradients 1e-7 (the implicit-function gradient of the bisection/Newton
# root carries its residual)
TOL_F64 = 1e-8
TOL_GRAD_F64 = 1e-7


def _data(seed, dtype, cond, d_total=10):
    rng = np.random.default_rng(seed)
    x = 0.8 * rng.normal(size=(B, d_total))
    x[:, 4] = rng.uniform(0.2, 2.9, B)
    x[:, 5] = rng.uniform(0.1, 6.2, B)
    z = rng.normal(size=(B, d_total))
    ci = rng.normal(size=(B, 3)) if cond else None
    cast = (lambda a: None if a is None else a.astype(dtype))
    return cast(x), cast(z), cast(ci)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _objectives(p, x, z, ci, mod):
    """(-log_prob().mean(), (x**2).mean() - 0.1 log-det mean of the sample
    direction) of a pdf of either package."""
    def nll(pp):
        return -p.log_prob(pp, x, conditional_input=ci)[0].mean()

    def samp(pp):
        zeros = mod.zeros(z.shape[0], dtype=z.dtype)
        s, ld = p.all_layer_forward(pp, z, zeros, ci)
        return (s**2).mean() - 0.1 * ld.mean()
    return nll, samp


@pytest.mark.parametrize("opts,cond", [(SKEW, 3), (CENTRE, None)],
                         ids=["skewed-cond", "centred"])
def test_f64_values_and_gradients_match_jax(opts, cond):
    """log_prob and its base positions, all_layer_forward on shared base
    draws (1e-8), and the gradients of both objectives (1e-7).  The skewed
    conditional model (per-row parameters everywhere) and the centred
    unconditional one (broadcast parameters in block 0, the centring mean
    from one parameter row); the skewed unconditional stack's float64
    values are also held by the frozen fixture parity_e2_gg_skew
    (tests/test_torch_pdf.py), every model's float32 route by
    tests/test_torch_layer_f32.py."""
    kw = dict(options_overwrite=opts, conditional_input_dim=cond,
              amortization_mlp_dims="16")
    jp, tp = jpdf("e4+s2+e4", "gg+f+gg", **kw), \
        tpdf("e4+s2+e4", "gg+f+gg", device="cpu", **kw)
    jpar = jp.init_params(seed=0, dtype=jnp.float64)
    rng = np.random.default_rng(7)
    # move every parameter so the exponents and per-row parameters vary
    jpar = {k: v + 0.05 * rng.normal(size=v.shape) for k, v in jpar.items()}
    tpar = params_from_jax(jpar)
    x, z, ci = _data(4, np.float64, cond)
    jn, js = _objectives(jp, _j(x), _j(z), _j(ci), jnp)

    @jax.jit
    def ref(p):
        lp, _, base = jp.log_prob(p, _j(x), conditional_input=_j(ci))
        xf, ldf = jp.all_layer_forward(p, _j(z), jnp.zeros(B, jnp.float64),
                                       _j(ci))
        return (lp, base, xf, ldf), (jax.grad(jn)(p), jax.grad(js)(p))

    vj, gj = ref(jpar)
    lt, _, bt = tp.log_prob(tpar, _t(x), conditional_input=_t(ci))
    vt = (lt, bt) + tp.all_layer_forward(
        tpar, _t(z), torch.zeros(B, dtype=torch.float64), _t(ci))
    for a, b in zip(vt, vj):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) < TOL_F64
    tn, ts = _objectives(tp, _t(x), _t(z), _t(ci), torch)
    gt = (tp._value_and_grad(tn, tpar)[1], tp._value_and_grad(ts, tpar)[1])
    for a, b in zip(gt, gj):
        for key in b:
            ref_g = np.asarray(b[key])
            err = np.abs(a[key].numpy() - ref_g).max() / max(
                np.abs(ref_g).max(), 1e-30)
            assert err < TOL_GRAD_F64, (key, err)
