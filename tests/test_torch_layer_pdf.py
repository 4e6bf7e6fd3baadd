"""The skewed and the mean-centred flagship of the port against the JAX
package: ``pdf("e4+s2+e4", "gggg+f+gggg")`` with
``options_overwrite={"g": {"add_skewness": 1}}`` or
``{"g": {"center_mean": 1}}``, unconditional and with
``conditional_input_dim=3``.  Neither stack runs as a whole block: the `g`
layers go one by one (ops/gf_layer.py, its plain versions on the CPU).

* init_params draws the same values as the JAX package (float64 values and
  gradients: tests/test_torch_layer_grad.py; the float32 route against the
  interpret-mode kernels: tests/test_torch_layer_f32.py);
* the float32 sample -> log_prob roundtrip on the CPU;
* nll_value_and_grad (autograd per sub-pdf, no block is eligible) equals
  autograd of -log_prob().mean().

Inputs are made with numpy from a seed and handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch.utils.convert import params_from_jax
from torch_one_thread import _one_torch_thread  # noqa: F401

FLAGSHIP = ("e4+s2+e4", "gggg+f+gggg")
SKEW = {"g": {"add_skewness": 1}}
CENTRE = {"g": {"center_mean": 1}}
MODELS = [(SKEW, None), (SKEW, 3), (CENTRE, None), (CENTRE, 3)]
IDS = ["skewed", "skewed-cond", "centred", "centred-cond"]
B = 256
TOL_ROUNDTRIP_Q999 = 1e-3      # tests/test_tpu_kernels.py
# nll_value_and_grad vs autograd: the same graph, summed per sub-pdf
TOL_NLL = 1e-6


def _pair(opts, cond, dims="16"):
    kw = dict(options_overwrite=opts, conditional_input_dim=cond,
              amortization_mlp_dims=dims)
    return jpdf(*FLAGSHIP, **kw), tpdf(*FLAGSHIP, device="cpu", **kw)


def _data(seed, dtype, cond, n=B):
    """Target rows (e4 within the bulk, s2 angles inside (0, pi) x
    (0, 2pi)), base draws and a conditional input."""
    rng = np.random.default_rng(seed)
    x = 0.8 * rng.normal(size=(n, 10))
    x[:, 4] = rng.uniform(0.2, 2.9, n)
    x[:, 5] = rng.uniform(0.1, 6.2, n)
    z = rng.normal(size=(n, 10))
    ci = rng.normal(size=(n, 3)) if cond else None
    cast = (lambda a: None if a is None else a.astype(dtype))
    return cast(x), cast(z), cast(ci)


def _t(a):
    return None if a is None else torch.as_tensor(a)


@pytest.mark.parametrize("opts,cond", MODELS, ids=IDS)
def test_init_params_equal_jax(opts, cond):
    """The skewed packing (exponents, zeros at init) and the centred one
    ((K-1)*d means) load 1:1, and init_params(seed=0) draws JAX's values."""
    jp, tp = _pair(opts, cond, dims="128")
    jpar = jp.init_params(seed=0, dtype=jnp.float64)
    tpar = tp.init_params(seed=0, dtype=torch.float64)
    assert sorted(tpar) == sorted(jpar)
    assert tp.num_parameter_list == jp.num_parameter_list
    loaded = params_from_jax(jpar)
    for key in jpar:
        np.testing.assert_array_equal(tpar[key].numpy(), np.asarray(jpar[key]))
        assert torch.equal(loaded[key], tpar[key])


def _centred_bulk(p, params, scale=1.0 / 3.0):
    """The centred model's means scaled into the bulk: at init_params the
    centring mean lies ~10 widths off, where the f32 4-step Newton solve of
    both packages does not converge on every row."""
    out = dict(params)
    for k, layers in enumerate(p.layer_list):
        key = f"mlp_{k}" if f"mlp_{k}" in params else "flow_0"
        if key not in params:
            continue
        vec = out[key].clone()
        row = vec.shape[0] - sum(p.num_parameter_list[k])
        for lay in layers:
            if getattr(lay, "center_mean", 0):
                lo = row + lay.model_offset * lay.dimension \
                    + lay.num_rotation_params
                vec[lo:lo + lay.num_mean_params] *= scale
            row += lay.num_params
        out[key] = vec
    return out


@pytest.mark.parametrize("opts,cond", MODELS, ids=IDS)
def test_f32_sample_roundtrip_on_cpu(opts, cond):
    """sample -> log_prob through the per-layer plain versions: finite, and
    |dlogp| q999 below 1e-3."""
    _, tp = _pair(opts, cond, dims="128")
    par = tp.init_params(seed=0)
    if opts is CENTRE:
        par = _centred_bulk(tp, par)
    n = 2048
    ci = torch.randn((n, 3), generator=torch.Generator().manual_seed(1)) \
        if cond else None
    x, _, lp, _ = tp.sample(par, samplesize=n, conditional_input=ci,
                            generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(x).all() and torch.isfinite(lp).all()
    lp_eval = tp.log_prob(par, x, conditional_input=ci)[0]
    assert torch.quantile((lp_eval - lp).abs(), 0.999).item() \
        < TOL_ROUNDTRIP_Q999


@pytest.mark.parametrize("opts,cond", MODELS, ids=IDS)
def test_nll_value_and_grad_matches_autograd(opts, cond):
    _, tp = _pair(opts, cond)
    par = {k: v + 0.02 * torch.randn(v.shape, generator=torch.Generator()
                                     .manual_seed(2))
           for k, v in tp.init_params(seed=0).items()}
    x, _, ci = _data(3, np.float32, cond)
    l1, g1 = tp.nll_value_and_grad(par, _t(x), _t(ci))
    l2, g2 = tp._value_and_grad(
        lambda pp: -tp.log_prob(pp, _t(x), _t(ci))[0].mean(), par)
    assert abs(float(l1) - float(l2)) < TOL_NLL * abs(float(l2))
    for key in g1:
        assert torch.allclose(g1[key], g2[key], rtol=1e-5, atol=1e-7), key
