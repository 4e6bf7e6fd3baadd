"""The remaining Euclidean options of the port against the JAX package:
the rq_splines stretch, the angles / cayley / triangular_combination
rotations, high_precision_tail_newton, the affine flow `t` (every
cov_type) and the identity `x` with an offset.

* float64: log_prob, the base positions and all_layer_forward on shared
  base draws at 1e-8, the gradient of the mean log_prob at 1e-7 (relative
  norm), on permanent parameters (one shared matrix) and on amortized ones
  (per-row matrices, splines and triangular solves);
* float32: the per-layer kernel routes (ops/gf_layer.py plain versions on
  the CPU) of the angles rotation and of tail Newton, against the JAX
  package with its per-layer Pallas kernels in interpret mode, log_prob at
  3e-4 and all_layer_forward at 3e-3, with the entry points the port calls
  counted.

Inputs are made with numpy from a seed and handed to both packages."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jammy_flows_tpu.ops.pallas_gf as pg
from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch.ops import gf_block as tblk, gf_layer as gl
from jammy_flows_tpu_torch.utils.convert import params_from_jax
from test_torch_grad_pdf import _j, _rel, _t
from torch_one_thread import _one_torch_thread  # noqa: F401

B = 128
TOL_F64 = 1e-8
TOL_F64_GRAD = 1e-7
TOL_F32_DENSITY = 3e-4
TOL_F32_SAMPLE = 3e-3

# rq_splines stretches under each rotation, then `t` with each cov_type
# (the last layer takes the sub-pdf's offset, `x` none); the classic
# stretch's rotations are those of the float32 routes below and of the
# e3_gg_angles fixture (test_torch_pdf.py)
SPLINES = {"nonlinear_stretch_type": "rq_splines"}
F64_MODELS = {
    "tri-t-shared": ("e3", "gtt", {
        (0, 0): {"g": dict(SPLINES, rotation_mode="triangular_combination")},
        (0, 1): {"t": {"cov_type": "diagonal_symmetric"}},
        (0, 2): {"t": {"cov_type": "full"}}}, None),
    "angles-t-per-row": ("e3", "gtt", {
        (0, 0): {"g": dict(SPLINES, rotation_mode="angles")},
        (0, 1): {"t": {"cov_type": "diagonal"}},
        (0, 2): {"t": {"cov_type": "full"}}}, 2),
    "cayley-x-offset": ("e2", "gtx", {
        "g": dict(SPLINES, rotation_mode="cayley"),
        "t": {"cov_type": "identity"}, "x": {"add_offset": 1}}, None),
}
# float32: an angles layer and a tail-Newton layer, on permanent
# (broadcast) parameters or amortized ones (lazy or per-row)
ROUTES = {(0, 0): {"g": {"rotation_mode": "angles"}},
          (0, 1): {"g": {"high_precision_tail_newton": 2}}}
# (mode, interface) of every gf_layer call of log_prob + all_layer_forward:
# the angles layer takes the raw (broadcast) or the lazy interface; the
# tail-Newton layer the prepared solve and the prepared density pass at the
# refined root and, in log_prob, the raw interface (its rows materialized
# when amortized)
ROUTE_CALLS = {
    None: {("forward", "raw"): 2, ("sample", "raw"): 1,
           ("inverse", "prepared"): 1, ("forward", "prepared"): 1},
    3: {("forward", "raw"): 1, ("forward", "lazy"): 1, ("sample", "lazy"): 1,
        ("inverse", "prepared"): 1, ("forward", "prepared"): 1},
}


@pytest.fixture
def interpret_mode():
    prev = pg._INTERPRET
    pg._INTERPRET = True
    jax.clear_caches()
    yield
    pg._INTERPRET = prev
    jax.clear_caches()


def _jittered(jp, dtype, seed):
    """init_params(seed=0) with the permanent parameters moved by
    0.3 N(0, 1) (the rotations' and `t`'s start at 0) and the MLP's by
    0.02 N(0, 1)."""
    rng = np.random.default_rng(seed)
    par = {k: np.asarray(v) for k, v in jp.init_params(
        seed=0, dtype=jnp.float64).items()}
    return {k: (v + (0.02 if k.startswith("mlp_") else 0.3)
                * rng.normal(size=v.shape)).astype(dtype)
            for k, v in par.items()}


def _data(d, cond, seed, dtype):
    rng = np.random.default_rng(seed)
    x, z = 0.8 * rng.normal(size=(B, d)), rng.normal(size=(B, d))
    ci = rng.normal(size=(B, cond)) if cond else None
    cast = (lambda a: None if a is None else a.astype(dtype))
    return cast(x), cast(z), cast(ci)


@pytest.mark.parametrize("name", list(F64_MODELS))
def test_f64_values_and_log_prob_gradient_match_jax(name):
    defs, flows, opts, cond = F64_MODELS[name]
    kw = dict(options_overwrite=opts, conditional_input_dim=cond,
              amortization_mlp_dims="16")
    jp, tp = jpdf(defs, flows, **kw), tpdf(defs, flows, device="cpu", **kw)
    par = _jittered(jp, np.float64, seed=1)
    x, z, ci = _data(int(defs[1:]), cond, seed=2, dtype=np.float64)
    jpar = {k: jnp.asarray(v) for k, v in par.items()}

    @jax.jit
    def ref(p, x, z, c):
        def nll(pp):
            lp, _, base = jp.log_prob(pp, x, conditional_input=c)
            return -lp.mean(), (lp, base)
        (_, (lp, base)), g = jax.value_and_grad(nll, has_aux=True)(p)
        return lp, base, g, jp.all_layer_forward(p, z, jnp.zeros(B), c)

    lj, bj, gj, (xj, ldj) = ref(jpar, _j(x), _j(z), _j(ci))
    tpar = params_from_jax(par)
    lt, _, bt = tp.log_prob(tpar, _t(x), conditional_input=_t(ci))
    xt, ldt = tp.all_layer_forward(tpar, _t(z), torch.zeros(B,
                                                            dtype=torch.float64),
                                   _t(ci))
    for a, b in ((lt, lj), (bt, bj), (xt, xj), (ldt, ldj)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) < TOL_F64
    _, gt = tp._value_and_grad(
        lambda pp: -tp.log_prob(pp, _t(x), conditional_input=_t(ci))[0]
        .mean(), tpar)
    for key, g in gt.items():
        assert _rel(g.numpy(), gj[key]) < TOL_F64_GRAD, key


@pytest.mark.parametrize("cond", [None, 3], ids=["unconditional",
                                                 "conditional"])
def test_f32_kernel_routes_match_interpret_kernels(interpret_mode,
                                                   monkeypatch, cond):
    kw = dict(options_overwrite=ROUTES, conditional_input_dim=cond,
              amortization_mlp_dims="16")
    jp, tp = jpdf("e3", "gg", **kw), tpdf("e3", "gg", device="cpu", **kw)
    assert tp._block_meta == [None]
    calls = []
    run = gl._run
    monkeypatch.setattr(gl, "_run", lambda *a: calls.append(a[:2]) or run(*a))
    par = _jittered(jp, np.float32, seed=3)
    x, z, ci = _data(3, cond, seed=4, dtype=np.float32)

    @jax.jit
    def ref(p, x, z, c):
        lp = jp.log_prob(p, x, conditional_input=c)[0]
        return (lp,) + jp.all_layer_forward(p, z, jnp.zeros(B, jnp.float32),
                                            c)

    lj, xj, ldj = ref({k: jnp.asarray(v) for k, v in par.items()}, _j(x),
                      _j(z), _j(ci))
    tpar = params_from_jax(par)
    lt = tp.log_prob(tpar, _t(x), conditional_input=_t(ci))[0]
    xt, ldt = tp.all_layer_forward(tpar, _t(z), torch.zeros(B), _t(ci))
    assert float(np.abs(lt.numpy() - np.asarray(lj)).max()) < TOL_F32_DENSITY
    assert float(np.abs(xt.numpy() - np.asarray(xj)).max()) < TOL_F32_SAMPLE
    assert float(np.abs(ldt.numpy() - np.asarray(ldj)).max()) < TOL_F32_SAMPLE
    assert collections.Counter(calls) == ROUTE_CALLS[cond]
    assert not any(tblk.LAUNCHES.values())
