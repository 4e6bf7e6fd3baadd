"""The s2 options of `f` against the JAX package, through the pdf entry
points; tests/test_torch_s2_v_pdf.py holds `v` and the embedding-space
models with the helpers defined here.

* `f` over its options as two-option grids, one option set a layer: the
  nested vertical / circular flows with the identity region, the kappa
  predictions (from the xyz / quaternion rotation too), the rotation modes,
  on the (z, phi) carrier; the correlated flow and the in-between rotation,
  on rows;
* the production `f` (tools/bench_production.py's ``PRODUCTION_F``, as
  chip_smoke.py has it) on ``"s2", "fff"`` and conditional on
  ``"e2+s2+e2", "gg+f+gg"``;

in float64: the parameter counts, init_params, log_prob and the base
positions, all_layer_forward on shared base draws at 1e-8, and
``nll_value_and_grad`` against ``jax.grad`` at 1e-7 relative, but for the
production `f` alone (its gradient is the joint's); in float32 the
production joint against the JAX package's float32 path (3e-4 density,
3e-3 sample).  The routes are held too: the (z, phi) carrier where every
layer of the s2 stack has that form, else rows.

The JAX references run the JAX package's row forms
(``JAMMY_DISABLE_COLUMNS=1``, its own switch): its column twins of these
models take XLA ~4x longer to compile (40 s for the production `f`'s
gradient), and the port's (z, phi) carrier is held against rows all the
same.  Inputs are made with numpy from a seed and handed to both packages."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import PRODUCTION_F
from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch.models.pdf import PDF
from jammy_flows_tpu_torch.utils.convert import params_from_jax
from test_torch_grad_pdf import _j, _rel, _t
from test_torch_s1_interval_pdf import _jittered
from torch_one_thread import _one_torch_thread  # noqa: F401

B = 64
TOL_F64 = 1e-8
TOL_F64_GRAD = 1e-7
TOL_SOLVE = 1e-6
TOL_F32_DENSITY = 3e-4
TOL_F32_SAMPLE = 3e-3
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})


# label -> (definitions, flows, options, conditional input dim, embedding
# space, tolerance of (log_prob, all_layer_forward), gradients, whether the
# s2 stack runs on the (z, phi) carrier)
MODELS = {
    "f nested / rotations (z, phi)": ("s2", "ff", {
        (0, 0): {"f": {"add_vertical_rq_spline_flow": 1,
                       "add_circular_rq_spline_flow": 1,
                       "boundary_cos_theta_identity_region": 0.4,
                       "spline_num_basis_functions": 4,
                       "vertical_restrict_max_min_width_height_ratio": 10.0,
                       "vertical_fix_boundary_derivative": 0,
                       "vertical_independent_width_height_parametrization": 1,
                       "kappa_prediction": "softplus_real_bounded",
                       "kappa_clamping": 1, "rotation_mode": "angles"}},
        (0, 1): {"f": {"add_vertical_rq_spline_flow": 1,
                       "vertical_smooth": 1,
                       "spline_num_basis_functions": -1,
                       "vertical_flow_defs": "rr",
                       "add_circular_rq_spline_flow": 1,
                       "circular_flow_defs": "o",
                       "vertical_fix_first_width_n_height_to_zero": 1,
                       "rotation_mode": "xyz", "kappa_prediction": "mu",
                       "inverse_z_scaling": 0}}},
        None, False, (TOL_F64, TOL_F64), True, True),
    "f correlated / in-between (rows)": ("s2", "ff", {
        (0, 0): {"f": {"add_correlated_rq_spline_flow": 1,
                       "correlated_max_rank": 2, "vertical_flow_defs": "r",
                       "circular_flow_defs": "o",
                       "boundary_cos_theta_identity_region": 0.2,
                       "rotation_mode": "quaternion",
                       "kappa_prediction": "quatvec_squared"}},
        (0, 1): {"f": {"add_extra_rotation_inbetween": 1,
                       "kappa_prediction": "log_bounded", "min_kappa": 1e-3,
                       "num_householder_iter": 2}}},
        None, False, (TOL_F64, TOL_F64), True, False),
    "production f": ("s2", "fff", PRODUCTION_F, None, False,
                     (TOL_F64, TOL_F64), False, True),
    "production joint": ("e2+s2+e2", "gg+f+gg", PRODUCTION_F, 3, False,
                         (TOL_F64, TOL_F64), True, True),
}


def _pair(spec, monkeypatch):
    defs, flows, opts, cond, emb = spec[:5]
    monkeypatch.setenv("JAMMY_DISABLE_COLUMNS", "1")
    kw = dict(options_overwrite=opts, conditional_input_dim=cond,
              amortization_mlp_dims="16")
    jp, tp = jpdf(defs, flows, **kw), tpdf(defs, flows, device="cpu", **kw)
    if emb:
        jp.set_embedding_flags(True)
        for layer in tp.layer_list[0]:
            layer.always_parametrize_in_embedding_space = True
        tp._update_embedding_structure()
    return jp, tp, cond


def _data(tp, cond, seed, dtype):
    """Target rows (s2 polar angles in (0.2, 2.9), azimuths in (0.1, 6.2),
    circle angles in (0.05, 2 pi - 0.05); unit vectors in embedding space;
    Euclidean ones 0.8 N(0, 1)), base draws and a conditional input."""
    rng = np.random.default_rng(seed)
    x = 0.8 * rng.normal(size=(B, tp.total_target_dim))
    for k, d in enumerate(tp.pdf_defs_list):
        lo, hi = tp.target_dim_indices[k]
        if d == "s2":
            th, ph = rng.uniform(0.2, 2.9, B), rng.uniform(0.1, 6.2, B)
            cols = [th, ph] if hi - lo == 2 else [
                np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)]
            x[:, lo:hi] = np.stack(cols, axis=1)
        elif d == "s1":
            a = rng.uniform(0.05, 2.0 * math.pi - 0.05, B)
            x[:, lo:hi] = np.stack([np.cos(a), np.sin(a)], axis=1) \
                if hi - lo == 2 else a[:, None]
    z = rng.normal(size=(B, tp.total_base_dim))
    ci = rng.normal(size=(B, cond)) if cond else None
    cast = (lambda a: None if a is None else a.astype(dtype))
    return cast(x), cast(z), cast(ci)


def check_f64(spec, monkeypatch):
    """init_params, log_prob, the base positions, all_layer_forward and,
    where the spec asks, nll_value_and_grad, against the JAX package in
    float64."""
    (tol_lp, tol_fwd), nll_grad = spec[5:7]
    jp, tp, cond = _pair(spec, monkeypatch)
    assert tp.num_parameter_list == jp.num_parameter_list
    jinit = jp.init_params(seed=0, dtype=jnp.float64)
    tinit = tp.init_params(seed=0, dtype=torch.float64)
    assert sorted(tinit) == sorted(jinit)
    for key in jinit:
        np.testing.assert_array_equal(tinit[key].numpy(),
                                      np.asarray(jinit[key]))
    par = _jittered(jp, np.float64, seed=1)
    x, z, ci = _data(tp, cond, 2, np.float64)

    @_jit
    def ref(p, x, z, c):
        def nll(pp):
            lp, _, base = jp.log_prob(pp, x, conditional_input=c)
            return -lp.mean(), (lp, base)

        if nll_grad:
            (_, out), g = jax.value_and_grad(nll, has_aux=True)(p)
        else:
            out, g = nll(p)[1], None
        return out + jp.all_layer_forward(p, z, jnp.zeros(B), c), g

    (lj, bj, xj, ldj), gj = ref({k: jnp.asarray(v) for k, v in par.items()},
                                _j(x), _j(z), _j(ci))
    tpar = params_from_jax(par)
    lt, _, bt = tp.log_prob(tpar, _t(x), conditional_input=_t(ci))
    xt, ldt = tp.all_layer_forward(tpar, _t(z), torch.zeros(
        B, dtype=torch.float64), _t(ci))
    for a, b, tol in ((lt, lj, tol_lp), (bt, bj, tol_lp), (xt, xj, tol_fwd),
                      (ldt, ldj, tol_fwd)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) < tol
    if nll_grad:
        loss, gt = tp.nll_value_and_grad(tpar, _t(x), _t(ci))
        assert abs(float(loss) + float(np.asarray(lj).mean())) < tol_lp
        assert sorted(gt) == sorted(gj)
        tol_g = TOL_F64_GRAD if tol_lp == TOL_F64 else TOL_SOLVE
        for key, g in gt.items():
            assert _rel(g.numpy(), gj[key]) < tol_g, key


def check_f32(spec, monkeypatch):
    """The port's float32 route (the plain block op for the `gg` blocks on
    the CPU) against the JAX package's float32 path: log_prob at 3e-4, the
    samples and their log-det at 3e-3.  The `v` model's sampling direction
    is the float32 sphere solve, which stops where the Newton direction
    turns within 8 eps of the point (cos >= 1 - 8 eps): ~1e-3 rad from the
    root in both packages, each at its own rounding.  Its log-det, which
    reads the point's derivatives there, is held to lie no farther from the
    float64 path than the JAX package's float32 one does, plus 3e-3."""
    jp, tp, cond = _pair(spec, monkeypatch)
    par = _jittered(jp, np.float32, seed=3)
    x, z, ci = _data(tp, cond, 4, np.float32)

    @_jit
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
    if "v" not in tp.flow_defs_list[0]:
        assert float(np.abs(ldt.numpy() - np.asarray(ldj)).max()) \
            < TOL_F32_SAMPLE
        return
    ld64 = tp.all_layer_forward(
        {k: v.double() for k, v in tpar.items()}, _t(z).double(),
        torch.zeros(B, dtype=torch.float64), _t(ci).double())[1].numpy()
    err_t = np.abs(ldt.numpy() - ld64).max()
    err_j = np.abs(np.asarray(ldj) - ld64).max()
    assert err_t < err_j + TOL_F32_SAMPLE


def check_route(spec, monkeypatch):
    """The (z, phi) carrier where every layer of the s2 stack has that form
    (the JAX package's column form), else the row loop; both directions."""
    _, tp, cond = _pair(spec, monkeypatch)
    calls = []
    zphi = PDF._zphi_columns
    monkeypatch.setattr(PDF, "_zphi_columns",
                        lambda self, *a: calls.append(1) or zphi(self, *a))
    par = tp.init_params(seed=0, dtype=torch.float64)
    x, z, ci = _data(tp, cond, 5, np.float64)
    tp.log_prob(par, _t(x), conditional_input=_t(ci))
    tp.all_layer_forward(par, _t(z), torch.zeros(B, dtype=torch.float64),
                         _t(ci))
    assert len(calls) == (2 if spec[7] else 0)


@pytest.mark.parametrize("label", list(MODELS))
def test_f64_matches_jax(monkeypatch, label):
    check_f64(MODELS[label], monkeypatch)


def test_f32_matches_jax(monkeypatch):
    check_f32(MODELS["production joint"], monkeypatch)


@pytest.mark.parametrize("label", list(MODELS))
def test_s2_stack_route(monkeypatch, label):
    check_route(MODELS[label], monkeypatch)
