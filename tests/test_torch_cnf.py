"""The manifold CNF `c` (jammy_flows_tpu_torch/layers/sphere_cnf.py)
against the JAX package's (jammy_flows_tpu/layers/sphere_cnf.py), in
float64 unless named:

* the maps (sindiv, divsin, the exponential and log maps, the tangent
  projection, the exponential map's log-det) and the log map's Jacobian
  with its clips, on both sides of every Taylor switch, at 1e-12 (3e-9
  the Jacobian, whose first term's cancellation grows an ulp to 1e-9), and
  its float32 prefactor no farther from float64 than the JAX package's;
* the field and its divergence (the port's derivatives carried forward by
  hand) against the JAX package's jacfwd trace, for shared and per-row MLP
  weights in three MLP shapes (highway modes 0-2, a low-rank one), at
  1e-11, and the gradient of the two through reverse mode against
  ``jax.grad`` at 1e-9 relative;
* log_prob, the base positions and all_layer_forward of ``pdf("s2", "c")``
  with midpoint, euler and dopri5 at 1e-8 (the fixed-step solvers) and
  1e-7 (dopri5: both packages step on the same error norms; a decision at
  the accept threshold may differ by an ulp); rk4's and a conditional
  dopri5 model's (the field's weights predicted per row) values come with
  their gradients;
* the float32 path (rk4) against the JAX package's float32 path at 3e-4
  (log_prob) and 3e-3 (samples);
* the route of a conditional `c` between gg blocks: its per-row slab
  materialized, its own autograd pass in ``nll_value_and_grad`` beside the
  blocks' fused NLL.

The gradients of the models (rk4's backprop through checkpointed steps,
dopri5's continuous adjoint) are in tests/test_torch_cnf_grad.py and
tests/test_torch_cnf_adjoint.py.  The
models are small (16 rows, a hidden layer of 8, 2 charts): the JAX
package's column twins are compiled at XLA's lowest backend optimization
level.  Inputs are made with numpy from a seed and handed to both
packages."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu.layers import sphere_cnf as jcnf
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch.layers import sphere_cnf as tcnf
from jammy_flows_tpu_torch.utils.convert import params_from_jax
from test_torch_grad_pdf import _j, _rel, _t
from torch_one_thread import _one_torch_thread  # noqa: F401

B = 16
SMALL = {"num_charts": 2, "cnf_network_hidden_dims": "8"}
TOL_MAPS = 1e-12
# jacoblog's first term is a difference of two terms ~5e3 (at z up to the
# clip, 1 - 1e-4) divided by powers of 1 - z^2: the port's (1 - z)(1 + z)
# and the JAX package's 1 - z^2 differ by an ulp, which that grows to 1e-9
TOL_JACOBLOG = 3e-9
TOL_DIV = 1e-11
TOL_DIV_GRAD = 1e-9
TOL_FIXED = 1e-8
TOL_ADAPTIVE = 1e-7
TOL_F32_DENSITY = 3e-4
TOL_F32_SAMPLE = 3e-3
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_maps_match_jax():
    rng = np.random.default_rng(0)
    ang = np.concatenate([rng.uniform(-3.0, 3.0, 12),
                          [0.0, 3e-7, -8e-7, 2e-6]])
    for name in ("sindiv", "divsin"):
        got = getattr(tcnf, name)(torch.as_tensor(ang)).numpy()
        want = np.asarray(getattr(jcnf, name)(jnp.asarray(ang)))
        assert np.abs(got - want).max() < TOL_MAPS, name
    x = _unit(rng, B)
    u = rng.normal(size=(B, 3)) * np.concatenate(
        [np.full(12, 0.7), [0.0, 1e-8, 3e-7, 2.0]])[:, None]
    u = u - (u * x).sum(1, keepdims=True) * x
    y = _unit(rng, B)
    y[0] = x[0]
    y[1] = -x[1]
    for name, args in (("sphere_exp", (x, u)), ("sphere_log", (x, y)),
                       ("sphere_proju", (x, u)), ("logdetexp", (u,)),
                       ("jacoblog", (x, y))):
        got = getattr(tcnf, name)(*map(torch.as_tensor, args)).numpy()
        want = np.asarray(getattr(jcnf, name)(*map(jnp.asarray, args)))
        tol = TOL_JACOBLOG if name == "jacoblog" else TOL_MAPS
        assert np.abs(got - want).max() < tol, name
    # the log map's Jacobian clips z at 1 - 1e-4; 1 - 5e-9 takes the limit
    # branch in float64, 0.99995 in float32
    z = np.array([-0.5, 0.0, 0.3, 0.9, 0.999, 1 - 2e-4, 1 - 1e-4, 1 - 5e-9,
                  0.99995])
    exact = tcnf._first_jac_scalar(torch.as_tensor(z), torch.float64).numpy()
    want = np.asarray(jcnf._first_jac_scalar(jnp.asarray(z), jnp.float64))
    assert np.abs(exact - want).max() < TOL_JACOBLOG
    # float32: no farther from float64 than the JAX package's float32
    got = tcnf._first_jac_scalar(torch.as_tensor(z, dtype=torch.float32),
                                 torch.float32).double().numpy()
    want = np.asarray(jcnf._first_jac_scalar(jnp.asarray(z, jnp.float32),
                                             jnp.float32), np.float64)
    assert np.abs(got - exact).max() <= max(np.abs(want - exact).max(), 1e-6)


# (hidden dims, highway mode, rank, per-row weights)
FIELDS = {"hidden 8, shared": ("8", 0, 0, False),
          "highway 1, 8-8, per row": ("8-8", 1, 0, True),
          "highway 2, 6-6, rank 2, per row": ("6-6", 2, 2, True)}


def _field_inputs(layer, per_row, seed):
    rng = np.random.default_rng(seed)
    fp = 0.7 * rng.normal(size=(B if per_row else 1, layer.num_nn_params))
    loc = _unit(rng, B)
    y = 0.4 * rng.normal(size=(B, 3))
    y[:3] *= np.array([0.0, 1e-3, 1e-1])[:, None]
    y = y - (y * loc).sum(1, keepdims=True) * loc
    return y, loc, fp, rng.normal(size=(B, 3)), rng.normal(size=B)


@pytest.mark.parametrize("label", list(FIELDS))
def test_divergence_matches_jacfwd(label):
    """The field and its divergence at t = 0.3 against the JAX package's
    vmapped jacfwd trace; the gradient of <field, a> + <div, b> with
    respect to y, the chart centre and the field's weights against
    jax.grad."""
    hidden, hw, rank, per_row = FIELDS[label]
    opts = dict(cnf_network_hidden_dims=hidden, cnf_network_highway_mode=hw,
                cnf_network_rank=rank, num_charts=2, solver="rk4")
    jl, tl = jcnf.CNFSphereCharts(**opts), tcnf.CNFSphereCharts(**opts)
    assert jl.num_nn_params == tl.num_nn_params
    y, loc, fp, a, b = _field_inputs(tl, per_row, seed=1)

    def obj_j(yy, ll, pp):
        rhs, div = jl._rhs_and_div(0.3, yy, ll, pp)
        return (rhs * a).sum() + (div * b).sum(), (rhs, div)

    (_, (rhs_j, div_j)), grads_j = _jit(jax.value_and_grad(
        obj_j, argnums=(0, 1, 2), has_aux=True))(y, loc, fp)
    leaves = [torch.tensor(v, requires_grad=True) for v in (y, loc, fp)]
    rhs_t, div_t = tl._rhs_and_div(0.3, *leaves)
    assert np.abs(rhs_t.detach().numpy() - np.asarray(rhs_j)).max() < TOL_DIV
    assert np.abs(div_t.detach().numpy() - np.asarray(div_j)).max() < TOL_DIV
    grads_t = torch.autograd.grad((rhs_t * _t(a)).sum() + (div_t * _t(b)).sum(),
                                  leaves)
    for gt, gj in zip(grads_t, grads_j):
        assert _rel(gt.numpy(), gj) < TOL_DIV_GRAD


def _pair(solver, cond=None):
    opts = {"c": dict(SMALL, solver=solver)}
    kw = dict(options_overwrite=opts, conditional_input_dim=cond,
              amortization_mlp_dims="8")
    return jpdf("s2", "c", **kw), tpdf("s2", "c", device="cpu", **kw)


def _data(cond, seed, dtype):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(0.2, 2.9, B), rng.uniform(0.1, 6.2, B)], 1)
    z = rng.normal(size=(B, 2))
    ci = rng.normal(size=(B, cond)) if cond else None
    cast = (lambda v: None if v is None else v.astype(dtype))
    return cast(x), cast(z), cast(ci)


def _params(jp, dtype, seed):
    """init_params(seed=0) with every parameter moved by 0.05 N(0, 1)."""
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) + 0.05 * rng.normal(size=v.shape)).astype(dtype)
            for k, v in jp.init_params(seed=0, dtype=jnp.float64).items()}


def _reference(jp, dtype):
    @_jit
    def ref(p, x, z, c):
        lp, _, base = jp.log_prob(p, x, conditional_input=c)
        return (lp, base) + jp.all_layer_forward(
            p, z, jnp.zeros(B, dtype), c)
    return ref


@pytest.mark.parametrize("solver,cond", [("midpoint", None), ("euler", None),
                                         ("dopri5", None)])
def test_models_match_jax(solver, cond):
    jp, tp = _pair(solver, cond)
    assert tp.num_parameter_list == jp.num_parameter_list
    jinit = jp.init_params(seed=0, dtype=jnp.float64)
    tinit = tp.init_params(seed=0, dtype=torch.float64)
    for key in jinit:
        np.testing.assert_array_equal(tinit[key].numpy(),
                                      np.asarray(jinit[key]))
    par = _params(jp, np.float64, seed=3)
    x, z, ci = _data(cond, 4, np.float64)
    want = _reference(jp, jnp.float64)(
        {k: jnp.asarray(v) for k, v in par.items()}, _j(x), _j(z), _j(ci))
    tpar = params_from_jax(par)
    lp, _, base = tp.log_prob(tpar, _t(x), conditional_input=_t(ci))
    fwd = tp.all_layer_forward(tpar, _t(z), torch.zeros(B, dtype=torch.float64),
                               _t(ci))
    tol = TOL_ADAPTIVE if solver == "dopri5" else TOL_FIXED
    for got, ref in zip((lp, base) + fwd, want):
        assert np.abs(got.numpy() - np.asarray(ref)).max() < tol


def test_f32_matches_jax():
    """rk4 in float32: log_prob at 3e-4, the samples and their log-det at
    3e-3 against the JAX package's float32 path."""
    jp, tp = _pair("rk4")
    par = _params(jp, np.float32, seed=5)
    x, z, _ = _data(None, 6, np.float32)
    want = _reference(jp, jnp.float32)(
        {k: jnp.asarray(v) for k, v in par.items()}, _j(x), _j(z), None)
    tpar = params_from_jax(par)
    lp = tp.log_prob(tpar, _t(x))[0]
    xs, ld = tp.all_layer_forward(tpar, _t(z), torch.zeros(B))
    assert np.abs(lp.numpy() - np.asarray(want[0])).max() < TOL_F32_DENSITY
    for got, ref in ((xs, want[2]), (ld, want[3])):
        assert np.abs(got.numpy() - np.asarray(ref)).max() < TOL_F32_SAMPLE


def test_conditional_flagship_routes(monkeypatch):
    """float32 ``"e2+s2+e2", "gg+c+gg"`` (rk4) with a conditional input on
    the CPU: the `c` layer gets its per-row slab materialized (a (B, n) tensor,
    not LazyParams); nll_value_and_grad runs the two gg blocks' fused NLL
    (lazy2) beside the `c` sub-pdf's own autograd pass and equals autograd
    of -log_prob().mean()."""
    from jammy_flows_tpu_torch.ops import gf_block

    tp = tpdf("e2+s2+e2", "gg+c+gg",
              options_overwrite={"c": dict(SMALL, solver="rk4")},
              conditional_input_dim=3, amortization_mlp_dims="16",
              device="cpu")
    layer = tp.layer_list[1][0]
    seen, fused = [], []
    run_map, nll = layer._map, gf_block.gf_block_nll_lazy2
    monkeypatch.setattr(layer, "_map", lambda params, *a, **k: (
        seen.append(params), run_map(params, *a, **k))[1])
    monkeypatch.setattr(gf_block, "gf_block_nll_lazy2", lambda *a: (
        fused.append(a[0].shape), nll(*a))[1])
    rng = np.random.default_rng(9)
    par = {k: v + 0.02 * torch.as_tensor(rng.normal(size=v.shape),
                                         dtype=v.dtype)
           for k, v in tp.init_params(seed=0).items()}
    x = torch.as_tensor(_rows_flagship(rng), dtype=torch.float32)
    ci = torch.as_tensor(rng.normal(size=(B, 3)), dtype=torch.float32)
    loss, grads = tp.nll_value_and_grad(par, x, ci)
    assert len(fused) == 2
    assert all(isinstance(p, torch.Tensor) and p.shape == (
        B, layer.num_params) for p in seen)
    ref_loss, ref = tp._value_and_grad(
        lambda pp: -tp.log_prob(pp, x, ci)[0].mean(), par)
    assert abs(loss.item() - ref_loss.item()) < 1e-5
    for key in ref:
        assert _rel(grads[key].numpy(), ref[key].numpy()) < 1e-4, key


def _rows_flagship(rng):
    return np.concatenate([0.8 * rng.normal(size=(B, 2)),
                           rng.uniform(0.2, 2.9, (B, 1)),
                           rng.uniform(0.1, 6.2, (B, 1)),
                           0.8 * rng.normal(size=(B, 2))], 1)
