"""The circle (`m`, `o`, `y`) and interval (`r`, `z`) layers of the port
against the JAX package, through the pdf entry points.

* Each symbol over its option grid, one model a symbol: sub-pdf 0 at the
  defaults with permanent parameters, sub-pdf 1's layers with the options
  and parameters amortized from sub-pdf 0, in float64: the parameter
  counts and init_params, log_prob and the base positions, and
  all_layer_forward on shared base draws at 1e-8;
* the examples' models at small width: ``pdf("s1+s2+e2", "m+f+gg",
  conditional_input_dim=2)``, ``pdf("e2+s1", "gg+o")`` and
  ``pdf("i1_-5.5_10.0", "r", conditional_input_dim=2)``: the same values,
  and ``nll_value_and_grad`` against ``jax.grad`` at 1e-7 relative, in
  float64 (for the first, also the gradient of a sample objective, through
  the Moebius solve's implicit gradient, along a random direction in each
  parameter against a central difference of the JAX package's objective);
  in float32 log_prob and all_layer_forward against the JAX package's
  float32 path, with the block entry points the port calls counted.  (The
  spline and Moebius functions' gradients are held against the JAX
  package's in tests/test_torch_s1_ops.py.)

Inputs are made with numpy from a seed and handed to both packages."""
import collections
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch.ops import gf_block as tblk
from jammy_flows_tpu_torch.utils.convert import params_from_jax
from test_torch_grad_pdf import _j, _rel, _t
from torch_one_thread import _one_torch_thread  # noqa: F401

B = 128
TOL_F64 = 1e-8
TOL_F64_GRAD = 1e-7
# the central difference's step: its error is ~1e-11 relative there, far
# below TOL_F64_GRAD (a larger step can carry a sample across the circle's
# seam at 2 pi)
H_FD = 1e-6
TOL_F32_DENSITY = 3e-4
TOL_F32_SAMPLE = 3e-3
# the JAX reference is compiled once and run once on a small batch, so its
# compile time is the file's: at XLA's lowest backend optimization level
# (less LLVM optimization of the same HLO) it compiles ~10% faster
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})

_NONSMOOTH = {"smooth_second_derivative": 0}
# symbol -> (definitions, flows, options): sub-pdf 0 keeps each layer's
# defaults, the options go to the layers of sub-pdf 1, one set a layer
# ((sub-pdf, layer) keys) or one set for the sub-pdf (int keys)
GRID = {
    "m": ("s1+s1", "m+m", {1: {"m": {"natural_direction": 1,
                                     "add_rotation": 1,
                                     "num_basis_functions": 3}}}),
    "o": ("s1+s1", "o+oo", {
        (1, 0): {"o": dict(_NONSMOOTH, num_basis_functions=4,
                           fix_first_width_n_height_to_zero=1,
                           natural_direction=0, add_rotation=0)},
        (1, 1): {"o": dict(_NONSMOOTH, num_basis_functions=5,
                           fix_boundary_derivatives=0.5,
                           fix_first_width_n_height_to_zero=1,
                           also_fix_second_width_to_zero=1,
                           independent_width_height_parametrization=1)}}),
    "y": ("s1+s2", "yy+y", {(0, 1): {"y": {"add_rotation": 1}},
                            1: {"y": {"add_rotation": 1}}}),
    "r": ("i1_-5.5_10.0+i1_-1.0_1.0", "r+rrr", {
        (1, 0): {"r": {"smooth_second_derivative": 1,
                       "num_basis_functions": 2,
                       "fix_boundary_derivatives": 0.5}},
        (1, 1): {"r": {"smooth_second_derivative": 1,
                       "num_basis_functions": 3,
                       "restrict_max_min_width_height_ratio": 10.0}},
        (1, 2): {"r": {"num_basis_functions": 4,
                       "fix_boundary_derivatives": 0.5,
                       "fix_first_width_n_height_to_zero": 1,
                       "also_fix_second_width_to_zero": 1,
                       "independent_width_height_parametrization": 1}}}),
    "z": ("i1+i1_-2.0_3.0", "z+zz", {}),
}
# the examples' models (examples/examples.ipynb), chip_smoke.py's circle
# and interval phase: (definitions, flows, conditional input dim), and the
# block entry points of one log_prob + all_layer_forward in float32
MODELS = {
    "s1+s2+e2 conditional": ("s1+s2+e2", "m+f+gg", 2),
    "e2+s1 unconditional": ("e2+s1", "gg+o", None),
    "interval conditional": ("i1_-5.5_10.0", "r", 2),
}
# the sample objective's gradient where the sampling direction solves (the
# Moebius layer's implicit gradient); the splines' sampling-direction
# gradients are tests/test_torch_s1_ops.py's
GRADS = {"s1+s2+e2 conditional": ("nll", "sample"),
         "e2+s1 unconditional": ("nll",), "interval conditional": ("nll",)}
BLOCK_CALLS = {
    "s1+s2+e2 conditional": {"density_lazy2": 1, "sample_lazy2": 1},
    "e2+s1 unconditional": {"density_perm": 1, "sample_perm": 1},
    "interval conditional": {},
}


def _pair(defs, flows, opts=None, cond=None):
    kw = dict(options_overwrite=opts, conditional_input_dim=cond,
              amortization_mlp_dims="16")
    return jpdf(defs, flows, **kw), tpdf(defs, flows, device="cpu", **kw)


def _jittered(jp, dtype, seed):
    """init_params(seed=0) with the permanent parameters moved by
    0.3 N(0, 1) and the MLPs' by 0.02 N(0, 1)."""
    rng = np.random.default_rng(seed)
    par = {k: np.asarray(v) for k, v in jp.init_params(
        seed=0, dtype=jnp.float64).items()}
    return {k: (v + (0.02 if k.startswith("mlp_") else 0.3)
                * rng.normal(size=v.shape)).astype(dtype)
            for k, v in par.items()}


def _data(tp, cond, seed, dtype):
    """Target rows inside each sub-manifold (angles in (0.05, 2 pi - 0.05),
    s2 polar angles in (0.2, 2.9), interval rows off the bounds by 0.1% of
    the width, Euclidean ones 0.8 N(0, 1)), base draws and a conditional
    input."""
    rng = np.random.default_rng(seed)
    x = 0.8 * rng.normal(size=(B, tp.total_target_dim))
    for k, layers in enumerate(tp.layer_list):
        lo, _ = tp.target_dim_indices[k]
        d = tp.pdf_defs_list[k]
        if d == "s1":
            x[:, lo] = rng.uniform(0.05, 2.0 * math.pi - 0.05, B)
        elif d == "s2":
            x[:, lo] = rng.uniform(0.2, 2.9, B)
            x[:, lo + 1] = rng.uniform(0.1, 6.2, B)
        elif d.startswith("i"):
            a, b = layers[0].low, layers[0].high
            x[:, lo] = rng.uniform(a + 1e-3 * (b - a), b - 1e-3 * (b - a), B)
    z = rng.normal(size=(B, tp.total_base_dim))
    ci = rng.normal(size=(B, cond)) if cond else None
    cast = (lambda a: None if a is None else a.astype(dtype))
    return cast(x), cast(z), cast(ci)


def _sample_objective(x, ld):
    return (x**2).mean() - 0.1 * ld.mean()


def _f64_check(jp, tp, cond, seed, grads=()):
    """log_prob, base positions, all_layer_forward at 1e-8; the gradients
    named in ``grads`` at 1e-7 relative: "nll" the mean NLL's (the port's
    nll_value_and_grad) against ``jax.grad``, "sample" the sample
    objective's along one random direction in each parameter against a
    central difference of the JAX package's objective (its value is
    compiled with the rest; a second ``jax.grad`` through the Moebius
    solve would double the file's compile time)."""
    par = _jittered(jp, np.float64, seed)
    x, z, ci = _data(tp, cond, seed + 1, np.float64)

    @_jit
    def ref(p, x, z, c):
        def nll(pp):
            lp, _, base = jp.log_prob(pp, x, conditional_input=c)
            return -lp.mean(), (lp, base)

        if "nll" in grads:
            (_, out), g = jax.value_and_grad(nll, has_aux=True)(p)
        else:
            out, g = nll(p)[1], None
        xs, ld = jp.all_layer_forward(p, z, jnp.zeros(B), c)
        return out + (xs, ld, _sample_objective(xs, ld)), g

    def run_ref(p):
        return ref({k: jnp.asarray(v) for k, v in p.items()}, _j(x), _j(z),
                   _j(ci))

    (lj, bj, xj, ldj, _), gj = run_ref(par)
    tpar = params_from_jax(par)
    lt, _, bt = tp.log_prob(tpar, _t(x), conditional_input=_t(ci))
    xt, ldt = tp.all_layer_forward(tpar, _t(z), torch.zeros(
        B, dtype=torch.float64), _t(ci))
    for a, b in ((lt, lj), (bt, bj), (xt, xj), (ldt, ldj)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) < TOL_F64
    if "nll" in grads:
        loss, gt = tp.nll_value_and_grad(tpar, _t(x), _t(ci))
        assert abs(float(loss) + float(np.asarray(lj).mean())) < TOL_F64
        assert sorted(gt) == sorted(gj)
        for key, g in gt.items():
            assert _rel(g.numpy(), gj[key]) < TOL_F64_GRAD, key
    if "sample" in grads:
        _, gt = tp._value_and_grad(lambda pp: _sample_objective(
            *tp.all_layer_forward(pp, _t(z), torch.zeros(
                B, dtype=torch.float64), _t(ci))), tpar)
        assert sorted(gt) == sorted(par)
        rng = np.random.default_rng(seed + 2)
        for key in sorted(par):
            v = rng.normal(size=par[key].shape)
            ends = [run_ref(dict(par, **{key: par[key] + s * H_FD * v}))[0][4]
                    for s in (1.0, -1.0)]
            fd = (float(ends[0]) - float(ends[1])) / (2.0 * H_FD)
            got = float((gt[key].numpy() * v).sum())
            assert abs(got - fd) < TOL_F64_GRAD * max(abs(fd), 1e-3), key


@pytest.mark.parametrize("symbol", list(GRID))
def test_option_grid_matches_jax(symbol):
    defs, flows, opts = GRID[symbol]
    jp, tp = _pair(defs, flows, opts)
    assert tp.num_parameter_list == jp.num_parameter_list
    jinit = jp.init_params(seed=0, dtype=jnp.float64)
    tinit = tp.init_params(seed=0, dtype=torch.float64)
    assert sorted(tinit) == sorted(jinit)
    for key in jinit:
        np.testing.assert_array_equal(tinit[key].numpy(),
                                      np.asarray(jinit[key]))
    _f64_check(jp, tp, None, seed=1)


@pytest.mark.parametrize("label", list(MODELS))
def test_examples_f64_match_jax(label):
    defs, flows, cond = MODELS[label]
    jp, tp = _pair(defs, flows, cond=cond)
    _f64_check(jp, tp, cond, seed=3, grads=GRADS[label])


@pytest.mark.parametrize("label", list(MODELS))
def test_examples_f32_match_jax(monkeypatch, label):
    """The port's float32 route (the plain block op for the `gg` blocks on
    the CPU, the circle and interval layers in plain PyTorch) against the
    JAX package's float32 path."""
    defs, flows, cond = MODELS[label]
    jp, tp = _pair(defs, flows, cond=cond)
    calls = collections.Counter()
    for name in ("density_perm", "sample_perm", "density_lazy2",
                 "sample_lazy2", "density_lazy", "sample_lazy"):
        fn = getattr(tblk, f"gf_block_{name}")
        monkeypatch.setattr(tblk, f"gf_block_{name}",
                            lambda *a, fn=fn, name=name:
                            calls.update([name]) or fn(*a))
    par = _jittered(jp, np.float32, seed=5)
    x, z, ci = _data(tp, cond, seed=6, dtype=np.float32)

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
    assert float(np.abs(ldt.numpy() - np.asarray(ldj)).max()) < TOL_F32_SAMPLE
    assert calls == BLOCK_CALLS[label]
