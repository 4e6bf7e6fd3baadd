"""The simplex layers (`u`, `w`) and the amortization machinery under them
(passthrough pdfs, amortization slabs, per-row MLP weights, the fully
amortized pdf) of the port against the JAX package, through the entry
points.

* float64, each model's parameter count and init_params (equal), log_prob
  and the base positions, and all_layer_forward on shared base draws, at
  1e-8: ``pdf("a2", "u")`` and ``pdf("a3", "w")`` (permanent parameters: the
  `w` layer's inner MLPs' weights shared by every row), ``pdf("a2", "w",
  conditional_input_dim=2)`` (the `w` layer's slab predicted per row: its
  inner MLP runs per-row weights), ``pdf("a2+e1", "u+g",
  conditional_input_dim=2)`` (the `g` layer reads the simplex's canonical
  embedding) and ``fully_amortized_pdf("e2+s1", "gg+o",
  conditional_input_dim=3)`` at its default inner highway mode 1 and outer
  rank 5 (narrow MLPs); gradients at 1e-7 relative: nll_value_and_grad of
  the first three against ``jax.grad``, and the fully amortized model's
  mean log_prob gradient;
* float32, the conditional `w` model and the fully amortized one against
  the JAX package's float32 path, the latter with the per-layer entry
  points it calls counted (per-row raw slabs: T4 in log_prob, T5 in
  all_layer_forward, the T7 density body in the gradient);
* a passthrough pdf's maps (first circle, interval and s2 layers without
  their projections) against the JAX package's; it refuses log_prob and
  nll_value_and_grad, an amortize_everything pdf its missing slab.

The JAX references run the JAX package's row forms (``_jax_row_forms``).
Inputs are made with numpy from a seed and handed to both packages."""
import collections
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jammy_flows_tpu import fully_amortized_pdf as jfa, pdf as jpdf
from jammy_flows_tpu_torch import fully_amortized_pdf as tfa, pdf as tpdf
from jammy_flows_tpu_torch.ops import gf_layer as tgl
from jammy_flows_tpu_torch.utils.convert import params_from_jax
from test_torch_grad_pdf import _j, _rel, _t
from torch_one_thread import _one_torch_thread  # noqa: F401

B = 128
TOL_F64 = 1e-8
TOL_F64_GRAD = 1e-7
TOL_F32_DENSITY = 3e-4
TOL_F32_SAMPLE = 3e-3
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})
FA = ("e2+s1", "gg+o")
FA_KW = dict(conditional_input_dim=3, inner_mlp_dims_sub_pdfs="16",
             amortization_mlp_dims="32")
# (definitions, flows, conditional input dim, gradient held)
MODELS = {
    "a2 u": ("a2", "u", None, True),
    "a3 w": ("a3", "w", None, False),
    "a2 w conditional": ("a2", "w", 2, True),
    "a2+e1 u+g conditional": ("a2+e1", "u+g", 2, False),
    "fully amortized e2+s1": FA + (3, True),
}


@pytest.fixture(autouse=True)
def _jax_row_forms(monkeypatch):
    """The JAX package's own switch (``JAMMY_DISABLE_COLUMNS``) sends its
    interval and circle stacks through their row forms, which the port
    mirrors; its column twins are the same math laid out for the TPU's
    tiles (held equal by its own tests), and their gradient of the
    conditional `w` model takes XLA ~40 s to compile here, the row forms'
    ~3 s."""
    monkeypatch.setenv("JAMMY_DISABLE_COLUMNS", "1")


def _pair(label):
    defs, flows, cond, _ = MODELS[label]
    if label.startswith("fully"):
        return jfa(defs, flows, **FA_KW), tfa(defs, flows, device="cpu",
                                              **FA_KW)
    kw = dict(conditional_input_dim=cond, amortization_mlp_dims="16")
    return jpdf(defs, flows, **kw), tpdf(defs, flows, device="cpu", **kw)


def _inner(tp):
    return getattr(tp, "inner_pdf", tp)


def _jittered(jp, dtype, seed):
    """init_params(seed=0) with every parameter moved by 0.02 N(0, 1) (the
    `u` layer's permanent temperature and class log-probs by 0.3)."""
    rng = np.random.default_rng(seed)
    par = {k: np.asarray(v) for k, v in jp.init_params(
        seed=0, dtype=jnp.float64).items()}
    return {k: (v + (0.3 if v.size < 8 else 0.02) * rng.normal(size=v.shape)
                ).astype(dtype) for k, v in par.items()}


def _data(tp, cond, seed, dtype):
    """Target rows inside each sub-manifold (simplex rows a Dirichlet draw's
    first d coordinates, circle angles in (0.05, 2 pi - 0.05), Euclidean
    ones 0.8 N(0, 1)), base draws and a conditional input."""
    p = _inner(tp)
    rng = np.random.default_rng(seed)
    x = 0.8 * rng.normal(size=(B, p.total_target_dim))
    for k, defs in enumerate(p.pdf_defs_list):
        lo, hi = p.target_dim_indices[k]
        if defs.startswith("a"):
            x[:, lo:hi] = rng.dirichlet(np.ones(hi - lo + 1), size=B)[:, :-1]
        elif defs == "s1":
            x[:, lo] = rng.uniform(0.05, 2.0 * math.pi - 0.05, B)
    z = rng.normal(size=(B, p.total_base_dim))
    ci = rng.normal(size=(B, cond)) if cond else None
    cast = (lambda a: None if a is None else a.astype(dtype))
    return cast(x), cast(z), cast(ci)


def _reference(jp, grad, dtype):
    """One compiled JAX function: log_prob, base positions, the mean
    log_prob's gradient (``grad``) and all_layer_forward."""
    @_jit
    def ref(p, x, z, c):
        def nll(pp):
            lp, _, base = jp.log_prob(pp, x, conditional_input=c)
            return -lp.mean(), (lp, base)

        if grad:
            (_, out), g = jax.value_and_grad(nll, has_aux=True)(p)
        else:
            out, g = nll(p)[1], None
        xs, ld = jp.all_layer_forward(p, z, jnp.zeros(B, dtype), c)
        return out + (xs, ld), g
    return ref


@pytest.mark.parametrize("label", list(MODELS))
def test_f64_matches_jax(label):
    _, _, cond, grad = MODELS[label]
    jp, tp = _pair(label)
    jinit = jp.init_params(seed=0, dtype=jnp.float64)
    tinit = tp.init_params(seed=0, dtype=torch.float64)
    assert sorted(tinit) == sorted(jinit)
    for key in jinit:
        np.testing.assert_array_equal(tinit[key].numpy(),
                                      np.asarray(jinit[key]))
    par = _jittered(jp, np.float64, seed=1)
    x, z, ci = _data(tp, cond, seed=2, dtype=np.float64)
    (lj, bj, xj, ldj), gj = _reference(jp, grad, jnp.float64)(
        {k: jnp.asarray(v) for k, v in par.items()}, _j(x), _j(z), _j(ci))
    tpar = params_from_jax(par)
    lt, _, bt = tp.log_prob(tpar, _t(x), conditional_input=_t(ci))
    xt, ldt = tp.all_layer_forward(tpar, _t(z), torch.zeros(
        B, dtype=torch.float64), _t(ci))
    for a, b in ((lt, lj), (bt, bj), (xt, xj), (ldt, ldj)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) < TOL_F64
    if not grad:
        return
    if label.startswith("fully"):
        loss, gt = tpdf._value_and_grad(
            lambda pp: -tp.log_prob(pp, _t(x), _t(ci))[0].mean(), tpar)
    else:
        loss, gt = tp.nll_value_and_grad(tpar, _t(x), _t(ci))
    assert abs(float(loss) + float(np.asarray(lj).mean())) < TOL_F64
    assert sorted(gt) == sorted(gj)
    for key, g in gt.items():
        assert _rel(g.numpy(), gj[key]) < TOL_F64_GRAD, key


@pytest.mark.parametrize("label", ["a2 w conditional",
                                   "fully amortized e2+s1"])
def test_f32_matches_jax(monkeypatch, label):
    """The port's float32 route on the CPU (plain PyTorch; the per-layer
    entry points' plain versions) against the JAX package's float32 path;
    the per-layer calls counted by (name, per-row slabs)."""
    _, _, cond, _ = MODELS[label]
    jp, tp = _pair(label)
    calls = collections.Counter()
    run, run_bwd = tgl._run, tgl._run_bwd
    monkeypatch.setattr(tgl, "_run", lambda mode, iface, x, params, *a: (
        calls.update([(f"{mode}_{iface}", params[0].ndim == 3)])
        or run(mode, iface, x, params, *a)))
    monkeypatch.setattr(tgl, "_run_bwd", lambda body, iface, x, params, *a: (
        calls.update([(f"{body}_bwd_{iface}", params[0].ndim == 3)])
        or run_bwd(body, iface, x, params, *a)))
    par = _jittered(jp, np.float32, seed=5)
    x, z, ci = _data(tp, cond, seed=6, dtype=np.float32)
    (lj, _, xj, ldj), _ = _reference(jp, False, jnp.float32)(
        {k: jnp.asarray(v) for k, v in par.items()}, _j(x), _j(z), _j(ci))
    tpar = params_from_jax(par)
    lt = tp.log_prob(tpar, _t(x), conditional_input=_t(ci))[0]
    xt, ldt = tp.all_layer_forward(tpar, _t(z), torch.zeros(B), _t(ci))
    assert float(np.abs(lt.numpy() - np.asarray(lj)).max()) < TOL_F32_DENSITY
    assert float(np.abs(xt.numpy() - np.asarray(xj)).max()) < TOL_F32_SAMPLE
    assert float(np.abs(ldt.numpy() - np.asarray(ldj)).max()) < TOL_F32_SAMPLE
    if label.startswith("fully"):
        # every g layer's slab is per row: T4 / T5 raw per row, then the
        # T7 density body in the gradient of the mean log_prob
        assert calls == {("forward_raw", True): 2, ("sample_raw", True): 2}
        tpdf._value_and_grad(
            lambda pp: -tp.log_prob(pp, _t(x), _t(ci))[0].mean(), tpar)
        assert calls[("forward_bwd_raw", True)] == 2
    else:
        assert not calls


def test_passthrough_maps_match_jax():
    """A passthrough pdf's first circle, interval and s2 layers take no
    projection from the base space: both maps on shared rows, float64."""
    kw = dict(use_as_passthrough_instead_of_pdf=True)
    jp = jpdf("s1+i1+s2", "mo+r+f", **kw)
    tp = tpdf("s1+i1+s2", "mo+r+f", device="cpu", **kw)
    par = _jittered(jp, np.float64, seed=7)
    rng = np.random.default_rng(8)
    x = np.stack([rng.uniform(0.05, 6.2, B), rng.uniform(0.05, 0.95, B),
                  rng.uniform(0.2, 2.9, B), rng.uniform(0.1, 6.2, B)], 1)

    @_jit
    def ref(p, x):
        ld = jnp.zeros(B)
        return jp.all_layer_inverse(p, x, ld) + jp.all_layer_forward(p, x, ld)

    want = ref({k: jnp.asarray(v) for k, v in par.items()}, jnp.asarray(x))
    tpar, ld = params_from_jax(par), torch.zeros(B, dtype=torch.float64)
    got = tp.all_layer_inverse(tpar, _t(x), ld) + \
        tp.all_layer_forward(tpar, _t(x), ld)
    for a, b in zip(got, want):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) < TOL_F64


def test_passthrough_and_amortize_everything_refuse_what_jax_refuses():
    p = tpdf("a2", "u", use_as_passthrough_instead_of_pdf=True, device="cpu")
    assert not p.layer_list[0][0].project_from_gauss_to_simplex
    par = p.init_params(seed=0, dtype=torch.float64)
    x = torch.full((4, 2), 0.3, dtype=torch.float64)
    with pytest.raises(ValueError):
        p.log_prob(par, x)
    with pytest.raises(ValueError):
        p.nll_value_and_grad(par, x)
    base, _ = p.all_layer_inverse(par, x, torch.zeros(4, dtype=x.dtype))
    assert base.shape == (4, 2)
    q = tpdf("e1+e2", "g+gg", amortize_everything=True, device="cpu")
    assert q.init_params(seed=0) == {}
    with pytest.raises(ValueError):
        q.all_layer_inverse({}, torch.zeros((4, 3)), torch.zeros(4))
    slab = torch.as_tensor(q.default_amortization_params(
        np.random.default_rng(0)))[None, :]
    with pytest.raises(ValueError):
        q.all_layer_inverse({}, torch.zeros((4, 3), dtype=torch.float64),
                            torch.zeros(4, dtype=torch.float64),
                            amortization_parameters=slab[:, :-1])
