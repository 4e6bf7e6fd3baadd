"""The port's flagship pdf("e4+s2+e4", "gggg+f+gggg") against the JAX package.

* init_params draws the same values from the same seed;
* float64: log_prob and all_layer_forward on shared base draws match the JAX
  f64 CPU path (per-layer bisection/Newton and the s2 column path);
* float32: the block route (plain block op on the CPU) matches the JAX
  package with its whole-block Pallas kernels in interpret mode;
* the frozen torch-reference fixtures parity_e1_g, parity_s2_f_default,
  parity_e2_gg_skew and the Euclidean ones (the pade iCDF, `h`, a
  conditional pdf, the rq_splines stretch, angles, `t` full / diagonal,
  `x` with an offset), the circle ones (`m`, `o` smooth and not, `y`, and
  `o` amortized from an e2 block), the interval ones (`r`, `z`), the simplex
  ones (`u`, `w`, conditional and not), the fully amortized `e2+s1` model,
  the custom-mode MLPs (full, highway mode 1, low rank) and the s2 ones
  (`f` with nested flows, with the identity region; `v` linear,
  exponential, conditional exponential and splines; `c` with rk4), each at
  its stored tolerance;
* what is still refused (the trainer's optimizer choice and checkpoints).

Inputs are made with numpy from a seed and handed to both packages."""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jammy_flows_tpu.ops.pallas_gf as pg
from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu_torch import fully_amortized_pdf as tfa, pdf as tpdf
from jammy_flows_tpu_torch import train as ttrain
from jammy_flows_tpu_torch.ops.special import std_normal_log_prob
from jammy_flows_tpu_torch.utils import checkpoint
from jammy_flows_tpu_torch.utils.convert import params_from_jax
from torch_one_thread import _one_torch_thread  # noqa: F401

FLAGSHIP = ("e4+s2+e4", "gggg+f+gggg")
FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
B = 256
# float64: identical algorithms (fixed trip counts), libm differences only
TOL_F64 = 1e-8
# float32 vs the interpret-mode kernels: the JAX package's kernel-vs-XLA
# limits (tests/test_pallas_interpret.py), density 3e-4, sample 3e-3
TOL_F32_DENSITY = 3e-4
TOL_F32_SAMPLE = 3e-3


@pytest.fixture
def interpret_mode():
    prev = pg._INTERPRET
    pg._INTERPRET = True
    jax.clear_caches()
    yield
    pg._INTERPRET = prev
    jax.clear_caches()


def _pair(cond, dims="16"):
    kw = dict(conditional_input_dim=cond, amortization_mlp_dims=dims)
    return jpdf(*FLAGSHIP, **kw), tpdf(*FLAGSHIP, device="cpu", **kw)


def _data(seed, dtype, cond):
    """Target rows (e4 within the bulk, s2 angles inside (0, pi) x (0, 2pi)),
    base draws and a conditional input."""
    rng = np.random.default_rng(seed)
    x = 0.8 * rng.normal(size=(B, 10))
    x[:, 4] = rng.uniform(0.2, 2.9, B)
    x[:, 5] = rng.uniform(0.1, 6.2, B)
    z = rng.normal(size=(B, 10))
    ci = rng.normal(size=(B, 3)) if cond else None
    cast = (lambda a: None if a is None else a.astype(dtype))
    return cast(x), cast(z), cast(ci)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


@pytest.mark.parametrize("cond", [None, 3])
def test_init_params_equal_jax(cond):
    jp, tp = _pair(cond, dims="128")
    jpar = jp.init_params(seed=0, dtype=jnp.float64)
    tpar = tp.init_params(seed=0, dtype=torch.float64)
    assert sorted(tpar) == sorted(jpar)
    for key in jpar:
        np.testing.assert_array_equal(tpar[key].numpy(), np.asarray(jpar[key]))
    back = params_from_jax({k: v.numpy() for k, v in tpar.items()})
    for key in tpar:
        assert back[key].dtype == torch.float64
        assert torch.equal(back[key], tpar[key])


@pytest.mark.parametrize("cond", [None, 3])
def test_f64_matches_jax(cond):
    jp, tp = _pair(cond)
    jpar = jp.init_params(seed=0, dtype=jnp.float64)
    tpar = params_from_jax(jpar)
    x, z, ci = _data(1, np.float64, cond)
    lj, _, pj = jax.jit(lambda p, x, c: jp.log_prob(p, x, conditional_input=c))(
        jpar, _j(x), _j(ci))
    lt, _, pt = tp.log_prob(tpar, _t(x), conditional_input=_t(ci))
    for a, b in ((lt, lj), (pt, pj)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) < TOL_F64
    xj, ldj = jax.jit(lambda p, z, c: jp.all_layer_forward(
        p, z, jnp.zeros(B, jnp.float64), c))(jpar, _j(z), _j(ci))
    xt, ldt = tp.all_layer_forward(tpar, _t(z), torch.zeros(B, dtype=torch.float64),
                                   _t(ci))
    assert float(np.abs(xt.numpy() - np.asarray(xj)).max()) < TOL_F64
    assert float(np.abs(ldt.numpy() - np.asarray(ldj)).max()) < TOL_F64


@pytest.mark.parametrize("cond", [None, 3])
def test_f32_block_route_matches_interpret_kernels(interpret_mode, cond):
    jp, tp = _pair(cond)
    jpar = jp.init_params(seed=0, dtype=jnp.float32)
    tpar = params_from_jax(jpar)
    assert tp._block_meta[0] is not None and tp._block_meta[2] is not None
    x, z, ci = _data(2, np.float32, cond)
    lj = jax.jit(lambda p, x, c: jp.log_prob(p, x, conditional_input=c)[0])(
        jpar, _j(x), _j(ci))
    lt = tp.log_prob(tpar, _t(x), conditional_input=_t(ci))[0]
    assert float(np.abs(lt.numpy() - np.asarray(lj)).max()) < TOL_F32_DENSITY
    xj, ldj = jax.jit(lambda p, z, c: jp.all_layer_forward(
        p, z, jnp.zeros(B, jnp.float32), c))(jpar, _j(z), _j(ci))
    xt, ldt = tp.all_layer_forward(tpar, _t(z), torch.zeros(B), _t(ci))
    assert float(np.abs(xt.numpy() - np.asarray(xj)).max()) < TOL_F32_SAMPLE
    assert float(np.abs(ldt.numpy() - np.asarray(ldj)).max()) < TOL_F32_SAMPLE


@pytest.mark.parametrize("direction", ["density", "sample"])
def test_f32_wide_summary_takes_the_block_op(interpret_mode, monkeypatch,
                                             direction):
    """A 200-wide conditional input takes the block op's lazy mode
    (precomputed hidden), not the fused lazy2 one, as the JAX package
    routes a summary wider than 128 (``pdf.py:502-503``), and matches the
    JAX package's f32 path, its Pallas kernels in interpret mode."""
    from jammy_flows_tpu_torch.ops import gf_block as tblk
    name = f"gf_block_{direction}_lazy"
    calls = []
    fn = getattr(tblk, name)
    monkeypatch.setattr(tblk, name, lambda *a: calls.append(1) or fn(*a))
    kw = dict(conditional_input_dim=200, amortization_mlp_dims="16")
    jp, tp = jpdf("e4", "gggg", **kw), tpdf("e4", "gggg", device="cpu", **kw)
    jpar = jp.init_params(seed=0, dtype=jnp.float32)
    tpar = params_from_jax(jpar)
    rng = np.random.default_rng(3)
    x = (0.8 * rng.normal(size=(B, 4))).astype(np.float32)
    ci = rng.normal(size=(B, 200)).astype(np.float32)
    if direction == "density":
        ref = jax.jit(lambda p, x, c: jp.log_prob(p, x, conditional_input=c)[0])(
            jpar, _j(x), _j(ci))
        got = tp.log_prob(tpar, _t(x), conditional_input=_t(ci))[0]
        tol = TOL_F32_DENSITY
    else:
        ref = jax.jit(lambda p, z, c: jp.all_layer_forward(
            p, z, jnp.zeros(B, jnp.float32), c)[0])(jpar, _j(x), _j(ci))
        got = tp.all_layer_forward(tpar, _t(x), torch.zeros(B), _t(ci))[0]
        tol = TOL_F32_SAMPLE
    assert len(calls) == 1
    assert float(np.abs(got.numpy() - np.asarray(ref)).max()) < tol


@pytest.mark.parametrize("name", ["e1_g", "s2_f_default", "e2_gg_skew",
                                  "e2_g_pade", "e2_hh", "cond_e1e2",
                                  "e2_g_rqsplines", "e3_gg_angles",
                                  "e10_t_full", "e4_t_diag", "e2_x_offset",
                                  "s1_m", "s1_o", "s1_o_nonsmooth", "s1_y",
                                  "joint_e2s1", "i1_r", "i1_z", "a1_u",
                                  "a1_w", "a2_u", "a2_w_cond", "a3_w",
                                  "fa_e2s1", "cond_custom_full",
                                  "cond_custom_hw1", "cond_custom_lowrank",
                                  "s2_f_boundary", "s2_ff_vertcirc",
                                  "s2_v_linear", "s2_v_exponential",
                                  "s2_v_cond_exp", "s2_v_cond_splines",
                                  "s2_c"])
def test_frozen_reference_fixture(name):
    with np.load(FIXTURES / f"parity_{name}.npz", allow_pickle=False) as f:
        data = {k: f[k] for k in f.files}
    cond = int(data["cond_dim"])
    kwargs = json.loads(str(data["pdf_kwargs_json"])) \
        if "pdf_kwargs_json" in data else {}
    ctor = tfa if bool(data.get("fully_amortized", False)) else tpdf
    p = ctor(str(data["defs"]), str(data["flows"]),
             options_overwrite=json.loads(str(data["opts_json"])),
             conditional_input_dim=None if cond < 0 else cond, device="cpu",
             **kwargs)
    params = {k[len("param_"):]: torch.as_tensor(v) for k, v in data.items()
              if k.startswith("param_")}
    assert sorted(params) == sorted(p.init_params(seed=0))
    tol = float(data["tol"])
    ci = torch.as_tensor(data["conditional_input"]) \
        if "conditional_input" in data else None
    lp = p.log_prob(params, torch.as_tensor(data["x_eval"]),
                    conditional_input=ci)[0].numpy()
    assert np.abs(lp - data["logprob_ref"]).max() < tol
    z = torch.as_tensor(data["z_base"])
    x, ld = p.all_layer_forward(params, z, torch.zeros(z.shape[0],
                                                       dtype=z.dtype), ci)
    assert np.abs(x.numpy() - data["x_fwd_ref"]).max() < 10 * tol
    if bool(data["skip_fwd_logpdf"]):
        return
    lp_fwd = data["logpdf_base_ref"] - ld.numpy()
    assert np.abs(lp_fwd - data["logpdf_target_ref"]).max() < tol


@pytest.mark.parametrize("cond", [None, 3])
def test_f32_sample_roundtrip_on_cpu(cond):
    """sample -> log_prob through the plain block op: finite, the right
    shapes, reproducible from the generator, |dlogp| q999 < 1e-3."""
    _, tp = _pair(cond, dims="128")
    par = tp.init_params(seed=0)
    n = 2048
    ci = torch.randn((n, 3), generator=torch.Generator().manual_seed(1)) \
        if cond else None
    x, z, lp, lb = tp.sample(par, samplesize=n, conditional_input=ci,
                             generator=torch.Generator().manual_seed(0))
    assert x.shape == (n, 10) and z.shape == (n, 10) and lp.shape == (n,)
    assert torch.isfinite(x).all() and torch.isfinite(lp).all()
    torch.testing.assert_close(lb, std_normal_log_prob(z))
    x2 = tp.sample(par, samplesize=n, conditional_input=ci,
                   generator=torch.Generator().manual_seed(0))[0]
    assert torch.equal(x, x2)
    lp_eval = tp.log_prob(par, x, conditional_input=ci)[0]
    assert torch.quantile((lp_eval - lp).abs(), 0.999).item() < 1e-3


def test_trainer_options_run(tmp_path):
    """The trainer's optimizer, checkpoint_path and checkpoint_every run: a
    caller's optimizer (Adam at lr 1e-3 gives the default fit's losses), a
    checkpoint after every chunk and at the end, each restorable."""
    p = tpdf("e2", "gg", device="cpu")
    par = p.init_params(seed=0)
    x = torch.randn((16, 2), generator=torch.Generator().manual_seed(0))
    _, ref = ttrain.fit(p, par, x, num_steps=3)
    got, losses = ttrain.fit(
        p, par, x, num_steps=3,
        optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-3, eps=1e-8),
        checkpoint_path=tmp_path / "ck", checkpoint_every=2)
    np.testing.assert_array_equal(losses, ref)
    assert sorted(f.name for f in (tmp_path / "ck").iterdir()) == \
        ["step_00000002", "step_00000003"]
    last, extra = checkpoint.restore(tmp_path / "ck" / "step_00000003",
                                     like_params=par)
    assert extra is None
    assert all(torch.equal(last[k], v) for k, v in got.items())


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert tpdf(*FLAGSHIP).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tpdf(*FLAGSHIP)
    p = tpdf(*FLAGSHIP, device="cpu")
    with pytest.raises(ValueError):
        p.log_prob(p.init_params(), torch.zeros((2, 10), device="meta"))
