"""The whole-block op's lazy mode (precomputed hidden activations) and the
routing by MLP shape, against the JAX package.

* ``gf_block_density_lazy`` / ``gf_block_sample_lazy`` (the plain version on
  the CPU) and their gradients against the JAX package's entry points and
  VJPs, its Pallas kernels in interpret mode (``pallas_gf_block.py:625``,
  ``:647``), on an e3 `gggg` block with the four iCDF types;
* the flagship with two-hidden-layer ``"16-16"`` MLPs, whose amortized
  blocks take the lazy mode in both packages: float32 log_prob and the
  sample direction on shared base draws against the interpret-mode
  kernels, the route of ``nll_value_and_grad``, and float64
  ``nll_value_and_grad`` against JAX;
* an MLP whose hidden width exceeds MAX_KERNEL_H (1024) takes the per-layer
  route with materialized rows, as in the JAX package.

Inputs are made with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jammy_flows_tpu.ops.pallas_gf as pg
import jammy_flows_tpu.ops.pallas_gf_block as jblk
from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch.ops import gf_block as tblk, gf_layer as tlay
from jammy_flows_tpu_torch.utils.convert import params_from_jax
from torch_one_thread import _one_torch_thread  # noqa: F401

FLAGSHIP = ("e4+s2+e4", "gggg+f+gggg")
IFTS = ("inormal_partly_precise", "isigmoid", "inormal_partly_crude",
        "inormal_full_pade")
B = 256
HID = 16
# float32 against the interpret-mode kernels: the JAX package's
# kernel-vs-XLA limits (tests/test_pallas_interpret.py, tests/
# test_tpu_kernels.py): values 3e-4 (density) / 3e-3 (sample), gradients
# 1e-4 / 3e-4 relative norm; NLL loss 1e-4
TOL = {"density": 3e-4, "sample": 3e-3}
TOL_GRAD = {"density": 1e-4, "sample": 3e-4}
TOL_LOSS = 1e-4
# float64: identical algorithms, libm differences only
TOL_F64 = 1e-7


@pytest.fixture
def interpret_mode():
    prev = pg._INTERPRET
    pg._INTERPRET = True
    jax.clear_caches()
    yield
    pg._INTERPRET = prev
    jax.clear_caches()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _counting(monkeypatch, module, names):
    """Count the calls of module's entry points ``names``."""
    calls = {n: 0 for n in names}
    for n in names:
        fn = getattr(module, n)

        def counted(*a, n=n, fn=fn):
            calls[n] += 1
            return fn(*a)
        monkeypatch.setattr(module, n, counted)
    return calls


@pytest.mark.parametrize("direction", ["density", "sample"])
def test_lazy_block_matches_interpret_kernel(interpret_mode, direction):
    """Values and the VJP of the lazy-mode entry point: the port's plain
    version (autograd through its block backward) against the JAX entry
    point and jax.vjp of it, on shared inputs and cotangents."""
    opts = {(0, i): {"g": {"inverse_function_type": ift}}
            for i, ift in enumerate(IFTS)}
    kw = dict(options_overwrite=opts, conditional_input_dim=3)
    jp, tp = jpdf("e3", "gggg", **kw), tpdf("e3", "gggg", device="cpu", **kw)
    jprep, jmeta = jp._block_info(0)
    tprep, tmeta = tp._block_meta[0]
    assert tmeta == jmeta
    k, d, layers = tmeta
    n_p = tblk.block_rows(k, d, layers)
    base = tpdf("e3", "gggg", device="cpu").init_params(seed=0)[
        "flow_0"].double().numpy()
    rng = np.random.default_rng(11)
    f32 = np.float32
    x = (0.8 * rng.normal(size=(B, d))).astype(f32)
    hidden = np.tanh(rng.normal(size=(B, HID))).astype(f32)
    w = (0.05 * rng.normal(size=(n_p, HID))).astype(f32)
    b = (base + 0.1 * rng.normal(size=n_p)).astype(f32)
    g_out = rng.normal(size=(B, d)).astype(f32)
    g_ld = rng.normal(size=(B, d)).astype(f32)

    jfn = getattr(jblk, f"gf_block_{direction}_lazy")
    (jout, jld), vjp = jax.vjp(lambda *a: jfn(*a, jprep, jmeta),
                               jnp.asarray(x), jnp.asarray(hidden),
                               jnp.asarray(w), jnp.asarray(b)[:, None])
    jgrads = vjp((jnp.asarray(g_out), jnp.asarray(g_ld)))
    jgrads = jgrads[:3] + (jgrads[3][:, 0],)

    leaves = [torch.as_tensor(a).requires_grad_() for a in (x, hidden, w, b)]
    out, ld = getattr(tblk, f"gf_block_{direction}_lazy")(*leaves, tprep,
                                                          tmeta)
    grads = torch.autograd.grad((out, ld), leaves, (torch.as_tensor(g_out),
                                                    torch.as_tensor(g_ld)))
    for got, ref in ((out, jout), (ld, jld)):
        err = float(np.abs(got.detach().numpy() - np.asarray(ref)).max())
        assert err < TOL[direction], err
    for name, got, ref in zip(("x", "hidden", "w", "b"), grads, jgrads):
        assert got.shape == ref.shape and torch.isfinite(got).all()
        assert _rel(got.numpy(), ref) < TOL_GRAD[direction], name


def _pair(cond, dims):
    kw = dict(conditional_input_dim=cond, amortization_mlp_dims=dims)
    return jpdf(*FLAGSHIP, **kw), tpdf(*FLAGSHIP, device="cpu", **kw)


def _jittered(jp, dtype, seed):
    """init_params(seed=0) with the MLP weights moved by 0.02 * N(0, 1), so
    that the amortized parameters differ from row to row."""
    par = jp.init_params(seed=0, dtype=dtype)
    rng = np.random.default_rng(seed)
    return {k: v + (0.02 * rng.normal(size=v.shape)).astype(v.dtype)
            if k.startswith("mlp_") else v for k, v in par.items()}


def _flagship_data(n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = 0.8 * rng.normal(size=(n, 10))
    x[:, 4] = rng.uniform(0.2, 2.9, n)
    x[:, 5] = rng.uniform(0.1, 6.2, n)
    z = rng.normal(size=(n, 10))
    ci = rng.normal(size=(n, 3))
    return x.astype(dtype), z.astype(dtype), ci.astype(dtype)


def test_flagship_two_hidden_layers_f32_matches_interpret_kernels(
        interpret_mode, monkeypatch):
    """pdf(e4+s2+e4, gggg+f+gggg, conditional_input_dim=3,
    amortization_mlp_dims="16-16"): both amortized blocks take the lazy
    mode in both packages (the MLP is not one tanh hidden layer); log_prob
    and all_layer_forward on shared base draws agree, and
    nll_value_and_grad takes the same route."""
    n = 128
    jp, tp = _pair(3, "16-16")
    jpar = _jittered(jp, np.float32, 1)
    tpar = params_from_jax(jpar)
    x, z, ci = _flagship_data(n, np.float32, 2)
    names = [f"gf_block_{dr}_{m}" for dr in ("density", "sample")
             for m in ("lazy", "lazy2", "perm")]
    tcalls = _counting(monkeypatch, tblk, names)
    jcalls = _counting(monkeypatch, jblk, names)

    lj = jax.jit(lambda p, x, c: jp.log_prob(p, x, conditional_input=c)[0])(
        jpar, jnp.asarray(x), jnp.asarray(ci))
    lt = tp.log_prob(tpar, torch.as_tensor(x),
                     conditional_input=torch.as_tensor(ci))[0]
    assert float(np.abs(lt.numpy() - np.asarray(lj)).max()) < TOL["density"]
    xj, ldj = jax.jit(lambda p, z, c: jp.all_layer_forward(
        p, z, jnp.zeros(n, jnp.float32), c))(jpar, jnp.asarray(z),
                                             jnp.asarray(ci))
    xt, ldt = tp.all_layer_forward(tpar, torch.as_tensor(z), torch.zeros(n),
                                   torch.as_tensor(ci))
    assert float(np.abs(xt.numpy() - np.asarray(xj)).max()) < TOL["sample"]
    assert float(np.abs(ldt.numpy() - np.asarray(ldj)).max()) < TOL["sample"]
    want = {nm: 2 * nm.endswith("_lazy") for nm in names}
    assert tcalls == want and jcalls == want, (tcalls, jcalls)

    # the training step: no fused NLL for a lazy-mode block (as in the JAX
    # package, pdf.py:859-900); autograd of each block's term runs the
    # block forward and its backward, and the loss is -log_prob's mean
    loss, grads = tp.nll_value_and_grad(tpar, torch.as_tensor(x),
                                        torch.as_tensor(ci))
    assert abs(float(loss) + float(lt.mean())) < TOL_LOSS
    assert sorted(grads) == sorted(tpar)
    assert all(torch.isfinite(g).all() and g.abs().max() > 0
               for g in grads.values())
    assert tcalls["gf_block_density_lazy"] == 4


def test_flagship_two_hidden_layers_f64_nll_matches_jax():
    """float64 nll_value_and_grad of the "16-16" flagship (unconditional:
    block 0 permanent, block 2 amortized by the two-hidden-layer MLP)."""
    jp, tp = _pair(None, "16-16")
    jpar = _jittered(jp, np.float64, 3)
    tpar = params_from_jax(jpar)
    x, _, _ = _flagship_data(B, np.float64, 4)
    lj, gj = jax.jit(jp.nll_value_and_grad)(jpar, jnp.asarray(x))
    lt, gt = tp.nll_value_and_grad(tpar, torch.as_tensor(x))
    assert abs(float(lt) - float(lj)) < TOL_F64
    assert sorted(gt) == sorted(gj)
    for key in gj:
        err = float(np.abs(gt[key].numpy() - np.asarray(gj[key])).max())
        assert err < TOL_F64, (key, err)


def test_hidden_wider_than_max_kernel_h_takes_the_per_layer_route(
        interpret_mode, monkeypatch):
    """A 1025-wide hidden layer is beyond MAX_KERNEL_H: the block op and the
    per-layer lazy interface are refused and every g layer takes
    materialized rows (the raw per-row interface), in both packages; the
    values agree with the JAX package's f32 path."""
    n = 64
    kw = dict(conditional_input_dim=3, amortization_mlp_dims="1025")
    jp, tp = jpdf("e4", "gggg", **kw), tpdf("e4", "gggg", device="cpu", **kw)
    assert tp._block_meta[0] is not None
    jpar = _jittered(jp, np.float32, 5)
    tpar = params_from_jax(jpar)
    rng = np.random.default_rng(6)
    x = (0.8 * rng.normal(size=(n, 4))).astype(np.float32)
    ci = rng.normal(size=(n, 3)).astype(np.float32)
    blocks = _counting(monkeypatch, tblk, [
        f"gf_block_{dr}_{m}" for dr in ("density", "sample")
        for m in ("lazy", "lazy2", "perm")])
    layer = _counting(monkeypatch, tlay, [
        "gf_forward_lazy", "gf_sample_lazy", "gf_forward_raw",
        "gf_sample_raw"])
    lj = jax.jit(lambda p, x, c: jp.log_prob(p, x, conditional_input=c)[0])(
        jpar, jnp.asarray(x), jnp.asarray(ci))
    lt = tp.log_prob(tpar, torch.as_tensor(x),
                     conditional_input=torch.as_tensor(ci))[0]
    assert float(np.abs(lt.numpy() - np.asarray(lj)).max()) < TOL["density"]
    xj = jax.jit(lambda p, z, c: jp.all_layer_forward(
        p, z, jnp.zeros(n, jnp.float32), c)[0])(jpar, jnp.asarray(x),
                                                jnp.asarray(ci))
    xt = tp.all_layer_forward(tpar, torch.as_tensor(x), torch.zeros(n),
                              torch.as_tensor(ci))[0]
    assert float(np.abs(xt.numpy() - np.asarray(xj)).max()) < TOL["sample"]
    assert not any(blocks.values()), blocks
    assert layer == {"gf_forward_lazy": 0, "gf_sample_lazy": 0,
                     "gf_forward_raw": 4, "gf_sample_raw": 4}, layer
