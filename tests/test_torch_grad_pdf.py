"""Float32 gradients of the port's flagship-family pdfs against the JAX
package: the port's ``nll_value_and_grad`` (fused NLL calls for the gggg
blocks, autograd of the `f` sub-pdf's term) against the JAX package's
``nll_value_and_grad`` with its Pallas kernels in interpret mode, and
against JAX ``value_and_grad(-log_prob(...).mean())``, for the three
configurations of tests/test_pallas_interpret.py:160-164; and the CPU
routes.  The float64 gradients are in tests/test_torch_grad_f64.py.

Inputs are made with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jammy_flows_tpu.ops.pallas_gf as pg
from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch.utils.convert import params_from_jax, to_numpy
from torch_one_thread import _one_torch_thread  # noqa: F401

CONFIGS = [("e4", "gggg", 3), ("e4", "gggg", None),
           ("e4+s2+e4", "gggg+f+gggg", 3)]
B32 = 512
# float32 against the interpret-mode kernels: the JAX package's fused-NLL
# limits on the chip (tests/test_tpu_kernels.py), loss 1e-4 absolute and a
# relative norm of 1e-4 per gradient
TOL_LOSS = 1e-4
TOL_GRAD = 1e-4


@pytest.fixture
def interpret_mode():
    prev = pg._INTERPRET
    pg._INTERPRET = True
    jax.clear_caches()
    yield
    pg._INTERPRET = prev
    jax.clear_caches()


def _pair(defs, flows, cond, dims="16"):
    kw = dict(conditional_input_dim=cond, amortization_mlp_dims=dims)
    return jpdf(defs, flows, **kw), tpdf(defs, flows, device="cpu", **kw)


def _data(p, n, cond, seed, dtype):
    rng = np.random.default_rng(seed)
    x = 0.6 * rng.normal(size=(n, p.total_target_dim))
    for k, d in enumerate(p.pdf_defs_list):
        if d == "s2":
            lo, _ = p.target_dim_indices[k]
            x[:, lo] = 1.2 + 0.2 * x[:, lo]
            x[:, lo + 1] = 1.0 + 0.2 * x[:, lo + 1]
    ci = None if cond is None else rng.normal(size=(n, cond))
    return x.astype(dtype), None if ci is None else ci.astype(dtype)


def _jittered(jp, dtype, seed):
    """init_params(seed=0) with the MLP weights moved by 0.02 * N(0, 1), so
    that the amortized parameters differ from row to row."""
    rng = np.random.default_rng(seed)
    par = {k: np.asarray(v) for k, v in jp.init_params(
        seed=0, dtype=jnp.float64).items()}
    return {k: (v + (0.02 * rng.normal(size=v.shape) if k.startswith("mlp_")
                     else 0.0)).astype(dtype) for k, v in par.items()}


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("config", CONFIGS, ids=["e4-cond", "e4-perm",
                                                 "flagship-cond"])
def test_nll_value_and_grad_matches_jax(interpret_mode, config):
    defs, flows, cond = config
    jp, tp = _pair(defs, flows, cond)
    par = _jittered(jp, np.float32, seed=1)
    x, ci = _data(tp, B32, cond, seed=2, dtype=np.float32)
    lt, gt = tp.nll_value_and_grad(params_from_jax(par), _t(x), _t(ci))
    gt = to_numpy(gt)
    jpar = {k: jnp.asarray(v) for k, v in par.items()}
    refs = (
        jax.jit(lambda pp: jp.nll_value_and_grad(pp, _j(x), _j(ci)))(jpar),
        jax.jit(jax.value_and_grad(lambda pp: -jp.log_prob(
            pp, _j(x), conditional_input=_j(ci))[0].mean()))(jpar))
    assert sorted(gt) == sorted(jpar)
    for lj, gj in refs:
        assert abs(float(lt) - float(lj)) < TOL_LOSS
        for key in gt:
            assert np.isfinite(gt[key]).all()
            assert _rel(gt[key], gj[key]) < TOL_GRAD, key


def test_f32_card_routes_are_the_cpu_plain_versions():
    """On the CPU, nll_value_and_grad runs the fused NLL call's plain
    version for each block and equals autograd of -log_prob().mean()
    through the entry points' plain backward."""
    from jammy_flows_tpu_torch.ops import gf_block
    _, tp = _pair("e4+s2+e4", "gggg+f+gggg", None)
    par = tp.init_params(seed=0)
    x, _ = _data(tp, 256, None, seed=7, dtype=np.float32)
    gf_block.reset_launch_counts()
    l1, g1 = tp.nll_value_and_grad(par, _t(x))
    l2, g2 = tp._value_and_grad(
        lambda pp: -tp.log_prob(pp, _t(x))[0].mean(), par)
    assert set(gf_block.LAUNCHES.values()) == {0}
    assert abs(float(l1) - float(l2)) < 1e-5
    for key in g1:
        assert _rel(g1[key].numpy(), g2[key].numpy()) < 1e-5
