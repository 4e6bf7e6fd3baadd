"""The per-layer backward with raw broadcast slabs (T7 raw: the port's
``gf_layer.layer_bwd_plain``, both bodies) against the JAX package's
``gf_forward_raw`` / ``gf_sample_raw`` VJPs, whose backward is the Pallas
kernel ``_gf_bwd_call`` (``_forward_bwd_body`` / ``_sample_bwd_body``) run
in interpret mode, as tests/test_pallas_interpret.py runs it.

Skewed and not, K = 10, D = 4 (fit_norm on) and K = 7, D = 3 (fit_norm off),
isigmoid and inormal_partly_precise.  The density body takes the VJP at x;
the sample body at the JAX sample call's root, which both sides get.  Both
sides get the same numpy-seeded slabs, x and cotangents, in float32.

Tolerance: the relative norm of each gradient, 1e-4 for the density body
and 3e-4 for the sample body (its Newton root carries the solve's
residual): the JAX package's kernel-vs-XLA limits, as in
tests/test_torch_gf_layer.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jammy_flows_tpu.ops.pallas_gf as pg
from jammy_flows_tpu.ops import special as jspecial
from jammy_flows_tpu_torch.ops import gf_layer as gl
from jammy_flows_tpu_torch.ops import special as tspecial
from torch_one_thread import _one_torch_thread  # noqa: F401

B = 256
TOL_GRAD = {"forward": 1e-4, "sample": 3e-4}


@pytest.fixture(autouse=True, scope="module")
def interpret_mode():
    prev = pg._INTERPRET
    pg._INTERPRET = True
    jax.clear_caches()
    yield
    pg._INTERPRET = prev
    jax.clear_caches()


def _preps(k, skew, fit):
    signs = tuple([1.0] * (k // 2) + [-1.0] * (k - k // 2))
    return tuple(
        (mod.width_regulator_fn(0, 1, 0.01, 100, 0), None, bool(fit),
         mod.log_bounded_exp_fn(0.1, 9.0, center=True) if skew else None,
         signs if skew else None) for mod in (tspecial, jspecial))


def _inputs(k, d, skew, fit, seed):
    """x, the cotangents (B, D) and the raw slabs (K, D, 1), float32."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x, g1, g2 = (rng.normal(size=(B, d)).astype(f32) for _ in range(3))
    slabs = [rng.normal(size=(k, d, 1)), -1.0 + 0.5 * rng.normal(size=(k, d, 1))]
    slabs += [rng.normal(size=(k, d, 1))] * fit
    slabs += [0.8 * rng.normal(size=(k, d, 1))] * skew
    return x, g1, g2, [s.astype(f32) for s in slabs]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("body", ["forward", "sample"])
@pytest.mark.parametrize("skew", [0, 1])
@pytest.mark.parametrize("kd,fit,ift", [((10, 4), 1, "inormal_partly_precise"),
                                        ((7, 3), 0, "isigmoid")])
def test_raw_broadcast_bwd_matches_interpret_kernel(body, skew, kd, fit, ift):
    k, d = kd
    assert pg.raw_kernel_eligible(k, d) and pg.pallas_available()
    x, g1, g2, slabs = _inputs(k, d, skew, fit, seed=17 * k + 2 * skew)
    tprep, jprep = _preps(k, skew, fit)
    entry = pg.gf_forward_raw if body == "forward" else pg.gf_sample_raw
    out, vjp = jax.vjp(lambda xx, *ss: entry(xx, tuple(ss), ift, jprep),
                       jnp.asarray(x), *map(jnp.asarray, slabs))
    j_gx, *j_gs = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    # the density body at x, the sample body at the sample call's root
    at = x if body == "forward" else np.array(out[0])
    t_gx, t_gs = gl.layer_bwd_plain(
        body, "raw", torch.as_tensor(at),
        tuple(torch.as_tensor(s[..., 0]) for s in slabs),
        torch.as_tensor(g1), torch.as_tensor(g2), ift, tprep)
    for got, ref in zip((t_gx, *t_gs), (j_gx, *j_gs)):
        ref = np.asarray(ref).reshape(got.shape)
        assert np.isfinite(got.numpy()).all()
        assert _rel(got.numpy(), ref) < TOL_GRAD[body], _rel(got, ref)
