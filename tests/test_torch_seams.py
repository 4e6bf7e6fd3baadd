"""The float32 seams of the reference's mixture math, in the JAX package and
in the port alike.

Two places in the float32 formulation switch branch on a threshold, and
the value jumps there by far more than the kernels' 3e-4 limit against
their plain versions:

  * the normal iCDF (``inormal_partly_precise``) moves from the erfinv
    polynomial to the Pade tail where 4 cdf (1 - cdf) crosses
    4 PADE_BOUND (1 - PADE_BOUND), cdf ~ 0.5e-7;
  * the mixture's log CDF / log SF / log pdf take the max-term fallback
    once every component lies beyond 55 width units.

A kernel and its plain version a float32 rounding apart can land on the
two sides of such a seam.  Here consecutive float32 inputs straddle each
seam; the JAX package's jump must be the port's, and larger than that
limit, while the steps away from the seam stay at the float32 slope.
Runs on the CPU.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jammy_flows_tpu.ops import logistic_kde as jk
from jammy_flows_tpu_torch.ops import logistic_kde as tk
from torch_one_thread import _one_torch_thread  # noqa: F401

KERNEL_TOL = 3e-4   # kernel vs plain, the density direction
SMOOTH = 1e-5       # a step between float32 neighbours off the seam
N_STEPS = 64        # float32 neighbours on each side of a seam


def _straddle(x0):
    """2 N_STEPS consecutive float32 values around x0."""
    x0 = np.float32(x0)
    return np.float32(x0 + np.arange(-N_STEPS, N_STEPS, dtype=np.float32)
                      * abs(np.spacing(x0)))


def _jump(v, at):
    """(the step across index at, the largest step elsewhere) of v."""
    d = np.diff(np.asarray(v, dtype=np.float64))
    return d[at], np.abs(np.delete(d, at)).max()


# the value's and the log-derivative's step from the Pade tail into the bulk
@pytest.mark.parametrize("ift, jump, ld_jump", [
    ("inormal_partly_precise", -3.357e-3, -4.862e-3),
    ("inormal_partly_crude", 6.63e-5, 5.229e-2)])
def test_icdf_seam_jump_is_the_references(ift, jump, ld_jump):
    log_cdf = _straddle(math.log(tk.PADE_BOUND))
    log_sf = np.float32(np.log1p(-np.exp(log_cdf.astype(np.float64))))
    log_pdf = np.zeros_like(log_cdf)
    good = log_cdf + log_sf + np.float32(tk.LOG_4) > np.float32(tk.LOG_SEAM)
    at, = np.nonzero(np.diff(good))
    assert len(at) == 1
    j_val = np.asarray(jk.icdf_pass(jnp.asarray(log_cdf),
                                    jnp.asarray(log_sf), ift))
    j_ld = np.asarray(jk.icdf_log_derivative(
        jnp.asarray(log_cdf), jnp.asarray(log_sf), jnp.asarray(log_pdf), ift))
    args = [torch.from_numpy(a) for a in (log_cdf, log_sf, log_pdf)]
    t_val = tk.icdf_pass(*args[:2], ift).numpy()
    t_ld = tk.icdf_log_derivative(*args, ift).numpy()
    for ref, got, expect in ((j_val, t_val, jump), (j_ld, t_ld, ld_jump)):
        (j_step, j_rest), (t_step, t_rest) = _jump(ref, at[0]), \
            _jump(got, at[0])
        assert j_step == pytest.approx(expect, rel=1e-3)
        assert abs(t_step - j_step) <= 2e-6
        assert max(j_rest, t_rest) < SMOOTH
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    if ift == "inormal_partly_precise":
        assert abs(j_val[at[0] + 1] - j_val[at[0]]) > KERNEL_TOL


@pytest.mark.parametrize("sign", [1, -1])
def test_mixture_fallback_seam_jump_is_the_references(sign):
    """K = 10 equal components, one crossing 55 width units (the left tail
    for sign 1, the right for -1) while the others sit at 80."""
    k = 10
    dom = _straddle(-55.0)
    common = np.full((k, 1, dom.size), -80.0, np.float32)
    common[0, 0] = dom
    common *= np.float32(sign)
    at, = np.nonzero(np.diff(dom < -55.0))
    assert len(at) == 1
    w = np.full((k, 1, 1), 1.0 / k, np.float32)
    ins = (common, w, np.log(w), np.ones_like(w), np.zeros_like(w))
    ref = jk.mixture_linear_logs(*(jnp.asarray(a) for a in ins), True)
    got = tk.mixture_linear_logs(*(torch.from_numpy(a) for a in ins), True)
    crossed = ("log_cdf", "log_pdf") if sign == 1 else ("log_sf", "log_pdf")
    for name, r, g in zip(("log_cdf", "log_sf", "log_pdf"), ref, got):
        r, g = np.asarray(r)[0], g.numpy()[0]
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-7)
        if name in crossed:
            j_step, j_rest = _jump(r, at[0])
            t_step, _ = _jump(g, at[0])
            assert abs(j_step) > 100 * KERNEL_TOL
            assert t_step == j_step
            assert j_rest < SMOOTH
