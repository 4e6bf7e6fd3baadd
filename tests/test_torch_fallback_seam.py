"""The mixture's fallback lanes' switch as one named constant.

The port's plain density (``ops/logistic_kde.py``) takes the far-tail
fallback lanes where every component lies beyond ``FALLBACK_SEAM`` (55)
width-units, as the JAX package does with its literal 55.0 and the CUDA
kernels with ``csrc/gf_common.cuh`` FALLBACK_SEAM.  The kernel-vs-plain
probe (``tools/perm_edge_probe.py``) moves that constant to flip-check rows
at the seam.  These tests hold that a move by delta changes exactly the
rows whose distance c = min_k |c_k| - 55 lies between 0 and delta (they
take the other branch), bit for bit nothing else, and that the unmoved
constant gives the JAX package's values on both sides of the seam.

Rows: K = 10, D = 4 seeded mixtures and x placed beyond every component
on either side at min_k |c_k| = 55 + u, u uniform in (-1, 1), float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jammy_flows_tpu.ops import logistic_kde as jlk
from jammy_flows_tpu_torch.ops import gf, logistic_kde as lk
from jammy_flows_tpu_torch.tools import perm_edge_probe as probe
from torch_one_thread import _one_torch_thread  # noqa: F401

K, D, B = 10, 4, 2048


def _case(seed):
    """(x (D, B), mixture (K, D, 1) tensors), float32."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    means = rng.normal(size=(K, D, 1)).astype(f32)
    iw = np.exp(0.3 * rng.normal(size=(K, D, 1))).astype(f32)
    ln = rng.normal(size=(K, D, 1))
    lnw = (ln - np.log(np.exp(ln).sum(0, keepdims=True))).astype(f32)
    u = rng.uniform(-1.0, 1.0, size=(D, B))
    side = np.where(rng.uniform(size=(D, B)) < 0.5, 1.0, -1.0)
    # beyond every component on one side: the nearest one at 55 + u units
    edge = np.where(side > 0, (means + (55.0 + u) / iw).max(0),
                    (means - (55.0 + u) / iw).min(0))
    mix = tuple(torch.as_tensor(a) for a in (means, iw, lnw))
    return torch.as_tensor(edge.astype(f32)), mix


def _density(x, mix, ift):
    return gf.mixture_value_deriv(x, mix, "log", ift)


@pytest.mark.parametrize("ift", ["isigmoid", "inormal_partly_precise"])
@pytest.mark.parametrize("delta", [0.25, -0.25])
def test_moving_the_fallback_seam_moves_only_rows_within_it(ift, delta):
    x, mix = _case(3)
    c = probe.seam_distances(x, mix, ift)[1]
    lo, hi = min(0.0, delta), max(0.0, delta)
    band = (c > lo) & (c <= hi)
    assert int(band.sum()) > 20 and int((~band).sum()) > 1000
    ref = _density(x, mix, ift)
    moved = probe.flipped(lambda: _density(x, mix, ift), delta, "fallback")
    assert lk.FALLBACK_SEAM == 55.0         # restored after the run
    changed = torch.zeros_like(band)
    for a, b in zip(moved, ref):
        assert torch.isfinite(a).all() and torch.isfinite(b).all()
        changed |= a != b
    # every row outside the band keeps its bits; the band's rows took the
    # other branch
    assert not bool((changed & ~band).any())
    assert int(changed.sum()) > int(band.sum()) // 2


def test_fallback_seam_matches_the_reference():
    """At the unmoved constant the port's (log_cdf, log_sf, log_pdf) on the
    seam rows are the JAX package's, lanes and all (float32 on both)."""
    x, (means, iw, lnw) = _case(4)
    common = (x[None] - means) * iw
    got = lk.mixture_linear_logs(common, torch.exp(lnw), lnw, iw,
                                 torch.log(iw), True)
    j = jnp.asarray
    ref = jlk.mixture_linear_logs(j(common.numpy()), j(torch.exp(lnw).numpy()),
                                  j(lnw.numpy()), j(iw.numpy()),
                                  j(torch.log(iw).numpy()), True)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-5)
