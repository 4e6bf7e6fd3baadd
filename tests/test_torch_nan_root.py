"""The per-layer sample body's plain version at a NaN root, against the
JAX package's T7 sample body.

The target's cotangent of a sample layer is c = (g1 + g2 lx) / fp with the
tangents fp = dval/dx and lx = dld/dx at the root.  The JAX package takes
them in forward mode (``_gf_sample_raw_bwd``: the Pallas kernel
``_sample_bwd_body``, run here in interpret mode, as
tests/test_pallas_interpret.py runs it), where a NaN root makes them NaN;
the port's plain version (``ops/gf.py`` ``implicit_step``) takes them by
reverse-mode autograd of the mixture's tangent rule, which gates a NaN
coordinate away.  Both must give NaN in the same places and the same
values elsewhere.

K = 10, D = 4, isigmoid (the plain mixture, where the two modes part, and
the skewed one); raw broadcast slabs; one element and one whole row of the
root NaN; float32.  Tolerance: the relative norm over the finite entries,
3e-4, the sample body's limit in tests/test_torch_layer_raw_bwd.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jammy_flows_tpu.ops.pallas_gf as pg
from jammy_flows_tpu_torch.ops import gf_layer as gl
from test_torch_layer_raw_bwd import _inputs, _preps, _rel
from torch_one_thread import _one_torch_thread  # noqa: F401

TOL = 3e-4


@pytest.fixture(autouse=True, scope="module")
def interpret_mode():
    prev = pg._INTERPRET
    pg._INTERPRET = True
    jax.clear_caches()
    yield
    pg._INTERPRET = prev
    jax.clear_caches()


@pytest.mark.parametrize("skew", [0, 1])
def test_sample_body_cotangent_is_nan_at_a_nan_root(skew):
    k, d, ift = 10, 4, "isigmoid"
    x, g1, g2, slabs = _inputs(k, d, skew, 1, seed=3 + skew)
    x[5, 2] = np.nan
    x[9] = np.nan
    tprep, jprep = _preps(k, skew, 1)
    j_c, j_gs = pg._gf_sample_raw_bwd(
        ift, jprep, (jnp.asarray(x), tuple(map(jnp.asarray, slabs))),
        (jnp.asarray(g1), jnp.asarray(g2)))
    t_slabs = tuple(torch.as_tensor(s[..., 0]) for s in slabs)
    args = (torch.as_tensor(g1), torch.as_tensor(g2), ift, tprep)
    t_c, t_gs = gl.layer_bwd_plain("sample", "raw", torch.as_tensor(x),
                                   t_slabs, *args)
    for got, ref in zip((t_c, *t_gs), (j_c, *j_gs)):
        got = got.numpy()
        ref = np.asarray(ref).reshape(got.shape)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        fin = np.isfinite(ref)
        assert np.isfinite(got[fin]).all()
        if fin.any():
            assert _rel(got[fin], ref[fin]) < TOL
    assert np.isnan(t_c.numpy()[5, 2]) and np.isnan(t_c.numpy()[9]).all()
    # the rows the NaN does not reach keep the values of a run without it
    clean = x.copy()
    clean[5, 2] = clean[9] = 0.5
    c_clean = gl.layer_bwd_plain("sample", "raw", torch.as_tensor(clean),
                                 t_slabs, *args)[0]
    keep = torch.ones(x.shape, dtype=torch.bool)
    keep[5, 2] = False
    keep[9] = False
    assert torch.equal(t_c[keep], c_clean[keep])
