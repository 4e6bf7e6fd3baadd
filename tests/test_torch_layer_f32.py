"""The skewed and the mean-centred flagship of the port against the JAX
package in float32 (see test_torch_layer_pdf.py for the models): the
per-layer route (ops/gf_layer.py plain versions on the CPU: raw / lazy
entry points for the skewed model, prepared ones for the centred) against
the JAX package with its per-layer Pallas kernels in interpret mode,
log_prob and all_layer_forward on shared base draws.

Inputs are made with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jammy_flows_tpu.ops.pallas_gf as pg
from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch.ops import gf_block as tblk, gf_layer as gl
from jammy_flows_tpu_torch.utils.convert import params_from_jax
from torch_one_thread import _one_torch_thread  # noqa: F401

SKEW = {"g": {"add_skewness": 1}}
CENTRE = {"g": {"center_mean": 1}}
MODELS = [(SKEW, None), (SKEW, 3), (CENTRE, None), (CENTRE, 3)]
IDS = ["skewed", "skewed-cond", "centred", "centred-cond"]
B = 256
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


def _data(seed, dtype, cond, d_total=10):
    rng = np.random.default_rng(seed)
    x = 0.8 * rng.normal(size=(B, d_total))
    x[:, 4] = rng.uniform(0.2, 2.9, B)
    x[:, 5] = rng.uniform(0.1, 6.2, B)
    z = rng.normal(size=(B, d_total))
    ci = rng.normal(size=(B, 3)) if cond else None
    cast = (lambda a: None if a is None else a.astype(dtype))
    return cast(x), cast(z), cast(ci)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


@pytest.mark.parametrize("opts,cond", MODELS, ids=IDS)
def test_f32_layer_route_matches_interpret_kernels(interpret_mode,
                                                   monkeypatch, opts, cond):
    kw = dict(options_overwrite=opts, conditional_input_dim=cond,
              amortization_mlp_dims="16")
    jp = jpdf("e4+s2+e4", "gggg+f+gggg", **kw)
    tp = tpdf("e4+s2+e4", "gggg+f+gggg", device="cpu", **kw)
    assert tp._block_meta[0] is None and tp._block_meta[2] is None
    calls = []
    run = gl._run
    monkeypatch.setattr(gl, "_run", lambda *a: calls.append(a[:2]) or run(*a))
    jpar = jp.init_params(seed=0, dtype=jnp.float32)
    rng = np.random.default_rng(6)
    jpar = {k: v + jnp.asarray(0.02 * rng.normal(size=v.shape), jnp.float32)
            for k, v in jpar.items()}
    tpar = params_from_jax(jpar)
    x, z, ci = _data(2, np.float32, cond)

    @jax.jit
    def ref(p, x, z, c):
        lp = jp.log_prob(p, x, conditional_input=c)[0]
        return (lp,) + jp.all_layer_forward(p, z, jnp.zeros(B, jnp.float32), c)

    lj, xj, ldj = ref(jpar, _j(x), _j(z), _j(ci))
    lt = tp.log_prob(tpar, _t(x), conditional_input=_t(ci))[0]
    xt, ldt = tp.all_layer_forward(tpar, _t(z), torch.zeros(B), _t(ci))
    assert float(np.abs(lt.numpy() - np.asarray(lj)).max()) < TOL_F32_DENSITY
    assert float(np.abs(xt.numpy() - np.asarray(xj)).max()) < TOL_F32_SAMPLE
    assert float(np.abs(ldt.numpy() - np.asarray(ldj)).max()) < TOL_F32_SAMPLE
    # the route: per-layer entry points, never the block op
    ifaces = {c[1] for c in calls}
    assert ifaces == ({"prepared"} if opts is CENTRE else
                      ({"lazy"} if cond else {"raw", "lazy"}))
    assert len(calls) == (24 if opts is CENTRE else 16)
    assert not any(tblk.LAUNCHES.values())
