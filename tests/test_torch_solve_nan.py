"""A NaN in one component of one dimension of a layer's parameters: the
port's plain versions of the solves (ops/gf.py ``solve``, the plain block
and per-layer versions the kernels are held to on the card) give NaN in
exactly the places the JAX package does.

The JAX side is its kernels' bodies run by XLA, eagerly (``pallas_gf``
``_solve`` with ``_prep_raw_params`` / ``_prepare_xla`` and
``_mixture_value_deriv_solve``; ``pallas_gf_block`` ``_block_sample_local``),
the functions its Pallas kernels evaluate per block.  Both take the
component-quantile bracket with a NaN-keeping min / max and clip, so an
isigmoid root is NaN where a component is; the regula-falsi start
(inormal_*, and every skewed mixture) fails its validity test on a NaN and
bisects from +-1e5, to a finite point in both.  The CUDA kernels are held
to these plain versions in tests/test_torch_layer_prep.py.

Cases: T1 sample perm (a flow_0 mean) and lazy2 (the final-layer bias of a
mean row) of a `gg` block; T5 / T6 raw, T6 prepared, broadcast and per-row
slabs (per row: one row's component); K = 10 and 7; isigmoid and
inormal_partly_precise (the skewed solve's kernels are held to their plain
versions at a NaN on the card).  Inputs are made with numpy from a seed and
handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jammy_flows_tpu.ops.pallas_gf as pg
import jammy_flows_tpu.ops.pallas_gf_block as jblk
from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu.ops import special as jspecial
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch.ops import gf_block as tblk, gf_layer as gl
from jammy_flows_tpu_torch.ops import special as tspecial
from torch_one_thread import _one_torch_thread  # noqa: F401

B = 128
IFTS = ("isigmoid", "inormal_partly_precise")
F32 = np.float32
D = 4


def _same_nans(t, j):
    assert np.array_equal(np.isnan(t.numpy()), np.isnan(np.asarray(j)))


@pytest.fixture(scope="module")
def gg():
    return jpdf("e4", "gg"), tpdf("e4", "gg", device="cpu")


@pytest.mark.parametrize("ift", IFTS)
@pytest.mark.parametrize("mode", ["perm", "lazy2"])
def test_block_sample_nan_places_match_jax(gg, mode, ift):
    """T1 sample with one mixture mean of the block's last layer NaN."""
    jp, tp = gg
    jprep, (k, d, jlayers) = jp._block_info(0)
    tprep, (_, _, tlayers) = tp._block_meta[0]
    jmeta = (k, d, tuple((*lm[:3], ift) for lm in jlayers))
    tmeta = (k, d, tuple((*lm[:3], ift) for lm in tlayers))
    n_rows = tblk.block_rows(*tmeta)
    idx = torch.arange(n_rows, dtype=torch.float64)[:, None]
    means = tblk._make_slabs([idx], *tmeta, "perm")[-1][2][0]
    j = int(means[3, 2, 0])
    rng = np.random.default_rng(10 + len(mode) + len(ift))
    z = rng.normal(size=(B, d)).astype(F32)
    flow0 = tp.init_params(seed=0)["flow_0"].numpy()
    vec = (flow0 + 0.1 * rng.normal(size=n_rows)).astype(F32)
    vec[j] = np.nan
    if mode == "perm":
        params = [vec]
        jparams = [jnp.asarray(vec)[:, None]]
        lazy = False
    else:
        hid, n_in = 16, 3
        summary = rng.normal(size=(B, n_in)).astype(F32)
        w1 = (rng.normal(size=(hid, n_in)) / np.sqrt(n_in)).astype(F32)
        b1 = (0.1 * rng.normal(size=hid)).astype(F32)
        w = (0.02 * rng.normal(size=(n_rows, hid))).astype(F32)
        params = [summary, w1, b1, w, vec]
        jparams = [jnp.asarray(summary.T), jnp.asarray(w1),
                   jnp.asarray(b1)[:, None], jnp.asarray(w),
                   jnp.asarray(vec)[:, None]]
        lazy = "lazy2"
    jo, jl = jblk._block_sample_local(jnp.asarray(z.T), jparams, jprep, jmeta,
                                      lazy)
    to, tl = tblk.block_plain("sample", torch.as_tensor(z),
                              tuple(torch.as_tensor(a) for a in params),
                              tprep, tmeta, mode)
    _same_nans(to, jo.T)
    _same_nans(tl, jl.T)
    assert bool(torch.isnan(to).any()) == (ift == "isigmoid")
    assert bool(torch.isnan(tl).any())


def _preps():
    return tuple((sp.width_regulator_fn(0, 1, 0.01, 100, 0), None, True)
                 for sp in (tspecial, jspecial))


# (mode, interface, per row)
LAYER_CASES = [("sample", "raw", False), ("sample", "raw", True),
               ("inverse", "raw", False), ("inverse", "raw", True),
               ("inverse", "prepared", False), ("inverse", "prepared", True)]


@pytest.mark.parametrize("mode,iface,per_row", LAYER_CASES)
def test_layer_solve_nan_places_match_jax(mode, iface, per_row):
    """T5 / T6 with one component of one dimension NaN (a prepared mean,
    or a raw log-width; per row at row 5 only)."""
    d = D
    for k in (10, 7):
        rng = np.random.default_rng(20 + k + per_row)
        shp = (k, d, B if per_row else 1)
        x = rng.normal(size=(B, d)).astype(F32)
        if iface == "prepared":
            slabs = [rng.normal(size=shp),
                     np.log(0.3 + rng.uniform(size=shp)),
                     rng.normal(size=shp)]
        else:
            slabs = [rng.normal(size=shp), -1.0 + 0.5 * rng.normal(size=shp),
                     rng.normal(size=shp)]
        slabs = [s.astype(F32) for s in slabs]
        slabs[0 if iface == "prepared" else 1][3, 1, 5 if per_row else 0] = \
            np.nan
        tprep, jprep = _preps()
        tslabs = tuple(torch.as_tensor(s) for s in slabs)
        # the JAX side takes every slab (K, D, B), broadcast ones repeated:
        # one shape for both forms, so that its eager dispatch compiles
        # each operation once
        jslabs = [jnp.asarray(np.broadcast_to(s, (k, d, B))) for s in slabs]
        if iface == "prepared":
            jmix = pg._prepare_xla(*jslabs) + (None, None)
        else:
            jmix = pg._prep_raw_params(jslabs, jprep)
        for ift in IFTS:
            if iface == "prepared":
                got = (gl.gf_inverse_pallas(torch.as_tensor(x), *tslabs,
                                            ift=ift),)
            else:
                got = gl.layer_plain(mode, iface, torch.as_tensor(x), tslabs,
                                     ift, tprep)
                got = got if isinstance(got, tuple) else (got,)
            root = pg._solve(jnp.asarray(x.T), jmix, ift)
            want = [root.T]
            if mode == "sample":
                want.append(pg._mixture_value_deriv_solve(
                    root, jmix, "log", ift)[1].T)
            for a, b in zip(got, want):
                _same_nans(a, b)
            assert bool(torch.isnan(got[0][:, 1]).any()) == \
                (ift == "isigmoid")
            others = [c for c in range(d) if c != 1]
            assert not bool(torch.isnan(got[0][:, others]).any())
