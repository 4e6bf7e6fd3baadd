"""The simplex chain and the amortization MLP of the port against the JAX
package.

* ops/manifold.py's simplex chain (Gaussian <-> box <-> skewed box <-> base
  simplex <-> canonical simplex, the projection matrices) in float64 at
  d = 1, 2, 3: values and log-dets at 1e-10, and the round trips;
* the Gaussian-CDF projections (to the box, to an interval) and their
  inverses keep their values inside the open unit interval in float32 and
  float64, far into the tails (where a float32 CDF rounds to 0 or 1) and on
  the faces, so that the simplex and interval models' log_prob of such
  samples stays finite;
* the Gumbel quantities of the `u` layer: values and gradients, finite
  where the unused branch's would not be (x > 5);
* AmortizableMLP in every highway mode, full rank and low rank: the packed
  size, ``default_init`` with a pinned final bias from the same numpy seed
  (equal), and ``apply`` with shared (Bp = 1) and per-row (Bp = B) weights,
  values and gradients (one ``jax.vjp``), in float64.

Inputs are made with numpy from a seed and handed to both packages."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jammy_flows_tpu.layers.simplex import GumbelSoftmax as JGumbel
from jammy_flows_tpu.models.amortizable_mlp import AmortizableMLP as JMLP
from jammy_flows_tpu.ops import manifold as jman
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch.layers.simplex import GumbelSoftmax as TGumbel
from jammy_flows_tpu_torch.models.amortizable_mlp import AmortizableMLP as TMLP
from jammy_flows_tpu_torch.ops import manifold as tman
from torch_one_thread import _one_torch_thread  # noqa: F401

B = 64
TOL = 1e-10
# the references compile once per case, at XLA's lowest backend
# optimization level (eager JAX compiles each op: ~10x slower here)
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})
NAMES = tuple(name for pair in (
    ("gauss_to_box", "box_to_gauss"),
    ("box_to_skewed_box", "skewed_box_to_box"),
    ("box_to_base_simplex", "base_simplex_to_box"),
    ("base_simplex_to_canonical", "canonical_simplex_to_base"))
    for name in pair)
# the same tolerance for the MLP's gradients, relative to their largest
TOL_GRAD = 1e-10


def _inputs(name, d, rng):
    """Rows inside each map's domain: Gaussian rows, box rows off its faces,
    base-simplex rows (a Dirichlet draw's first d coordinates), canonical
    rows (the whole draw)."""
    if name == "gauss_to_box":
        return rng.normal(size=(B, d))
    if name in ("box_to_gauss", "box_to_skewed_box", "skewed_box_to_box",
                "box_to_base_simplex"):
        return rng.uniform(0.02, 0.98, size=(B, d))
    full = rng.dirichlet(np.ones(d + 1), size=B)
    return full if name == "canonical_simplex_to_base" else full[:, :d]


@pytest.mark.parametrize("d", [1, 2, 3])
def test_simplex_chain_matches_jax(d):
    rng = np.random.default_rng(d)
    ld0 = rng.normal(size=B)
    xs = [_inputs(name, d, rng) for name in NAMES]
    ref = _jit(lambda xs, ld: [getattr(jman, name)(x, ld)
                               for name, x in zip(NAMES, xs)])(
        [jnp.asarray(x) for x in xs], jnp.asarray(ld0))
    for name, x, (yj, lj) in zip(NAMES, xs, ref):
        yt, lt = getattr(tman, name)(torch.as_tensor(x),
                                     torch.as_tensor(ld0))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                                   atol=TOL, err_msg=name)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=TOL, err_msg=name)
    # each map's inverse undoes it, the log-dets cancelling
    for fwd, inv in zip(NAMES[::2], NAMES[1::2]):
        x = torch.as_tensor(_inputs(fwd, d, rng))
        y, ld = getattr(tman, fwd)(x, torch.zeros(B, dtype=x.dtype))
        back, ld = getattr(tman, inv)(y, ld)
        torch.testing.assert_close(back, x, rtol=0, atol=1e-9)
        torch.testing.assert_close(ld, torch.zeros_like(ld), rtol=0,
                                   atol=1e-9)
    m, m_rev = tman.simplex_projection_matrices(d)
    mj, mj_rev = jman.simplex_projection_matrices(d)
    np.testing.assert_array_equal(m.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(m_rev.numpy(), np.asarray(mj_rev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gaussian_cdf_projections_stay_inside_the_unit_interval(dtype):
    """Base draws from 5.25 (where the JAX package's float32 box coordinate
    rounds to 1 and its log_prob is NaN) to 40 standard deviations."""
    tails = torch.tensor([5.25, 5.5, 6.0, 10.0, 40.0], dtype=dtype)
    z = torch.cat([tails, -tails])[:, None]
    ld = torch.zeros(z.shape[0], dtype=dtype)
    u, _ = tman.gauss_to_box(z, ld)
    v, _ = tman.real_line_to_interval(z, ld, -2.0, 3.0)
    assert ((u > 0) & (u < 1)).all() and ((v > -2.0) & (v < 3.0)).all()
    for back, ld_back in (tman.box_to_gauss(u, ld),
                          tman.interval_to_real_line(v, ld, -2.0, 3.0)):
        assert torch.isfinite(back).all() and torch.isfinite(ld_back).all()
    # rows on the faces themselves (a coordinate that rounded to 0 or 1)
    ends = torch.tensor([[0.0], [1.0]], dtype=dtype)
    for back, ld_back in (tman.box_to_gauss(ends, ld[:2]),
                          tman.interval_to_real_line(5.0 * ends - 2.0, ld[:2],
                                                     -2.0, 3.0)):
        assert torch.isfinite(back).all() and torch.isfinite(ld_back).all()
    p = tpdf("a2+i1_-2.0_3.0", "w+r", device="cpu")
    par = p.init_params(seed=0, dtype=dtype)
    zz = torch.cat([z, z.flip(0), z], dim=1)
    x, _ = p.all_layer_forward(par, zz, ld)
    assert torch.isfinite(p.log_prob(par, x)[0]).all()


def test_gumbel_quantities_and_gradients_match_jax():
    """Across the switch at x = 5 and far past it (where the unused exact
    branch's own gradient would be NaN), values and the gradient of their
    sum."""
    x = np.concatenate([np.linspace(-3.0, 40.0, 61), [5.0, 5.0 + 1e-9]])

    def jsum(v):
        return sum(q.sum() for q in JGumbel._gumbel_log_quantities(v))

    vals_j, grad_j = _jit(lambda v: (JGumbel._gumbel_log_quantities(v),
                                     jax.grad(jsum)(v)))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    vals_t = TGumbel._gumbel_log_quantities(xt)
    (grad_t,) = torch.autograd.grad(sum(q.sum() for q in vals_t), xt)
    for a, b in zip(vals_t, vals_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-12, atol=1e-300)
    assert torch.isfinite(grad_t).all()
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j),
                               rtol=1e-12, atol=1e-300)


# (hidden layers, rank of every matrix) per highway mode: full rank and low
# rank (rank 2 makes the 6 -> 5 and 7 -> 4 maps low-rank, "smart" mode),
# and mode 1 without a hidden layer (its linear highway alone)
MLP_SHAPES = {0: (("6-5", 2),), 1: (("7", 0), ("", 0)), 2: (("6-5", 0),),
              3: (("6-5", 2),), 4: (("7", 2),)}


@pytest.mark.parametrize("mode", sorted(MLP_SHAPES))
def test_mlp_highway_modes_and_per_row_weights_match_jax(mode):
    rng = np.random.default_rng(10 + mode)
    for hidden, ranks in MLP_SHAPES[mode]:
        kw = dict(highway_mode=mode, low_rank_approximations=ranks)
        jm, tm = JMLP(3, hidden, 4, **kw), TMLP(3, hidden, 4, **kw)
        assert tm.num_params == jm.num_params
        bias = rng.normal(size=4)
        np.testing.assert_array_equal(
            tm.default_init(np.random.default_rng(mode), fix_final_bias=bias),
            jm.default_init(np.random.default_rng(mode), fix_final_bias=bias))
        np.testing.assert_array_equal(
            tm.default_init(np.random.default_rng(mode)),
            jm.default_init(np.random.default_rng(mode)))
        x = rng.normal(size=(B, 3))
        ct = rng.normal(size=(B, 4))
        for bp in (1, B):
            w = 0.3 * rng.normal(size=(bp, jm.num_params))
            out_j, (gw_j, gx_j) = _jit(lambda w, x, ct: (
                lambda out, vjp: (out, vjp(ct)))(*jax.vjp(jm.apply, w, x)))(
                jnp.asarray(w), jnp.asarray(x), jnp.asarray(ct))
            wt = torch.as_tensor(w).requires_grad_()
            xt = torch.as_tensor(x).requires_grad_()
            out_t = tm.apply(wt, xt)
            gw_t, gx_t = torch.autograd.grad(out_t, (wt, xt),
                                             torch.as_tensor(ct))
            what = (mode, hidden, ranks, bp)
            np.testing.assert_allclose(out_t.detach().numpy(),
                                       np.asarray(out_j), rtol=0, atol=TOL,
                                       err_msg=str(what))
            for a, b in ((gw_t, gw_j), (gx_t, gx_j)):
                b = np.asarray(b)
                assert np.abs(a.numpy() - b).max() <= \
                    TOL_GRAD * max(np.abs(b).max(), 1.0), what
    # the penultimate split and the fused kernels take highway mode 0 only
    assert TMLP(3, "6", 4).supports_full_fusion()
    assert (TMLP(3, "6", 4, highway_mode=mode).supports_penultimate()
            == (mode == 0))


def test_mlp_per_row_weights_are_not_copied(monkeypatch):
    """The per-row products read (B, out, in) views of the slab's columns,
    a slab that is itself a column slice of a wider one included; their
    gradient is one (B, n) tensor; a slab of another row count raises."""
    tm = TMLP(2, "8", 5)
    wide = torch.randn((B, tm.num_params + 7), dtype=torch.float64)
    slab = wide[:, 3:3 + tm.num_params]
    x = torch.randn((B, 2), dtype=torch.float64)
    storages = []
    bmm = torch.bmm

    def spy(a, b):
        storages.append(a.untyped_storage().data_ptr())
        return bmm(a, b)

    monkeypatch.setattr(torch, "bmm", spy)
    out = tm.apply(slab, x)
    assert storages == [wide.untyped_storage().data_ptr()] * 2
    torch.testing.assert_close(out, tm.apply(slab.clone(), x), rtol=0, atol=0)
    w = slab.clone().requires_grad_()
    (g,) = torch.autograd.grad(tm.apply(w, x).sum(), w)
    assert g.shape == w.shape
    with pytest.raises(ValueError):
        tm.apply(w[:3], x)
