"""The diagnostics' mappings and entropies against the JAX package, in
float64 on the conditional ``"e2+s2+e2", "gg+f+gg"`` at one set of
jittered parameters:

* ``all_layer_forward_subdims`` / ``all_layer_inverse_subdims`` and their
  per-sub-manifold log-dets on JAX's own base draws z and targets x, in
  the default, embedding and intrinsic coordinates;
* ``sample_with_subdim_logprobs``' per-sub-manifold log-pdfs on the z that
  JAX's call returned (JAX seeds cannot be reproduced: parity runs on
  shared draws);
* ``_marginal_entropy`` (the S x S conditioning-pair logsumexp) and its
  gradient in the parameters on JAX's targets;
* ``approximate_coverage`` on shared x, per sub-manifold;

and on the port alone: ``entropy``, ``entropy_iterative`` (chunked over
samples and batch items) and ``entropy_device`` equal on one generator
state; the entropy's gradient against central differences; failsafe
draws that pass the cross-check.  Inputs are made with numpy from a seed
and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch.utils.convert import params_from_jax
from test_torch_cnf import _jit
from torch_one_thread import _one_torch_thread  # noqa: F401

DEFS = ("e2+s2+e2", "gg+f+gg")
KW = dict(conditional_input_dim=2, amortization_mlp_dims="16")
S, NB = 16, 4          # B rows: S draws for each of NB conditional rows
B = S * NB
TOL = 1e-10
TOL_GRAD = 1e-8
COORDS = {"default": (False, False), "embedding": (True, False),
          "intrinsic": (False, True)}


def _str_keys(d):
    return {str(k): v for k, v in d.items()}


def _key(k):
    return k if k == "total" else int(k)


@pytest.fixture(scope="module")
def models():
    jp = jpdf(*DEFS, **KW)
    tp = tpdf(*DEFS, device="cpu", **KW)
    rng = np.random.default_rng(1)
    par = {k: np.asarray(v) + 0.05 * rng.normal(size=v.shape)
           for k, v in jp.init_params(seed=0, dtype=jnp.float64).items()}
    ci = np.repeat(rng.normal(size=(NB, 2)), S, axis=0)
    return jp, tp, par, params_from_jax(par), ci


@pytest.fixture(scope="module")
def jax_mappings(models):
    """JAX's sample_with_subdim_logprobs and the inverse mapping of its
    samples in each coordinate system, from one compiled call."""
    jp, _, par, _, ci = models

    @_jit
    def ref(p, c, key):
        out = {}
        for name, (emb, intr) in COORDS.items():
            x, z, lpd = jp.sample_with_subdim_logprobs(
                p, key, conditional_input=c, force_embedding_coordinates=emb,
                force_intrinsic_coordinates=intr)
            xb, ldb = jp.all_layer_inverse_subdims(
                p, x, c, force_embedding_coordinates=emb,
                force_intrinsic_coordinates=intr)
            out[name] = (x, z, _str_keys(lpd), xb, _str_keys(ldb))
        return out

    return jax.tree.map(np.asarray, ref(par, ci, jax.random.PRNGKey(3)))


@pytest.mark.parametrize("coords", sorted(COORDS))
def test_subdim_mappings_match_jax(models, jax_mappings, coords):
    _, tp, _, tpar, ci = models
    emb, intr = COORDS[coords]
    x, z, lpd, xb, ldb = jax_mappings[coords]
    tci = torch.as_tensor(ci)
    xt, lpt = tp._subdim_logprobs(tpar, torch.as_tensor(z), tci, emb, intr)
    assert np.abs(xt.numpy() - x).max() < TOL
    assert sorted(lpd) == sorted(str(k) for k in lpt)
    for k, v in lpd.items():
        assert np.abs(lpt[_key(k)].numpy() - v).max() < TOL
    xf, ldf = tp.all_layer_forward_subdims(
        tpar, torch.as_tensor(z), tci, force_embedding_coordinates=emb,
        force_intrinsic_coordinates=intr)
    torch.testing.assert_close(xf, xt, rtol=0, atol=0)
    xbt, ldbt = tp.all_layer_inverse_subdims(
        tpar, torch.as_tensor(x), tci, force_embedding_coordinates=emb,
        force_intrinsic_coordinates=intr)
    assert np.abs(xbt.numpy() - xb).max() < TOL
    for k, v in ldb.items():
        assert np.abs(ldbt[_key(k)].numpy() - v).max() < TOL
    # the totals are the whole mappings' log-dets
    lp_t = tp.log_prob(tpar, torch.as_tensor(x), tci,
                       force_embedding_coordinates=emb,
                       force_intrinsic_coordinates=intr)[0]
    assert (lp_t - lpt["total"]).abs().max() < TOL


def test_marginal_entropy_and_gradient_match_jax(models, jax_mappings):
    """On JAX's targets in embedding coordinates: S draws for each of NB
    conditional rows."""
    jp, tp, par, tpar, ci = models
    targets = jax_mappings["embedding"][0]

    @_jit
    def ref(p, t, ds):
        def f(pp):
            e = jp._marginal_entropy(pp, t, ds, 1, S, NB, True, False, 8)
            return e.sum(), e
        (_, e1), g = jax.value_and_grad(f, has_aux=True)(p)
        e2 = jp._marginal_entropy(p, t, ds, 2, S, NB, True, False, S)
        return e1, g, e2

    e1, g, e2 = jax.tree.map(np.asarray, ref(par, targets, ci))
    ds = torch.as_tensor(ci)
    leaves = {k: v.clone().requires_grad_() for k, v in tpar.items()}
    t = torch.as_tensor(targets)
    e1_t = tp._marginal_entropy(leaves, t, ds, 1, S, NB, True, False, 8)
    g_t = torch.autograd.grad(e1_t.sum(), list(leaves.values()))
    e2_t = tp._marginal_entropy(tpar, t, ds, 2, S, NB, True, False, S)
    assert np.abs(e1_t.detach().numpy() - e1).max() < TOL
    assert np.abs(e2_t.numpy() - e2).max() < TOL
    scale = max(np.abs(v).max() for v in g.values())
    for key, gt in zip(leaves, g_t):
        assert np.abs(gt.numpy() - g[key]).max() < TOL_GRAD * scale


def test_approximate_coverage_matches_jax(models):
    jp, tp, par, tpar, ci = models
    x = tp.sample(tpar, conditional_input=torch.as_tensor(ci),
                  generator=torch.Generator().manual_seed(8))[0].numpy()
    subs = (-1, 0, 1, 2)
    lp_j = _jit(lambda p, x, c: jp.log_prob(p, x, conditional_input=c))

    def compiled_log_prob(p, x, conditional_input=None, **kw):
        assert not any(kw.values())         # the defaults
        return lp_j(p, x, conditional_input)

    jp_c = jpdf(*DEFS, **KW)
    jp_c.log_prob = compiled_log_prob
    cov_j = jp_c.approximate_coverage(par, x, conditional_input=ci,
                                      sub_manifolds=subs,
                                      num_percentile_points=50)
    cov_t = tp.approximate_coverage(tpar, torch.as_tensor(x),
                                    conditional_input=torch.as_tensor(ci),
                                    sub_manifolds=subs,
                                    num_percentile_points=50)
    np.testing.assert_array_equal(cov_t["expected"], cov_j["expected"])
    for what in ("true", "logprob_diffs", "chi2_cdf_evals"):
        assert sorted(cov_t[what], key=str) == sorted(cov_j[what], key=str)
        for k, v in cov_j[what].items():
            assert np.abs(cov_t[what][k] - np.asarray(v)).max() < TOL


def test_entropy_twins_agree(models):
    """entropy, entropy_iterative (samples in chunks of 4, batch items in
    chunks of 2) and entropy_device on one generator state: the same
    draws and the same S x S sums, so the same values."""
    _, tp, _, tpar, ci = models
    tci = torch.as_tensor(ci[:3])
    subs = (-1, 0, 1, 2)

    def gen():
        return torch.Generator().manual_seed(11)

    ent = tp.entropy(tpar, gen(), sub_manifolds=subs, conditional_input=tci,
                     samplesize=16)
    it = tp.entropy_iterative(tpar, gen(), sub_manifolds=subs,
                              conditional_input=tci, samplesize=16,
                              iterative_samplesize=4,
                              max_iterative_batchsize=2)
    dev = tp.entropy_device(tpar, gen(), sub_manifolds=subs,
                            conditional_input=tci, samplesize=16)
    assert sorted(ent, key=str) == sorted(it, key=str) == \
        sorted((_key(k) for k in dev), key=str)
    for k, v in ent.items():
        assert v.shape == (3,) and torch.isfinite(v).all()
        torch.testing.assert_close(it[k], v, rtol=0, atol=1e-12)
        torch.testing.assert_close(dev[str(k)], v, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tp.entropy_iterative(tpar, gen(), conditional_input=tci,
                             samplesize=16, iterative_samplesize=5)


def test_entropy_gradient(models):
    """The joint and a marginal entropy are differentiable in the
    parameters (nothing detaches them): autograd against central
    differences of the same draws."""
    _, tp, _, tpar, ci = models
    tci = torch.as_tensor(ci[:2])

    def ent(pp):
        e = tp.entropy(pp, torch.Generator().manual_seed(12),
                       sub_manifolds=(-1, 1), conditional_input=tci,
                       samplesize=8)
        return (e["total"] + e[1]).sum()

    leaves = {k: v.clone().requires_grad_() for k, v in tpar.items()}
    grads = dict(zip(leaves, torch.autograd.grad(ent(leaves),
                                                 list(leaves.values()))))
    rng = np.random.default_rng(13)
    h = 1e-6
    for key in tpar:
        assert torch.isfinite(grads[key]).all() and grads[key].norm() > 0
        for i in rng.choice(tpar[key].numel(), 3, replace=False):
            plus = {k: v.clone() for k, v in tpar.items()}
            minus = {k: v.clone() for k, v in tpar.items()}
            plus[key].view(-1)[i] += h
            minus[key].view(-1)[i] -= h
            fd = (ent(plus) - ent(minus)).item() / (2 * h)
            assert abs(fd - grads[key].view(-1)[i].item()) < \
                1e-5 * max(1.0, abs(fd))


def test_failsafe_subdim_draws_pass_the_crosscheck(models):
    _, tp, _, tpar, ci = models
    tci = torch.as_tensor(ci)
    x, z, lpd = tp.sample_with_subdim_logprobs(
        tpar, torch.Generator().manual_seed(14), conditional_input=tci,
        failsafe_crosscheck_tolerance=1e-6, failsafe_rounds=2)
    lp = tp.log_prob(tpar, x, tci, force_embedding_coordinates=True)[0]
    assert (lp - lpd["total"]).abs().max() < 1e-6
    assert x.shape == (B, tp.total_target_dim_embedded)
    # the per-sub-manifold log-pdfs add up to the total
    torch.testing.assert_close(lpd[0] + lpd[1] + lpd[2], lpd["total"],
                               rtol=0, atol=1e-10)
    _, lpz = tp._subdim_logprobs(tpar, z, tci, True, False)
    for k, v in lpd.items():
        torch.testing.assert_close(lpz[k], v, rtol=0, atol=0)
