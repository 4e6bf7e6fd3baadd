"""The vMF / zlp-Kent utilities against the JAX package's
``utils/vmf_kent.py``, in float64:

* the closed forms and samplers (the same numpy code): vMF coverage and
  sampler, the gamma rotation, the zlp-Kent log-pdf (one point or N points
  per item), sampler and Monte-Carlo coverage, coverage from log-pdfs;
* the batched maximum-likelihood fit (batched Adam as optax.adam defines
  it, then the masked damped Newton from torch.func) on shared samples of
  a conditional ``"s2", "f"`` (JAX's ``marginal_moments(
  calc_zlp_kent_fit=True, return_samples=True)`` fed the port's draws),
  through the port's moments reduction:
  kappa, u, the log-likelihood and gamma1 to 1e-8, gamma2 / gamma3 up to
  sign (the Kent density is even in them), the held-out cross-entropy;

and on the port alone: a stopped item keeps its parameters (a grad_tol
above every gradient gives the Adam-only fit), and the fit recovers a
known Kent distribution."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu.utils import vmf_kent as jv
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch.utils import vmf_kent as tv
from jammy_flows_tpu_torch.utils.convert import params_from_jax
from torch_one_thread import _one_torch_thread  # noqa: F401

TOL_FIT = 1e-8


def _kent_params(rng, n):
    g1 = rng.normal(size=(n, 3))
    g2 = rng.normal(size=(n, 3))
    return g1, g2, np.cross(g1, g2), rng.uniform(2.0, 30.0, n), \
        rng.uniform(0.6, 1.8, n)


def test_closed_forms_match_jax():
    rng = np.random.default_rng(0)
    n = 5
    g1, g2, g3, kappa, u = _kent_params(rng, n)
    pts = rng.normal(size=(n, 3))
    many = rng.normal(size=(n, 7, 3))
    np.testing.assert_array_equal(
        tv.vmf_coverage_s2_batch(pts, g1, np.append(kappa[:-1], 0.0)),
        jv.vmf_coverage_s2_batch(pts, g1, np.append(kappa[:-1], 0.0)))
    np.testing.assert_array_equal(
        tv.sample_vmf_s2(g1[0], 5.0, 100, np.random.default_rng(1)),
        jv.sample_vmf_s2(g1[0], 5.0, 100, np.random.default_rng(1)))
    np.testing.assert_array_equal(tv._rotation_from_gammas(g1, g2, g3),
                                  jv._rotation_from_gammas(g1, g2, g3))
    for x in (pts, many):
        np.testing.assert_array_equal(
            tv.zlpkent_logpdf_s2_batch(x, g1, g2, g3, kappa, u),
            jv.zlpkent_logpdf_s2_batch(x, g1, g2, g3, kappa, u))
    np.testing.assert_array_equal(
        tv.sample_zlpkent_s2_batch(g1, g2, g3, kappa, u, 50, seed=2),
        jv.sample_zlpkent_s2_batch(g1, g2, g3, kappa, u, 50, seed=2))
    ref, tgt, w = rng.normal(size=(n, 30)), rng.normal(size=n), \
        rng.uniform(size=(n, 30))
    for kw in ({}, {"weights": w}):
        np.testing.assert_array_equal(
            tv.coverage_from_logpdf_samples(ref, tgt, **kw),
            jv.coverage_from_logpdf_samples(ref, tgt, **kw))
    np.testing.assert_array_equal(
        tv.zlp_kent_coverage(pts, g1, g2, g3, kappa, u,
                             num_samples_per_bitem=200, seed=3),
        jv.zlp_kent_coverage(pts, g1, g2, g3, kappa, u,
                             num_samples_per_bitem=200, seed=3))


def _up_to_sign(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.minimum(np.abs(a - b).max(axis=-1),
                      np.abs(a + b).max(axis=-1)).max()


def test_kent_fit_in_moments_matches_jax():
    kw = dict(conditional_input_dim=2, amortization_mlp_dims="16")
    jp = jpdf("s2", "f", **kw)
    tp = tpdf("s2", "f", device="cpu", **kw)
    rng = np.random.default_rng(4)
    par = {k: np.asarray(v) + 0.3 * rng.normal(size=v.shape)
           for k, v in jp.init_params(seed=0, dtype=jnp.float64).items()}
    ci = rng.normal(size=(3, 2))
    S = 120
    # the samples: the port's draw in embedding coordinates, handed to the
    # JAX package's marginal_moments in place of its own sampler's
    x = tp.sample_with_subdim_logprobs(
        params_from_jax(par), torch.Generator().manual_seed(5),
        conditional_input=torch.as_tensor(ci).repeat_interleave(S, dim=0))[0]
    jp.sample_with_subdim_logprobs = lambda p, key, n, ds, **_: (
        jnp.asarray(x.numpy()), None, None)
    mj = jp.marginal_moments(par, jax.random.PRNGKey(5), conditional_input=ci,
                             samplesize=S, calc_zlp_kent_fit=True,
                             return_samples=True)
    mt = tp._moments_of_samples(mj["samples_0"].reshape(3 * S, 3), 3, S,
                                calc_zlp_kent_fit=True, return_samples=True)
    assert sorted(mt) == sorted(mj)
    fj, ft = mj["zlp_kent_pars_0"], mt["zlp_kent_pars_0"]
    assert sorted(fj) == sorted(ft)
    for key in ("kappa", "u", "loglike", "gamma1"):
        scale = max(1.0, np.abs(fj[key]).max())
        assert np.abs(ft[key] - np.asarray(fj[key])).max() < TOL_FIT * scale
    for key in ("gamma2", "gamma3"):
        assert _up_to_sign(ft[key], fj[key]) < TOL_FIT
    assert (ft["grad_norm"] < 1e-5).all()
    assert np.abs(mt["entropy_kent_crossent_0"]
                  - mj["entropy_kent_crossent_0"]).max() < TOL_FIT


def test_stopped_items_keep_their_parameters():
    """An item whose gradient norm is at most grad_tol leaves the Newton
    loop with its parameters: a grad_tol above every gradient gives the
    Adam-only fit, a zero one moves every item."""
    rng = np.random.default_rng(6)
    g1, g2, g3, kappa, u = _kent_params(rng, 4)
    x = torch.as_tensor(tv.sample_zlpkent_s2_batch(g1, g2, g3, kappa, u, 150,
                                                   seed=7))
    adam = tv.fit_zlpkent_batch_quat(x, num_steps=20)
    frozen = tv.fit_zlpkent_batch_quat(x, num_steps=20, newton_steps=6,
                                       grad_tol=1e9)
    for key, v in adam.items():
        np.testing.assert_array_equal(frozen[key], v)
    newton = tv.fit_zlpkent_batch_quat(x, num_steps=20, newton_steps=6,
                                       grad_tol=0.0)
    assert (newton["loglike"] > adam["loglike"]).all()
    assert (newton["grad_norm"] < adam["grad_norm"]).all()


def test_kent_fit_recovers_a_known_distribution():
    rng = np.random.default_rng(8)
    g1, g2, g3, _, _ = _kent_params(rng, 2)
    kappa, u = np.array([8.0, 20.0]), np.array([0.8, 1.3])
    x = tv.sample_zlpkent_s2_batch(g1, g2, g3, kappa, u, 4000, seed=9)
    fit = tv.fit_zlpkent_batch_quat(x, num_steps=150, newton_steps=8,
                                    grad_tol=1e-9)
    np.testing.assert_allclose(fit["kappa"], kappa, rtol=0.1)
    # u and 1/u with gamma2 and gamma3 swapped are the same distribution
    assert (np.minimum(np.abs(fit["u"] - u), np.abs(1.0 / fit["u"] - u))
            < 0.1 * u).all()
    g1n = g1 / np.linalg.norm(g1, axis=1, keepdims=True)
    assert (np.sum(fit["gamma1"] * g1n, axis=1) > 0.99).all()
    assert (fit["grad_norm"] < 1e-6).all()
