"""The diagnostics' scans and moments against the JAX package, in float64:

* the s2 lattice scan ``coverage_and_or_pdf_scan`` (deterministic: the
  whole returned dict, labels' coverage and log-pdfs included) and
  ``coverage_scan_device`` on a conditional ``"s2", "f"``;
* the moments reduction on the samples of JAX's
  ``marginal_moments(return_samples=True)`` on a conditional
  ``"e2+s1+s2", "gg+m+f"``: every returned key (and, on the port, the
  keys that given exact entropies add);
* Banerjee's kappa and the vMF entropy, host (numpy) and device (torch)
  forms, for p = 2 and 3;

and on the port alone: the Euclidean and s2 device scans against the
host scans on one generator state; ``marginal_moments_device`` against
``marginal_moments``; the s2 entropy scan against Monte Carlo (JAX's own
test, tests/test_diagnostics.py:248-266).  The JAX package's host-driven
methods run on its compiled log_prob / sampler."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu.models import diagnostics as jdiag
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch.models import diagnostics as tdiag
from jammy_flows_tpu_torch.utils.convert import params_from_jax
from test_torch_cnf import _jit
from torch_one_thread import _one_torch_thread  # noqa: F401

KW = dict(conditional_input_dim=2, amortization_mlp_dims="16")
TOL = 1e-10


def _pair(defs, flows, seed=0, scale=0.05):
    jp = jpdf(defs, flows, **KW)
    tp = tpdf(defs, flows, device="cpu", **KW)
    rng = np.random.default_rng(seed)
    par = {k: np.asarray(v) + scale * rng.normal(size=v.shape)
           for k, v in jp.init_params(seed=0, dtype=jnp.float64).items()}
    return jp, tp, par, params_from_jax(par)


def _compiled_log_prob(jp):
    """jp.log_prob compiled once per keyword set (the host-driven JAX
    methods call it eagerly)."""
    orig, cache = jp.log_prob, {}

    def log_prob(params, x, conditional_input=None, **kw):
        key = tuple(sorted(kw.items()))
        if key not in cache:
            cache[key] = _jit(lambda p, x, c: orig(
                p, x, conditional_input=c, **dict(key)))
        return cache[key](params, x, conditional_input)
    jp.log_prob = log_prob


def _same(a, b, tol=TOL):
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y, tol)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() < tol


def test_s2_scans_match_jax():
    jp, tp, par, tpar = _pair("s2", "f")
    _compiled_log_prob(jp)
    rng = np.random.default_rng(2)
    nb = 4
    ci = rng.normal(size=(nb, 2))
    labels = np.stack([rng.uniform(0.3, 2.8, nb), rng.uniform(0.1, 6.2, nb)],
                      axis=1)
    kw = dict(exact_coverage_calculation=True, save_pdf_scan=True,
              calculate_MAP=True, samples_per_event=512)
    rj = jp.coverage_and_or_pdf_scan(par, labels=labels, conditional_input=ci,
                                     **kw)
    rt = tp.coverage_and_or_pdf_scan(tpar, labels=torch.as_tensor(labels),
                                     conditional_input=torch.as_tensor(ci),
                                     **kw)
    assert sorted(rj) == sorted(rt)
    for key, v in rj.items():
        _same(rt[key], v)
    jp_dev = jpdf("s2", "f", **KW)          # its own log_prob, traced
    dj = _jit(lambda p, lab, c: jp_dev.coverage_scan_device(
        p, lab, conditional_input=c, samples_per_event=512,
        return_scan=True))(par, labels, ci)
    dt = tp.coverage_scan_device(tpar, torch.as_tensor(labels),
                                 conditional_input=torch.as_tensor(ci),
                                 samples_per_event=512, return_scan=True)
    assert sorted(dj) == sorted(dt)
    for key, v in dj.items():
        _same(dt[key].numpy(), v)
    # the device scan's coverage and MAP are the host scan's
    _same(dt["real_cov_values"].numpy(), rt["real_cov_values"])
    _same(dt["map_positions"].numpy(), rt["map_positions"])


@pytest.mark.parametrize("defs", [("e2", "gg"), ("s2", "f")], ids=str)
def test_device_scan_matches_host_scan(defs):
    """One generator state: the same draws, grids (Euclidean: per-event
    percentile bounds, torch.quantile against numpy) and HPD sums."""
    tp = tpdf(*defs, device="cpu", **KW)
    g = torch.Generator().manual_seed(3)
    tpar = {k: v + 0.05 * torch.randn(v.shape, generator=g, dtype=v.dtype)
            for k, v in tp.init_params(seed=0, dtype=torch.float64).items()}
    ci = torch.randn((6, 2), generator=g, dtype=torch.float64)
    labels = tp.sample(tpar, conditional_input=ci, generator=g)[0]
    host = tp.coverage_and_or_pdf_scan(
        tpar, labels=labels, conditional_input=ci,
        exact_coverage_calculation=True, calculate_MAP=True,
        save_pdf_scan=True, samples_per_event=1024,
        generator=torch.Generator().manual_seed(4))
    dev = tp.coverage_scan_device(
        tpar, labels, conditional_input=ci, samples_per_event=1024,
        generator=torch.Generator().manual_seed(4), return_scan=True)
    np.testing.assert_allclose(dev["real_cov_values"].numpy(),
                               host["real_cov_values"], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(dev["map_positions"].numpy(),
                                  host["map_positions"])
    for b in range(6):
        np.testing.assert_allclose(dev["scan_log_evals"][b].numpy(),
                                   host["pdf_scan_log_evals"][b], rtol=0,
                                   atol=1e-12)
    assert ((host["real_cov_values"] >= 0)
            & (host["real_cov_values"] <= 1 + 1e-6)).all()
    # with no generator both seed their own with 0
    a = tp.coverage_scan_device(tpar, labels, conditional_input=ci,
                                samples_per_event=256)
    b = tp.coverage_and_or_pdf_scan(tpar, labels=labels, conditional_input=ci,
                                    exact_coverage_calculation=True,
                                    samples_per_event=256)
    np.testing.assert_allclose(a["real_cov_values"].numpy(),
                               b["real_cov_values"], rtol=0, atol=1e-12)


def test_moments_reduction_matches_jax():
    jp, tp, par, tpar = _pair("e2+s1+s2", "gg+m+f", seed=5)
    n_items, S = 3, 40
    ci = np.random.default_rng(6).normal(size=(n_items, 2))
    orig = jp.sample_with_subdim_logprobs
    draw = _jit(lambda p, key, n, ds: (lambda x, z, lpd: (
        x, z, {str(k): v for k, v in lpd.items()}))(*orig(
            p, key, n, ds, force_embedding_coordinates=True)),
        static_argnums=2)

    def sample_with_subdim_logprobs(params, key, samplesize, ds, **kw):
        assert kw.get("force_embedding_coordinates", True) and \
            kw.get("failsafe_crosscheck_tolerance") is None
        x, z, lpd = draw(params, key, samplesize, ds)
        return x, z, {k if k == "total" else int(k): v
                      for k, v in lpd.items()}
    jp.sample_with_subdim_logprobs = sample_with_subdim_logprobs
    mj = jp.marginal_moments(par, jax.random.PRNGKey(7), conditional_input=ci,
                             samplesize=S, return_samples=True)
    targets = np.concatenate([mj[f"samples_{k}"] for k in range(3)],
                             axis=-1).reshape(n_items * S, -1)
    mt = tp._moments_of_samples(targets, n_items, S, return_samples=True)
    assert sorted(mt) == sorted(mj)
    for key, v in mj.items():
        _same(mt[key], v)
    # given exact entropies, the reduction adds them and the KL differences
    entropy = {k: np.full(n_items, 1.5 + i) for i, k in
               enumerate(("total", 0, 1, 2))}
    mk = tp._moments_of_samples(targets, n_items, S, entropy_dict=entropy)
    for k, v in entropy.items():
        np.testing.assert_array_equal(mk[f"entropy_{k}"], v)
    np.testing.assert_array_equal(mk["kl_diff_exact_approximate_0"],
                                  mt["entropy_gauss_approx_0"] - entropy[0])
    np.testing.assert_array_equal(mk["kl_diff_exact_approximate_2"],
                                  mt["entropy_vmf_approx_2"] - entropy[2])
    assert "kl_diff_exact_approximate_1" not in mk     # s1: none


@pytest.mark.parametrize("p", [2, 3])
def test_banerjee_kappa_and_vmf_entropy_match_jax(p):
    rbar = np.concatenate([np.linspace(0.01, 0.99, 25), [0.999, 1e-12]])
    for kw in ({}, {"abs_precision": 1e-9}):
        _same(tdiag._banerjee_kappa(rbar, p=p, **kw),
              jdiag._banerjee_kappa(rbar, p=p, **kw), 1e-12)
    k_j = np.asarray(_jit(lambda r: jdiag._banerjee_kappa_jnp(r, p=p))(rbar))
    k_t = tdiag._banerjee_kappa_torch(torch.as_tensor(rbar), p=p).numpy()
    assert np.abs(k_t - k_j).max() < 1e-10 * np.abs(k_j).max()
    if p == 3:
        kappa = np.concatenate([np.logspace(-3, 2, 30), [19.9, 20.1]])
        _same(tdiag._vmf_entropy(kappa), jdiag._vmf_entropy(kappa), 1e-12)
        e_j = np.asarray(_jit(jdiag._vmf_entropy_jnp)(kappa))
        _same(tdiag._vmf_entropy_torch(torch.as_tensor(kappa)).numpy(), e_j,
              1e-10)


def test_moments_device_matches_host():
    tp = tpdf("e2+s1+s2", "gg+m+f", device="cpu", **KW)
    g = torch.Generator().manual_seed(9)
    tpar = {k: v + 0.05 * torch.randn(v.shape, generator=g, dtype=v.dtype)
            for k, v in tp.init_params(seed=0, dtype=torch.float64).items()}
    ci = torch.randn((4, 2), generator=g, dtype=torch.float64)
    host = tp.marginal_moments(tpar, torch.Generator().manual_seed(10),
                               conditional_input=ci, samplesize=64)
    dev = tp.marginal_moments_device(tpar, torch.Generator().manual_seed(10),
                                     conditional_input=ci, samplesize=64)
    assert set(dev) <= set(host)
    for key, v in dev.items():
        # the host's kappa stops at mises_abs_precision, the device's after
        # 8 Newton steps
        tol = 1e-6 if key.startswith(("varlike_1", "varlike_2",
                                      "entropy_vmf")) else 1e-12
        assert np.abs(v.numpy() - host[key]).max() <= \
            tol * max(1.0, np.abs(host[key]).max())


def test_s2_entropy_scanning_matches_mc():
    tp = tpdf("s2", "f", device="cpu")
    params = tp.init_params(seed=0, dtype=torch.float64)
    rot_n = tp.layer_list[0][0].num_rotation_params
    params["flow_0"][rot_n] = math.log(5.0)
    scan = tp.marginal_moments(params, torch.Generator().manual_seed(3),
                               samplesize=200,
                               calc_kl_diff_and_entropic_quantities=True,
                               s2_entropy_scanning=True)
    mc = tp.marginal_moments(params, torch.Generator().manual_seed(3),
                             samplesize=4000,
                             calc_kl_diff_and_entropic_quantities=True)
    assert abs(float(scan["entropy_0"][0]) - float(mc["entropy_0"][0])) < 0.05
    assert np.isfinite(scan["kl_diff_exact_approximate_0"]).all()
    with pytest.raises(ValueError):
        tpdf("e2", "gg", device="cpu")._s2_scan_entropy({}, None, 1)
