"""The plotting helpers on the port's pdf (matplotlib's Agg backend),
against the JAX package's ``utils/plotting.py`` where a plot is
deterministic: the Lambert-disk, Mollweide and zoomed S2 integrals and the
2-d density's HPD levels, on the same float64 parameters (the JAX side on
its compiled log_prob); the sampled views (the 2-d density panel's grid
integral, corner grids, the Lambert-transformed and multiplot views) on
the port alone, from a torch.Generator."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu.utils import plotting as jplot
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch.utils import plotting as tplot
from jammy_flows_tpu_torch.utils.convert import params_from_jax
from test_torch_diagnostics_scans import _compiled_log_prob
from torch_one_thread import _one_torch_thread  # noqa: F401

plt = pytest.importorskip("matplotlib.pyplot")


def _pair(defs, flows, seed=1):
    jp = jpdf(defs, flows)
    tp = tpdf(defs, flows, device="cpu")
    par = {k: np.asarray(v) for k, v in
           jp.init_params(seed=seed, dtype=jnp.float64).items()}
    _compiled_log_prob(jp)
    return jp, tp, par, params_from_jax(par)


def _both(fn_name, jp, tp, par, tpar, **kw):
    out = []
    for mod, p, pp in ((jplot, jp, par), (tplot, tp, tpar)):
        fig, ax = plt.subplots()
        out.append(getattr(mod, fn_name)(ax, p, pp, **kw))
        plt.close(fig)
    return out


def test_sphere_integrals_match_jax(tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    jp, tp, par, tpar = _pair("s2", "f")
    tv = np.array([0.8, 2.0])
    j, t = _both("plot_sphere_lambert", jp, tp, par, tpar, npts=40,
                 true_values=tv, rotate_to_true_value=True)
    assert abs(t - 1.0) < 0.05 and abs(t - j) < 1e-10
    j, t = _both("plot_sphere_mollweide", jp, tp, par, tpar, n_base=512,
                 rounds=2, true_values=tv[None, :])
    assert abs(t - 1.0) < 0.05 and abs(t - j) < 1e-10
    j, t = _both("plot_sphere_zoom", jp, tp, par, tpar,
                 center=np.array([1.2, 3.0]), zoom_radius_deg=60.0, npts=50)
    assert 0.0 < t <= 1.0 + 1e-6 and abs(t - j) < 1e-10
    j, t = _both("plot_sphere_2d", jp, tp, par, tpar, n_theta=40, n_phi=80)
    np.testing.assert_allclose(t, j, rtol=1e-10)
    fig, ax = plt.subplots()
    tplot.plot_sphere_lambert(ax, tp, tpar, npts=30)
    fig.savefig(tmp_path / "lambert.png")
    plt.close(fig)
    assert (tmp_path / "lambert.png").stat().st_size > 0


def test_density_2d_matches_jax():
    jp, tp, par, tpar = _pair("e2", "gg", seed=6)
    bounds = np.array([[-3.0, 3.0], [-3.0, 3.0]])
    j, t = _both("plot_density_2d", jp, tp, par, tpar, bounds=bounds,
                 npts=50)
    np.testing.assert_allclose(t, j, rtol=1e-10)


def test_sampled_views(tmp_path):
    """The 2-d density panel integrates to ~1 on its grid; corner grids
    (with a Lambert-transformed s2 block, contours only), a pure-s2
    Mollweide view and a conditional multiplot render."""
    p = tpdf("e2", "gg", device="cpu")
    params = p.init_params(seed=6, dtype=torch.float64)
    fig = tplot.visualize_pdf(p, params, torch.Generator().manual_seed(0),
                              samplesize=3000, npts=60,
                              true_values=np.array([0.0, 0.0]))
    assert abs(fig._jammy_total_pdf_integral - 1.0) < 0.05
    assert fig._jammy_samples.shape == (3000, 2)
    plt.close(fig)

    p = tpdf("e2+s2", "gg+f", device="cpu")
    params = p.init_params(seed=4, dtype=torch.float64)
    tv = np.array([0.0, 0.0, 1.2, 3.0])
    fig = tplot.visualize_pdf(p, params, torch.Generator().manual_seed(1),
                              samplesize=2000, true_values=tv,
                              var_names=["x", "y", "theta", "phi"],
                              show_relative_std=1)
    assert len(fig.get_axes()) >= 10
    fig.savefig(tmp_path / "corner.png")
    plt.close(fig)
    fig = tplot.visualize_pdf(p, params, samplesize=2000, s2_norm="lambert",
                              plot_only_contours=True, true_values=tv)
    plt.close(fig)

    p = tpdf("s2", "f", device="cpu")
    fig = tplot.visualize_pdf(p, p.init_params(seed=3, dtype=torch.float64),
                              samplesize=500, s2_norm="mollweide")
    assert abs(fig._jammy_total_pdf_integral - 1.0) < 0.05
    plt.close(fig)

    p = tpdf("e1+s2", "g+f", conditional_input_dim=2, device="cpu")
    ci = torch.as_tensor(np.random.default_rng(0).normal(size=(2, 2)))
    fig = tplot.visualize_pdf(p, p.init_params(seed=5, dtype=torch.float64),
                              conditional_input=ci, samplesize=800,
                              multiplot=True,
                              true_values=np.array([[0.0, 1.0, 3.0],
                                                    [0.5, 2.0, 1.0]]),
                              var_names=["x", "theta", "phi"])
    assert len(fig.get_axes()) >= 12
    assert fig._jammy_samples.shape == (1600, 3)
    plt.close(fig)
    with pytest.raises(ValueError):
        tplot.plot_joint_pdf(p, None, np.zeros((5, 2)))
    assert math.isfinite(tplot.show_sample_contours(
        plt.subplots()[1], np.random.default_rng(1).normal(size=(2000, 2)))
        [0][0])
    plt.close("all")
