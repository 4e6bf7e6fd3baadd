"""The grid, contour and healpix helpers against the JAX package's
``utils/{grid,contours,healpix}.py``, in float64:

* the numpy geometry (percentile bounds, meshgrids, the Mollweide and
  Lambert projections and rotations, gridlines), the contour levels and
  lines, and the RING-scheme healpix pixelization: equal arrays;
* the functions that evaluate a pdf through the port's log_prob in chunks:
  ``pdf_on_grid`` on a conditional ``"e2", "gg"``, ``multires_s2_scan``
  (every round's cells, log-densities and areas) and
  ``export_healpix_map`` / ``scan_to_healpix`` on a conditional
  ``"s2", "f"``, against the JAX functions on the JAX package's compiled
  log_prob."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu.utils import contours as jc, grid as jg, healpix as jh
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch.utils import contours as tc, grid as tg, \
    healpix as th
from jammy_flows_tpu_torch.utils.convert import params_from_jax
from test_torch_diagnostics_scans import _compiled_log_prob
from torch_one_thread import _one_torch_thread  # noqa: F401

KW = dict(conditional_input_dim=2, amortization_mlp_dims="16")
TOL = 1e-10


def _eq(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_grid_geometry_matches_jax():
    rng = np.random.default_rng(0)
    s = rng.normal(size=(500, 3))
    _eq(tg.percentile_bounds(s), jg.percentile_bounds(s))
    _eq(tg.percentile_bounds(s, (2.0, 98.0), 0.3),
        jg.percentile_bounds(s, (2.0, 98.0), 0.3))
    b = jg.percentile_bounds(s)
    _eq(tg.make_grid(b, 7), jg.make_grid(b, 7))
    theta = np.concatenate([rng.uniform(0, np.pi, 50), [0.0, np.pi]])
    phi = rng.uniform(0, 2 * np.pi, 52)
    _eq(tg.mollweide_xy(theta, phi), jg.mollweide_xy(theta, phi))
    _eq(tg.mollweide_xy(theta, phi, center_phi=1.0),
        jg.mollweide_xy(theta, phi, center_phi=1.0))
    for target in ([0.7, 2.0], [0.0, 1.0]):
        for rev in (False, True):
            _eq(tg.rotate_coords_to(theta, phi, target, reverse=rev),
                jg.rotate_coords_to(theta, phi, target, reverse=rev))
    sph = np.stack([theta, phi], axis=1)
    for fix in (None, np.array([1.1, 4.0])):
        xl = jg.spherical_to_cartesian_lambert(sph, fix_point=fix)
        _eq(tg.spherical_to_cartesian_lambert(sph, fix_point=fix), xl)
        _eq(tg.cartesian_lambert_to_spherical(xl, fix_point=fix),
            jg.cartesian_lambert_to_spherical(xl, fix_point=fix))
    _eq(tg.get_basic_gridlines(), jg.get_basic_gridlines())
    _eq(tg.get_basic_gridlines(3, 4, 20), jg.get_basic_gridlines(3, 4, 20))
    _eq(tg.lambert_azimuthal_equal_area(theta, phi, (0.4, 1.0)),
        jg.lambert_azimuthal_equal_area(theta, phi, (0.4, 1.0)))


def test_contours_match_jax():
    pytest.importorskip("contourpy")
    xs = np.linspace(-3, 3, 60)
    xx, yy = np.meshgrid(xs, xs)
    lp = -0.5 * (xx**2 + 2 * yy**2 + xx * yy) - np.log(2 * np.pi)
    area = (xs[1] - xs[0])**2
    for areas in (area, np.full(lp.size, area)):
        _eq(tc.find_contour_levels(lp.ravel(), areas),
            jc.find_contour_levels(lp.ravel(), areas))
    _eq(tc.find_1d_contours(xs, -0.5 * xs**2, (0.5, 0.9)),
        jc.find_1d_contours(xs, -0.5 * xs**2, (0.5, 0.9)))
    for wrap in (False, True):
        lines_t, lev_t = tc.compute_contours(xx, yy, lp, area,
                                             wrap_phi=wrap)
        lines_j, lev_j = jc.compute_contours(xx, yy, lp, area,
                                             wrap_phi=wrap)
        _eq(lev_t, lev_j)
        _eq(lines_t, lines_j)


@pytest.mark.parametrize("nside", [1, 4, 16])
def test_healpix_matches_jax(nside):
    assert th.npix(nside) == jh.npix(nside)
    assert th.pixel_area(nside) == jh.pixel_area(nside)
    _eq(th.pix2ang_ring(nside), jh.pix2ang_ring(nside))
    rng = np.random.default_rng(nside)
    t = np.arccos(rng.uniform(-1, 1, 300))
    p = rng.uniform(0, 2 * np.pi, 300)
    _eq(th.ang2pix_ring(nside, t, p), jh.ang2pix_ring(nside, t, p))
    ipix = rng.integers(0, th.npix(nside), 20)
    _eq(th.pix2ang_ring(nside, ipix), jh.pix2ang_ring(nside, ipix))
    pts = np.stack([t, p], axis=1)
    lp, areas = rng.normal(size=300), rng.uniform(0.01, 0.02, 300)
    _eq(th.scan_to_healpix(pts, lp, areas, nside),
        jh.scan_to_healpix(pts, lp, areas, nside))


def _pair(defs, flows):
    jp = jpdf(defs, flows, **KW)
    tp = tpdf(defs, flows, device="cpu", **KW)
    rng = np.random.default_rng(3)
    par = {k: np.asarray(v) + 0.05 * rng.normal(size=v.shape)
           for k, v in jp.init_params(seed=0, dtype=jnp.float64).items()}
    _compiled_log_prob(jp)
    return jp, tp, par, params_from_jax(par), rng.normal(size=(1, 2))


def test_pdf_on_grid_matches_jax():
    jp, tp, par, tpar, ci = _pair("e2", "gg")
    bounds = np.array([[-2.0, 2.5], [-3.0, 1.0]])
    # two chunks of the grid, one conditional row broadcast to each
    got = tg.pdf_on_grid(tp, tpar, bounds, 30, conditional_input=ci,
                         chunk_size=500)
    want = jg.pdf_on_grid(jp, par, bounds, 30, conditional_input=ci,
                          chunk_size=500)
    _eq(got[0], want[0])
    assert np.abs(got[1] - want[1]).max() < TOL
    assert got[2] == want[2]


def test_s2_scan_and_healpix_export_match_jax():
    jp, tp, par, tpar, ci = _pair("s2", "f")
    got = tg.multires_s2_scan(tp, tpar, conditional_input=ci, n_base=256,
                              rounds=2, chunk=300, return_cells=True)
    want = jg.multires_s2_scan(jp, par, conditional_input=ci, n_base=256,
                               rounds=2, chunk=300, return_cells=True)
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.abs(a - b).max() < TOL
    assert abs((np.exp(got[1]) * got[2]).sum() - 1.0) < 0.05
    for log in (False, True):
        m_t = th.export_healpix_map(tp, tpar, 4, conditional_input=ci,
                                    chunk=100, log=log)
        m_j = jh.export_healpix_map(jp, par, 4, conditional_input=ci,
                                    chunk=100, log=log)
        assert np.abs(m_t - m_j).max() < TOL * max(1.0, np.abs(m_j).max())
    m = th.scan_to_healpix(*got[:3], 8)
    assert abs(m.sum() * th.pixel_area(8) - (np.exp(got[1]) * got[2]).sum()) \
        < 1e-12
    # the evaluation dtype follows the parameters
    par32 = {k: v.float() for k, v in tpar.items()}
    assert tg.eval_dtype(par32) == torch.float32
    assert tg.eval_dtype(par32, torch.zeros(1, dtype=torch.float64)) == \
        torch.float64
    assert tg.eval_dtype({}) == torch.float32
    lp32 = tg.eval_log_prob(tp, par32, got[0][:10], ci,
                            force_intrinsic=True)
    assert lp32.dtype == np.float32
