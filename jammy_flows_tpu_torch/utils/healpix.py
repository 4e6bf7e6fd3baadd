"""Healpy-free HEALPix (RING scheme) pixelization + map export: the
PyTorch port's copy of ``jammy_flows_tpu/utils/healpix.py``.

The S2 machinery uses exact equal-area cos(theta) x phi grids and the
adaptive multires scan (utils/grid.py); users of the reference consume
healpix maps downstream (main/default.py:2186-2240).  This module provides
that interop without healpy: standard RING-scheme ang2pix/pix2ang (Gorski
et al. 2005 geometry, vectorized numpy) and exporters that evaluate a PDF
on pixel centers or rebin a multiresolution scan into a healpix map.  The
resulting arrays are directly consumable by healpy (`hp.mollview(m)`).
"""
from __future__ import annotations

import numpy as np


def npix(nside):
    return 12 * nside * nside


def pix2ang_ring(nside, ipix=None):
    """RING-scheme pixel centers.  Returns (theta, phi) arrays.

    ipix defaults to all pixels 0..12*nside^2-1.
    """
    nside = int(nside)
    n_pix = npix(nside)
    if ipix is None:
        ipix = np.arange(n_pix, dtype=np.int64)
    p = np.asarray(ipix, dtype=np.int64)
    assert ((p >= 0) & (p < n_pix)).all(), "pixel index out of range"
    ncap = 2 * nside * (nside - 1)

    z = np.empty(p.shape, np.float64)
    phi = np.empty(p.shape, np.float64)

    # north polar cap: p = 2 i (i-1) + (j-1), 1 <= j <= 4i
    north = p < ncap
    if north.any():
        pn = p[north]
        ph_ = (pn + 1) / 2.0
        i = (np.sqrt(ph_ - np.sqrt(np.floor(ph_)))).astype(np.int64) + 1
        j = (pn + 1) - 2 * i * (i - 1)
        z[north] = 1.0 - i * i / (3.0 * nside * nside)
        phi[north] = (j - 0.5) * np.pi / (2.0 * i)

    # equatorial belt: rings i = nside .. 3*nside, 4*nside pixels each
    eq = (p >= ncap) & (p < n_pix - ncap)
    if eq.any():
        q = p[eq] - ncap
        i = q // (4 * nside) + nside
        j = q % (4 * nside) + 1
        fodd = 0.5 * (1 + ((i + nside) & 1))   # phase: 1/2 or 1
        z[eq] = 4.0 / 3.0 - 2.0 * i / (3.0 * nside)
        phi[eq] = (j - fodd) * np.pi / (2.0 * nside)

    # south polar cap (mirror of north, phi order reversed within the ring)
    south = p >= n_pix - ncap
    if south.any():
        ip = n_pix - p[south]
        ph_ = ip / 2.0
        i = (np.sqrt(ph_ - np.sqrt(np.floor(ph_)))).astype(np.int64) + 1
        j = 4 * i + 1 - (ip - 2 * i * (i - 1))
        z[south] = -1.0 + i * i / (3.0 * nside * nside)
        phi[south] = (j - 0.5) * np.pi / (2.0 * i)

    theta = np.arccos(np.clip(z, -1.0, 1.0))
    return theta, np.mod(phi, 2.0 * np.pi)


def ang2pix_ring(nside, theta, phi):
    """RING-scheme pixel index of (theta, phi) (vectorized)."""
    nside = int(nside)
    z = np.cos(np.asarray(theta, np.float64))
    phi = np.mod(np.asarray(phi, np.float64), 2.0 * np.pi)
    za = np.abs(z)
    tt = phi / (0.5 * np.pi)            # in [0, 4)
    n_pix = npix(nside)
    ncap = 2 * nside * (nside - 1)
    pix = np.empty(z.shape, np.int64)

    # equatorial region |z| <= 2/3
    eq = za <= 2.0 / 3.0
    if eq.any():
        t1 = nside * (0.5 + tt[eq])
        t2 = nside * 0.75 * z[eq]
        jp = np.floor(t1 - t2).astype(np.int64)   # ascending edge index
        jm = np.floor(t1 + t2).astype(np.int64)   # descending edge index
        ir = nside + 1 + jp - jm                  # ring counted from z=2/3
        kshift = 1 - (ir & 1)
        ip = ((jp + jm - nside + kshift + 1) // 2) % (4 * nside)
        pix[eq] = ncap + (ir - 1) * 4 * nside + ip

    # polar caps
    cap = ~eq
    if cap.any():
        ttc = tt[cap]
        tp = ttc - np.floor(ttc)
        tmp = nside * np.sqrt(3.0 * (1.0 - za[cap]))
        jp = np.floor(tp * tmp).astype(np.int64)
        jm = np.floor((1.0 - tp) * tmp).astype(np.int64)
        ir = jp + jm + 1                          # ring from the pole
        ip = np.floor(ttc * ir).astype(np.int64) % (4 * ir)
        north_pix = 2 * ir * (ir - 1) + ip
        south_pix = n_pix - 2 * ir * (ir + 1) + ip
        pix[cap] = np.where(z[cap] > 0, north_pix, south_pix)
    return pix


def pixel_area(nside):
    """Solid angle per pixel (equal-area by construction)."""
    return 4.0 * np.pi / npix(nside)


def export_healpix_map(pdf_obj, params, nside, conditional_input=None,
                       chunk=20000, log=False):
    """Evaluate an s2 PDF on all RING pixel centers (through the port's
    log_prob on the pdf's device, chunk by chunk).

    Returns a (12*nside^2,) numpy map of densities per steradian in RING
    ordering — directly consumable by healpy (hp.mollview, hp.write_map).
    The map integrates to ~1: sum(map) * pixel_area(nside).
    """
    from .grid import eval_log_prob

    theta, phi = pix2ang_ring(nside)
    pts = np.stack([theta, phi], axis=1)
    lp = eval_log_prob(pdf_obj, params, pts, conditional_input,
                       force_intrinsic=True, chunk=chunk)
    # intrinsic theta/phi density -> per-steradian density
    lp = lp - np.log(np.maximum(np.sin(theta), 1e-300))
    return lp if log else np.exp(lp)


def scan_to_healpix(pts, log_evals, areas, nside):
    """Rebin a multires_s2_scan result onto a RING healpix map.

    Each scan cell's probability mass is deposited into the pixel containing
    its center; the map is mass / pixel_area (density per steradian), so
    sum(map)*pixel_area preserves the scan's total integral exactly.
    """
    mass = np.exp(np.asarray(log_evals)) * np.asarray(areas)
    pix = ang2pix_ring(nside, np.asarray(pts)[:, 0], np.asarray(pts)[:, 1])
    m = np.zeros(npix(nside))
    np.add.at(m, pix, mass)
    return m / pixel_area(nside)
