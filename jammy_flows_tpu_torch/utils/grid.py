"""Grid evaluation helpers: percentile bounds, meshgrids and chunked pdf
evaluation on them, the adaptive multiresolution S2 scan, and the
Mollweide / Lambert projections of the spherical plots.

PyTorch counterpart of ``jammy_flows_tpu/utils/grid.py``: the geometry is
the same numpy code; a pdf is evaluated through the port's ``log_prob`` on
the pdf's device, in chunks, each chunk's log-densities moved to the host
once.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def eval_dtype(params, conditional_input=None):
    """The dtype a grid is evaluated in: the conditional input's (its first
    tensor's, for a list), else the parameters', else float32."""
    ci = conditional_input[0] if isinstance(conditional_input, (list, tuple)) \
        else conditional_input
    if isinstance(ci, torch.Tensor):
        return ci.dtype
    return next((v.dtype for v in params.values()), torch.float32)


def eval_log_prob(pdf_obj, params, positions, conditional_input=None,
                  force_intrinsic=False, chunk=20000):
    """log_prob of the host positions (N, D) in chunks of ``chunk`` rows on
    the pdf's device, one (1, c) conditional input row broadcast to each
    chunk (a list: one row per tensor); returns a numpy (N,) array."""
    dtype = eval_dtype(params, conditional_input)
    dev = pdf_obj.device
    if conditional_input is not None:
        conditional_input = [torch.as_tensor(c, dtype=dtype, device=dev)
                             for c in conditional_input] \
            if isinstance(conditional_input, (list, tuple)) else \
            torch.as_tensor(conditional_input, dtype=dtype, device=dev)
    outs = []
    for s in range(0, positions.shape[0], chunk):
        block = torch.as_tensor(np.asarray(positions[s:s + chunk]),
                                dtype=dtype, device=dev)
        ci = None
        if conditional_input is not None:
            rows = (block.shape[0],)
            ci = [c.expand(rows + c.shape[1:]) for c in conditional_input] \
                if isinstance(conditional_input, list) else \
                conditional_input.expand(rows + conditional_input.shape[1:])
        with torch.no_grad():
            lp = pdf_obj.log_prob(params, block, conditional_input=ci,
                                  force_intrinsic_coordinates=force_intrinsic)[0]
        outs.append(lp.cpu().numpy())
    return np.concatenate(outs)


def percentile_bounds(samples, percentiles=(0.5, 99.5), margin_factor=0.1):
    """Per-dimension [low, high] bounds from sample percentiles
    (grid_functions.py:6-104)."""
    lows = np.percentile(samples, percentiles[0], axis=0)
    highs = np.percentile(samples, percentiles[1], axis=0)
    margin = (highs - lows) * margin_factor
    return np.stack([lows - margin, highs + margin], axis=1)


def make_grid(bounds, npts_per_dim):
    """Flattened meshgrid positions (N, D) + uniform bin volume."""
    axes = [np.linspace(lo, hi, npts_per_dim) for lo, hi in bounds]
    mesh = np.meshgrid(*axes, indexing="ij")
    positions = np.stack([m.ravel() for m in mesh], axis=1)
    widths = [(hi - lo) / (npts_per_dim - 1) for lo, hi in bounds]
    return positions, float(np.prod(widths))


def pdf_on_grid(pdf_obj, params, bounds, npts_per_dim, conditional_input=None,
                chunk_size=20000):
    """Evaluate the PDF on a regular grid (grid_functions.py:106-283).

    Returns (positions (N, D) numpy, log_evals (N,) numpy, bin_volume float).
    """
    positions, bin_volume = make_grid(bounds, npts_per_dim)
    log_evals = eval_log_prob(pdf_obj, params, positions, conditional_input,
                              chunk=chunk_size)
    return positions, log_evals, bin_volume


def multires_s2_scan(pdf_obj, params, conditional_input=None, n_base=1024,
                     rounds=3, refine_frac=0.25, chunk=20000,
                     return_cells=False):
    """Adaptive multiresolution scan of an s2 PDF (healpy-free equivalent of
    plotting/spherical.py:480 get_multiresolution_evals).

    Starts from an equal-area (cos-theta x phi) grid and repeatedly
    subdivides the highest-probability-mass cells into 4.  Returns
    (positions (N,2 theta/phi), log_evals (N,), areas (N,)) covering the
    sphere exactly (sum(exp(log_evals) * areas) ~ 1 for a normalized PDF).
    With ``return_cells=True`` also returns the cell bounds (N, 4) as
    (z_lo, z_hi, phi_lo, phi_hi) for polygon rendering
    (utils/plotting.py:plot_sphere_mollweide).
    """
    n_t = max(2, int(np.sqrt(n_base / 2)))
    n_p = 2 * n_t
    z_edges = np.linspace(-1.0, 1.0, n_t + 1)
    p_edges = np.linspace(0.0, 2 * np.pi, n_p + 1)
    cells = []
    for i in range(n_t):
        for j in range(n_p):
            cells.append((z_edges[i], z_edges[i + 1], p_edges[j], p_edges[j + 1]))
    cells = np.asarray(cells)      # (N, 4): z_lo, z_hi, phi_lo, phi_hi

    def eval_cells(cells_arr):
        zc = 0.5 * (cells_arr[:, 0] + cells_arr[:, 1])
        pc = 0.5 * (cells_arr[:, 2] + cells_arr[:, 3])
        theta = np.arccos(np.clip(zc, -1, 1))
        pts = np.stack([theta, pc], axis=1)
        lp = eval_log_prob(pdf_obj, params, pts, conditional_input,
                           force_intrinsic=True, chunk=chunk)
        areas = (cells_arr[:, 1] - cells_arr[:, 0]) * \
            (cells_arr[:, 3] - cells_arr[:, 2])
        return pts, lp, areas

    pts, lp, areas = eval_cells(cells)
    for _ in range(rounds):
        mass = np.exp(lp) * areas
        k = max(1, int(refine_frac * len(cells)))
        refine_idx = np.argsort(mass)[::-1][:k]
        keep_mask = np.ones(len(cells), bool)
        keep_mask[refine_idx] = False
        kept = cells[keep_mask]
        sub = []
        for (zl, zh, pl, ph) in cells[refine_idx]:
            zm, pm = 0.5 * (zl + zh), 0.5 * (pl + ph)
            sub += [(zl, zm, pl, pm), (zl, zm, pm, ph),
                    (zm, zh, pl, pm), (zm, zh, pm, ph)]
        cells = np.concatenate([kept, np.asarray(sub)])
        pts, lp, areas = eval_cells(cells)
    # convert cell areas from (dz * dphi) to solid angle: dz dphi IS the
    # solid angle element on the sphere, and the intrinsic theta/phi density
    # carries the sin(theta) factor -> density per dz dphi = pdf / sin(theta)
    sin_t = np.maximum(np.sin(pts[:, 0]), 1e-12)
    if return_cells:
        return pts, lp - np.log(sin_t), areas, cells
    return pts, lp - np.log(sin_t), areas


def mollweide_xy(theta, phi, center_phi=np.pi, newton_iters=8):
    """Equal-area Mollweide projection (healpy-Mollweide-equivalent view,
    plotting/spherical.py:452-550 territory).

    theta/phi in radians -> (x, y) with x in [-2*sqrt(2), 2*sqrt(2)],
    y in [-sqrt(2), sqrt(2)].  ``center_phi`` maps to x=0; the seam sits at
    center_phi +- pi.  The auxiliary angle solves 2a + sin(2a) = pi sin(lat)
    by Newton (quadratic; 8 iters reach f64 machine precision).
    """
    theta = np.asarray(theta, dtype=np.float64)
    lat = 0.5 * np.pi - theta
    lon = np.mod(np.asarray(phi, dtype=np.float64) - center_phi + np.pi,
                 2.0 * np.pi) - np.pi
    a = lat.copy()
    rhs = np.pi * np.sin(lat)
    for _ in range(newton_iters):
        f = 2.0 * a + np.sin(2.0 * a) - rhs
        df = 2.0 + 2.0 * np.cos(2.0 * a)
        a = a - f / np.maximum(df, 1e-9)
    # poles: the iteration is singular (df -> 0); the limit is a = lat
    pole = np.abs(np.abs(lat) - 0.5 * np.pi) < 1e-9
    a = np.where(pole, lat, a)
    x = (2.0 * math.sqrt(2.0) / np.pi) * lon * np.cos(a)
    y = math.sqrt(2.0) * np.sin(a)
    return x, y


def rotate_coords_to(theta, phi, target, reverse=False):
    """Rotate (theta, phi) so that the ``target`` direction lands on the
    south pole theta=pi (grid_functions.py:284-336).

    ``reverse=True`` applies the inverse rotation.  Used by the rotated
    Lambert projection so the disk is centred on a point of interest.
    """
    theta = np.asarray(theta, dtype=np.float64)
    phi = np.asarray(phi, dtype=np.float64)
    t_theta, t_phi = float(target[0]), float(target[1])

    tdir = np.array([np.cos(t_phi) * np.sin(t_theta),
                     np.sin(t_phi) * np.sin(t_theta),
                     np.cos(t_theta)])
    axis = -np.cross(tdir, np.array([0.0, 0.0, 1.0]))
    axis_len = np.sqrt((axis**2).sum())
    if axis_len < 1e-12:
        # target already (anti)parallel to z: rotate about x
        axis = np.array([1.0, 0.0, 0.0])
    else:
        axis = axis / axis_len
    angle = np.pi - t_theta
    if reverse:
        angle = -angle

    vecs = np.stack([np.cos(phi) * np.sin(theta),
                     np.sin(phi) * np.sin(theta),
                     np.cos(theta)], axis=-1)
    # Rodrigues rotation
    c, s = np.cos(angle), np.sin(angle)
    k = axis
    res = (vecs * c + np.cross(np.broadcast_to(k, vecs.shape), vecs) * s
           + k[None, :] * (vecs @ k)[..., None] * (1.0 - c))

    new_theta = np.arccos(np.clip(res[..., 2], -1.0, 1.0))
    new_phi = np.arctan2(res[..., 1], res[..., 0])
    return new_theta, new_phi


def spherical_to_cartesian_lambert(spherical, fix_point=None):
    """(theta, phi) -> equal-area Lambert plane coords, disk centred on the
    south pole (or on ``fix_point`` when given) — grid_functions.py:359-377."""
    theta = np.asarray(spherical[:, 0], dtype=np.float64)
    phi = np.asarray(spherical[:, 1], dtype=np.float64)
    if fix_point is not None:
        theta, phi = rotate_coords_to(theta, phi, fix_point)
    r = 2.0 * np.cos(theta / 2.0)
    return np.stack([r * np.cos(phi), r * np.sin(phi)], axis=1)


def cartesian_lambert_to_spherical(xl, fix_point=None):
    """Inverse of :func:`spherical_to_cartesian_lambert`
    (grid_functions.py:339-357).  Points with r>2 are outside the sphere."""
    xl = np.asarray(xl, dtype=np.float64)
    r = np.sqrt((xl**2).sum(axis=1))
    r_safe = np.maximum(r, 1e-12)
    phi = np.arccos(np.clip(xl[:, 0] / r_safe, -1.0, 1.0))
    phi = np.where(xl[:, 1] >= 0, phi, 2.0 * np.pi - phi)
    theta = 2.0 * np.arccos(np.clip(r / 2.0, -1.0, 1.0))
    if fix_point is not None:
        theta, phi = rotate_coords_to(theta, phi, fix_point, reverse=True)
    return np.stack([theta, phi], axis=1)


def get_basic_gridlines(n_theta=5, n_phi=10, npts=100):
    """Constant-theta / constant-phi gridlines as (npts, 2) theta/phi arrays
    (grid_functions.py:379-399)."""
    lines = []
    for g in np.linspace(0.1, np.pi - 0.1, n_theta):
        azis = np.linspace(0.0, 2 * np.pi, npts)
        lines.append(np.stack([np.full_like(azis, g), azis], axis=1))
    for a in np.linspace(0.0, 2 * np.pi - 2 * np.pi / n_phi, n_phi):
        zens = np.linspace(0.0, np.pi, npts)
        lines.append(np.stack([zens, np.full_like(zens, a)], axis=1))
    return lines


def lambert_azimuthal_equal_area(theta, phi, center=(0.0, 0.0)):
    """Lambert azimuthal equal-area projection of (theta, phi) around a
    center direction (grid_functions.py:339-398)."""
    theta0, phi0 = center
    # rotate center to the pole: use spherical trig directly
    cos_c = (np.cos(theta0) * np.cos(theta)
             + np.sin(theta0) * np.sin(theta) * np.cos(phi - phi0))
    k = np.sqrt(2.0 / np.maximum(1.0 + cos_c, 1e-12))
    x = k * np.sin(theta) * np.sin(phi - phi0)
    y = k * (np.sin(theta0) * np.cos(theta)
             - np.cos(theta0) * np.sin(theta) * np.cos(phi - phi0))
    return x, y
