"""Visualization helpers (equivalent of the reference's helper_fns/plotting/).

PyTorch counterpart of ``jammy_flows_tpu/utils/plotting.py``: corner-style
joint-PDF visualization over mixed manifolds plus S2 map views.  All
plotting is host-side matplotlib, imported inside the functions (the
package imports without it); the pdf evaluations and draws run through the
port's ``log_prob`` / ``sample`` on the pdf's device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import grid as grid_utils
from . import contours as contour_utils


def _eval_chunked(pdf_obj, params, positions, conditional_input=None,
                  force_intrinsic=False, chunk=20000):
    return grid_utils.eval_log_prob(pdf_obj, params, positions,
                                    conditional_input, force_intrinsic, chunk)


def _host(x):
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plot_1d_marginal(ax, pdf_obj, params, samples, dim_index,
                     conditional_input=None, npts=200, color="C0"):
    """1-d marginal histogram from samples + overlaid density if total dim 1."""
    s = _host(samples)[:, dim_index]
    ax.hist(s, bins=50, density=True, color=color, alpha=0.4)
    ax.set_xlabel(f"dim {dim_index}")


def plot_density_2d(ax, pdf_obj, params, bounds, conditional_input=None,
                    npts=100, probs=(0.68, 0.95), cmap="viridis"):
    """Filled 2-d density + HPD contours for a 2-d Euclidean PDF
    (plotting/general.py:276-664 core path)."""
    positions, bin_volume = grid_utils.make_grid(bounds, npts)
    lp = _eval_chunked(pdf_obj, params, positions, conditional_input)
    zz = lp.reshape(npts, npts)
    xx = positions[:, 0].reshape(npts, npts)
    yy = positions[:, 1].reshape(npts, npts)
    ax.pcolormesh(xx, yy, np.exp(zz), cmap=cmap, shading="auto")
    lines, levels = contour_utils.compute_contours(xx, yy, zz, bin_volume,
                                                   probs=probs)
    for prob, segs in zip(probs, lines):
        for seg in segs:
            ax.plot(seg[:, 0], seg[:, 1], color="white", lw=1.0)
    return levels


def plot_sphere_2d(ax, pdf_obj, params, conditional_input=None, n_theta=100,
                   n_phi=200, probs=(0.68, 0.95), cmap="viridis"):
    """theta-phi map of an s2 PDF with HPD contours
    (plotting/spherical.py equivalent, healpy-free)."""
    thetas = np.linspace(1e-3, math.pi - 1e-3, n_theta)
    phis = np.linspace(1e-3, 2 * math.pi - 1e-3, n_phi)
    tt, pp = np.meshgrid(thetas, phis, indexing="ij")
    pts = np.stack([tt.ravel(), pp.ravel()], axis=1)
    lp = _eval_chunked(pdf_obj, params, pts, conditional_input,
                       force_intrinsic=True)
    zz = lp.reshape(n_theta, n_phi)
    area = (thetas[1] - thetas[0]) * (phis[1] - phis[0])
    ax.pcolormesh(pp, tt, np.exp(zz), cmap=cmap, shading="auto")
    lines, levels = contour_utils.compute_contours(pp, tt, zz, area,
                                                   probs=probs, wrap_phi=True)
    for segs in lines:
        for seg in segs:
            ax.plot(seg[:, 0], seg[:, 1], color="white", lw=1.0)
    ax.set_xlabel("phi")
    ax.set_ylabel("theta")
    ax.invert_yaxis()
    return levels


def plot_sphere_lambert(ax, pdf_obj, params, conditional_input=None, npts=60,
                        true_values=None, rotate_to_true_value=False,
                        probs=(0.68, 0.95), cmap="viridis", draw_gridlines=True):
    """Equal-area Lambert-disk view of a pure-s2 PDF
    (plotting/spherical.py + grid_functions.py:123-236 equivalent).

    Evaluates the PDF on a [-2,2]^2 Lambert grid, converts grid points to
    (theta, phi) — optionally rotated so ``true_values`` sits at the disk
    centre — and subtracts log sin(theta) so the plotted density is per
    Lambert area (the projection is equal-area, so the disk integral is the
    total probability).  Returns the disk integral (should be ~1).
    """
    if pdf_obj.pdf_defs_list != ["s2"]:
        raise ValueError("plot_sphere_lambert supports pure-s2 PDFs")
    xs = np.linspace(-2.0, 2.0, npts)
    xx, yy = np.meshgrid(xs, xs, indexing="ij")
    pts_l = np.stack([xx.ravel(), yy.ravel()], axis=1)
    r = np.sqrt((pts_l**2).sum(axis=1))
    inside = r < 2.0 - 1e-6

    fix_point = true_values if (rotate_to_true_value
                                and true_values is not None) else None
    sph = grid_utils.cartesian_lambert_to_spherical(pts_l[inside],
                                                    fix_point=fix_point)
    # clamp away from the exact poles (intrinsic parametrization is singular)
    sph[:, 0] = np.clip(sph[:, 0], 1e-5, math.pi - 1e-5)
    lp = _eval_chunked(pdf_obj, params, sph, conditional_input,
                       force_intrinsic=True)
    # theta/phi density -> Lambert-plane density (equal-area: drop sin(theta))
    lp = lp - np.log(np.maximum(np.sin(sph[:, 0]), 1e-12))

    zz = np.full(pts_l.shape[0], -600.0)
    zz[inside] = lp
    zz = zz.reshape(npts, npts)
    vals = np.ma.masked_array(np.exp(zz), mask=~inside.reshape(npts, npts))
    ax.pcolormesh(xx, yy, vals, cmap=cmap, shading="auto")

    cell = (xs[1] - xs[0])**2
    total_integral = float(np.exp(lp).sum() * cell)

    lines, _ = contour_utils.compute_contours(xx, yy, zz, cell, probs=probs)
    for segs in lines:
        for seg in segs:
            ax.plot(seg[:, 0], seg[:, 1], color="white", lw=1.0)

    if draw_gridlines:
        for gl in grid_utils.get_basic_gridlines():
            gxy = grid_utils.spherical_to_cartesian_lambert(gl,
                                                            fix_point=fix_point)
            keep = np.sqrt((gxy**2).sum(axis=1)) < 1.999
            ax.plot(np.where(keep, gxy[:, 0], np.nan),
                    np.where(keep, gxy[:, 1], np.nan),
                    color="gray", lw=0.4, alpha=0.6)
    if true_values is not None:
        txy = grid_utils.spherical_to_cartesian_lambert(
            np.asarray(true_values, dtype=np.float64)[None, :],
            fix_point=fix_point)
        ax.scatter(txy[:, 0], txy[:, 1], color="red", s=20, zorder=5)
    circle = np.linspace(0, 2 * math.pi, 200)
    ax.plot(2 * np.cos(circle), 2 * np.sin(circle), color="black", lw=1.0)
    ax.set_aspect("equal")
    ax.set_xlim(-2.1, 2.1)
    ax.set_ylim(-2.1, 2.1)
    return total_integral


def plot_sphere_mollweide(ax, pdf_obj, params, conditional_input=None,
                          n_base=2048, rounds=3, probs=(0.68, 0.95),
                          cmap="viridis", draw_gridlines=True,
                          true_values=None, scan=None, contour_npts=(80, 160)):
    """Full-sky equal-area Mollweide view rendering the MULTIRESOLUTION scan
    (healpy-free equivalent of plotting/spherical.py:452-550
    plot_multiresolution_healpy).

    Each adaptive cell of utils/grid.py:multires_s2_scan is drawn as a
    projected polygon colored by its density (per solid angle); HPD contour
    lines for ``probs`` are computed on a regular theta-phi grid and
    projected on top.  Returns the scan's total integral (~1 for a
    normalized PDF).  Pass a precomputed ``scan`` (pts, lp, areas, cells) to
    render an existing scan without re-evaluating.
    """
    from matplotlib.collections import PolyCollection
    import matplotlib.pyplot as plt

    if scan is None:
        scan = grid_utils.multires_s2_scan(
            pdf_obj, params, conditional_input=conditional_input,
            n_base=n_base, rounds=rounds, return_cells=True)
    pts, lp, areas, cells = scan
    total_integral = float(np.sum(np.exp(lp) * areas))

    # polygon corners per cell, with edge subdivision for projection curvature
    polys = []
    tsub = np.linspace(0.0, 1.0, 4)
    for (zl, zh, pl, ph) in cells:
        zz = np.concatenate([np.full(4, zl), tsub * (zh - zl) + zl,
                             np.full(4, zh), (1 - tsub) * (zh - zl) + zl])
        pp = np.concatenate([tsub * (ph - pl) + pl, np.full(4, ph),
                             (1 - tsub) * (ph - pl) + pl, np.full(4, pl)])
        th = np.arccos(np.clip(zz, -1.0, 1.0))
        x, y = grid_utils.mollweide_xy(th, pp)
        polys.append(np.stack([x, y], axis=1))
    vals = np.exp(lp)
    norm = plt.Normalize(vmin=0.0, vmax=float(vals.max()))
    coll = PolyCollection(polys, array=vals, cmap=cmap, norm=norm,
                          edgecolors="none")
    ax.add_collection(coll)

    # HPD contour lines from a regular grid, projected
    n_t, n_p = contour_npts
    thetas = np.linspace(1e-3, math.pi - 1e-3, n_t)
    phis = np.linspace(1e-3, 2 * math.pi - 1e-3, n_p)
    tt, pp = np.meshgrid(thetas, phis, indexing="ij")
    grid_pts = np.stack([tt.ravel(), pp.ravel()], axis=1)
    glp = _eval_chunked(pdf_obj, params, grid_pts, conditional_input,
                        force_intrinsic=True)
    zz = glp.reshape(n_t, n_p)
    area = (thetas[1] - thetas[0]) * (phis[1] - phis[0])
    lines, levels = contour_utils.compute_contours(pp, tt, zz, area,
                                                   probs=probs, wrap_phi=True)
    for segs in lines:
        for seg in segs:
            x, y = grid_utils.mollweide_xy(seg[:, 1], seg[:, 0])
            # break segments that jump across the Mollweide seam
            jump = np.abs(np.diff(x)) > 2.0
            x = np.insert(x, np.where(jump)[0] + 1, np.nan)
            y = np.insert(y, np.where(jump)[0] + 1, np.nan)
            ax.plot(x, y, color="white", lw=1.0)

    if draw_gridlines:
        for gl in grid_utils.get_basic_gridlines():
            x, y = grid_utils.mollweide_xy(np.asarray(gl)[:, 0],
                                           np.asarray(gl)[:, 1])
            jump = np.abs(np.diff(x)) > 2.0
            x = np.insert(x, np.where(jump)[0] + 1, np.nan)
            y = np.insert(y, np.where(jump)[0] + 1, np.nan)
            ax.plot(x, y, color="gray", lw=0.4, alpha=0.6)
    if true_values is not None:
        tv = np.asarray(true_values, dtype=np.float64).reshape(-1, 2)
        x, y = grid_utils.mollweide_xy(tv[:, 0], tv[:, 1])
        ax.scatter(x, y, color="red", s=20, zorder=5)

    # outline of the projection ellipse
    t = np.linspace(0, 2 * math.pi, 200)
    ax.plot(2 * math.sqrt(2) * np.cos(t), math.sqrt(2) * np.sin(t),
            color="black", lw=1.0)
    ax.set_aspect("equal")
    ax.set_xlim(-2 * math.sqrt(2) - 0.1, 2 * math.sqrt(2) + 0.1)
    ax.set_ylim(-math.sqrt(2) - 0.1, math.sqrt(2) + 0.1)
    ax.set_axis_off()
    return total_integral


def plot_sphere_zoom(ax, pdf_obj, params, center, zoom_radius_deg=20.0,
                     conditional_input=None, npts=80, probs=(0.68, 0.95),
                     cmap="viridis", draw_gridlines=True, true_values=None):
    """Zoomed equal-area view around ``center`` = (theta, phi)
    (plotting/spherical.py:552-614 zoomed-healpy equivalent).

    A Lambert azimuthal projection rotated so ``center`` sits at the origin,
    restricted to the disk of angular radius ``zoom_radius_deg``.  The
    projection is equal-area, so HPD contours and the disk integral remain
    exact in the zoomed window.
    """
    center = np.asarray(center, dtype=np.float64).ravel()
    r_max = 2.0 * math.sin(math.radians(zoom_radius_deg) / 2.0)
    xs = np.linspace(-r_max, r_max, npts)
    xx, yy = np.meshgrid(xs, xs, indexing="ij")
    pts_l = np.stack([xx.ravel(), yy.ravel()], axis=1)
    inside = np.sqrt((pts_l**2).sum(axis=1)) < r_max - 1e-9

    sph = grid_utils.cartesian_lambert_to_spherical(pts_l[inside],
                                                    fix_point=center)
    sph[:, 0] = np.clip(sph[:, 0], 1e-5, math.pi - 1e-5)
    lp = _eval_chunked(pdf_obj, params, sph, conditional_input,
                       force_intrinsic=True)
    lp = lp - np.log(np.maximum(np.sin(sph[:, 0]), 1e-12))

    zz = np.full(pts_l.shape[0], -600.0)
    zz[inside] = lp
    zz = zz.reshape(npts, npts)
    vals = np.ma.masked_array(np.exp(zz), mask=~inside.reshape(npts, npts))
    ax.pcolormesh(xx, yy, vals, cmap=cmap, shading="auto")

    cell = (xs[1] - xs[0])**2
    window_integral = float(np.exp(lp).sum() * cell)
    lines, _ = contour_utils.compute_contours(xx, yy, zz, cell, probs=probs)
    for segs in lines:
        for seg in segs:
            ax.plot(seg[:, 0], seg[:, 1], color="white", lw=1.0)

    if draw_gridlines:
        for gl in grid_utils.get_basic_gridlines(n_theta=9, n_phi=18,
                                                 npts=400):
            gxy = grid_utils.spherical_to_cartesian_lambert(gl,
                                                            fix_point=center)
            keep = np.sqrt((gxy**2).sum(axis=1)) < r_max
            ax.plot(np.where(keep, gxy[:, 0], np.nan),
                    np.where(keep, gxy[:, 1], np.nan),
                    color="gray", lw=0.4, alpha=0.6)
    if true_values is not None:
        txy = grid_utils.spherical_to_cartesian_lambert(
            np.asarray(true_values, dtype=np.float64)[None, :],
            fix_point=center)
        ax.scatter(txy[:, 0], txy[:, 1], color="red", s=20, zorder=5)
    circle = np.linspace(0, 2 * math.pi, 200)
    ax.plot(r_max * np.cos(circle), r_max * np.sin(circle), color="black",
            lw=1.0)
    ax.set_aspect("equal")
    return window_integral


def show_sample_contours(ax, samples, bins=50, color="white",
                         contour_probs=(0.68, 0.95)):
    """Sample-based HPD contours with percentage labels on an existing axes
    (plotting/general.py:122-207).

    samples: (N, 2).  bins: int or [x_edges, y_edges].  Histograms the
    samples, finds the HPD density levels for ``contour_probs``, and draws
    labelled matplotlib contours.  Returns the contour bounding box
    [[xmin, xmax], [ymin, ymax]] (or None when contouring fails).
    """
    samples = _host(samples)
    fill, xedges, yedges = np.histogram2d(samples[:, 0], samples[:, 1],
                                          bins=bins, density=True)
    xvals = 0.5 * (xedges[1:] + xedges[:-1])
    yvals = 0.5 * (yedges[1:] + yedges[:-1])
    bw = (xedges[1] - xedges[0]) * (yedges[1] - yedges[0])
    with np.errstate(divide="ignore"):
        levels = contour_utils.find_contour_levels(
            np.log(fill.ravel() + 1e-300), bw, contour_probs)
    levels = np.asarray(levels)[::-1]           # ascending for ax.contour
    if len(np.unique(levels)) < len(levels) or not np.all(levels > 0):
        return None
    try:
        ret = ax.contour(xvals, yvals, fill.T, levels=levels, colors=color)
        fmt = {lev: "%d %%" % int(prob * 100)
               for lev, prob in zip(levels, list(contour_probs)[::-1])}
        ax.clabel(ret, fontsize=9, inline=1, fmt=fmt, levels=levels,
                  colors=color)
    except (ValueError, IndexError):
        return None
    segs = [s for level_segs in ret.allsegs for s in level_segs if len(s)]
    if not segs:
        return None
    allpts = np.concatenate(segs, axis=0)
    return [[allpts[:, 0].min(), allpts[:, 0].max()],
            [allpts[:, 1].min(), allpts[:, 1].max()]]


def _corner_bounds(samples, bounds=None, vis_percentiles=(2.0, 98.0),
                   relative_buffer=0.1, num_bins=50):
    """Per-dim visualization bounds + histogram edges
    (grid_functions.py obtain_bins_and_visualization_regions equivalent)."""
    samples = _host(samples)
    if bounds is None:
        b = grid_utils.percentile_bounds(
            samples, percentiles=vis_percentiles,
            margin_factor=relative_buffer)
    else:
        b = np.asarray(bounds, dtype=np.float64)
    # guard degenerate (near-constant) dims
    widths = b[:, 1] - b[:, 0]
    fix = widths <= 0
    b[fix, 0] -= 0.5
    b[fix, 1] += 0.5
    edges = [np.linspace(lo, hi, num_bins + 1) for lo, hi in b]
    return b, edges


def _lambert_transform_subdims(pdf_obj, samples, true_values,
                               s2_rotate_to_true_value):
    """Transform every s2 sub-manifold's (theta, phi) sample columns (and
    true values) to the Lambert plane (plotting/general.py:352-396).
    Returns (samples, true_values, per-subdim gridlines dict, fix_points)."""
    samples = np.array(_host(samples), dtype=np.float64)
    tv = None if true_values is None else \
        np.array(np.asarray(true_values, dtype=np.float64).ravel())
    gridlines = {}
    for k, sub_def in enumerate(pdf_obj.pdf_defs_list):
        if sub_def != "s2":
            continue
        lo, hi = pdf_obj.target_dim_indices_intrinsic[k]
        fix_point = None
        if s2_rotate_to_true_value and tv is not None:
            fix_point = tv[lo:hi].copy()
        samples[:, lo:hi] = grid_utils.spherical_to_cartesian_lambert(
            samples[:, lo:hi], fix_point=fix_point)
        if tv is not None:
            tv[lo:hi] = grid_utils.spherical_to_cartesian_lambert(
                tv[lo:hi][None, :], fix_point=fix_point)[0]
        gridlines[(lo, hi)] = [
            grid_utils.spherical_to_cartesian_lambert(np.asarray(gl),
                                                      fix_point=fix_point)
            for gl in grid_utils.get_basic_gridlines()]
    return samples, tv, gridlines


def plot_joint_pdf(pdf_obj, params, samples, fig=None, axes=None,
                   conditional_input=None, bounds=None, multiplot=False,
                   total_pdf_eval_pts=10000, true_values=None,
                   plot_only_contours=False, contour_probs=(0.68, 0.95),
                   contour_color="white", skip_plotting_density=False,
                   hide_labels=False, s2_norm="standard", colormap="viridis",
                   s2_rotate_to_true_value=False, s2_show_gridlines=True,
                   skip_plotting_samples=False, var_names=(),
                   relative_buffer=0.1, vis_percentiles=(2.0, 98.0),
                   show_relative_std=0):
    """Reference-style joint-PDF plot from drawn samples
    (plotting/general.py:276-664).

    dim 1 -> histogram + density curve; dim 2 (and not multiplot) -> single
    panel with density image, labelled HPD density contours and sample
    contours; otherwise a corner grid: lower-triangle hist2d panels with
    labelled sample HPD contours and true-value markers, diagonal 1-d step
    histograms.  ``s2_norm='lambert'`` transforms every s2 sub-manifold's
    sample columns to the equal-area Lambert plane (with gridlines).
    ``var_names`` labels the outer axes.  Returns (axes, total_pdf_integral)
    where total_pdf_integral is the 1-d/2-d density-grid integral (None for
    corner grids, which are sample-based like the reference's).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    samples = np.asarray(_host(samples), dtype=np.float64)
    dim = samples.shape[1]
    if dim != pdf_obj.total_base_dim:
        raise ValueError("plot_joint_pdf expects intrinsic-coordinate samples")

    plot_density = dim <= 2 and not skip_plotting_density
    ci_one = None
    if conditional_input is not None:
        ci0 = conditional_input[0] if isinstance(conditional_input, list) \
            else conditional_input
        if ci0.shape[0] > 1:
            plot_density = False
        if isinstance(conditional_input, list):
            ci_one = [c[0:1] for c in conditional_input]
        else:
            ci_one = conditional_input[0:1]

    gridlines = {}
    tv_plot = None if true_values is None else \
        np.asarray(true_values, dtype=np.float64).ravel().copy()
    if s2_norm == "lambert":
        samples, tv_plot, gridlines = _lambert_transform_subdims(
            pdf_obj, samples, true_values, s2_rotate_to_true_value)
    elif s2_show_gridlines:
        for k, sub_def in enumerate(pdf_obj.pdf_defs_list):
            if sub_def == "s2":
                lo, hi = pdf_obj.target_dim_indices_intrinsic[k]
                gridlines[(lo, hi)] = [np.asarray(gl) for gl in
                                       grid_utils.get_basic_gridlines()]

    vis_bounds, hist_edges = _corner_bounds(
        samples, bounds=bounds, vis_percentiles=vis_percentiles,
        relative_buffer=relative_buffer)

    if fig is None and axes is None:
        if dim == 1 or (dim == 2 and not multiplot):
            fig, ax0 = plt.subplots(figsize=(5, 4))
            axes = {"ax": ax0}
        else:
            fig, axarr = plt.subplots(dim, dim, figsize=(2.2 * dim,
                                                         2.2 * dim))
            axes = {(i, j): axarr[i][j] for i in range(dim)
                    for j in range(dim)}
            for i in range(dim):
                for j in range(dim):
                    if j > i:
                        axarr[i][j].set_axis_off()

    total_pdf_integral = None

    if dim == 1:
        ax = axes["ax"]
        ax.hist(samples[:, 0], bins=hist_edges[0], density=True)
        if plot_density:
            positions, lp, bv = grid_utils.pdf_on_grid(
                pdf_obj, params, vis_bounds, total_pdf_eval_pts,
                conditional_input=ci_one)
            ax.plot(positions[:, 0], np.exp(lp), color="k")
            total_pdf_integral = float(np.exp(lp).sum() * bv)
        if tv_plot is not None:
            ax.axvline(tv_plot[0], color="red", lw=2.0)
        if hide_labels:
            ax.set_xticklabels([])
            ax.set_yticklabels([])
        if var_names:
            ax.set_xlabel(var_names[0])
        ax.set_xlim(*vis_bounds[0])
        return axes, total_pdf_integral

    if dim == 2 and not multiplot:
        ax = axes["ax"]
        npts = max(int(total_pdf_eval_pts ** 0.5), 20)
        if plot_density:
            is_pure_s2 = pdf_obj.pdf_defs_list == ["s2"] and \
                s2_norm != "lambert"
            if is_pure_s2:
                # intrinsic (theta, phi) map, like plot_sphere_2d
                eval_bounds = np.array([[1e-3, math.pi - 1e-3],
                                        [1e-3, 2 * math.pi - 1e-3]])
                positions, bv = grid_utils.make_grid(eval_bounds, npts)
                lp = _eval_chunked(pdf_obj, params, positions, ci_one,
                                   force_intrinsic=True)
            else:
                positions, lp, bv = grid_utils.pdf_on_grid(
                    pdf_obj, params, vis_bounds, npts,
                    conditional_input=ci_one)
            zz = lp.reshape(npts, npts)
            xx = positions[:, 0].reshape(npts, npts)
            yy = positions[:, 1].reshape(npts, npts)
            pc = ax.pcolormesh(xx, yy, np.exp(zz), cmap=colormap,
                               shading="auto")
            plt.colorbar(pc, ax=ax)
            total_pdf_integral = float(np.exp(lp).sum() * bv)
            if contour_probs:
                levels = contour_utils.find_contour_levels(
                    lp, bv, contour_probs)[::-1]
                if len(np.unique(levels)) == len(levels):
                    ret = ax.contour(xx, yy, np.exp(zz), levels=levels,
                                     colors="black")
                    fmt = {lev: "%d %%" % int(pr * 100) for lev, pr in
                           zip(levels, list(contour_probs)[::-1])}
                    ax.clabel(ret, fontsize=9, inline=1, fmt=fmt,
                              levels=levels, colors="black")
        elif not plot_only_contours and not skip_plotting_samples:
            ax.hist2d(samples[:, 0], samples[:, 1],
                      bins=[hist_edges[0], hist_edges[1]], density=True,
                      cmap=colormap, cmin=1e-20)
        if contour_probs and not skip_plotting_samples:
            show_sample_contours(ax, samples,
                                 bins=[hist_edges[0], hist_edges[1]],
                                 color=contour_color,
                                 contour_probs=contour_probs)
        for (lo, hi), gls in gridlines.items():
            if (lo, hi) == (0, 2):
                for gl in gls:
                    ax.plot(gl[:, 0], gl[:, 1], color="gray", alpha=0.5,
                            lw=0.4)
        if tv_plot is not None:
            ax.plot([tv_plot[0]], [tv_plot[1]], color="red", marker="o",
                    ms=3.0)
        ax.set_xlim(*vis_bounds[0])
        ax.set_ylim(*vis_bounds[1])
        if var_names:
            ax.set_xlabel(var_names[0])
            ax.set_ylabel(var_names[1])
        if hide_labels:
            ax.set_xticklabels([])
            ax.set_yticklabels([])
        return axes, total_pdf_integral

    # corner grid (dim > 2, or multiplot at dim 2): sample-based panels
    names = list(var_names) if var_names else [f"dim {i}"
                                               for i in range(dim)]
    if len(names) != dim:
        raise ValueError("var_names must have one entry per dim")
    for i in range(dim):
        for j in range(dim):
            if j > i or (i, j) not in axes:
                continue
            ax = axes[(i, j)]
            if j < i:
                pair = samples[:, [j, i]]
                if not plot_only_contours:
                    ax.hist2d(pair[:, 0], pair[:, 1],
                              bins=[hist_edges[j], hist_edges[i]],
                              density=True, cmap=colormap, cmin=1e-20)
                if contour_probs:
                    show_sample_contours(ax, pair,
                                         bins=[hist_edges[j],
                                               hist_edges[i]],
                                         color=contour_color,
                                         contour_probs=contour_probs)
                for (lo, hi), gls in gridlines.items():
                    if (lo, hi) == (j, i + 1) and hi - lo == 2:
                        for gl in gls:
                            ax.plot(gl[:, 0], gl[:, 1], color="gray",
                                    alpha=0.5, lw=0.4)
                if tv_plot is not None:
                    ax.plot([tv_plot[j]], [tv_plot[i]], color="red",
                            marker="o", ms=3.0)
                ax.set_xlim(*vis_bounds[j])
                ax.set_ylim(*vis_bounds[i])
                if i == dim - 1:
                    ax.set_xlabel(names[j])
                    for lab in ax.get_xticklabels():
                        lab.set_rotation(45)
                else:
                    ax.set_xticklabels([])
                if j == 0:
                    ax.set_ylabel(names[i])
                else:
                    ax.set_yticklabels([])
            else:                                   # diagonal: 1-d marginal
                ax.hist(samples[:, i], bins=hist_edges[i], histtype="step",
                        density=True, color="black")
                if show_relative_std:
                    std = float(np.std(samples[:, i]))
                    rel = 0.5 * (vis_bounds[i][1] - vis_bounds[i][0]) / \
                        max(std, 1e-30)
                    ax.set_title("%.1f" % rel, fontsize=9)
                if tv_plot is not None:
                    ax.axvline(tv_plot[i], color="red", lw=2.0)
                ax.set_xlim(*vis_bounds[i])
                ax.set_yticklabels([])
                if i == dim - 1:
                    ax.set_xlabel(names[i])
                    for lab in ax.get_xticklabels():
                        lab.set_rotation(45)
                else:
                    ax.set_xticklabels([])
            if hide_labels:
                ax.set_xticklabels([])
                ax.set_yticklabels([])
    return axes, total_pdf_integral


def visualize_pdf(pdf_obj, params, generator=None, conditional_input=None,
                  samplesize=10000, npts=100, fig=None, s2_norm="standard",
                  s2_rotate_to_true_value=False, true_values=None,
                  bounds=None, plot_only_contours=False,
                  contour_probs=(0.68, 0.95), contour_color="white",
                  skip_plotting_density=False, hide_labels=False,
                  colormap="viridis", s2_show_gridlines=True,
                  skip_plotting_samples=False, var_names=(),
                  vis_percentiles=(2.0, 98.0), relative_buffer=0.1,
                  show_relative_std=0, multiplot=False):
    """Sample the PDF and render the reference-style joint visualization
    (plotting/general.py:666-840): 1-d/2-d density panels or a corner grid
    of pairwise sample panels with labelled HPD contours, true-value
    markers and ``var_names``.

    Repo extras: ``s2_norm`` in {'mollweide', 'zoom'} renders the dedicated
    full-sky / zoomed equal-area view for pure-s2 PDFs; a batched
    ``conditional_input`` with ``multiplot=True`` renders one corner grid
    per batch item (each item's posterior sampled separately).

    Draws come from ``generator`` (by default one on the pdf's device
    seeded with 0).  Returns the matplotlib figure; the drawn samples and
    the density-grid integral (when computed) are attached as
    ``fig._jammy_samples`` / ``fig._jammy_total_pdf_integral``.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    generator = pdf_obj._generator(generator)
    conditional_input = pdf_obj._conditional(conditional_input)

    # dedicated pure-s2 map views (lambert mirrors the reference's
    # lambert view; mollweide/zoom are repo extras)
    if s2_norm in ("mollweide", "zoom", "lambert") and \
            pdf_obj.pdf_defs_list == ["s2"]:
        ci_one = None if conditional_input is None else conditional_input[:1]
        tv = None if true_values is None else \
            np.asarray(true_values, dtype=np.float64).ravel()
        if fig is None:
            fig, ax = plt.subplots(figsize=(8, 4.5) if s2_norm == "mollweide"
                                   else (5, 5))
        else:
            ax = fig.gca()
        if s2_norm == "mollweide":
            integ = plot_sphere_mollweide(
                ax, pdf_obj, params, conditional_input=ci_one,
                probs=tuple(contour_probs),
                draw_gridlines=s2_show_gridlines,
                true_values=None if tv is None else tv[None, :])
        elif s2_norm == "lambert":
            integ = plot_sphere_lambert(
                ax, pdf_obj, params, conditional_input=ci_one,
                true_values=tv, probs=tuple(contour_probs),
                draw_gridlines=s2_show_gridlines,
                rotate_to_true_value=s2_rotate_to_true_value)
        else:
            center = tv if tv is not None else np.array([0.5 * math.pi,
                                                         math.pi])
            integ = plot_sphere_zoom(
                ax, pdf_obj, params, center=center,
                conditional_input=ci_one, probs=tuple(contour_probs),
                draw_gridlines=s2_show_gridlines, true_values=tv)
        fig._jammy_total_pdf_integral = integ
        return fig

    multi_ci = conditional_input is not None and (
        (conditional_input[0] if isinstance(conditional_input, list)
         else conditional_input).shape[0] > 1)

    if multi_ci and multiplot:
        # one corner plot per batch item
        ci0 = conditional_input[0] if isinstance(conditional_input, list) \
            else conditional_input
        n_items = int(ci0.shape[0])
        figs_per_row = min(3, n_items)
        nrows = (n_items + figs_per_row - 1) // figs_per_row
        dim = pdf_obj.total_base_dim
        if fig is None:
            fig = plt.figure(figsize=(2.0 * dim * figs_per_row,
                                      2.0 * dim * nrows))
        outer = fig.add_gridspec(nrows, figs_per_row, hspace=0.35,
                                 wspace=0.35)
        all_samples = []
        for it in range(n_items):
            if isinstance(conditional_input, list):
                ci_it = [c[it:it + 1].repeat_interleave(samplesize, dim=0)
                         for c in conditional_input]
            else:
                ci_it = conditional_input[it:it + 1].repeat_interleave(
                    samplesize, dim=0)
            with torch.no_grad():
                s_it = pdf_obj.sample(params, conditional_input=ci_it,
                                      generator=generator,
                                      force_intrinsic_coordinates=True)[0]
            all_samples.append(_host(s_it))
            sub = outer[it // figs_per_row, it % figs_per_row].subgridspec(
                dim, dim)
            axes = {}
            for i in range(dim):
                for j in range(dim):
                    if j <= i:
                        axes[(i, j)] = fig.add_subplot(sub[i, j])
            tv_it = None
            if true_values is not None:
                tva = np.asarray(true_values, dtype=np.float64)
                tv_it = tva[it] if tva.ndim == 2 else tva
            plot_joint_pdf(
                pdf_obj, params, all_samples[-1], fig=fig, axes=axes,
                conditional_input=None, bounds=bounds, multiplot=True,
                true_values=tv_it, plot_only_contours=plot_only_contours,
                contour_probs=contour_probs, contour_color=contour_color,
                skip_plotting_density=True, hide_labels=hide_labels,
                s2_norm=s2_norm, colormap=colormap,
                s2_rotate_to_true_value=s2_rotate_to_true_value,
                s2_show_gridlines=s2_show_gridlines,
                skip_plotting_samples=skip_plotting_samples,
                var_names=var_names, relative_buffer=relative_buffer,
                vis_percentiles=vis_percentiles,
                show_relative_std=show_relative_std)
        fig._jammy_samples = np.concatenate(all_samples, axis=0)
        fig._jammy_total_pdf_integral = None
        return fig

    if conditional_input is not None:
        if multi_ci:
            ci_rep = conditional_input      # one sample per batch row
        elif isinstance(conditional_input, list):
            ci_rep = [c[:1].repeat_interleave(samplesize, dim=0)
                      for c in conditional_input]
        else:
            ci_rep = conditional_input[:1].repeat_interleave(samplesize, dim=0)
        with torch.no_grad():
            samples = pdf_obj.sample(params, conditional_input=ci_rep,
                                     generator=generator,
                                     force_intrinsic_coordinates=True)[0]
    else:
        with torch.no_grad():
            samples = pdf_obj.sample(params, samplesize=samplesize,
                                     generator=generator,
                                     force_intrinsic_coordinates=True)[0]
    samples = _host(samples)

    axes, integ = plot_joint_pdf(
        pdf_obj, params, samples, fig=fig,
        conditional_input=conditional_input, bounds=bounds,
        multiplot=multiplot, total_pdf_eval_pts=npts * npts,
        true_values=true_values, plot_only_contours=plot_only_contours,
        contour_probs=contour_probs, contour_color=contour_color,
        skip_plotting_density=skip_plotting_density,
        hide_labels=hide_labels, s2_norm=s2_norm, colormap=colormap,
        s2_rotate_to_true_value=s2_rotate_to_true_value,
        s2_show_gridlines=s2_show_gridlines,
        skip_plotting_samples=skip_plotting_samples, var_names=var_names,
        relative_buffer=relative_buffer, vis_percentiles=vis_percentiles,
        show_relative_std=show_relative_std)
    fig = next(iter(axes.values())).figure
    fig.tight_layout()
    fig._jammy_samples = samples
    fig._jammy_total_pdf_integral = integ
    return fig
