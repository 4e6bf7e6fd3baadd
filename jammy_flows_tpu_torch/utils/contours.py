"""Contour machinery: the PyTorch port's copy of
``jammy_flows_tpu/utils/contours.py`` (helper_fns/contours.py).

Finds highest-posterior-density contour levels containing given probability
mass and generates contour lines from gridded PDF evaluations (via contourpy,
which ships with matplotlib), including azimuthal wrap-around splitting for
spherical maps.
"""
from __future__ import annotations

import numpy as np


def find_contour_levels(log_evals, areas, probs=(0.68, 0.95)):
    """HPD levels: densities such that the enclosed mass equals each prob
    (contours.py:21-82).

    log_evals: (N,) log-pdf values on cells with areas (N,) (or scalar).
    Returns descending list of density levels (one per prob).
    """
    log_evals = np.asarray(log_evals, dtype=np.float64)
    p = np.exp(log_evals)
    if np.isscalar(areas) or np.ndim(areas) == 0:
        masses = p * float(areas)
    else:
        masses = p * np.asarray(areas)
    order = np.argsort(p)[::-1]
    cum = np.cumsum(masses[order])
    levels = []
    for prob in probs:
        idx = np.searchsorted(cum, prob)
        idx = min(idx, len(order) - 1)
        levels.append(p[order[idx]])
    return np.asarray(levels)


def find_1d_contours(xs, log_evals, probs=(0.68, 0.95)):
    """1-d HPD intervals (contours.py:164-256).  Returns a list (per prob)
    of lists of (low, high) intervals."""
    xs = np.asarray(xs)
    log_evals = np.asarray(log_evals)
    dx = np.gradient(xs)
    levels = find_contour_levels(log_evals, dx, probs)
    p = np.exp(log_evals)
    results = []
    for level in levels:
        above = p >= level
        intervals = []
        start = None
        for i, a in enumerate(above):
            if a and start is None:
                start = xs[i]
            elif not a and start is not None:
                intervals.append((start, xs[i - 1]))
                start = None
        if start is not None:
            intervals.append((start, xs[-1]))
        results.append(intervals)
    return results


def compute_contours(xx, yy, log_evals, areas, probs=(0.68, 0.95),
                     wrap_phi=False):
    """Contour lines containing given probability mass
    (contours.py:84-162).

    xx, yy: meshgrid arrays (ny, nx); log_evals: matching grid of log-pdf;
    areas: cell areas.  Returns list (per prob) of line segments
    [(M_i, 2) arrays].  wrap_phi splits segments crossing the 0/2pi seam.
    """
    import contourpy

    levels = find_contour_levels(np.asarray(log_evals).ravel(),
                                 np.asarray(areas).ravel() if np.ndim(areas)
                                 else areas, probs)
    gen = contourpy.contour_generator(xx, yy, np.exp(np.asarray(log_evals)))
    all_lines = []
    for level in levels:
        segments = gen.lines(float(level))
        if wrap_phi:
            split = []
            for seg in segments:
                seg = np.asarray(seg)
                jumps = np.where(np.abs(np.diff(seg[:, 0])) > np.pi)[0]
                start = 0
                for j in jumps:
                    split.append(seg[start:j + 1])
                    start = j + 1
                split.append(seg[start:])
            segments = [s for s in split if len(s) > 1]
        all_lines.append([np.asarray(s) for s in segments])
    return all_lines, levels
