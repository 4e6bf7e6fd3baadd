"""Rational-quadratic splines: the standard one on a box, the one with
linear tails on all of R (the `g` flow's rq_splines stretch), the C^2-smooth
one and the C^2-smooth circular one on [0, 2 pi].

PyTorch counterpart of ``rq_spline``, ``rq_spline_linear_ext``,
``rq_spline_smooth`` and ``rq_spline_smooth_circular`` in
``jammy_flows_tpu/ops/splines.py`` and the helpers they use.  Inputs are
(B, D); unnormalized widths / heights are (Bp, D, K), derivatives (Bp, D,
K + 1) (the smooth spline's two boundary ones (Bp, D, 2)), with Bp in {1,
B}; the box edges are floats, or (Bp, D) tensors for the linear-tail
spline.  Returns (outputs (B, D), log|d outputs / d inputs| (B, D)).

The bin search is the JAX package's masked count (a row's bin is the
number of edges at or below it, less one, clipped to the bins), so ties on
an edge and NaN inputs land in the same bin as there: the JAX package's
small margin on the top edge (``eps``) moves no row to another bin once
the count is clipped, so it is left out.  The per-bin values are read with
``torch.gather`` where the JAX package contracts a one-hot, which gives the
same values and gradients.  The JAX package's column twins (one (B,)
tensor per bin, for the TPU's tile padding) are not ported: the circle and
interval layers call these row forms.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .special import softplus

MIN_BIN_WIDTH = 1e-3
MIN_BIN_HEIGHT = 1e-3
MIN_DERIVATIVE = 1e-3
TWO_PI = 2.0 * math.pi


def _restrict_ratio(unnormalized, num_bins, ratio):
    """Logits squashed into a range that keeps the largest / smallest bin
    ratio at most ``ratio``; unchanged for ratio <= 0."""
    if ratio <= 0.0:
        return unnormalized
    ln_max_allowed = (math.log(ratio) - math.log(num_bins - 1)) / 2.0
    if not ln_max_allowed > 0:
        raise ValueError("Allowed max/min ratio for widths/heights is too "
                         f"small: {ratio:.3e}")
    return 2.0 * torch.sigmoid(unnormalized) * ln_max_allowed - ln_max_allowed


def _bin_positions(unnormalized, num_bins, rel_min, low, high):
    """softmax -> floored widths -> the K + 1 edges in [low, high], the end
    edges pinned to low / high (floats, or tensors broadcasting against the
    edges); returns (widths, edges)."""
    w = torch.softmax(unnormalized, dim=-1)
    w = rel_min + (1.0 - rel_min * num_bins) * w
    # the scan over the K bins runs along the leading dimension: CUDA's scan
    # along the innermost one took 12 ms for 1M x 4 rows of 10 bins on an
    # H100 (tools/euclid_profile.py, 3/4 of the rq_splines flagship's time)
    cum = torch.cumsum(w.movedim(-1, 0), dim=0).movedim(0, -1)
    cum = torch.cat([torch.zeros_like(cum[..., :1]), cum], dim=-1)
    cum = (high - low) * cum + low
    shape = cum[..., :1].shape
    ends = [torch.as_tensor(v, dtype=cum.dtype, device=cum.device).expand(
        shape) for v in (low, high)]
    cum = torch.cat([ends[0], cum[..., 1:-1], ends[1]], dim=-1)
    return cum[..., 1:] - cum[..., :-1], cum


def _searchsorted(edges, x):
    """The bin of x among edges (..., K + 1): the count of edges at or
    below x, less one, clipped to [0, K - 1]."""
    idx = torch.sum(x[..., None] >= edges, dim=-1) - 1
    return torch.clamp(idx, 0, edges.shape[-1] - 2)


def _gather(values, idx):
    """values (Bp, D, K) at idx (B, D) -> (B, D)."""
    values = values.expand(idx.shape + values.shape[-1:])
    return torch.gather(values, -1, idx[..., None])[..., 0]


def _rq_core(inputs, idx, cumwidths, widths, cumheights, heights, derivatives,
             inverse):
    """The rational-quadratic map of each input in its located bin, and its
    log-derivative."""
    in_cumw = _gather(cumwidths[..., :-1], idx)
    in_w = _gather(widths, idx)
    in_cumh = _gather(cumheights[..., :-1], idx)
    in_h = _gather(heights, idx)
    in_delta = _gather(heights / widths, idx)
    in_d = _gather(derivatives[..., :-1], idx)
    in_d1 = _gather(derivatives[..., 1:], idx)

    d_sum_term = in_d + in_d1 - 2.0 * in_delta
    if inverse:
        rel = inputs - in_cumh
        a = rel * d_sum_term + in_h * (in_delta - in_d)
        b = in_h * in_d - rel * d_sum_term
        c = -in_delta * rel
        discriminant = b**2 - 4.0 * a * c
        discriminant = torch.maximum(discriminant,
                                     torch.zeros_like(discriminant))
        root = (2.0 * c) / (-b - torch.sqrt(discriminant))
        outputs = root * in_w + in_cumw
        theta = root
    else:
        theta = (inputs - in_cumw) / in_w
        t1mt = theta * (1.0 - theta)
        numerator = in_h * (in_delta * theta**2 + in_d * t1mt)
        denominator = in_delta + d_sum_term * t1mt
        outputs = in_cumh + numerator / denominator

    t1mt = theta * (1.0 - theta)
    denominator = in_delta + d_sum_term * t1mt
    deriv_numerator = in_delta**2 * (
        in_d1 * theta**2 + 2.0 * in_delta * t1mt + in_d * (1.0 - theta)**2)
    logabsdet = torch.log(deriv_numerator) - 2.0 * torch.log(denominator)
    if inverse:
        logabsdet = -logabsdet
    return outputs, logabsdet


def _box_bins(unnormalized_widths, unnormalized_heights, left, right, bottom,
              top, rel_min_bin_width, rel_min_bin_height, ratio):
    """The bins of the box [left, right] x [bottom, top]: (widths,
    cumwidths, heights, cumheights), the logits restricted by ``ratio``."""
    num_bins = unnormalized_widths.shape[-1]
    uw = _restrict_ratio(unnormalized_widths, num_bins, ratio)
    uh = _restrict_ratio(unnormalized_heights, num_bins, ratio)
    widths, cumwidths = _bin_positions(uw, num_bins, rel_min_bin_width, left,
                                       right)
    heights, cumheights = _bin_positions(uh, num_bins, rel_min_bin_height,
                                         bottom, top)
    return widths, cumwidths, heights, cumheights


def rq_spline_linear_ext(inputs, unnormalized_widths, unnormalized_heights,
                         unnormalized_derivatives, left, right, bottom, top,
                         inverse=False):
    """The RQ spline on the box [left, right] x [bottom, top], continued
    outside it by lines of the end derivatives: a bijection of R."""
    widths, cumwidths, heights, cumheights = _box_bins(
        unnormalized_widths, unnormalized_heights, left[..., None],
        right[..., None], bottom[..., None], top[..., None], MIN_BIN_WIDTH,
        MIN_BIN_HEIGHT, -1.0)
    derivatives = MIN_DERIVATIVE + softplus(unnormalized_derivatives)

    edges = cumheights if inverse else cumwidths
    idx = _searchsorted(edges, inputs)
    outputs, logabsdet = _rq_core(inputs, idx, cumwidths, widths, cumheights,
                                  heights, derivatives, inverse)

    d0 = derivatives[..., 0]
    dk = derivatives[..., -1]
    if inverse:
        lo, hi = bottom, top
        out_lo = inputs / d0 + (cumwidths[..., 0] - cumheights[..., 0] / d0)
        out_hi = inputs / dk + (cumwidths[..., -1] - cumheights[..., -1] / dk)
        ld_lo, ld_hi = -torch.log(d0), -torch.log(dk)
    else:
        lo, hi = left, right
        out_lo = inputs * d0 + (cumheights[..., 0] - cumwidths[..., 0] * d0)
        out_hi = inputs * dk + (cumheights[..., -1] - cumwidths[..., -1] * dk)
        ld_lo, ld_hi = torch.log(d0), torch.log(dk)

    below = inputs <= lo
    above = inputs >= hi
    outputs = torch.where(below, out_lo, torch.where(above, out_hi, outputs))
    logabsdet = torch.where(below, ld_lo,
                            torch.where(above, ld_hi, logabsdet))
    return outputs, logabsdet


def rq_spline(inputs, unnormalized_widths, unnormalized_heights,
              unnormalized_derivatives, inverse=False, left=0.0, right=1.0,
              bottom=0.0, top=1.0, rel_min_bin_width=MIN_BIN_WIDTH,
              rel_min_bin_height=MIN_BIN_HEIGHT,
              min_derivative=MIN_DERIVATIVE,
              restrict_max_min_width_height_ratio=-1.0):
    """The monotone RQ spline on the box [left, right] x [bottom, top];
    K + 1 derivatives."""
    return rq_spline_on_bins(inputs, rq_spline_bins(
        unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
        left, right, bottom, top, rel_min_bin_width, rel_min_bin_height,
        min_derivative, restrict_max_min_width_height_ratio), inverse)


def rq_spline_bins(unnormalized_widths, unnormalized_heights,
                   unnormalized_derivatives, left=0.0, right=1.0, bottom=0.0,
                   top=1.0, rel_min_bin_width=MIN_BIN_WIDTH,
                   rel_min_bin_height=MIN_BIN_HEIGHT,
                   min_derivative=MIN_DERIVATIVE,
                   restrict_max_min_width_height_ratio=-1.0):
    """rq_spline's bins, made once for many evaluations: (widths,
    cumwidths, heights, cumheights, derivatives)."""
    widths, cumwidths, heights, cumheights = _box_bins(
        unnormalized_widths, unnormalized_heights, left, right, bottom, top,
        rel_min_bin_width, rel_min_bin_height,
        restrict_max_min_width_height_ratio)
    return (widths, cumwidths, heights, cumheights,
            min_derivative + softplus(unnormalized_derivatives))


def rq_spline_on_bins(inputs, bins, inverse=False):
    """rq_spline on bins made by rq_spline_bins."""
    widths, cumwidths, heights, cumheights, derivatives = bins
    idx = _searchsorted(cumheights if inverse else cumwidths, inputs)
    return _rq_core(inputs, idx, cumwidths, widths, cumheights, heights,
                    derivatives, inverse)


def _solve_c2_derivatives(widths, heights, boundary_derivatives,
                          solution_index=0):
    """The K + 1 knot derivatives of a C^2 spline of K <= 3 bins from its
    two (positive) boundary ones; at K = 3 the spline is taken mirrored, so
    both interior derivatives are equal."""
    k = widths.shape[-1]
    bd0, bd1 = boundary_derivatives[..., :1], boundary_derivatives[..., 1:]
    if k == 1:
        return boundary_derivatives
    if k == 2:
        h1, h2 = heights[..., :1], heights[..., 1:]
        w1, w2 = widths[..., :1], widths[..., 1:]
        hsum = h1 + h2
        lower_p = h1 / hsum
        higher_p = h2 / hsum
        neg_p_half = 0.5 * (lower_p * (h2 / w2 - bd1)
                            + higher_p * (h1 / w1 - bd0))
        q = -(h1 * h2) * (lower_p / w1**2 + higher_p / w2**2)
        disc = torch.sqrt(torch.clamp(neg_p_half**2 - q, min=0.0))
        res = neg_p_half + disc if solution_index == 0 else neg_p_half - disc
        return torch.cat([bd0, res, bd1], dim=-1)
    if k == 3:
        w1, w2 = widths[..., 0:1], widths[..., 1:2]
        h1, h2 = heights[..., 0:1], heights[..., 1:2]
        common = w1 * w2 * (2.0 * h1 + h2)
        p = h2 * (bd0 * w1 * w2 - h1 * (w1 + w2)) / common
        q = -h1 * h2 * (h1 * w2**2 + h2 * w1**2) / (common * w1 * w2)
        neg_p_half = -p / 2.0
        res = neg_p_half + torch.sqrt(torch.clamp(neg_p_half**2 - q, min=0.0))
        return torch.cat([bd0, res, res, bd1], dim=-1)
    raise NotImplementedError("smooth RQ spline supports <=3 bins")


def rq_spline_smooth(inputs, unnormalized_widths, unnormalized_heights,
                     unnormalized_boundary_derivatives, inverse=False,
                     left=0.0, right=1.0, bottom=0.0, top=1.0,
                     rel_min_bin_width=MIN_BIN_WIDTH,
                     rel_min_bin_height=MIN_BIN_HEIGHT,
                     min_derivative=MIN_DERIVATIVE,
                     restrict_max_min_width_height_ratio=-1.0,
                     solution_index=0):
    """The C^2-smooth RQ spline on the box: only its two boundary
    derivatives are free, the interior ones solved for (K <= 3)."""
    widths, cumwidths, heights, cumheights = _box_bins(
        unnormalized_widths, unnormalized_heights, left, right, bottom, top,
        rel_min_bin_width, rel_min_bin_height,
        restrict_max_min_width_height_ratio)
    boundary_d = min_derivative + softplus(unnormalized_boundary_derivatives)
    derivatives = _solve_c2_derivatives(widths, heights, boundary_d,
                                        solution_index)
    idx = _searchsorted(cumheights if inverse else cumwidths, inputs)
    return _rq_core(inputs, idx, cumwidths, widths, cumheights, heights,
                    derivatives, inverse)


def fixed_log_derivative(derivative, min_derivative):
    """The unnormalized derivative that ``min_derivative + softplus`` maps
    to ``derivative`` exactly (a spline's fixed boundary derivative)."""
    if not derivative > min_derivative:
        raise ValueError("fix_boundary_derivatives must exceed min_derivative")
    return float(np.log(np.exp(derivative - min_derivative) - 1.0))


class SplineParamLayout:
    """A spline layer's parameter row (the circle's `o`, the interval's
    `r`): widths, heights, then the free derivatives.  Of ``num_bins``
    free bins, the first width and height (and with ``fix_second_w`` the
    second width) may be pinned to 0 and left out of the row, and the
    heights may be parametrized as offsets from the widths."""

    def __init__(self, num_bins, fix_first=0, fix_second_w=0,
                 independent_wh=0):
        self.fix_first = int(fix_first)
        self.fix_second_w = int(fix_second_w)
        self.independent_wh = int(independent_wh)
        self.num_heights = num_bins - self.fix_first
        self.num_widths = self.num_heights - self.fix_first * self.fix_second_w

    def unpack(self, params):
        """(widths, heights, derivatives) of (Bp, P) rows, with the pinned
        zeros put back."""
        nw, nh = self.num_widths, self.num_heights
        w, h, d = params[:, :nw], params[:, nw:nw + nh], params[:, nw + nh:]
        if self.fix_first:
            zero = torch.zeros_like(h[:, :1])
            h = torch.cat([zero, h], dim=1)
            w = torch.cat([zero, zero, w] if self.fix_second_w
                          else [zero, w], dim=1)
        if self.independent_wh:
            h = w + h
        return w, h, d


def rq_spline_smooth_circular(inputs, unnormalized_widths,
                              unnormalized_heights, inverse=False,
                              rel_min_bin_width=MIN_BIN_WIDTH,
                              rel_min_bin_height=MIN_BIN_HEIGHT):
    """The C^2-smooth circular RQ spline of 2 bins on [0, 2 pi]: its three
    knot derivatives are equal (solved in closed form), so value and
    derivative match at the seam.  The spline is shifted so that its first
    bin is centred on pi, and the inputs 0 and 2 pi map to themselves
    exactly."""
    if unnormalized_widths.shape[-1] != 2:
        raise ValueError("circular smooth spline requires exactly 2 bins")
    widths, cumwidths, heights, cumheights = _box_bins(
        unnormalized_widths, unnormalized_heights, 0.0, TWO_PI, 0.0, TWO_PI,
        rel_min_bin_width, rel_min_bin_height, -1.0)

    w1, w2 = widths[..., :1], widths[..., 1:]
    h1, h2 = heights[..., :1], heights[..., 1:]
    h_prod = h1 * h2
    w_prod = w1 * w2
    sqrt_fac = torch.sqrt(
        h_prod * (8.0 * ((h2 * w1)**2 + (h1 * w2)**2)
                  + (9.0 * (w1 + w2)**2 - 16.0 * w_prod) * h_prod))
    denom = 4.0 * (h1 + h2) * w_prod
    res = (h_prod * (w1 + w2) + sqrt_fac) / denom
    derivatives = torch.cat([res, res, res], dim=-1)

    # the shift that centres the first bin on pi, in the input and the
    # output coordinates
    w1mx = -math.pi + w1 / 2.0
    w1mx_p_w2 = w1mx + w2
    nom = h2 * w1mx * (w1mx * h1 - res * w1 * w1mx_p_w2)
    den = h1 * w2**2 + 2.0 * (h1 - res * w1) * w1mx * w1mx_p_w2
    shift_out = (TWO_PI - (h1 + nom / den))[..., 0]
    shift_in = math.pi - widths[..., 0] / 2.0
    if inverse:
        shift_in, shift_out = shift_out, shift_in
    used_inputs = inputs - shift_in
    used_inputs = torch.where(used_inputs < 0.0, used_inputs + TWO_PI,
                              used_inputs)

    idx = _searchsorted(cumheights if inverse else cumwidths, used_inputs)
    outputs, logabsdet = _rq_core(used_inputs, idx, cumwidths, widths,
                                  cumheights, heights, derivatives, inverse)

    outputs = outputs + shift_out
    outputs = torch.where(outputs > TWO_PI, outputs - TWO_PI, outputs)
    outputs = torch.where(inputs == 0.0, 0.0, outputs)
    outputs = torch.where(inputs == TWO_PI, TWO_PI, outputs)
    return outputs, logabsdet
