"""Rational-quadratic spline with linear tails on all of R (the `g` flow's
rq_splines stretch).

PyTorch counterpart of ``rq_spline_linear_ext`` in
``jammy_flows_tpu/ops/splines.py`` and the helpers it uses.  Inputs are
(B, D); unnormalized widths / heights are (Bp, D, K), derivatives (Bp, D,
K + 1), the box edges left / right / bottom / top (Bp, D), with Bp in {1,
B}.  Returns (outputs (B, D), log|d outputs / d inputs| (B, D)).

The bin search is the JAX package's masked count (a row's bin is the
number of edges at or below it, less one, clipped to the bins), so ties on
an edge and NaN inputs land in the same bin as there; the per-bin values
are read with ``torch.gather`` where the JAX package contracts a one-hot,
which gives the same values and gradients.  The other spline variants
(``rq_spline``, the smooth, circular and column forms) come with the
spherical and interval layers.
"""
from __future__ import annotations

import torch

from .special import softplus

MIN_BIN_WIDTH = 1e-3
MIN_BIN_HEIGHT = 1e-3
MIN_DERIVATIVE = 1e-3


def _bin_positions(unnormalized, num_bins, rel_min, low, high):
    """softmax -> floored widths -> the K + 1 edges in [low, high], the end
    edges pinned to low / high; returns (widths, edges)."""
    w = torch.softmax(unnormalized, dim=-1)
    w = rel_min + (1.0 - rel_min * num_bins) * w
    # the scan over the K bins runs along the leading dimension: CUDA's scan
    # along the innermost one took 12 ms for 1M x 4 rows of 10 bins on an
    # H100 (tools/euclid_profile.py, 3/4 of the rq_splines flagship's time)
    cum = torch.cumsum(w.movedim(-1, 0), dim=0).movedim(0, -1)
    cum = torch.cat([torch.zeros_like(cum[..., :1]), cum], dim=-1)
    cum = (high - low) * cum + low
    shape = cum[..., :1].shape
    cum = torch.cat([low.expand(shape), cum[..., 1:-1], high.expand(shape)],
                    dim=-1)
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


def rq_spline_linear_ext(inputs, unnormalized_widths, unnormalized_heights,
                         unnormalized_derivatives, left, right, bottom, top,
                         inverse=False):
    """The RQ spline on the box [left, right] x [bottom, top], continued
    outside it by lines of the end derivatives: a bijection of R."""
    num_bins = unnormalized_widths.shape[-1]
    widths, cumwidths = _bin_positions(
        unnormalized_widths, num_bins, MIN_BIN_WIDTH, left[..., None],
        right[..., None])
    heights, cumheights = _bin_positions(
        unnormalized_heights, num_bins, MIN_BIN_HEIGHT, bottom[..., None],
        top[..., None])
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
