"""Interval flow layers: the RQ spline (`r`) and the identity (`z`).

PyTorch counterpart of ``jammy_flows_tpu/layers/interval.py``, on (B, 1)
rows with (Bp, P) parameter slabs: the JAX package's row form.  Its column
twins, which exist for the TPU's tile padding, are not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import FlowLayer
from ..ops import manifold
from ..ops.splines import (SplineParamLayout, fixed_log_derivative,
                           rq_spline, rq_spline_smooth)


class IntervalLayer(FlowLayer):
    """Base: the Gaussian-CDF projection between the real line and [low,
    high] when the layer is the first of an interval sub-manifold."""

    def __init__(self, dimension=1, euclidean_to_interval_as_first=0,
                 low_boundary=0.0, high_boundary=1.0):
        super().__init__(dimension)
        if dimension != 1:
            raise ValueError("interval flows are 1-dimensional")
        if not high_boundary > low_boundary:
            raise ValueError(f"interval [{low_boundary}, {high_boundary}] is "
                             "empty")
        self.low = float(low_boundary)
        self.high = float(high_boundary)
        self.euclidean_to_interval_as_first = int(
            euclidean_to_interval_as_first)

    def forward(self, params, x, log_det):
        if self.euclidean_to_interval_as_first:
            x, log_det = manifold.real_line_to_interval(x, log_det, self.low,
                                                        self.high)
        return self._forward(params, x, log_det)

    def inverse(self, params, x, log_det):
        x, log_det = self._inverse(params, x, log_det)
        if self.euclidean_to_interval_as_first:
            x, log_det = manifold.interval_to_real_line(x, log_det, self.low,
                                                        self.high)
        return x, log_det

    def _forward(self, params, x, log_det):
        raise NotImplementedError

    def _inverse(self, params, x, log_det):
        raise NotImplementedError


class RQSplineInterval(IntervalLayer):
    """Neural-spline-flow RQ spline on [low, high] - symbol "r".  Parameter
    layout: widths, heights, derivatives.  Options: both boundary
    derivatives fixed, the C^2-smooth spline (2 bins, or 3 mirrored: the
    third bin repeats the first), the first width and height (and the second
    width) pinned to 0, heights parametrized as offsets from the widths, and
    a bounded ratio of the largest to the smallest bin."""

    def __init__(self, dimension=1, num_basis_functions=10,
                 euclidean_to_interval_as_first=0, low_boundary=0.0,
                 high_boundary=1.0, min_width=1e-4, min_height=1e-4,
                 min_derivative=1e-4, fix_boundary_derivatives=-1.0,
                 smooth_second_derivative=0,
                 restrict_max_min_width_height_ratio=-1.0,
                 fix_first_width_n_height_to_zero=0,
                 also_fix_second_width_to_zero=0,
                 independent_width_height_parametrization=0):
        super().__init__(dimension, euclidean_to_interval_as_first,
                         low_boundary, high_boundary)
        k = num_basis_functions
        self.num_basis_functions = k
        self.min_width = min_width
        self.min_height = min_height
        self.min_derivative = min_derivative
        self.restrict_ratio = restrict_max_min_width_height_ratio
        self.smooth_second_derivative = int(smooth_second_derivative)
        self.fix_boundary_derivatives = fix_boundary_derivatives
        self.boundary_log_derivs_fixed_value = None
        if fix_boundary_derivatives > 0.0:
            self.boundary_log_derivs_fixed_value = fixed_log_derivative(
                fix_boundary_derivatives, min_derivative)

        self.mirrored = False
        if self.smooth_second_derivative == 1:
            if k not in (2, 3):
                raise ValueError("smooth 2nd derivative needs 2 or 3 bins")
            if fix_boundary_derivatives > 0.0:
                bd_sub = 3 if k == 2 else 4
            else:
                bd_sub = 1 if k == 2 else 2
            # K = 3 is mirrored: the first width / height stand for the third
            self.mirrored = k == 3
        else:
            bd_sub = 2 if fix_boundary_derivatives > 0.0 else 0
        self.layout = SplineParamLayout(
            k - self.mirrored, fix_first_width_n_height_to_zero,
            also_fix_second_width_to_zero,
            independent_width_height_parametrization)
        self.num_derivative_params = k + 1 - bd_sub
        self.num_params = (self.layout.num_widths + self.layout.num_heights
                           + self.num_derivative_params)

    def param_structure(self):
        return [("widths", self.layout.num_widths),
                ("heights", self.layout.num_heights),
                ("derivatives", self.num_derivative_params)]

    def _unpack(self, params):
        w, h, d = self.layout.unpack(params)
        if self.mirrored:
            w = torch.cat([w, w[:, :1]], dim=1)
            h = torch.cat([h, h[:, :1]], dim=1)
        return w, h, d

    def _spline(self, params, x, log_det, inverse):
        x = torch.clamp(x, self.low, self.high)
        w, h, d = self._unpack(params)
        box = dict(left=self.low, right=self.high, bottom=self.low,
                   top=self.high, rel_min_bin_width=self.min_width,
                   rel_min_bin_height=self.min_height,
                   min_derivative=self.min_derivative,
                   restrict_max_min_width_height_ratio=self.restrict_ratio)
        fixed = self.fix_boundary_derivatives > 0
        if self.smooth_second_derivative == 0:
            if fixed:
                f = torch.full_like(d[:, :1],
                                    self.boundary_log_derivs_fixed_value)
                d = torch.cat([f, d, f], dim=1)
            res, ld = rq_spline(x, w[:, None, :], h[:, None, :],
                                d[:, None, :], inverse=inverse, **box)
        else:
            if fixed:
                d = torch.full(w.shape[:-1] + (2,),
                               self.boundary_log_derivs_fixed_value,
                               dtype=x.dtype, device=x.device)
            res, ld = rq_spline_smooth(x, w[:, None, :], h[:, None, :],
                                       d[:, None, :], inverse=inverse, **box)
        res = torch.clamp(res, self.low, self.high)
        return res, log_det + torch.sum(ld, dim=-1)

    def _forward(self, params, x, log_det):
        return self._spline(params, x, log_det, inverse=False)

    def _inverse(self, params, x, log_det):
        return self._spline(params, x, log_det, inverse=True)

    def default_params(self, rng=None):
        if self.smooth_second_derivative:
            return np.zeros(self.num_params)
        return np.full(self.num_params, 0.54)


class IntervalIdentity(IntervalLayer):
    """Identity interval flow - symbol "z": the base's projection only."""

    def _forward(self, params, x, log_det):
        return x, log_det

    def _inverse(self, params, x, log_det):
        return x, log_det

    def default_params(self, rng=None):
        return np.zeros(0)
