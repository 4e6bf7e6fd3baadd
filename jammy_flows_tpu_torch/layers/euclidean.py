"""Euclidean Gaussianization flow (`g`, and its alias `h`).

PyTorch counterpart of ``GaussianizationFlow`` in
``jammy_flows_tpu/layers/euclidean.py``: classic stretch, householder or no
rotation, optional offset.  This is the per-layer path (f64, or f32 stacks
the whole-block op does not take); eligible f32 stacks run through
``ops/gf_block.py`` instead.  The rq_splines stretch, the other rotation
modes, skewness, center_mean and high_precision_tail_newton raise
``NotImplementedError`` (ROADMAP.md, Queue 1: remaining GF options).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import FlowLayer, split_params
from ..ops import logistic_kde, rotations
from ..ops.inverse import make_inverse_fn
from ..ops.special import log_bounded_exp_fn, width_regulator_fn

_TODO = "(ROADMAP.md, Queue 1: remaining GF options)"
_IFTS = ("isigmoid", "inormal_partly_precise", "inormal_partly_crude",
         "inormal_full_pade")


class EuclideanLayer(FlowLayer):
    """Shared offset handling: [offset (dim) if model_offset] + child."""

    def __init__(self, dimension, model_offset=0):
        super().__init__(dimension)
        self.model_offset = int(model_offset)
        if self.model_offset:
            self.num_params += dimension

    def forward(self, params, x, log_det):
        if self.model_offset:
            offset = params[:, :self.dimension]
            y, log_det = self._forward(params[:, self.dimension:], x, log_det)
            return y + offset, log_det
        return self._forward(params, x, log_det)

    def inverse(self, params, x, log_det):
        if self.model_offset:
            offset = params[:, :self.dimension]
            return self._inverse(params[:, self.dimension:], x - offset,
                                 log_det)
        return self._inverse(params, x, log_det)

    def default_params(self, rng=None):
        rng = rng or np.random.default_rng(0)
        parts = []
        if self.model_offset:
            parts.append(np.full(self.dimension, 0.001))
        parts.append(self._default_params(rng))
        return np.concatenate(parts)

    def _forward(self, params, x, log_det):
        raise NotImplementedError

    def _inverse(self, params, x, log_det):
        raise NotImplementedError

    def _default_params(self, rng):
        raise NotImplementedError


class GaussianizationFlow(EuclideanLayer):
    """Per-dimension logistic-mixture CDF -> inverse-Gaussian-CDF pass,
    followed by a householder rotation."""

    def __init__(self, dimension,
                 nonlinear_stretch_type="classic",
                 num_kde=5,
                 num_householder_iter=-1,
                 fit_normalization=0,
                 inverse_function_type="inormal_partly_precise",
                 model_offset=0,
                 softplus_for_width=0,
                 width_smooth_saturation=1,
                 lower_bound_for_widths=0.01,
                 upper_bound_for_widths=100,
                 lower_bound_for_norms=1,
                 upper_bound_for_norms=10,
                 center_mean=0,
                 clamp_widths=0,
                 regulate_normalization=0,
                 add_skewness=0,
                 rotation_mode="householder",
                 high_precision_tail_newton=0):
        super().__init__(dimension, model_offset=model_offset)
        if nonlinear_stretch_type != "classic":
            raise NotImplementedError(
                f"nonlinear_stretch_type={nonlinear_stretch_type!r} {_TODO}")
        if add_skewness:
            raise NotImplementedError(f"add_skewness {_TODO}")
        if center_mean:
            raise NotImplementedError(f"center_mean {_TODO}")
        if high_precision_tail_newton:
            raise NotImplementedError(f"high_precision_tail_newton {_TODO}")
        if rotation_mode not in ("householder", "none"):
            raise NotImplementedError(f"rotation_mode={rotation_mode!r} {_TODO}")
        if inverse_function_type not in _IFTS:
            raise ValueError(
                f"unknown inverse_function_type {inverse_function_type}")
        self.num_kde = num_kde
        self.inverse_function_type = inverse_function_type
        self.fit_normalization = int(fit_normalization)
        self.regulate_normalization = int(regulate_normalization)
        self.rotation_mode = rotation_mode

        if rotation_mode == "householder":
            it = dimension if num_householder_iter == -1 \
                else num_householder_iter
            self.householder_iter = it
            self.num_rotation_params = it * dimension if it > 0 else 0
        else:
            self.householder_iter = 0
            self.num_rotation_params = 0
        self.num_params += self.num_rotation_params

        self.width_regulator = width_regulator_fn(
            softplus_for_width, width_smooth_saturation,
            lower_bound_for_widths, upper_bound_for_widths, clamp_widths)
        self.norm_regulator = log_bounded_exp_fn(lower_bound_for_norms,
                                                 upper_bound_for_norms)
        # (width_reg, norm_reg|None, fit_norm): the block op's prep spec
        self._kernel_prep = (
            self.width_regulator,
            self.norm_regulator if (fit_normalization
                                    and regulate_normalization) else None,
            bool(fit_normalization))

        bandwidth = (4.0 * math.sqrt(math.pi) / ((math.pi**4) * num_kde))**0.2
        self.init_log_width = math.log(bandwidth)
        kd = num_kde * dimension
        self.num_params += 2 * kd + (kd if self.fit_normalization else 0)

    def _unpack(self, params):
        """(means, log_widths, log_norms) in the (K, D, Bp) layout, and the
        rotation slab."""
        rot = params[:, :self.num_rotation_params]
        rest = params[:, self.num_rotation_params:]
        d, k = self.dimension, self.num_kde
        sizes = [k * d, k * d] + ([k * d] if self.fit_normalization else [])
        parts = split_params(rest, sizes)

        def kdb(block):
            return block.T.reshape(k, d, block.shape[0])

        means = kdb(parts[0])
        log_widths = self.width_regulator(kdb(parts[1]))
        if self.fit_normalization:
            ln_raw = kdb(parts[2])
            log_norms = self.norm_regulator(ln_raw) \
                if self.regulate_normalization else ln_raw
        else:
            log_norms = torch.zeros_like(log_widths)
        return (means, log_widths, log_norms), rot

    def _apply_rotation(self, rot, x, inverse):
        if self.num_rotation_params == 0:
            return x
        vs = rot.reshape(-1, self.householder_iter, self.dimension)
        return rotations.householder_apply(vs, x, inverse=inverse)

    def _forward(self, params, x, log_det):
        """Base -> target: iterative inverse of the gaussianization pass,
        then the rotation."""
        flow_params, rot = self._unpack(params)
        ift = self.inverse_function_type

        def value_fn(xx, p):
            return logistic_kde.gaussianize_value(xx, *p, ift)

        def value_and_grad_fn(xx, p):
            val, log_deriv = logistic_kde.gaussianize_forward(xx, *p, ift)
            return val, torch.exp(log_deriv)

        n_bis, n_newt = (25, 20) if x.dtype == torch.float64 else (18, 8)
        inv = make_inverse_fn(value_fn, value_and_grad_fn, lo=-1e5, hi=1e5,
                              num_bisection_iter=n_bis,
                              num_newton_iter=n_newt)
        res = inv(x, flow_params)
        _, log_deriv = logistic_kde.gaussianize_forward(res, *flow_params, ift)
        log_det = log_det - torch.sum(log_deriv, dim=-1)
        return self._apply_rotation(rot, res, inverse=False), log_det

    def _inverse(self, params, x, log_det):
        """Target -> base: inverse rotation, then the analytic
        gaussianization pass."""
        flow_params, rot = self._unpack(params)
        x = self._apply_rotation(rot, x, inverse=True)
        val, log_deriv = logistic_kde.gaussianize_forward(
            x, *flow_params, self.inverse_function_type)
        return val, log_det + torch.sum(log_deriv, dim=-1)

    def _default_params(self, rng):
        parts = []
        if self.rotation_mode == "householder":
            if self.num_rotation_params > 0:
                parts.append(rng.standard_normal(self.num_rotation_params))
        d, k = self.dimension, self.num_kde
        parts.append(rng.standard_normal(k * d))
        parts.append(np.full(k * d, self.init_log_width))
        if self.fit_normalization:
            parts.append(np.ones(k * d))
        return np.concatenate(parts)
