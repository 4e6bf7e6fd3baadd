"""Euclidean Gaussianization flow (`g`, and its alias `h`).

PyTorch counterpart of ``GaussianizationFlow`` in
``jammy_flows_tpu/layers/euclidean.py``: classic stretch, householder or no
rotation, optional offset, skewness (``add_skewness``) and mean centring
(``center_mean``).  This is the per-layer path (f64, or f32 stacks the
whole-block op does not take); eligible f32 stacks run through
``ops/gf_block.py`` instead.  A float32 layer runs its mixture pass through
``ops/gf_layer.py`` (the per-layer kernels on the card, their plain versions
on the CPU), as the JAX package routes it to its per-layer Pallas kernels;
float64, and skewness with mean centring, run the plain formulation of
``ops/logistic_kde.py``.  The rq_splines stretch, the other rotation modes
and high_precision_tail_newton raise ``NotImplementedError`` (ROADMAP.md,
Queue 1: remaining GF options).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import FlowLayer, split_params
from ..ops import gf_block, gf_layer, logistic_kde, rotations
from ..ops.inverse import make_inverse_fn
from ..ops.lazy_params import LazyParams, materialize_if_lazy
from ..ops.special import log_bounded_exp_fn, width_regulator_fn

_TODO = "(ROADMAP.md, Queue 1: remaining GF options)"
_IFTS = ("isigmoid", "inormal_partly_precise", "inormal_partly_crude",
         "inormal_full_pade")


def _cols(params, lo, hi=None):
    """Parameter columns lo:hi of a (Bp, P) slab or a LazyParams."""
    if isinstance(params, LazyParams):
        return params.rows(lo, hi)
    return params[:, lo:hi]


class EuclideanLayer(FlowLayer):
    """Shared offset handling: [offset (dim) if model_offset] + child."""

    def __init__(self, dimension, model_offset=0):
        super().__init__(dimension)
        self.model_offset = int(model_offset)
        if self.model_offset:
            self.num_params += dimension

    def forward(self, params, x, log_det):
        if self.model_offset:
            offset = materialize_if_lazy(_cols(params, 0, self.dimension))
            y, log_det = self._forward(_cols(params, self.dimension), x,
                                       log_det)
            return y + offset, log_det
        return self._forward(params, x, log_det)

    def inverse(self, params, x, log_det):
        if self.model_offset:
            offset = materialize_if_lazy(_cols(params, 0, self.dimension))
            return self._inverse(_cols(params, self.dimension), x - offset,
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

    accepts_lazy_params = True    # _unpack takes LazyParams rows

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
        if high_precision_tail_newton:
            raise NotImplementedError(f"high_precision_tail_newton {_TODO}")
        if rotation_mode not in ("householder", "none"):
            raise NotImplementedError(f"rotation_mode={rotation_mode!r} {_TODO}")
        if inverse_function_type not in _IFTS:
            raise ValueError(
                f"unknown inverse_function_type {inverse_function_type}")
        self.nonlinear_stretch_type = nonlinear_stretch_type
        self.num_kde = num_kde
        self.inverse_function_type = inverse_function_type
        self.fit_normalization = int(fit_normalization)
        self.regulate_normalization = int(regulate_normalization)
        self.add_skewness = int(add_skewness)
        self.center_mean = int(center_mean)
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
        self.exponent_regulator = log_bounded_exp_fn(0.1, 9.0, center=True)
        # the first num_kde // 2 components skew with sign +1, the rest -1
        signs = tuple([1.0] * (num_kde // 2) + [-1.0] * (num_kde - num_kde // 2))
        # (width_reg, norm_reg|None, fit_norm, exp_reg|None, signs|None): the
        # kernels' prep spec; the last two drive the skewed mixture
        self._kernel_prep = (
            self.width_regulator,
            self.norm_regulator if (fit_normalization
                                    and regulate_normalization) else None,
            bool(fit_normalization),
            self.exponent_regulator if add_skewness else None,
            signs if add_skewness else None)
        self._skew_signs = signs

        bandwidth = (4.0 * math.sqrt(math.pi) / ((math.pi**4) * num_kde))**0.2
        self.init_log_width = math.log(bandwidth)
        kd = num_kde * dimension
        self.num_mean_params = (num_kde - self.center_mean) * dimension
        self.num_params += self.num_mean_params + kd * (
            1 + self.fit_normalization + self.add_skewness)

    def _unpack(self, params):
        """(flow_params, rotation slab, raws).  flow_params: (means,
        log_widths, log_norms[, log_skew, signs]) in the (K, D, Bp) layout,
        or None for lazy rows.  raws: the kernels' raw interface, tagged
        ("raw", (means, lw_raw[, ln_raw][, se_raw])) or ("lazy", hidden, ws,
        bs) (the layer's final MLP rows per group), or None with center_mean
        (its last mean is made from the others)."""
        if isinstance(params, LazyParams):
            lazy = self._unpack_lazy(params)
            if lazy is not None:
                return lazy
            params = params.materialize()
        rot = params[:, :self.num_rotation_params]
        rest = params[:, self.num_rotation_params:]
        d, k = self.dimension, self.num_kde
        sizes = [self.num_mean_params, k * d] + [k * d] * (
            self.fit_normalization + self.add_skewness)
        parts = split_params(rest, sizes)

        def kdb(block, kk):
            return block.T.reshape(kk, d, block.shape[0])

        means = kdb(parts[0], k - self.center_mean)
        lw_raw = kdb(parts[1], k)
        log_widths = self.width_regulator(lw_raw)
        slabs = [means, lw_raw]
        if self.fit_normalization:
            ln_raw = kdb(parts[2], k)
            slabs.append(ln_raw)
            log_norms = self.norm_regulator(ln_raw) \
                if self.regulate_normalization else ln_raw
        else:
            log_norms = torch.zeros_like(log_widths)
        skew = ()
        if self.add_skewness:
            se_raw = kdb(parts[-1], k)
            slabs.append(se_raw)
            signs = torch.tensor(self._skew_signs, dtype=params.dtype,
                                 device=params.device).reshape(-1, 1, 1)
            skew = (self.exponent_regulator(se_raw), signs)
        raws = ("raw", tuple(slabs))
        if self.center_mean:
            # the last mean centres the mixture, from the unnormalized weights
            w = torch.exp(log_norms)
            new_mean = -torch.sum(means * w[:-1], dim=0, keepdim=True) \
                / w[-1:]
            means = torch.cat([means, new_mean], dim=0)
            raws = None
        return (means, log_widths, log_norms) + skew, rot, raws

    def _unpack_lazy(self, params):
        """Lazy rows: the rotation rows materialized (``torch.matmul``), the
        mixture groups kept as (hidden, w rows, b rows) for the kernels; None
        when the layer needs materialized parameters: center_mean, or a
        final hidden width above MAX_KERNEL_H (``euclidean.py:284-290`` of
        the JAX package)."""
        if self.center_mean or params.w.shape[1] > gf_block.MAX_KERNEL_H:
            return None
        nr = self.num_rotation_params
        hidden = params.hidden_act()
        rot = _cols(params, 0, nr).materialize() if nr else \
            torch.zeros((hidden.shape[0], 0), dtype=hidden.dtype,
                        device=hidden.device)
        dk = self.dimension * self.num_kde
        n_groups = 2 + self.fit_normalization + self.add_skewness
        groups = [_cols(params, nr + i * dk, nr + (i + 1) * dk)
                  for i in range(n_groups)]
        return None, rot, ("lazy", hidden, tuple(g.w for g in groups),
                           tuple(g.b for g in groups))

    def _kernel_eligible(self, dtype):
        """float32 runs the per-layer kernel route (``euclidean.py:308-319``
        of the JAX package); skewness with center_mean has no kernel
        interface (the skewed chain runs only on raw or lazy parameters)."""
        return dtype == torch.float32 and not (self.add_skewness
                                               and self.center_mean)

    def _gf_density_pass(self, x, flow_params, raws):
        """(gaussianize(x), log|d/dx|): the lazy, raw or prepared per-layer
        entry point when kernel-eligible, the plain formulation otherwise."""
        ift = self.inverse_function_type
        if self._kernel_eligible(x.dtype):
            if raws is not None and raws[0] == "lazy":
                return gf_layer.gf_forward_lazy(
                    x, *raws[1:], ift, self._kernel_prep,
                    (self.num_kde, self.dimension))
            if raws is not None:
                return gf_layer.gf_forward_raw(x, raws[1], ift,
                                               self._kernel_prep)
            return gf_layer.gf_forward_pallas(x, *flow_params[:3], ift)
        return logistic_kde.gaussianize_forward(x, *flow_params[:3], ift,
                                                *flow_params[3:])

    def _apply_rotation(self, rot, x, inverse):
        if self.num_rotation_params == 0:
            return x
        vs = rot.reshape(-1, self.householder_iter, self.dimension)
        return rotations.householder_apply(vs, x, inverse=inverse)

    def _forward(self, params, x, log_det):
        """Base -> target: the inverse of the gaussianization pass (the
        fused sample entry point on raw or lazy parameters, else a solve
        wrapped in implicit-function gradients), then the rotation."""
        flow_params, rot, raws = self._unpack(params)
        ift = self.inverse_function_type
        solver = None
        if self._kernel_eligible(x.dtype):
            if raws is not None:
                if raws[0] == "lazy":
                    res, log_deriv = gf_layer.gf_sample_lazy(
                        x, *raws[1:], ift, self._kernel_prep,
                        (self.num_kde, self.dimension))
                else:
                    res, log_deriv = gf_layer.gf_sample_raw(
                        x, raws[1], ift, self._kernel_prep)
                log_det = log_det - torch.sum(log_deriv, dim=-1)
                return self._apply_rotation(rot, res, inverse=False), log_det

            def solver(target, p):
                return gf_layer.gf_inverse_pallas(target, *p[:3], ift=ift)

        def value_fn(xx, p):
            return logistic_kde.gaussianize_value(xx, *p[:3], ift, *p[3:])

        def value_and_grad_fn(xx, p):
            val, log_deriv = logistic_kde.gaussianize_forward(
                xx, *p[:3], ift, *p[3:])
            return val, torch.exp(log_deriv)

        n_bis, n_newt = (25, 20) if x.dtype == torch.float64 else (18, 8)
        inv = make_inverse_fn(value_fn, value_and_grad_fn, lo=-1e5, hi=1e5,
                              num_bisection_iter=n_bis,
                              num_newton_iter=n_newt, solver=solver)
        res = inv(x, flow_params)
        _, log_deriv = self._gf_density_pass(res, flow_params, raws)
        log_det = log_det - torch.sum(log_deriv, dim=-1)
        return self._apply_rotation(rot, res, inverse=False), log_det

    def _inverse(self, params, x, log_det):
        """Target -> base: inverse rotation, then the analytic
        gaussianization pass."""
        flow_params, rot, raws = self._unpack(params)
        x = self._apply_rotation(rot, x, inverse=True)
        val, log_deriv = self._gf_density_pass(x, flow_params, raws)
        return val, log_det + torch.sum(log_deriv, dim=-1)

    def _default_params(self, rng):
        parts = []
        if self.rotation_mode == "householder":
            if self.num_rotation_params > 0:
                parts.append(rng.standard_normal(self.num_rotation_params))
        d, k = self.dimension, self.num_kde
        parts.append(rng.standard_normal(self.num_mean_params))
        parts.append(np.full(k * d, self.init_log_width))
        if self.fit_normalization:
            parts.append(np.ones(k * d))
        if self.add_skewness:
            parts.append(np.zeros(k * d))
        return np.concatenate(parts)
