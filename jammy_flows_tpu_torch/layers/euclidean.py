"""Euclidean flow layers: the Gaussianization flow (`g`, and its alias
`h`), the affine flow (`t`) and the identity (`x`).

PyTorch counterpart of ``jammy_flows_tpu/layers/euclidean.py``.
``GaussianizationFlow`` takes every option of the JAX package: the classic
or the rq_splines stretch; householder, angles, cayley (two dimensions),
triangular_combination or no rotation; offset, skewness (``add_skewness``),
mean centring (``center_mean``) and ``high_precision_tail_newton``.  This is
the per-layer path (f64, or f32 stacks the whole-block op does not take);
eligible f32 stacks run through ``ops/gf_block.py`` instead.  A float32
classic layer runs its mixture pass through ``ops/gf_layer.py`` (the
per-layer kernels on the card, their plain versions on the CPU), as the JAX
package routes it to its per-layer Pallas kernels, whatever its rotation;
float64, skewness with mean centring, and the rq_splines stretch run plain
PyTorch (``ops/logistic_kde.py``, ``ops/splines.py``), as there.

``high_precision_tail_newton`` (n > 0) refines a float32 sampling solve by
n Newton steps of the mixture pass in float64, then takes the density pass
at the refined root.  The JAX package refines only when ``jax_enable_x64``
is on, and skips it silently without (the default on a TPU); torch always
has float64, so the port refines every float32 input: here alone the port
does not follow a JAX session without x64.  A skewed layer's density pass
at the refined root keeps the skew (the raw interface, ``gf_forward_raw``);
the JAX package takes the 3-parameter prepared pass there and loses it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import FlowLayer, named_parts, split_params
from ..ops import gf_block, gf_layer, logistic_kde, matrix, rotations
from ..ops.inverse import make_inverse_fn
from ..ops.lazy_params import LazyParams, materialize_if_lazy
from ..ops.special import log_bounded_exp_fn, width_regulator_fn
from ..ops.splines import rq_spline_linear_ext

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

    def param_structure(self):
        parts = [("offset", self.dimension)] if self.model_offset else []
        return named_parts(self, parts + self._child_param_structure())

    def _child_param_structure(self):
        rest = self.num_params - self.model_offset * self.dimension
        return [("params", rest)] if rest else []

    def _forward(self, params, x, log_det):
        raise NotImplementedError

    def _inverse(self, params, x, log_det):
        raise NotImplementedError

    def _default_params(self, rng):
        raise NotImplementedError


def _rotation_param_count(mode, dim, num_householder_iter):
    """(rotation parameters, householder reflections) of a rotation mode
    (``euclidean.py:83-98`` of the JAX package)."""
    if mode == "householder":
        it = dim if num_householder_iter == -1 else num_householder_iter
        return (it * dim if it > 0 else 0), it
    if mode == "triangular_combination":
        return (dim - 1 + dim * (dim - 1) if dim > 1 else 0), 0
    if mode == "angles":
        return (dim * (dim - 1) // 2 if dim > 1 else 0), 0
    if mode == "cayley":
        if dim > 2:
            raise ValueError("the cayley rotation needs 2 dimensions")
        return (1 if dim == 2 else 0), 0
    if mode == "none":
        return 0, 0
    raise ValueError(f"unknown rotation mode {mode}")


class GaussianizationFlow(EuclideanLayer):
    """Per-dimension stretch (a logistic-mixture CDF -> inverse-Gaussian-CDF
    pass, or an RQ spline with linear tails), followed by a rotation."""

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
        if nonlinear_stretch_type not in ("classic", "rq_splines"):
            raise ValueError(
                f"unknown stretch type {nonlinear_stretch_type}")
        if inverse_function_type not in _IFTS:
            raise ValueError(
                f"unknown inverse_function_type {inverse_function_type}")
        self.hp_tail_newton = int(high_precision_tail_newton)
        self.nonlinear_stretch_type = nonlinear_stretch_type
        self.num_kde = num_kde
        self.inverse_function_type = inverse_function_type
        self.fit_normalization = int(fit_normalization)
        self.regulate_normalization = int(regulate_normalization)
        self.add_skewness = int(add_skewness)
        self.center_mean = int(center_mean)
        self.rotation_mode = rotation_mode
        self.num_rotation_params, self.householder_iter = \
            _rotation_param_count(rotation_mode, dimension,
                                  num_householder_iter)
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
        if nonlinear_stretch_type == "classic":
            self.num_mean_params = (num_kde - self.center_mean) * dimension
            self.num_params += self.num_mean_params + kd * (
                1 + self.fit_normalization + self.add_skewness)
        else:
            self.num_params += 2 * kd + (num_kde + 1) * dimension \
                + 4 * dimension

    def _unpack(self, params):
        """(flow_params, rotation slab, raws).  Classic stretch:
        flow_params (means, log_widths, log_norms[, log_skew, signs]) in the
        (K, D, Bp) layout, or None for lazy rows; raws the kernels' raw
        interface, tagged ("raw", (means, lw_raw[, ln_raw][, se_raw])) or
        ("lazy", hidden, ws, bs) (the layer's final MLP rows per group), or
        None with center_mean (its last mean is made from the others).
        rq_splines: flow_params (widths, heights, derivatives (Bp, D, K[+1]),
        left, right, bottom, top (Bp, D)), raws None."""
        if isinstance(params, LazyParams):
            lazy = self._unpack_lazy(params)
            if lazy is not None:
                return lazy
            params = params.materialize()
        rot = params[:, :self.num_rotation_params]
        rest = params[:, self.num_rotation_params:]
        d, k = self.dimension, self.num_kde
        if self.nonlinear_stretch_type == "rq_splines":
            lw, lh, ld_, bp = split_params(rest, [d * k, d * k, d * (k + 1),
                                                  d * 4])
            bp = bp.reshape(-1, d, 4)
            min_abs_width = 0.5
            left, bottom = bp[..., 0], bp[..., 2]
            right = left + torch.exp(bp[..., 1]) + min_abs_width
            top = bottom + torch.exp(bp[..., 3]) + min_abs_width
            return (lw.reshape(-1, d, k), lh.reshape(-1, d, k),
                    ld_.reshape(-1, d, k + 1), left, right, bottom, top), \
                rot, None
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
        when the layer needs materialized parameters: the rq_splines
        stretch, center_mean, tail Newton, or a final hidden width above
        MAX_KERNEL_H (``euclidean.py:284-290`` of the JAX package)."""
        if (self.nonlinear_stretch_type != "classic" or self.center_mean
                or self.hp_tail_newton
                or params.w.shape[1] > gf_block.MAX_KERNEL_H):
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
        entry point when kernel-eligible, the plain formulation otherwise.
        The prepared interface has no skew: a skewed mixture always brings
        its raw slabs here."""
        ift = self.inverse_function_type
        if self._kernel_eligible(x.dtype):
            if raws is not None and raws[0] == "lazy":
                return gf_layer.gf_forward_lazy(
                    x, *raws[1:], ift, self._kernel_prep,
                    (self.num_kde, self.dimension))
            if raws is not None:
                return gf_layer.gf_forward_raw(x, raws[1], ift,
                                               self._kernel_prep)
            if self.add_skewness:
                raise ValueError("a skewed mixture's density pass needs its "
                                 "raw slabs")
            return gf_layer.gf_forward_pallas(x, *flow_params[:3], ift)
        return logistic_kde.gaussianize_forward(x, *flow_params[:3], ift,
                                                *flow_params[3:])

    def _apply_rotation(self, rot, x, inverse):
        """The rotation (its transpose or inverse when ``inverse``) of each
        row of x; rot is the (Bp, num_rotation_params) slab."""
        if self.num_rotation_params == 0:
            return x
        d = self.dimension
        if self.rotation_mode == "householder":
            vs = rot.reshape(-1, self.householder_iter, d)
            return rotations.householder_apply(vs, x, inverse=inverse)
        if self.rotation_mode == "triangular_combination":
            n_tri = d * (d - 1) // 2
            return matrix.triangular_combination_apply(
                d, rot[:, :n_tri], rot[:, n_tri:n_tri + d - 1],
                rot[:, n_tri + d - 1:2 * n_tri + d - 1], x, inverse=inverse)
        mat = rotations.givens_matrix(rot, d) \
            if self.rotation_mode == "angles" else rotations.cayley_matrix(rot)
        return rotations.apply_rotation(mat, x, inverse=inverse)

    def _forward(self, params, x, log_det):
        """Base -> target: the inverse of the stretch, then the rotation.
        Classic stretch: the fused sample entry point on raw or lazy
        parameters, else a solve wrapped in implicit-function gradients
        (tail-refined with ``high_precision_tail_newton``) and the density
        pass at its root."""
        flow_params, rot, raws = self._unpack(params)
        if self.nonlinear_stretch_type == "rq_splines":
            res, log_deriv = rq_spline_linear_ext(x, *flow_params,
                                                  inverse=True)
            log_det = log_det + torch.sum(log_deriv, dim=-1)
            return self._apply_rotation(rot, res, inverse=False), log_det
        ift = self.inverse_function_type
        solver = None
        if self._kernel_eligible(x.dtype):
            if raws is not None and not self.hp_tail_newton:
                if raws[0] == "lazy":
                    res, log_deriv = gf_layer.gf_sample_lazy(
                        x, *raws[1:], ift, self._kernel_prep,
                        (self.num_kde, self.dimension))
                else:
                    res, log_deriv = gf_layer.gf_sample_raw(
                        x, raws[1], ift, self._kernel_prep)
                log_det = log_det - torch.sum(log_deriv, dim=-1)
                return self._apply_rotation(rot, res, inverse=False), log_det
            if not self.add_skewness:
                # the prepared solve kernel, and the prepared density pass
                # at its (tail-refined) root, as in the JAX package; a
                # skewed mixture keeps its raw slabs for that pass
                raws = None

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
        res = self._tail_refine(inv(x, flow_params), x, flow_params)
        _, log_deriv = self._gf_density_pass(res, flow_params, raws)
        log_det = log_det - torch.sum(log_deriv, dim=-1)
        return self._apply_rotation(rot, res, inverse=False), log_det

    def _tail_refine(self, res, target, flow_params):
        """``high_precision_tail_newton`` Newton steps of the mixture pass in
        float64 from a float32 root (``_maybe_tail_refine``, JAX
        ``euclidean.py:446-468``), differentiated by plain autograd of the
        steps; float64 inputs and n = 0 return the root as it is."""
        if not self.hp_tail_newton or target.dtype != torch.float32:
            return res
        ps = [p.double() for p in flow_params]
        r, t = res.double(), target.double()
        for _ in range(self.hp_tail_newton):
            val, logd = logistic_kde.gaussianize_forward(
                r, *ps[:3], self.inverse_function_type, *ps[3:])
            r = r - (val - t) * torch.exp(-logd)
        return r.to(target.dtype)

    def _inverse(self, params, x, log_det):
        """Target -> base: inverse rotation, then the analytic stretch."""
        flow_params, rot, raws = self._unpack(params)
        x = self._apply_rotation(rot, x, inverse=True)
        if self.nonlinear_stretch_type == "rq_splines":
            val, log_deriv = rq_spline_linear_ext(x, *flow_params,
                                                  inverse=False)
        else:
            val, log_deriv = self._gf_density_pass(x, flow_params, raws)
        return val, log_det + torch.sum(log_deriv, dim=-1)

    def _child_param_structure(self):
        """The reference's names: the rotation ("vs", "anglepars",
        "cayleypars", "trianglepars"), "means", "log_widths", "log_norms",
        "exponents"; the rq_splines stretch's "log_heights",
        "log_derivatives", "boundary_points"."""
        rot_name = {"householder": "vs", "angles": "anglepars",
                    "cayley": "cayleypars",
                    "triangular_combination": "trianglepars",
                    "none": "rotation"}[self.rotation_mode]
        parts = []
        if self.num_rotation_params:
            parts.append((rot_name, self.num_rotation_params))
        d, k = self.dimension, self.num_kde
        if self.nonlinear_stretch_type == "classic":
            parts.append(("means", self.num_mean_params))
            parts.append(("log_widths", k * d))
            if self.fit_normalization:
                parts.append(("log_norms", k * d))
            if self.add_skewness:
                parts.append(("exponents", k * d))
        else:
            parts += [("log_widths", d * k), ("log_heights", d * k),
                      ("log_derivatives", d * (k + 1)),
                      ("boundary_points", d * 4)]
        return parts

    def _default_params(self, rng):
        """``euclidean.py:512-532`` of the JAX package: random householder
        vectors, zeros for the other rotations."""
        parts = []
        if self.rotation_mode == "householder":
            if self.num_rotation_params > 0:
                parts.append(rng.standard_normal(self.num_rotation_params))
        else:
            parts.append(np.zeros(self.num_rotation_params))
        d, k = self.dimension, self.num_kde
        if self.nonlinear_stretch_type == "rq_splines":
            parts += [np.ones(k * d), np.ones(k * d),
                      np.full((k + 1) * d, 0.54135),    # softplus^-1(1)
                      np.tile(np.array([-1.0, 1.0, -1.0, 1.0]), d)]
            return np.concatenate(parts)
        parts.append(rng.standard_normal(self.num_mean_params))
        parts.append(np.full(k * d, self.init_log_width))
        if self.fit_normalization:
            parts.append(np.ones(k * d))
        if self.add_skewness:
            parts.append(np.zeros(k * d))
        return np.concatenate(parts)


_COV_TYPES = ("identity", "diagonal_symmetric", "diagonal", "full")


class MultivariateNormal(EuclideanLayer):
    """The affine flow `t`: x -> L x with L lower triangular of positive
    diagonal: the identity, one shared scale, a diagonal, or full
    (``euclidean.py:535-601`` of the JAX package)."""

    def __init__(self, dimension, cov_type="full", model_offset=0,
                 width_smooth_saturation=1, lower_bound_for_widths=0.01,
                 upper_bound_for_widths=100, softplus_for_width=0,
                 clamp_widths=0):
        super().__init__(dimension, model_offset=model_offset)
        if cov_type not in _COV_TYPES:
            raise ValueError(f"unknown cov_type {cov_type}")
        self.cov_type = cov_type
        self.make_log_positive = width_regulator_fn(
            softplus_for_width, width_smooth_saturation,
            lower_bound_for_widths, upper_bound_for_widths, clamp_widths)
        self.num_cov_params = {
            "identity": 0, "diagonal_symmetric": 1, "diagonal": dimension,
            "full": dimension + dimension * (dimension - 1) // 2}[cov_type]
        self.num_params += self.num_cov_params

    def _unpack(self, params):
        """(single_log_diag, full_log_diag, off_diag) of
        ``matrix.triangular_apply``."""
        d = self.dimension
        if self.cov_type == "diagonal_symmetric":
            return (self.make_log_positive(params[:, :1]), None, None)
        if self.cov_type == "diagonal":
            return (None, self.make_log_positive(params[:, :d]), None)
        return (None, self.make_log_positive(params[:, :d]), params[:, d:])

    def _apply(self, params, x, log_det, inverse):
        if self.cov_type == "identity":
            return x, log_det
        res, ld = matrix.triangular_apply(self.dimension, self.cov_type,
                                          self._unpack(params), x,
                                          inverse=inverse)
        return res, log_det + ld

    def _forward(self, params, x, log_det):
        return self._apply(params, x, log_det, inverse=False)

    def _inverse(self, params, x, log_det):
        return self._apply(params, x, log_det, inverse=True)

    def _child_param_structure(self):
        """The reference's names, "lower_trinagular_entries" spelling
        included."""
        d = self.dimension
        return {"identity": [],
                "diagonal_symmetric": [("log_diagonal_symmetric", 1)],
                "diagonal": [("log_diagonal", d)],
                "full": [("log_diagonal", d),
                         ("lower_trinagular_entries", d * (d - 1) // 2)]}[
                             self.cov_type]

    def _default_params(self, rng):
        return np.zeros(self.num_cov_params)


class EuclideanIdentity(EuclideanLayer):
    """The identity flow `x`, with an offset when ``add_offset``
    (``euclidean.py:604-617`` of the JAX package)."""

    def __init__(self, dimension, add_offset=0, model_offset=0):
        super().__init__(dimension,
                         model_offset=1 if (add_offset or model_offset) else 0)

    def _forward(self, params, x, log_det):
        return x, log_det

    def _inverse(self, params, x, log_det):
        return x, log_det

    def _default_params(self, rng):
        return np.zeros(0)
