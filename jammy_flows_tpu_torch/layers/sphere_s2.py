"""S2 Fisher-von-Mises scaling flow - symbol `f`.

PyTorch counterpart of ``FisherVonMises2D`` in
``jammy_flows_tpu/layers/sphere_s2.py`` with its default options: a vMF CDF
scaling of z = cos(theta) with a learnt kappa, followed by the base class's
householder rotation, on the (z, phi) column path.  The nested vertical,
circular and correlated spline flows, the kappa-from-rotation predictions and
the extra in-between rotation raise ``NotImplementedError`` (ROADMAP.md,
Queue 1: remaining layers).  The exponential-map flow `v` is not ported
yet.
"""
from __future__ import annotations

import math

import torch

from .sphere import SphereLayer
from ..ops import manifold
from ..ops.special import softplus

_TODO = "is not ported yet (ROADMAP.md, Queue 1: remaining layers)"


def _vmf_log_expm1_2k(kappa):
    """Numerically stable log(e^{2 kappa} - 1)."""
    two_k = 2.0 * kappa
    small = two_k < 0.69
    small_val = torch.log(torch.expm1(torch.where(small, two_k, 0.69)))
    large_val = two_k + torch.log1p(-torch.exp(-torch.where(small, 0.69,
                                                             two_k)))
    return torch.where(small, small_val, large_val)


class FisherVonMises2D(SphereLayer):
    """Parameter layout after the rotation params: [log-kappa (1)]."""

    def __init__(self, dimension=2, euclidean_to_sphere_as_first=0,
                 fisher_parametrization="split",
                 add_vertical_rq_spline_flow=0,
                 add_circular_rq_spline_flow=0,
                 vertical_flow_defs="rr",
                 circular_flow_defs="oo",
                 add_correlated_rq_spline_flow=0,
                 correlated_max_rank=3,
                 inverse_z_scaling=1,
                 spline_num_basis_functions=5,
                 boundary_cos_theta_identity_region=0.0,
                 vertical_smooth=0,
                 vertical_restrict_max_min_width_height_ratio=-1.0,
                 vertical_fix_boundary_derivative=1,
                 vertical_fix_first_width_n_height_to_zero=0,
                 vertical_also_fix_second_width_to_zero=0,
                 vertical_independent_width_height_parametrization=0,
                 circular_add_rotation=0,
                 min_kappa=1e-10,
                 kappa_prediction="direct_log_real_bounded",
                 add_extra_rotation_inbetween=0,
                 kappa_clamping=0,
                 add_rotation=1,
                 rotation_mode="householder",
                 num_householder_iter=-1, **kwargs):
        super().__init__(2, euclidean_to_sphere_as_first, add_rotation,
                         rotation_mode=rotation_mode,
                         num_householder_iter=num_householder_iter, **kwargs)
        if fisher_parametrization != "split":
            raise ValueError("only the 'split' fisher parametrization exists")
        for flag, name in ((add_vertical_rq_spline_flow, "vertical spline flow"),
                           (add_circular_rq_spline_flow, "circular spline flow"),
                           (add_correlated_rq_spline_flow,
                            "correlated spline flow"),
                           (add_extra_rotation_inbetween,
                            "add_extra_rotation_inbetween")):
            if flag:
                raise NotImplementedError(f"`f` option {name} {_TODO}")
        if kappa_prediction not in ("direct_log_real_bounded",
                                    "softplus_real_bounded", "log_bounded"):
            raise NotImplementedError(
                f"kappa_prediction={kappa_prediction!r} {_TODO}")
        self.z_scaling_factor = -1.0 if inverse_z_scaling else 1.0
        self.min_kappa = min_kappa
        self.kappa_prediction = kappa_prediction
        self.kappa_clamping = int(kappa_clamping)
        self.num_params += 1

    def _kappa_cols(self, slab):
        x = slab[0]
        if self.kappa_prediction == "direct_log_real_bounded":
            if self.kappa_clamping:
                x = torch.clamp(x, min=-5.0)
            return torch.exp(x) + self.min_kappa
        if self.kappa_prediction == "softplus_real_bounded":
            if self.kappa_clamping:
                x = torch.clamp(x, min=-5.0)
            return softplus(x) + self.min_kappa
        sp = softplus(x)
        if self.kappa_clamping:
            sp = torch.clamp(sp, min=-5.0)
        return torch.exp(sp + math.log(self.min_kappa))

    def _vmf_z_inverse_cols(self, z, kappa, log_det):
        """Density-direction z transform + log-det."""
        s = self.z_scaling_factor
        small = kappa < (1e-8 if z.dtype == torch.float64 else 1e-4)
        kappa_safe = torch.where(small, 1.0, kappa)
        safe_part = _vmf_log_expm1_2k(kappa_safe)
        ld_update = (torch.log(2.0 * kappa_safe) + kappa_safe * (s * z + 1.0)
                     - safe_part)
        ret = s * ((1.0 + torch.exp(-2.0 * kappa_safe)
                    - 2.0 * torch.exp(kappa_safe * (s * z - 1.0)))
                   / (-1.0 + torch.exp(-2.0 * kappa_safe)))
        ret = torch.where(small, z, ret)
        ld_update = torch.where(small, 0.0, ld_update)
        return ret, log_det + ld_update

    def _vmf_z_forward_cols(self, z, kappa, log_det):
        """Sampling-direction z transform + log-det."""
        s = self.z_scaling_factor
        small = kappa < (1e-8 if z.dtype == torch.float64 else 1e-4)
        kappa_safe = torch.where(small, 1.0, kappa)
        ld_update = -torch.log(kappa_safe * s * z
                               + kappa_safe / torch.tanh(kappa_safe))
        ret = s * (1.0 + (1.0 / kappa_safe) * torch.log(
            0.5 * (1.0 + s * z)
            + (0.5 - 0.5 * s * z) * torch.exp(-2.0 * kappa_safe)))
        ret = torch.where(small, z, ret)
        ld_update = torch.where(small, 0.0, ld_update)
        return ret, log_det + ld_update

    def _inverse_cols_z(self, slab, cols, log_det):
        z, angle = cols
        z, log_det = self._vmf_z_inverse_cols(z, self._kappa_cols(slab),
                                              log_det)
        # the JAX package clamps twice (around its nested flows); a clamp
        # is idempotent, so one suffices without them
        return (manifold.safe_costheta(z), angle), log_det

    def _forward_cols_z(self, slab, cols, log_det):
        z, angle = cols
        z, log_det = self._vmf_z_forward_cols(z, self._kappa_cols(slab),
                                              log_det)
        return (manifold.safe_costheta(z), angle), log_det

    def _default_params(self, rng):
        return rng.standard_normal(1) - 3.0
