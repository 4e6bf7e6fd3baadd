"""S2 flow layers: the Fisher-von-Mises scaling flow (`f`) and the
exponential-map flow (`v`).

PyTorch counterpart of ``FisherVonMises2D`` and ``ExponentialMapS2`` in
``jammy_flows_tpu/layers/sphere_s2.py``.  Neither package has a kernel for
this math: it is plain PyTorch on (B,) columns.  A layer runs on the (z =
cos(theta), phi) carrier where the JAX package has a column form, else on
(theta, phi) rows (layers/sphere.py):

* `f`: a vMF CDF scaling of z with a learnt kappa (or kappa from the xyz /
  quaternion rotation parameters), around optional nested passthrough pdfs
  (vertical interval splines on z, circular splines on phi scaled off at the
  poles, or one correlated `i1+s1` pdf), an identity region near the poles
  and a fixed 90-degree rotation between the scaling and the nested flows;
  the correlated pdf and the in-between rotation run on rows only, as in the
  JAX package.
* `v`: phi(x) = exp_x of the tangent part of the gradient of a convex
  potential (linear, quadratic, exponential, or RQ splines of x . mu);
  its log-det is 0.5 log det(P^T P) with P the Jacobian on a tangent basis,
  from two directional derivatives computed alongside phi (forward mode by
  hand, so that training differentiates the log-det by reverse mode), and
  its non-analytic direction is the sphere-Newton solve of ops/inverse.py.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .sphere import SphereLayer
from ..ops import manifold
from ..ops.inverse import make_sphere_inverse_fn
from ..ops.special import softplus
from ..ops.splines import rq_spline_bins, rq_spline_on_bins


# ---------------------------------------------------------------------------
# Fisher-von-Mises 2-D flow - symbol "f"
# ---------------------------------------------------------------------------

def _azimuthal_flow_scaling(cos_theta):
    """C^2-smooth scaling in [0, 1]: 1 at the equator, 0 at both poles; it
    switches the azimuthal spline flow off near the poles."""
    c = cos_theta
    neg = 6 * c**5 + 15 * c**4 + 10 * c**3 + 1.0
    pos = -6 * c**5 + 15 * c**4 - 10 * c**3 + 1.0
    return torch.where(c <= 0, neg, pos)


def _vmf_log_expm1_2k(kappa):
    """Numerically stable log(e^{2 kappa} - 1)."""
    two_k = 2.0 * kappa
    small = two_k < 0.69
    small_val = torch.log(torch.expm1(torch.where(small, two_k, 0.69)))
    large_val = two_k + torch.log1p(-torch.exp(-torch.where(small, 0.69,
                                                             two_k)))
    return torch.where(small, small_val, large_val)


KAPPA_PARAM = ("direct_log_real_bounded", "softplus_real_bounded",
               "log_bounded")


class FisherVonMises2D(SphereLayer):
    """Parameter layout after the rotation params: [log-kappa (0 / 1)] +
    [the correlated pdf's slab | the vertical pdf's, then the circular
    pdf's].  The nested flows are ``amortize_everything`` passthrough pdfs
    on this layer's device, fed their part of the slab row by row."""

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
                 num_householder_iter=-1, device=None, **kwargs):
        super().__init__(2, euclidean_to_sphere_as_first, add_rotation,
                         rotation_mode=rotation_mode,
                         num_householder_iter=num_householder_iter, **kwargs)
        if fisher_parametrization != "split":
            raise ValueError("only the 'split' fisher parametrization exists")
        self.z_scaling_factor = -1.0 if inverse_z_scaling else 1.0
        self.min_kappa = min_kappa
        self.kappa_prediction = kappa_prediction
        self.kappa_clamping = int(kappa_clamping)
        self.boundary = float(boundary_cos_theta_identity_region)
        self.add_extra_rotation_inbetween = int(add_extra_rotation_inbetween)
        self.has_kappa_param = kappa_prediction in KAPPA_PARAM
        needs = {"mu": "xyz", "mu_squared": "xyz", "quatvec": "quaternion",
                 "quatvec_squared": "quaternion"}.get(kappa_prediction)
        if needs and not (self.add_rotation and rotation_mode == needs):
            raise ValueError(f"kappa_prediction={kappa_prediction!r} needs "
                             f"add_rotation with rotation_mode={needs!r}")
        self.num_kappa_params = int(self.has_kappa_param)
        self.num_params += self.num_kappa_params

        self.add_vertical = int(add_vertical_rq_spline_flow)
        self.add_circular = int(add_circular_rq_spline_flow)
        self.add_correlated = int(add_correlated_rq_spline_flow)
        from ..models.pdf import PDF   # deferred: pdf imports the layers

        interval_def = "i1_-%.2f_%.2f" % (1.0 - self.boundary,
                                          1.0 - self.boundary)
        nested = dict(amortize_everything=True,
                      amortization_mlp_use_custom_mode=True,
                      use_as_passthrough_instead_of_pdf=True, device=device)
        pins = {"fix_first_width_n_height_to_zero":
                vertical_fix_first_width_n_height_to_zero,
                "also_fix_second_width_to_zero":
                vertical_also_fix_second_width_to_zero,
                "independent_width_height_parametrization":
                vertical_independent_width_height_parametrization}
        self.vertical_flow = None
        self.circular_flow = None
        self.correlated_flow = None
        if self.add_correlated:
            if self.add_vertical or self.add_circular:
                raise ValueError("the correlated spline flow replaces the "
                                 "vertical and circular ones")
            self.correlated_flow = PDF(
                interval_def + "+s1",
                vertical_flow_defs + "+" + circular_flow_defs,
                amortization_mlp_dims="64",
                amortization_mlp_ranks=correlated_max_rank, **nested)
        if self.add_vertical:
            r_opts = dict(
                pins, smooth_second_derivative=vertical_smooth,
                fix_boundary_derivatives=(
                    -1.0 if vertical_fix_boundary_derivative == 0 else 1.0),
                restrict_max_min_width_height_ratio=(
                    vertical_restrict_max_min_width_height_ratio))
            overrides = {"r": r_opts}
            if spline_num_basis_functions == -1:
                # 2 and 3 bins in turn (smooth splines only)
                if vertical_smooth != 1:
                    raise ValueError("spline_num_basis_functions=-1 needs "
                                     "vertical_smooth=1")
                for i in range(len(vertical_flow_defs)):
                    overrides[(0, i)] = {"r": dict(
                        r_opts, num_basis_functions=2 if i % 2 == 0 else 3)}
            else:
                r_opts["num_basis_functions"] = spline_num_basis_functions
            self.vertical_flow = PDF(interval_def, vertical_flow_defs,
                                     options_overwrite=overrides, **nested)
        if self.add_circular:
            # without S1 rotations (pole complications) the circular flow
            # has no rotation parameters, which the pole scaling would
            # leave alone: it scales the whole slab
            if circular_add_rotation != 0:
                raise ValueError("the circular spline flow takes no S1 "
                                 "rotation (pole complications)")
            self.circular_flow = PDF("s1", circular_flow_defs,
                                     options_overwrite={"o": dict(
                                         pins, num_basis_functions=2,
                                         smooth_second_derivative=1,
                                         add_rotation=0)},
                                     **nested)
        self.total_num_correlated, self.total_num_vertical, \
            self.total_num_circular = (
                0 if f is None else f.total_number_amortizable_params
                for f in (self.correlated_flow, self.vertical_flow,
                          self.circular_flow))
        self.num_params += (self.total_num_correlated + self.total_num_vertical
                            + self.total_num_circular)

    # -- kappa and the nested slabs ----------------------------------------
    def _kappa(self, child, rot):
        """(Bp,) kappa from the child (Bp, P) and rotation (Bp, R) slabs."""
        if self.has_kappa_param:
            x = child[:, 0]
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
        vec = rot if self.kappa_prediction.startswith("mu") else rot[:, 1:]
        sq = torch.sum(vec**2, dim=-1)
        return sq if self.kappa_prediction.endswith("_squared") \
            else torch.sqrt(sq)

    def _split_nested(self, child):
        """(correlated, vertical, circular) columns of the child slab, or
        None each."""
        off = self.num_kappa_params
        parts = []
        for n in (self.total_num_correlated, self.total_num_vertical,
                  self.total_num_circular):
            parts.append(child[:, off:off + n] if n else None)
            off += n
        return parts

    @staticmethod
    def _scaled_circular(circ, z):
        """The circular slab scaled by the pole polynomial of z: per row (B,
        n), even when shared (Bp = 1)."""
        return circ * _azimuthal_flow_scaling(z)[:, None]

    # -- the kappa z-transform ---------------------------------------------
    def _vmf_z_inverse(self, z, kappa, log_det):
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

    def _vmf_z_forward(self, z, kappa, log_det):
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

    # -- nested flows, identity region, in-between rotation ----------------
    def _contained(self, z):
        """Rows inside the non-identity region |z| < 1 - boundary, or None
        without an identity region."""
        if self.boundary == 0.0:
            return None
        b = self.boundary
        return (z > (-1.0 + b)) & (z < (1.0 - b))

    def _nested(self, flow, x, log_det, amort, forward, contained):
        """A nested passthrough pdf on rows x (B, n); the identity outside
        the region ``contained``."""
        run = flow.all_layer_forward if forward else flow.all_layer_inverse
        y, dld = run({}, x, torch.zeros_like(log_det), None,
                     amortization_parameters=amort)
        if contained is None:
            return y, log_det + dld
        return torch.where(contained[:, None], y, x), \
            log_det + torch.where(contained, dld, 0.0)

    @staticmethod
    def _extra_inbetween_rotation(z, angle, log_det, inverse):
        """The fixed 90-degree rotation about y (its transpose when
        ``inverse``), through (theta, phi) with their log(sin) terms."""
        theta = torch.arccos(manifold.safe_costheta(z))
        log_det = log_det - torch.log(torch.sin(
            manifold.safe_angle_within_pi(theta)))
        x, y, zz, log_det = manifold.spherical_to_eucl_cols(theta, angle,
                                                            log_det)
        e = (-zz, y, x) if inverse else (zz, y, -x)
        theta, angle, log_det = manifold.eucl_to_spherical_cols(*e, log_det)
        log_det = log_det + torch.log(torch.sin(
            manifold.safe_angle_within_pi(theta)))
        return torch.cos(theta), angle, log_det

    def _nested_flows(self, child, z, angle, log_det, forward):
        """The nested flows on the z and phi columns: vertical then circular
        forward, circular then vertical inverse, or the correlated pdf; the
        identity region is taken from z before them."""
        corr, vert, circ = self._split_nested(child)
        contained = self._contained(z)
        if corr is not None:
            comb, log_det = self._nested(self.correlated_flow,
                                         torch.stack([z, angle], dim=1),
                                         log_det, corr, forward, contained)
            return comb[:, 0], comb[:, 1], log_det

        def vertical(z, log_det):
            if vert is None:
                return z, log_det
            z, log_det = self._nested(self.vertical_flow, z[:, None],
                                      log_det, vert, forward, contained)
            return z[:, 0], log_det

        def circular(angle, log_det):
            if circ is None:
                return angle, log_det
            angle, log_det = self._nested(
                self.circular_flow, angle[:, None], log_det,
                self._scaled_circular(circ, z), forward, contained)
            return angle[:, 0], log_det

        if forward:
            z, log_det = vertical(z, log_det)
            angle, log_det = circular(angle, log_det)
        else:
            angle, log_det = circular(angle, log_det)
            z, log_det = vertical(z, log_det)
        return z, angle, log_det

    # -- the map on (z, phi) columns, shared by rows and the carrier -------
    def _z_inverse(self, child, rot, z, angle, log_det):
        z, log_det = self._vmf_z_inverse(z, self._kappa(child, rot), log_det)
        z = manifold.safe_costheta(z)
        if self.add_extra_rotation_inbetween:
            z, angle, log_det = self._extra_inbetween_rotation(
                z, angle, log_det, inverse=True)
        z, angle, log_det = self._nested_flows(child, z, angle, log_det,
                                               forward=False)
        return manifold.safe_costheta(z), angle, log_det

    def _z_forward(self, child, rot, z, angle, log_det):
        z, angle, log_det = self._nested_flows(child, z, angle, log_det,
                                               forward=True)
        if self.add_extra_rotation_inbetween:
            z, angle, log_det = self._extra_inbetween_rotation(
                z, angle, log_det, inverse=False)
        z, log_det = self._vmf_z_forward(z, self._kappa(child, rot), log_det)
        return manifold.safe_costheta(z), angle, log_det

    # -- rows -----------------------------------------------------------------
    def _rows(self, child, x, log_det, rot, core):
        if self.always_parametrize_in_embedding_space:
            x, log_det = manifold.eucl_to_spherical(x, log_det)
        z = torch.cos(x[:, 0])
        log_det = log_det + torch.log(torch.sin(
            manifold.safe_angle_within_pi(x[:, 0])))
        z, angle, log_det = core(child, rot, z, x[:, 1], log_det)
        theta = torch.arccos(z)
        log_det = log_det - torch.log(torch.sin(
            manifold.safe_angle_within_pi(theta)))
        ret = torch.stack([theta, angle], dim=1)
        if self.always_parametrize_in_embedding_space:
            return manifold.spherical_to_eucl(ret, log_det)
        return ret, log_det

    def _forward(self, child, x, log_det, rot):
        return self._rows(child, x, log_det, rot, self._z_forward)

    def _inverse(self, child, x, log_det, rot):
        return self._rows(child, x, log_det, rot, self._z_inverse)

    # -- the (z, phi) carrier ---------------------------------------------
    def supports_zphi(self):
        return not (self.always_parametrize_in_embedding_space
                    or self.add_correlated or self.add_extra_rotation_inbetween)

    def _forward_cols_z(self, child_slab, cols, log_det, rot_slab):
        z, angle, log_det = self._z_forward(child_slab.T, rot_slab.T, *cols,
                                            log_det)
        return (z, angle), log_det

    def _inverse_cols_z(self, child_slab, cols, log_det, rot_slab):
        z, angle, log_det = self._z_inverse(child_slab.T, rot_slab.T, *cols,
                                            log_det)
        return (z, angle), log_det

    def _child_param_structure(self):
        """The reference's names (each nested flow's whole amortization
        slab under one)."""
        parts = []
        if self.num_kappa_params:
            parts.append(("loglike_kappa", self.num_kappa_params))
        if self.add_correlated:
            parts.append(("correlated_params", self.total_num_correlated))
        else:
            if self.add_vertical:
                parts.append(("vertical_params", self.total_num_vertical))
            if self.add_circular:
                parts.append(("circular_params", self.total_num_circular))
        return parts

    def _default_params(self, rng):
        parts = []
        if self.has_kappa_param:
            parts.append(rng.standard_normal(1) - 3.0)
        # the nested flows' whole amortization slabs (with the correlated
        # pdf's MLP), not just their layers' parameters
        for flow in (self.correlated_flow, self.vertical_flow,
                     self.circular_flow):
            if flow is not None:
                parts.append(flow.default_amortization_params(rng))
        return np.concatenate(parts) if parts else np.zeros(0)


# ---------------------------------------------------------------------------
# Exponential-map S2 flow - symbol "v"
# ---------------------------------------------------------------------------

def _mu_norm_function_old(x, stretch_factor=10.0, max_value=1.0):
    """Bounds a positive input below max_value."""
    return -torch.log(1.0 + (math.e - 1.0) * torch.exp(-x / stretch_factor)) \
        + max_value


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


class ExponentialMapS2(SphereLayer):
    """S2 exponential-map flow - symbol "v": K components of a convex
    potential, each a mean direction mu (3 raw values, or 9 householder
    values and a norm), a log-weight and the potential's own parameters
    (exponential: a log-beta; splines: 10 widths, 10 heights, 11
    derivatives); parameters packed (npp, K), flat index p * K + k.  The map
    is analytic in the density direction (``natural_direction=0``) or in
    the sampling one; the other direction solves it (ops/inverse.py)."""

    NUM_SPLINE_BASIS = 10

    def __init__(self, dimension=2, euclidean_to_sphere_as_first=0,
                 exp_map_type="exponential", natural_direction=0,
                 num_components=10, add_rotation=0, max_num_newton_iter=1000,
                 mean_parametrization="old", **kwargs):
        super().__init__(2, euclidean_to_sphere_as_first, add_rotation,
                         rotation_mode="householder", **kwargs)
        self.exp_map_type = exp_map_type
        self.natural_direction = int(natural_direction)
        self.num_components = num_components
        self.max_num_newton_iter = max_num_newton_iter
        self.mean_parametrization = mean_parametrization
        self.num_mu_params = 3 if mean_parametrization == "old" else 10
        extra = {"linear": 1, "quadratic": 1, "exponential": 2,
                 "splines": 1 + 3 * self.NUM_SPLINE_BASIS + 1}
        if exp_map_type not in extra:
            raise ValueError(f"unknown exp_map_type {exp_map_type!r}")
        self.num_potential_pars = self.num_mu_params + extra[exp_map_type]
        self.num_params += self.num_potential_pars * self.num_components
        self._solve = make_sphere_inverse_fn(
            self._exp_map, prepare=lambda p: self._potential(p[0]),
            max_iter=max_num_newton_iter, damping=0.4)

    # -- the potential's gradient field -------------------------------------
    def _mu_and_weights(self, pp):
        """pp (Bp, npp, K) -> (mu: three (Bp, K) columns, weights (Bp, K))."""
        m = self.num_mu_params
        if self.mean_parametrization == "old":
            raw = pp[:, :3, :]
            norm = torch.sqrt(torch.sum(raw**2, dim=1))
            mu = tuple(raw[:, i, :] / norm for i in range(3))
            fake_norm = _mu_norm_function_old(norm)
        else:
            # mu = Q0 Q1 Q2 e_z: the reflections applied last to first
            one = torch.ones_like(pp[:, 0, :])
            mu = (torch.zeros_like(one), torch.zeros_like(one), one)
            for i in reversed(range(3)):
                v = tuple(pp[:, 3 * i + j, :] for j in range(3))
                nrm = torch.sqrt(_dot(v, v) + 1e-20)
                v = tuple(c / nrm for c in v)
                dot = _dot(v, mu)
                mu = tuple(wc - 2.0 * vc * dot for vc, wc in zip(v, mu))
            fake_norm = torch.sigmoid(pp[:, 9, :])
        lw = pp[:, m, :]
        weights = torch.exp(lw - torch.logsumexp(lw, dim=-1, keepdim=True)) \
            * fake_norm
        return mu, weights

    def _potential(self, slab):
        """What the (Bp, P) slab fixes, made once per call: mu, the
        weights, and the potential's own terms (exponential: beta; splines:
        the bins on [-1, 1] x [-1, 1])."""
        m = self.num_mu_params
        pp = slab.reshape(-1, self.num_potential_pars, self.num_components)
        mu, w = self._mu_and_weights(pp)
        if self.exp_map_type == "exponential":
            return mu, w, torch.exp(pp[:, m + 1, :])
        if self.exp_map_type != "splines":
            return mu, w, None
        nb = self.NUM_SPLINE_BASIS
        uw, uh, ud = (pp[:, lo:hi, :].transpose(1, 2) for lo, hi in (
            (m + 1, m + 1 + nb), (m + 1 + nb, m + 1 + 2 * nb),
            (m + 1 + 2 * nb, m + 2 + 3 * nb)))
        return mu, w, rq_spline_bins(uw, uh, ud, left=-1.0, right=1.0,
                                     bottom=-1.0, top=1.0)

    def _scale(self, x_mu, w, extra):
        """Each component's gradient scale s(x . mu) (B, K) and its
        derivative in x . mu (None where it is 0)."""
        if self.exp_map_type == "linear":
            return w, None
        if self.exp_map_type == "quadratic":
            return w * x_mu, w
        if self.exp_map_type == "exponential":
            e = torch.exp(extra * (x_mu - 1.0))
            return w * e, w * extra * e
        res, ld = rq_spline_on_bins(x_mu, extra)
        return w * res, w * torch.exp(ld)

    def _exp_map(self, x3, pot, t3=None):
        """phi(x) on (x, y, z) columns for the potential ``pot``; with tangents
        t3 (three tensors broadcasting to (n, B)) also phi's directional
        derivatives along them, three (n, B) tensors.  The guards are
        dtype-aware, as in the JAX package: its float64 constants round to
        1 in float32."""
        finfo = torch.finfo(x3[0].dtype)
        tiny = finfo.tiny
        edge = max(1e-14, 8.0 * finfo.eps)
        mu, w, extra = pot
        x_mu = _dot([c[:, None] for c in x3], mu)
        s, ds = self._scale(x_mu, w, extra)
        g = tuple(torch.sum(s * c, dim=-1) for c in mu)
        gn2 = _dot(g, g)
        gn = torch.sqrt(torch.clamp(gn2, min=tiny))
        u = tuple(c / gn for c in g)
        cos_raw = _dot(u, x3)
        cos_a = torch.clamp(cos_raw, -1.0 + edge, 1.0 - edge)
        sin2 = 1.0 - cos_a**2
        sin_a = torch.sqrt(torch.clamp(sin2, min=tiny))
        tang = tuple((uc - xc * cos_a) / sin_a for uc, xc in zip(u, x3))
        v = _dot(g, tang)
        cv, sv = torch.cos(v), torch.sin(v)
        phi = tuple(xc * cv + tc * sv for xc, tc in zip(x3, tang))
        if t3 is None:
            return phi
        if ds is None:
            dg = (0.0, 0.0, 0.0)
        else:
            dsm = ds * _dot([c[..., None] for c in t3], mu)
            dg = tuple(torch.sum(dsm * c, dim=-1) for c in mu)
        dgn = torch.where(gn2 > tiny, _dot(g, dg) / gn, 0.0)
        du = tuple((dc - uc * dgn) / gn for dc, uc in zip(dg, u))
        inside = (cos_raw > -1.0 + edge) & (cos_raw < 1.0 - edge)
        dcos = torch.where(inside, _dot(du, x3) + _dot(u, t3), 0.0)
        dsin = torch.where(sin2 > tiny, -cos_a * dcos / sin_a, 0.0)
        dtang = tuple((duc - tc * cos_a - xc * dcos) / sin_a - tgc * dsin / sin_a
                      for duc, tc, xc, tgc in zip(du, t3, x3, tang))
        dv = _dot(dg, tang) + _dot(g, dtang)
        dphi = tuple(tc * cv - xc * sv * dv + dtc * sv + tgc * cv * dv
                     for tc, xc, dtc, tgc in zip(t3, x3, dtang, tang))
        return phi, dphi

    def _logdet(self, x3, pot):
        """(phi columns, 0.5 log det(P^T P)), P = J on the tangent basis."""
        t1, t2 = manifold.sphere_tangent_basis_cols(*x3)
        phi, (dx, dy, dz) = self._exp_map(
            x3, pot, tuple(torch.stack([a, b]) for a, b in zip(t1, t2)))
        a, b = (dx[0], dy[0], dz[0]), (dx[1], dy[1], dz[1])
        aa, bb, ab = _dot(a, a), _dot(b, b), _dot(a, b)
        return phi, 0.5 * torch.log(aa * bb - ab**2)

    def _map(self, slab, x3, log_det, sampling):
        """The layer on unit-vector columns: analytic where natural, else
        solved, the log-det taken at the solution."""
        pot = self._potential(slab)
        if bool(self.natural_direction) == sampling:
            out, ld = self._logdet(x3, pot)
            return out, log_det + ld
        out = self._solve(*x3, (slab,))
        _, ld = self._logdet(out, pot)
        return out, log_det - ld

    # -- rows and the (z, phi) carrier --------------------------------------
    def _rows(self, child, x, log_det, sampling):
        if self.always_parametrize_in_embedding_space:
            out, log_det = self._map(child, x.unbind(1), log_det, sampling)
            return torch.stack(out, dim=1), log_det
        *x3, log_det = manifold.spherical_to_eucl_cols(x[:, 0], x[:, 1],
                                                       log_det)
        out, log_det = self._map(child, tuple(x3), log_det, sampling)
        theta, phi, log_det = manifold.eucl_to_spherical_cols(*out, log_det)
        return torch.stack([theta, phi], dim=1), log_det

    def _forward(self, child, x, log_det, rot):
        return self._rows(child, x, log_det, sampling=True)

    def _inverse(self, child, x, log_det, rot):
        return self._rows(child, x, log_det, sampling=False)

    def _child_param_structure(self):
        return [("potential_pars",
                 self.num_potential_pars * self.num_components)]

    def supports_zphi(self):
        return not self.always_parametrize_in_embedding_space

    def _cols_z(self, child_slab, cols, log_det, sampling):
        out, log_det = self._map(child_slab.T,
                                 manifold.zphi_to_eucl_cols(*cols), log_det,
                                 sampling)
        return manifold.eucl_to_zphi_cols(*out), log_det

    def _forward_cols_z(self, child_slab, cols, log_det, rot_slab):
        return self._cols_z(child_slab, cols, log_det, sampling=True)

    def _inverse_cols_z(self, child_slab, cols, log_det, rot_slab):
        return self._cols_z(child_slab, cols, log_det, sampling=False)
