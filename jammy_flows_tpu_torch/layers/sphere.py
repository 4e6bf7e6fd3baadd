"""Spherical layers: the base (plane <-> sphere projection and embedding
rotation), the circle flows Moebius (`m`) and CircularRQSpline (`o`), and
SphericalIdentity (`y`).

PyTorch counterpart of ``jammy_flows_tpu/layers/sphere.py``.  Layers run on
rows: S1 on (B, 1) angles in [0, 2 pi), S2 on (B, 2) (theta, phi), or on the
embedding's (B, d + 1) unit vectors when ``always_parametrize_in_embedding_
space`` is set, with (Bp, P) parameter slabs (``forward`` / ``inverse``).  S2
layers that have a column form in the JAX package also run on the (z, phi)
column carrier (``forward_cols_z`` / ``inverse_cols_z``; ``supports_zphi``):
coordinates travel as tuples of (B,) columns and parameters as a transposed
(P, Bp) slab, and z = cos(theta) rides between layers, so the rotations'
log(sin) terms vanish (dA = dz dphi).  The JAX package's (theta, phi)
columns, which exist for the TPU's tile padding, are not ported.  The
embedding rotation is householder, givens angles, or (S2 only) xyz or
quaternion.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import FlowLayer, coordinates_intrinsic, named_parts
from ..ops import manifold, rotations
from ..ops.inverse import make_inverse_fn
from ..ops.special import logaddexp
from ..ops.splines import (SplineParamLayout, fixed_log_derivative,
                           rq_spline, rq_spline_smooth_circular)

PI = math.pi
TWO_PI = 2.0 * math.pi
ROTATION_MODES = ("householder", "angles", "xyz", "quaternion")


ANGLE_MARGIN = 1e-7


def safe_angle_within_2pi(x):
    """Clamp an angle into [ANGLE_MARGIN, 2 pi - ANGLE_MARGIN]."""
    return torch.clamp(x, ANGLE_MARGIN, TWO_PI - ANGLE_MARGIN)


class SphereLayer(FlowLayer):
    """Parameter layout: [rotation params] + child params."""

    def __init__(self, dimension=2, euclidean_to_sphere_as_first=1,
                 add_rotation=0, rotation_mode="householder",
                 num_householder_iter=-1,
                 always_parametrize_in_embedding_space=0):
        super().__init__(dimension, always_parametrize_in_embedding_space)
        if dimension not in (1, 2):
            raise ValueError(f"spherical layers are S1 or S2, not S{dimension}")
        if rotation_mode not in ROTATION_MODES:
            raise ValueError(f"unknown sphere rotation mode {rotation_mode!r}")
        self.euclidean_to_sphere_as_first = int(euclidean_to_sphere_as_first)
        self.add_rotation = int(add_rotation)
        self.rotation_mode = rotation_mode
        self.num_rotation_params = 0
        self.householder_iter = 0
        if self.add_rotation:
            emb = dimension + 1
            if rotation_mode == "angles":
                self.num_rotation_params = emb * (emb - 1) // 2
            elif rotation_mode in ("xyz", "quaternion"):
                if dimension != 2:
                    raise ValueError(f"rotation_mode={rotation_mode!r} "
                                     "rotates S2 only")
                self.num_rotation_params = 3 if rotation_mode == "xyz" else 4
            else:
                it = emb if num_householder_iter == -1 else num_householder_iter
                self.householder_iter = it
                self.num_rotation_params = it * emb
        self.num_params += self.num_rotation_params

    # -- the embedding rotation ----------------------------------------------
    def _rotation_matrix(self, rot):
        """(Bp, d + 1, d + 1) from the (Bp, R) rotation parameters (not the
        householder mode, which is applied reflection by reflection)."""
        if self.rotation_mode == "angles":
            return rotations.givens_matrix(rot, self.dimension + 1)
        if self.rotation_mode == "xyz":
            return rotations.xyz_matrix(rot)
        return rotations.quaternion_matrix(rot)

    def _apply_embedding_rotation(self, rot, x, log_det, inverse):
        """Rotate rows in embedding space: a measure-preserving map, whose
        S2 log-det terms come from the conversions to and from the angles."""
        if not self.add_rotation:
            return x, log_det
        emb = self.always_parametrize_in_embedding_space
        if not emb:
            x, log_det = manifold.spherical_to_eucl(x, log_det)
        if self.rotation_mode == "householder":
            vs = rot.reshape(-1, self.householder_iter, self.dimension + 1)
            x = rotations.householder_apply(vs, x, inverse=inverse)
        else:
            x = rotations.apply_rotation(self._rotation_matrix(rot), x,
                                         inverse=inverse)
        if not emb:
            x, log_det = manifold.eucl_to_spherical(x, log_det)
        return x, log_det

    # -- the row protocol -----------------------------------------------------
    def forward(self, params, x, log_det):
        rot = params[:, :self.num_rotation_params]
        child = params[:, self.num_rotation_params:]
        if self.euclidean_to_sphere_as_first:
            if self.dimension == 1:
                x, log_det = manifold.plane_to_circle(x, log_det)
            else:
                x, log_det = manifold.plane_to_sphere2(x, log_det)
            if self.always_parametrize_in_embedding_space:
                x, log_det = manifold.spherical_to_eucl(x, log_det)
        x, log_det = self._forward(child, x, log_det, rot)
        return self._apply_embedding_rotation(rot, x, log_det, inverse=False)

    def inverse(self, params, x, log_det):
        rot = params[:, :self.num_rotation_params]
        child = params[:, self.num_rotation_params:]
        x, log_det = self._apply_embedding_rotation(rot, x, log_det,
                                                    inverse=True)
        x, log_det = self._inverse(child, x, log_det, rot)
        if self.euclidean_to_sphere_as_first:
            if self.always_parametrize_in_embedding_space:
                x, log_det = manifold.eucl_to_spherical(x, log_det)
            if self.dimension == 1:
                x, log_det = manifold.circle_to_plane(x, log_det)
            else:
                x, log_det = manifold.sphere2_to_plane(x, log_det)
        return x, log_det

    def _forward(self, child, x, log_det, rot):
        raise NotImplementedError

    def _inverse(self, child, x, log_det, rot):
        raise NotImplementedError

    # -- (z, phi)-carrier column protocol (S2) -------------------------------
    def supports_zphi(self):
        """True when this layer runs on the (z, phi) carrier: an S2 layer
        with a column form in the JAX package, not in embedding space."""
        return False

    def _rot_vs_cols(self, rot_slab):
        emb = self.dimension + 1
        return [[rot_slab[i * emb + j] for j in range(emb)]
                for i in range(self.householder_iter)]

    def _apply_embedding_rotation_cols_z(self, rot_slab, cols, inverse):
        if not self.add_rotation:
            return cols
        ecols = manifold.zphi_to_eucl_cols(cols[0], cols[1])
        if self.rotation_mode == "householder":
            ecols = rotations.householder_apply_cols(
                self._rot_vs_cols(rot_slab), ecols, inverse=inverse)
        else:
            ecols = rotations.apply_matrix_cols(
                self._rotation_matrix(rot_slab.T), ecols, inverse=inverse)
        return manifold.eucl_to_zphi_cols(*ecols)

    def forward_cols_z(self, slab, cols, log_det):
        rot = slab[:self.num_rotation_params]
        child = slab[self.num_rotation_params:]
        if self.euclidean_to_sphere_as_first:
            z, phi, log_det = manifold.plane_to_zsphere2_cols(cols[0], cols[1],
                                                              log_det)
            cols = (z, phi)
        cols, log_det = self._forward_cols_z(child, cols, log_det, rot)
        return self._apply_embedding_rotation_cols_z(rot, cols,
                                                     inverse=False), log_det

    def inverse_cols_z(self, slab, cols, log_det):
        rot = slab[:self.num_rotation_params]
        child = slab[self.num_rotation_params:]
        cols = self._apply_embedding_rotation_cols_z(rot, cols, inverse=True)
        cols, log_det = self._inverse_cols_z(child, cols, log_det, rot)
        if self.euclidean_to_sphere_as_first:
            x0, x1, log_det = manifold.zsphere2_to_plane_cols(cols[0], cols[1],
                                                              log_det)
            cols = (x0, x1)
        return cols, log_det

    def _forward_cols_z(self, child_slab, cols, log_det, rot_slab):
        raise NotImplementedError

    def _inverse_cols_z(self, child_slab, cols, log_det, rot_slab):
        raise NotImplementedError

    # -- coordinate bookkeeping ---------------------------------------------
    @property
    def embedded_dim(self):
        return self.dimension + 1

    @property
    def base_dim(self):
        if self.always_parametrize_in_embedding_space and \
                not self.euclidean_to_sphere_as_first:
            return self.dimension + 1
        return self.dimension

    def embedding_conditional_return(self, x):
        if x.shape[1] == self.dimension:
            x = manifold.spherical_to_eucl(x)
        return x

    def transform_target_space(self, x, log_det=0.0, transform_from="default",
                               transform_to="embedding"):
        """Intrinsic angles <-> embedding unit vectors, with the log-det of
        the conversion."""
        now, want = coordinates_intrinsic(self, transform_from, transform_to)
        if now and not want:
            return manifold.spherical_to_eucl(x, log_det)
        if want and not now:
            return manifold.eucl_to_spherical(x, log_det)
        return x, log_det

    def default_params(self, rng=None):
        rng = rng or np.random.default_rng(0)
        parts = [rng.standard_normal(self.num_rotation_params)]
        parts.append(self._default_params(rng))
        return np.concatenate(parts)

    def param_structure(self):
        """The rotation's parameters first, then the child layer's."""
        rot_name = {"householder": "householder", "angles": "anglepars",
                    "xyz": "xyzpars", "quaternion": "quatpars"}[
                        self.rotation_mode]
        parts = [(rot_name, self.num_rotation_params)] \
            if self.num_rotation_params else []
        return named_parts(self, parts + self._child_param_structure())

    def _child_param_structure(self):
        rest = self.num_params - self.num_rotation_params
        return [("params", rest)] if rest else []

    def _default_params(self, rng):
        return rng.standard_normal(self.num_params - self.num_rotation_params)


# ---------------------------------------------------------------------------
# Moebius flow on S1 - symbol "m"
# ---------------------------------------------------------------------------

MIN_OMEGA_RADIUS = 0.001
MAX_OMEGA_RADIUS = 0.999


def _moebius_omega(omega_pars, use_xyz=True):
    """The components' centres omega (Bp, K, 2), their radius (Bp, K, 1)
    held in (0.001, 0.999) by a sigmoid: omega_pars (Bp, K, 4) [x, y,
    log-length, log-norm], or (Bp, K, 3) [angle, log-length, log-norm]."""
    log_length_par = omega_pars[:, :, -2:-1]
    denom = logaddexp(0.0, -log_length_par)
    omega_length = MIN_OMEGA_RADIUS + torch.exp(
        math.log(MAX_OMEGA_RADIUS - MIN_OMEGA_RADIUS) - denom)
    if use_xyz:
        normed = omega_pars[:, :, :2] / torch.sqrt(
            torch.sum(omega_pars[:, :, :2]**2, dim=2, keepdim=True))
        return normed * omega_length, omega_length
    angle = omega_pars[:, :, 0:1]
    return torch.cat([torch.cos(angle) * omega_length,
                      torch.sin(angle) * omega_length], dim=2), omega_length


def moebius_trafo(x, omega_pars, use_xyz=True):
    """The convex combination of K Moebius transforms of x (B, 1) in
    (-pi, pi], each rotated to fix f(-pi) = -pi, weighted by the softmax of
    the log-norms; (B, 1)."""
    cos_x = torch.cos(x)[:, None, :]
    sin_x = torch.sin(x)[:, None, :]
    omega_vec, omega_length = _moebius_omega(omega_pars, use_xyz)
    ox, oy = omega_vec[:, :, 0:1], omega_vec[:, :, 1:2]
    o_m_o_sq = 1.0 - omega_length**2

    def xy_vals(cx, sx):
        o_p_o = 1.0 + omega_length**2 - 2.0 * (cx * ox + sx * oy)
        return (o_m_o_sq * (cx - ox) - ox * o_p_o,
                o_m_o_sq * (sx - oy) - oy * o_p_o)

    x_m_pi, y_m_pi = xy_vals(math.cos(-PI), math.sin(-PI))
    rot = -PI - torch.atan2(y_m_pi, x_m_pi)
    x_val, y_val = xy_vals(cos_x, sin_x)
    x_p = torch.cos(rot) * x_val - torch.sin(rot) * y_val
    y_p = torch.sin(rot) * x_val + torch.cos(rot) * y_val
    arc = torch.atan2(y_p, x_p)[:, :, -1:] + PI
    log_norms = omega_pars[:, :, -1:]
    weights = torch.exp(log_norms - torch.logsumexp(log_norms, dim=1,
                                                    keepdim=True))
    return torch.sum(arc * weights, dim=1) - PI


def moebius_trafo_deriv(x, omega_pars, use_xyz=True):
    """d moebius_trafo / dx (> 0), (B, 1)."""
    cos_x = torch.cos(x)[:, None, :]
    sin_x = torch.sin(x)[:, None, :]
    omega_vec, omega_length = _moebius_omega(omega_pars, use_xyz)
    o_m_o_sq = 1.0 - omega_length**2
    o_p_o = 1.0 + omega_length**2 - 2.0 * (cos_x * omega_vec[:, :, 0:1]
                                           + sin_x * omega_vec[:, :, 1:2])
    log_norms = omega_pars[:, :, -1:]
    weighted = (torch.log(o_m_o_sq / o_p_o) + log_norms) \
        - torch.logsumexp(log_norms, dim=1, keepdim=True)
    return torch.exp(torch.logsumexp(weighted, dim=1))


class Moebius(SphereLayer):
    """Moebius circle flow - symbol "m": K components of 4 parameters (3
    without the xyz parametrization).  The map is analytic in the density
    direction (``natural_direction=0``) or in the sampling one; the other
    direction solves it on [-pi, pi] by 20 bisection and 20 Newton steps,
    with the implicit-function gradient (ops/inverse.py)."""

    def __init__(self, dimension=1, euclidean_to_sphere_as_first=1,
                 add_rotation=0, natural_direction=0,
                 use_moebius_xyz_parametrization=True, num_basis_functions=5,
                 **kwargs):
        super().__init__(1, euclidean_to_sphere_as_first, add_rotation,
                         rotation_mode="householder", **kwargs)
        self.use_xyz = bool(use_moebius_xyz_parametrization)
        self.num_basis_functions = num_basis_functions
        self.num_omega_pars = 4 if self.use_xyz else 3
        self.natural_direction = int(natural_direction)
        self.num_params += num_basis_functions * self.num_omega_pars
        self._solve = make_inverse_fn(
            lambda xx, p: moebius_trafo(xx, p[0], self.use_xyz),
            lambda xx, p: (moebius_trafo(xx, p[0], self.use_xyz),
                           moebius_trafo_deriv(xx, p[0], self.use_xyz)),
            lo=-PI, hi=PI, num_bisection_iter=20, num_newton_iter=20)

    def _child_param_structure(self):
        return [("moebius", self.num_basis_functions * self.num_omega_pars)]

    def _apply(self, params, x, log_det, sampling):
        mp = params.reshape(-1, self.num_basis_functions, self.num_omega_pars)
        if self.always_parametrize_in_embedding_space:
            x, log_det = manifold.eucl_to_spherical(x, log_det)
        x = torch.where(x > PI, x - TWO_PI, x)
        if bool(self.natural_direction) == sampling:
            log_deriv = torch.sum(torch.log(
                moebius_trafo_deriv(x, mp, self.use_xyz)), dim=-1)
            x = moebius_trafo(x, mp, self.use_xyz)
        else:
            x = self._solve(x, (mp,))
            log_deriv = -torch.sum(torch.log(
                moebius_trafo_deriv(x, mp, self.use_xyz)), dim=-1)
        x = torch.where(x < 0.0, x + TWO_PI, x)
        if self.always_parametrize_in_embedding_space:
            return manifold.spherical_to_eucl(x, log_det + log_deriv)
        return x, log_det + log_deriv

    def _forward(self, params, x, log_det, rot):
        return self._apply(params, x, log_det, sampling=True)

    def _inverse(self, params, x, log_det, rot):
        return self._apply(params, x, log_det, sampling=False)


# ---------------------------------------------------------------------------
# Circular RQ-spline on S1 - symbol "o"
# ---------------------------------------------------------------------------

class CircularRQSpline(SphereLayer):
    """Circular rational-quadratic spline on [0, 2 pi] - symbol "o": the
    C^2-smooth two-bin spline (the default), or K bins with a periodic
    derivative at the seam or both boundary derivatives fixed.  Parameter
    layout after the rotation: widths, heights, derivatives; the first
    width and height (and the second width) may be pinned to 0, and the
    heights may be parametrized as offsets from the widths.  The spline
    runs forward in the sampling direction (``natural_direction=1``) or in
    the density one."""

    def __init__(self, dimension=1, euclidean_to_sphere_as_first=1,
                 add_rotation=1, natural_direction=1, num_basis_functions=2,
                 min_width=1e-4, min_height=1e-4, min_derivative=1e-4,
                 fix_boundary_derivatives=-1.0, smooth_second_derivative=1,
                 fix_first_width_n_height_to_zero=0,
                 also_fix_second_width_to_zero=0,
                 independent_width_height_parametrization=0, **kwargs):
        super().__init__(1, euclidean_to_sphere_as_first, add_rotation,
                         rotation_mode="householder", **kwargs)
        k = num_basis_functions
        self.num_basis_functions = k
        self.natural_direction = int(natural_direction)
        self.min_width = min_width
        self.min_height = min_height
        self.min_derivative = min_derivative
        self.fix_boundary_derivatives = fix_boundary_derivatives
        self.smooth_second_derivative = int(smooth_second_derivative)
        self.layout = SplineParamLayout(
            k, fix_first_width_n_height_to_zero,
            also_fix_second_width_to_zero,
            independent_width_height_parametrization)

        self.boundary_log_derivs_fixed_value = None
        if self.smooth_second_derivative == 1:
            if k != 2:
                raise ValueError("smooth circular spline needs 2 bins")
            bd_sub = 3
        elif fix_boundary_derivatives > 0.0:
            bd_sub = 2
            self.boundary_log_derivs_fixed_value = fixed_log_derivative(
                fix_boundary_derivatives, min_derivative)
        else:
            bd_sub = 1  # periodic: the seam's derivative is shared
        self.num_derivative_params = k + 1 - bd_sub
        self.num_params += (self.layout.num_widths + self.layout.num_heights
                            + self.num_derivative_params)

    def _child_param_structure(self):
        return [("widths", self.layout.num_widths),
                ("heights", self.layout.num_heights),
                ("derivatives", self.num_derivative_params)]

    def _apply(self, params, x, log_det, sampling):
        if self.always_parametrize_in_embedding_space:
            x, log_det = manifold.eucl_to_spherical(x, log_det)
        x = safe_angle_within_2pi(x)
        w, h, d = self.layout.unpack(params)
        use_inverse = not sampling if self.natural_direction else sampling
        if self.smooth_second_derivative == 0:
            if self.fix_boundary_derivatives > 0.0:
                fixed = torch.full_like(d[:, :1],
                                        self.boundary_log_derivs_fixed_value)
                d = torch.cat([fixed, d, fixed], dim=1)
            else:
                d = torch.cat([d, d[:, :1]], dim=1)  # periodic seam
            res, ld = rq_spline(
                x, w[:, None, :], h[:, None, :], d[:, None, :],
                inverse=use_inverse, left=0.0, right=TWO_PI, bottom=0.0,
                top=TWO_PI, rel_min_bin_width=self.min_width,
                rel_min_bin_height=self.min_height,
                min_derivative=self.min_derivative)
        else:
            res, ld = rq_spline_smooth_circular(
                x, w[:, None, :], h[:, None, :], inverse=use_inverse,
                rel_min_bin_width=self.min_width,
                rel_min_bin_height=self.min_height)
        res = safe_angle_within_2pi(res)
        log_det = log_det + torch.sum(ld, dim=-1)
        if self.always_parametrize_in_embedding_space:
            return manifold.spherical_to_eucl(res, log_det)
        return res, log_det

    def _forward(self, params, x, log_det, rot):
        return self._apply(params, x, log_det, sampling=True)

    def _inverse(self, params, x, log_det, rot):
        return self._apply(params, x, log_det, sampling=False)

    def _default_params(self, rng):
        n = (self.layout.num_widths + self.layout.num_heights
             + self.num_derivative_params)
        if self.smooth_second_derivative:
            return np.zeros(n)
        return np.full(n, 0.54)


# ---------------------------------------------------------------------------
# Spherical identity - symbol "y"
# ---------------------------------------------------------------------------

class SphericalIdentity(SphereLayer):
    """Identity spherical flow - symbol "y": the base's projection and
    optional rotation only."""

    def __init__(self, dimension=1, euclidean_to_sphere_as_first=1,
                 add_rotation=0, **kwargs):
        super().__init__(dimension, euclidean_to_sphere_as_first, add_rotation,
                         rotation_mode="householder", **kwargs)

    def _forward(self, params, x, log_det, rot):
        return x, log_det

    def _inverse(self, params, x, log_det, rot):
        return x, log_det

    def supports_zphi(self):
        return self.dimension == 2 and \
            not self.always_parametrize_in_embedding_space

    def _forward_cols_z(self, child_slab, cols, log_det, rot_slab):
        return cols, log_det

    def _inverse_cols_z(self, child_slab, cols, log_det, rot_slab):
        return cols, log_det

    def _default_params(self, rng):
        return np.zeros(0)
