"""Circle, S2, interval and simplex coordinate conversions with exact
log-determinants.

PyTorch counterpart of ``jammy_flows_tpu/ops/manifold.py``: the angle
clamps; the circle's and the interval's Gaussian-CDF projections from the
real line, on (B, 1) rows; the embedding; the simplex chain (Gaussian ->
box -> skewed box -> base simplex -> canonical simplex, on (B, d) rows);
the S2 projection from the plane and the embedding on (theta, phi) rows;
and the (z, phi) and (theta, phi) column converters used by the s2 layers,
on tuples of flat (B,) columns.  The log-det accumulator is (B,).
"""
from __future__ import annotations

import math

import torch

from .special import LOG_SQRT_2PI

PI = math.pi
TWO_PI = 2.0 * math.pi
SQRT2 = math.sqrt(2.0)


def _safe_acos_arg(x, margin=None):
    if margin is None:
        margin = 1e-14 if x.dtype == torch.float64 else 1e-7
    return torch.clamp(x, -1.0 + margin, 1.0 - margin)


def safe_angle_within_pi(x, margin=1e-7):
    """Clamp a polar angle away from 0 and pi."""
    return torch.clamp(x, margin, PI - margin)


def safe_costheta(x, margin=None):
    """Clamp cos(theta) away from +-1."""
    if margin is None:
        margin = 1e-10 if x.dtype == torch.float64 else 1e-7
    return torch.clamp(x, -1.0 + margin, 1.0 - margin)


def plane_to_circle(x, log_det):
    """R -> [0, 2 pi) through the Gaussian CDF of |x|: x (B, 1), positive
    reals to (0, pi], negative ones to (pi, 2 pi)."""
    radius = torch.abs(x)
    log_det = log_det + LOG_SQRT_2PI - 0.5 * radius[:, 0]**2
    angle = PI * (1.0 - torch.erf(radius / SQRT2))
    return torch.where(x >= 0, angle, TWO_PI - angle), log_det


def circle_to_plane(x, log_det):
    """[0, 2 pi) -> R, the inverse of plane_to_circle; the folded angle is
    kept eps away from 0 and 2 pi (1e-8 in float64, 1e-5 otherwise)."""
    negative = x > PI
    folded = torch.where(negative, TWO_PI - x, x)
    eps = 1e-8 if x.dtype == torch.float64 else 1e-5
    folded = torch.clamp(folded, eps, TWO_PI - eps)
    r = SQRT2 * torch.special.erfinv(1.0 - folded / PI)
    log_det = log_det - LOG_SQRT_2PI + 0.5 * r[:, 0]**2
    return torch.where(negative, -r, r), log_det


def _inside_unit(u):
    """u kept eps/2 inside (0, 1), both ways through the Gaussian CDF.  In
    float32 the CDF rounds to 0 or 1 beyond |x| ~ 5.4, and a coordinate
    within an ulp of a face (a simplex row whose remainder 1 - sum(x) is
    below x's resolution) comes back as 0 or 1, where erfinv gives +-inf
    and log_prob a NaN; the JAX package's float32 erf stops short of +-1 by
    an argument clamp, but not its erfinv (ROADMAP.md, Queue 3)."""
    half = torch.finfo(u.dtype).eps / 2
    return torch.clamp(u, half, 1.0 - half)


def real_line_to_interval(x, log_det, low, high):
    """R -> [low, high] through the Gaussian CDF: x (B, 1)."""
    width = high - low
    res = _inside_unit(0.5 + 0.5 * torch.erf(x / SQRT2))
    log_det = log_det - 0.5 * x[:, 0]**2 - LOG_SQRT_2PI + math.log(width)
    return res * width + low, log_det


def interval_to_real_line(x, log_det, low, high):
    """[low, high] -> R, the inverse of real_line_to_interval."""
    width = high - low
    u = _inside_unit((x - low) / width)
    res = torch.special.erfinv(2.0 * u - 1.0) * SQRT2
    log_det = log_det + 0.5 * res[:, 0]**2 + LOG_SQRT_2PI - math.log(width)
    return res, log_det


def _tiny(x):
    return torch.finfo(x.dtype).tiny


def gauss_to_box(x, log_det):
    """R^d -> (0, 1)^d through the Gaussian CDF."""
    log_det = log_det + torch.sum(-0.5 * x**2 - LOG_SQRT_2PI, dim=-1)
    return _inside_unit(0.5 * (1.0 + torch.erf(x / SQRT2))), log_det


def box_to_gauss(x, log_det):
    res = SQRT2 * torch.special.erfinv(2.0 * _inside_unit(x) - 1.0)
    log_det = log_det - torch.sum(-0.5 * res**2 - LOG_SQRT_2PI, dim=-1)
    return res, log_det


def box_to_skewed_box(x, log_det):
    """Skew the box so that the induced simplex density is flat: every
    dimension but the last takes u -> 1 - (1 - u)^(1/2).  The log-det is the
    exact Jacobian, sum(-log 2 - log(1 - u_new)), as in the JAX package
    (whose note says why it departs from the torch reference's forward
    factor)."""
    if x.shape[1] > 1:
        head = 1.0 - torch.sqrt(1.0 - x[:, :-1])
        log_det = log_det + torch.sum(
            -torch.log(torch.clamp(1.0 - head, min=_tiny(x))), dim=-1) \
            - math.log(2.0) * (x.shape[1] - 1)
        x = torch.cat([head, x[:, -1:]], dim=1)
    return x, log_det


def skewed_box_to_box(x, log_det):
    if x.shape[1] > 1:
        log_det = log_det + torch.sum(
            torch.log(torch.clamp(1.0 - x[:, :-1], min=_tiny(x))), dim=-1) \
            + math.log(2.0) * (x.shape[1] - 1)
        head = 1.0 - (1.0 - x[:, :-1])**2
        x = torch.cat([head, x[:, -1:]], dim=1)
    return x, log_det


def box_to_base_simplex(x, log_det):
    """Box -> axis-aligned base simplex: res[i] = x[i] prod_{j<i}(1 - x[j]),
    log_det += sum_i sum_{j<i} log(1 - x[j])."""
    d = x.shape[1]
    one_minus = 1.0 - x
    cum = torch.cumprod(one_minus, dim=1)
    excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
    if d > 1:
        # dimension j < d - 1 is counted d - 1 - j times
        weights = torch.arange(d - 1, 0, -1, dtype=x.dtype, device=x.device)
        log_det = log_det + torch.sum(weights * torch.log(torch.clamp(
            one_minus[:, :-1], min=_tiny(x))), dim=-1)
    return x * excl, log_det


def base_simplex_to_box(x, log_det):
    d = x.shape[1]
    cums = torch.cumsum(x, dim=1)
    excl = torch.cat([torch.zeros_like(cums[:, :1]), cums[:, :-1]], dim=1)
    denom = torch.clamp(1.0 - excl, min=_tiny(x))
    if d > 1:
        log_det = log_det - torch.sum(torch.log(denom[:, 1:]), dim=-1)
    return x / denom, log_det


def simplex_projection_matrices(dim, dtype=torch.float64, device=None):
    """(M (dim, dim + 1), M_reverse (dim + 1, dim)) projecting the base
    simplex to the canonical simplex and back."""
    m = torch.zeros((dim, dim + 1), dtype=dtype, device=device)
    m[:, 0] = -1.0
    m[:, 1:] = torch.eye(dim, dtype=dtype, device=device)
    m_rev = torch.full((dim + 1, dim), -1.0, dtype=dtype, device=device)
    idx = torch.arange(dim, device=device)
    m_rev[1 + idx, idx] = float(dim)
    return m, m_rev / (1.0 + dim)


def _onehot0(n, x):
    return torch.nn.functional.one_hot(
        torch.zeros((), dtype=torch.long, device=x.device), n).to(x.dtype)


def base_simplex_to_canonical(x, log_det):
    dim = x.shape[1]
    m, _ = simplex_projection_matrices(dim, x.dtype, x.device)
    return _onehot0(dim + 1, x) + x @ m, log_det + 0.5 * math.log(dim + 1)


def canonical_simplex_to_base(x, log_det):
    dim = x.shape[1] - 1
    _, m_rev = simplex_projection_matrices(dim, x.dtype, x.device)
    return (x - _onehot0(dim + 1, x)) @ m_rev, \
        log_det - 0.5 * math.log(dim + 1)


def spherical_to_eucl(x, log_det=None):
    """Intrinsic angles -> embedded unit vector: (B, 1) circle angle ->
    (B, 2) (cos, sin), or (B, 2) (theta, phi) -> (B, 3).  With ``log_det``
    returns (eucl, log_det'), the S2 one gaining log sin(theta) (the circle's
    map is measure-preserving)."""
    if x.shape[1] == 1:
        eucl = torch.cat([torch.cos(x), torch.sin(x)], dim=1)
        return eucl if log_det is None else (eucl, log_det)
    *eucl, ld = spherical_to_eucl_cols(x[:, 0], x[:, 1], 0.0 if log_det is None
                                       else log_det)
    eucl = torch.stack(eucl, dim=1)
    return eucl if log_det is None else (eucl, ld)


def eucl_to_spherical(x, log_det):
    """Embedded point -> intrinsic angles: (B, 2) -> (B, 1) circle angle,
    or (B, 3) -> (B, 2) (theta, phi) with log_det - log sin(theta)."""
    if x.shape[1] == 2:
        return circle_eucl_to_spherical(x), log_det
    theta, phi, log_det = eucl_to_spherical_cols(x[:, 0], x[:, 1], x[:, 2],
                                                 log_det)
    return torch.stack([theta, phi], dim=1), log_det


def sphere_tangent_basis_cols(x, y, z):
    """An orthonormal basis (t1, t2) of the tangent plane at the unit vector
    (x, y, z) columns: e_z (e_x near the poles, |z| >= 0.9) projected and
    normalized, and its cross product with the point."""
    near_pole = torch.abs(z) >= 0.9
    rx = torch.where(near_pole, 1.0, 0.0).to(x.dtype)
    rz = torch.where(near_pole, 0.0, 1.0).to(x.dtype)
    rdx = rx * x + rz * z
    t1x, t1y, t1z = rx - x * rdx, -y * rdx, rz - z * rdx
    t1n = torch.sqrt(t1x * t1x + t1y * t1y + t1z * t1z)
    t1x, t1y, t1z = t1x / t1n, t1y / t1n, t1z / t1n
    return ((t1x, t1y, t1z),
            (y * t1z - z * t1y, z * t1x - x * t1z, x * t1y - y * t1x))


def circle_eucl_to_spherical(x):
    """(B, 2) embedded point of the circle -> (B, 1) angle in [0, 2 pi]
    (measure-preserving: no log-det term)."""
    norm = torch.sqrt(torch.sum(x**2, dim=1, keepdim=True))
    ang = torch.arccos(_safe_acos_arg(x[:, :1] / norm))
    return torch.where(x[:, 1:2] < 0, TWO_PI - ang, ang)


def plane_to_sphere2(x, log_det):
    """R^2 -> (theta, phi) rows through the radial Gaussian-CDF projection;
    the log-det in the (theta, phi) measure (its sin(theta) dropped)."""
    radius = torch.sqrt(torch.sum(x**2, dim=-1, keepdim=True))
    phi = _phi_from_xy(x[:, :1], x[:, 1:2], radius)
    theta = torch.arccos(_safe_acos_arg(1.0 - 2.0 * torch.exp(
        -0.5 * radius**2)))
    theta = safe_angle_within_pi(theta)
    log_det = log_det + torch.log(1.0 - torch.cos(theta[:, 0])) \
        - torch.log(torch.sin(theta[:, 0]))
    return torch.cat([theta, phi], dim=1), log_det


def sphere2_to_plane(x, log_det):
    """(theta, phi) rows -> R^2, the inverse of plane_to_sphere2."""
    theta = safe_angle_within_pi(x[:, :1])
    cos_t = safe_costheta(torch.cos(theta), margin=1e-6)
    r = torch.sqrt(-2.0 * torch.log(0.5 * (1.0 - cos_t)))
    log_det = log_det - torch.log(1.0 - cos_t[:, 0]) \
        + torch.log(torch.sin(theta[:, 0]))
    phi = x[:, 1:2]
    return torch.cat([r * torch.cos(phi), r * torch.sin(phi)], dim=1), \
        log_det


def spherical_to_eucl_cols(theta, phi, log_det):
    """(theta, phi) columns -> (x, y, z) columns, log_det + log sin(theta)."""
    theta = safe_angle_within_pi(theta)
    st = torch.sin(theta)
    return st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta), \
        log_det + torch.log(st)


def eucl_to_spherical_cols(x, y, z, log_det):
    """(x, y, z) columns -> (theta, phi) columns, log_det - log sin(theta)."""
    norm = torch.sqrt(x**2 + y**2 + z**2)
    theta = safe_angle_within_pi(torch.arccos(_safe_acos_arg(z / norm)))
    log_det = log_det - torch.log(torch.sin(theta))
    xy_norm = torch.sqrt(x**2 + y**2)
    phi = torch.arccos(_safe_acos_arg(x / torch.clamp(xy_norm, min=1e-30)))
    phi = torch.where(y < 0, TWO_PI - phi, phi)
    return theta, phi, log_det


def _phi_from_xy(x0, x1, r):
    acos_arg = torch.where(r == 0.0, 1.0, x0 / torch.clamp(r, min=1e-30))
    phi = torch.arccos(_safe_acos_arg(acos_arg))
    return torch.where(x1 < 0, TWO_PI - phi, phi)


def plane_to_zsphere2_cols(x0, x1, log_det):
    """Plane -> (z = cos(theta), phi), log-det in the (z, phi) measure."""
    radius = torch.sqrt(x0**2 + x1**2)
    phi = _phi_from_xy(x0, x1, radius)
    z = safe_costheta(1.0 - 2.0 * torch.exp(-0.5 * radius**2), margin=1e-6)
    log_det = log_det + torch.log(1.0 - z)
    return z, phi, log_det


def zsphere2_to_plane_cols(z, phi, log_det):
    """(z, phi) -> plane, log-det in the (z, phi) measure."""
    z = safe_costheta(z, margin=1e-6)
    r = torch.sqrt(-2.0 * torch.log(0.5 * (1.0 - z)))
    log_det = log_det - torch.log(1.0 - z)
    return r * torch.cos(phi), r * torch.sin(phi), log_det


def zphi_to_eucl_cols(z, phi):
    """(z, phi) -> embedding (x, y, z); measure-preserving (dA = dz dphi)."""
    z = safe_costheta(z, margin=1e-7)
    st = torch.sqrt(torch.clamp(1.0 - z * z, min=1e-14))
    return st * torch.cos(phi), st * torch.sin(phi), z


def eucl_to_zphi_cols(x, y, z):
    """Embedding (x, y, z) -> (z, phi); measure-preserving."""
    norm = torch.sqrt(x**2 + y**2 + z**2)
    zn = safe_costheta(z / norm, margin=1e-7)
    xy_norm = torch.sqrt(x**2 + y**2)
    phi = torch.arccos(_safe_acos_arg(x / torch.clamp(xy_norm, min=1e-30)))
    phi = torch.where(y < 0, TWO_PI - phi, phi)
    return zn, phi
