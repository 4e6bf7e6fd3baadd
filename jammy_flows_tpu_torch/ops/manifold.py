"""S2 coordinate conversions with exact log-determinants.

PyTorch counterpart of the S2 parts of ``jammy_flows_tpu/ops/manifold.py``:
the angle clamps, the embedding and the (z, phi) column converters used by
the `f` layer's column path.  Coordinates are tuples of flat (B,) columns; the
log-det accumulator is (B,).
"""
from __future__ import annotations

import math

import torch

PI = math.pi
TWO_PI = 2.0 * math.pi


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


def spherical_to_eucl(x):
    """(B, 2) intrinsic (theta, phi) -> (B, 3) embedded unit vector (the
    log-det term is not needed by the callers)."""
    theta = safe_angle_within_pi(x[:, :1])
    phi = x[:, 1:2]
    st = torch.sin(theta)
    return torch.cat([st * torch.cos(phi), st * torch.sin(phi),
                      torch.cos(theta)], dim=1)


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
