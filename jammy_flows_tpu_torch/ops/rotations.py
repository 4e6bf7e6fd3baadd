"""Rotations of the `g` flow and of the sphere layers' embedding space:
householder (row and column form), givens angles, cayley, and the S2 modes
xyz (the z-axis turned onto a unit vector) and quaternion.

PyTorch counterpart of ``jammy_flows_tpu/ops/rotations.py``.
"""
from __future__ import annotations

import itertools

import torch


def householder_apply(vs, x, inverse=False):
    """Apply the product-of-reflections rotation R (or R^T when inverse) to
    x (B, d) without forming the matrix.  R = q1 q2 ... qn, so the forward
    map applies qn first and the inverse applies q1 first."""
    n_iter = vs.shape[1]
    order = range(n_iter) if inverse else reversed(range(n_iter))
    for i in order:
        v = vs[:, i, :]
        v = v / torch.sqrt(torch.sum(v**2, dim=-1, keepdim=True) + 1e-20)
        x = x - 2.0 * v * torch.sum(v * x, dim=-1, keepdim=True)
    return x


def householder_matrix(vs):
    """The product of reflections R = q1 q2 ... qn as a matrix: vs (B,
    n_iter, d) raw vectors -> (B, d, d)."""
    b, n_iter, d = vs.shape
    eye = torch.eye(d, dtype=vs.dtype, device=vs.device)
    q = eye.expand(b, d, d)
    for i in range(n_iter):
        v = vs[:, i, :]
        v = v / torch.sqrt(torch.sum(v**2, dim=-1, keepdim=True) + 1e-20)
        q = torch.bmm(q, eye - 2.0 * v[:, :, None] * v[:, None, :])
    return q


def householder_apply_cols(vs_cols, cols, inverse=False):
    """Column twin of householder_apply: cols is a tuple of d (B,) columns,
    vs_cols a list (n_iter) of lists (d) of (Bp,) raw reflection columns."""
    n_iter = len(vs_cols)
    d = len(cols)
    cols = list(cols)
    order = range(n_iter) if inverse else reversed(range(n_iter))
    for i in order:
        v = vs_cols[i]
        if len(v) != d:
            raise ValueError("reflection vector width differs from the "
                             "coordinate count")
        nrm = torch.sqrt(sum(c * c for c in v) + 1e-20)
        v = [c / nrm for c in v]
        dot = v[0] * cols[0]
        for j in range(1, d):
            dot = dot + v[j] * cols[j]
        cols = [c - 2.0 * vj * dot for c, vj in zip(cols, v)]
    return tuple(cols)


def givens_matrix(angles, d):
    """The product of Givens rotations over every pair i < j, the pair's
    rotation applied after those of the pairs before it: angles (Bp,
    d (d - 1) / 2) -> (Bp, d, d)."""
    b = angles.shape[0]
    eye = torch.eye(d, dtype=angles.dtype, device=angles.device)
    prev = eye.expand(b, d, d)
    for ind, (i, j) in enumerate(itertools.combinations(range(d), 2)):
        c = torch.cos(angles[:, ind, None])
        s = torch.sin(angles[:, ind, None])
        rows = list(prev.unbind(1))
        rows[i], rows[j] = c * rows[i] + s * rows[j], c * rows[j] - s * rows[i]
        prev = torch.stack(rows, dim=1)
    return prev


def cayley_matrix(param):
    """The 2-D Cayley rotation of t = param[:, 0] (Bp, 1):
    1 / (1 + t^2) [[1 - t^2, -2t], [2t, 1 - t^2]] -> (Bp, 2, 2)."""
    t = param[:, 0]
    mult = 1.0 / (1.0 + t**2)
    a = (1.0 - t**2) * mult
    off = 2.0 * t * mult
    row0 = torch.stack([a, -off], dim=-1)
    row1 = torch.stack([off, a], dim=-1)
    return torch.stack([row0, row1], dim=1)


def xyz_matrix(params):
    """The rotation turning the z-axis onto mu = params / |params|: params
    (Bp, 3) -> (Bp, 3, 3); singular at mu = -e_z (it divides by 1 + mu_z),
    as in the JAX package."""
    normed = params / torch.sqrt(torch.sum(params**2, dim=-1, keepdim=True)
                                 + 1e-20)
    mx, my, mz = normed[:, 0], normed[:, 1], normed[:, 2]
    opz = 1.0 + mz
    r00 = 1.0 - mx**2 / opz
    r11 = 1.0 - my**2 / opz
    r01 = -mx * my / opz
    row0 = torch.stack([r00, r01, mx], dim=-1)
    row1 = torch.stack([r01, r11, my], dim=-1)
    row2 = torch.stack([-mx, -my, mz], dim=-1)
    return torch.stack([row0, row1, row2], dim=1)


def quaternion_matrix(params):
    """The rotation of the unnormalized quaternion (a, i, j, k): params
    (Bp, 4) -> (Bp, 3, 3)."""
    sq = torch.sum(params**2, dim=-1) + 1e-20
    a, i, j, k = params[:, 0], params[:, 1], params[:, 2], params[:, 3]
    row0 = torch.stack([1.0 - 2.0 * (j**2 + k**2) / sq,
                        2.0 * (i * j - a * k) / sq,
                        2.0 * (i * k + j * a) / sq], dim=-1)
    row1 = torch.stack([2.0 * (i * j + a * k) / sq,
                        1.0 - 2.0 * (i**2 + k**2) / sq,
                        2.0 * (j * k - i * a) / sq], dim=-1)
    row2 = torch.stack([2.0 * (i * k - j * a) / sq,
                        2.0 * (j * k + i * a) / sq,
                        1.0 - 2.0 * (i**2 + j**2) / sq], dim=-1)
    return torch.stack([row0, row1, row2], dim=1)


def apply_matrix_cols(mat, cols, inverse=False):
    """(Bp, d, d) rotations applied to d (B,) columns: y_i = sum_j R_ij x_j
    (R^T when ``inverse``)."""
    d = len(cols)
    out = []
    for i in range(d):
        acc = None
        for j in range(d):
            r = mat[:, j, i] if inverse else mat[:, i, j]
            term = r * cols[j]
            acc = term if acc is None else acc + term
        out.append(acc)
    return tuple(out)


def apply_rotation(mat, x, inverse=False):
    """R x (R^T x when ``inverse``) for each row of x (B, d); mat (Bp, d, d)
    with Bp in {1, B}: a shared matrix is one 2-D product."""
    if mat.shape[0] == 1:
        m = mat[0]
        return torch.matmul(x, m if inverse else m.T)
    if inverse:
        return torch.einsum("bji,bj->bi", mat, x)
    return torch.einsum("bij,bj->bi", mat, x)
