"""Triangular matrices with a positive diagonal, for the affine flow (`t`)
and the `g` flow's triangular_combination rotation.

PyTorch counterpart of ``jammy_flows_tpu/ops/matrix.py``: the forward
direction multiplies, the inverse direction solves
(``torch.linalg.solve_triangular``), and the log-determinant is the sum of
the log-diagonal in both directions.  Matrices come as (Bp, d, d) with Bp in
{1, B}: one shared matrix (permanent parameters) is applied as one 2-D
product or solve over every row, per-row matrices (amortized parameters) as
a batched one.
"""
from __future__ import annotations

import torch


def build_lower_triangular(dim, log_diagonal, off_diagonal, upper=False):
    """(Bp, dim, dim) with diagonal exp(log_diagonal) and the strictly lower
    entries ``off_diagonal`` (Bp, dim (dim - 1) / 2) in row-major order
    (transposed when ``upper``), and its log-determinant (Bp,)."""
    b = log_diagonal.shape[0]
    mat = torch.diag_embed(torch.exp(log_diagonal))
    if dim > 1 and off_diagonal is not None and off_diagonal.shape[-1] > 0:
        rows, cols = torch.tril_indices(dim, dim, offset=-1)
        flat = torch.zeros((b, dim * dim), dtype=log_diagonal.dtype,
                           device=log_diagonal.device)
        flat[:, (rows * dim + cols).to(log_diagonal.device)] = off_diagonal
        mat = mat + flat.reshape(b, dim, dim)
    if upper:
        mat = mat.transpose(-1, -2)
    return mat, torch.sum(log_diagonal, dim=-1)


def _tri_matvec(mat, x):
    """(Bp, d, d) applied to the rows of x (B, d)."""
    if mat.shape[0] == 1:
        return torch.matmul(x, mat[0].T)
    return torch.einsum("bij,bj->bi", mat, x)


def _tri_solve(mat, x, lower):
    """Solve mat y = x for each row of x (B, d)."""
    if mat.shape[0] == 1:
        return torch.linalg.solve_triangular(mat[0], x.T, upper=not lower).T
    mat = mat.expand((x.shape[0],) + mat.shape[1:])
    return torch.linalg.solve_triangular(mat, x[..., None],
                                         upper=not lower)[..., 0]


def triangular_apply(dim, cov_type, params_tuple, x, inverse=False):
    """y = L x (or x = L^-1 y when ``inverse``) for the affine flow's
    covariance types; params_tuple = (single_log_diag, full_log_diag,
    off_diag).  Returns (result, log|det|), the log-determinant negated for
    the inverse."""
    single_log_diag, full_log_diag, off_diag = params_tuple
    if cov_type == "identity":
        return x, torch.zeros(x.shape[:1], dtype=x.dtype, device=x.device)
    if cov_type == "diagonal_symmetric":
        ld = dim * single_log_diag[:, 0]
        if inverse:
            return x * torch.exp(-single_log_diag), -ld
        return x * torch.exp(single_log_diag), ld
    if cov_type == "diagonal":
        ld = torch.sum(full_log_diag, dim=-1)
        if inverse:
            return x * torch.exp(-full_log_diag), -ld
        return x * torch.exp(full_log_diag), ld
    if cov_type == "full":
        mat, ld = build_lower_triangular(dim, full_log_diag, off_diag)
        if inverse:
            return _tri_solve(mat, x, lower=True), -ld
        return _tri_matvec(mat, x), ld
    raise ValueError(f"Unknown cov type {cov_type}")


def triangular_combination_apply(dim, left_pars, diag_pars, right_pars, x,
                                 inverse=False):
    """The volume-preserving L D U map (the `g` flow's
    triangular_combination rotation): L and U unit triangular from
    left_pars / right_pars (Bp, dim (dim - 1) / 2), D = exp(diag) with
    diag_pars (Bp, dim - 1) and a last entry of minus their sum."""
    zeros = torch.zeros((left_pars.shape[0], dim), dtype=x.dtype,
                        device=x.device)
    upper, _ = build_lower_triangular(dim, zeros, right_pars, upper=True)
    lower, _ = build_lower_triangular(dim, zeros, left_pars)
    diag = torch.cat([diag_pars, -torch.sum(diag_pars, dim=1, keepdim=True)],
                     dim=1)
    if inverse:
        y = _tri_solve(lower, x, lower=True)
        y = y * torch.exp(-diag)
        return _tri_solve(upper, y, lower=False)
    y = _tri_matvec(upper, x)
    y = y * torch.exp(diag)
    return _tri_matvec(lower, y)
