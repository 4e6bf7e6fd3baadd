"""Householder rotations, in row and column form.

PyTorch counterpart of the householder parts of
``jammy_flows_tpu/ops/rotations.py``.  The other rotation modes (givens
angles, cayley, xyz, quaternion) wait for the layers that use them.
"""
from __future__ import annotations

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
