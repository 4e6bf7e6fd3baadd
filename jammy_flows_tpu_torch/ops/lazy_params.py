"""MLP-predicted parameter slabs kept as their factors.

PyTorch counterpart of ``jammy_flows_tpu/ops/lazy_params.py`` for the
fused-MLP ("lazy2") mode: the (B, P) slab is ``tanh(summary @ w1.T + b1)
@ w.T + b`` and is never formed on the block-kernel path, where the CUDA
kernel runs both matmuls itself.  Layers without a kernel materialize the
rows they need.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class LazyParams:
    """summary (B, In), w1 (H, In), b1 (H,), w (P, H), b (P,)."""
    summary: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w: torch.Tensor
    b: torch.Tensor

    def hidden(self):
        return torch.tanh(torch.matmul(self.summary, self.w1.T) + self.b1)

    def rows(self, lo, hi):
        """The slab's parameter columns lo:hi, still factored."""
        return dataclasses.replace(self, w=self.w[lo:hi], b=self.b[lo:hi])

    def materialize(self):
        """(B, P) = hidden @ w.T + b."""
        return torch.matmul(self.hidden(), self.w.T) + self.b

    def materialize_T(self):
        """(P, B) = w @ hidden.T + b[:, None]: param-major for the column
        path."""
        return torch.matmul(self.w, self.hidden().T) + self.b[:, None]
