"""MLP-predicted parameter slabs kept as their factors.

PyTorch counterpart of ``jammy_flows_tpu/ops/lazy_params.py``: the (B, P)
slab ``hidden @ w.T + b`` is never formed where a kernel takes its factors.

* The whole-block kernel's fused-MLP ("lazy2") mode reads ``summary``, ``w1``
  and ``b1`` and makes ``hidden = tanh(summary @ w1.T + b1)`` itself.
* The whole-block kernel's "lazy" mode (``ops/gf_block.py``, for an MLP of
  more hidden layers or a summary wider than 128) and the per-layer kernels'
  lazy interface (``ops/gf_layer.py``) read the precomputed ``hidden``
  (B, H), made once per sub-pdf by ``AmortizableMLP.apply_penultimate``, and
  the rows of ``w`` / ``b`` (the block's all, a layer's its mixture groups').

Column slices (the per-layer splits of the orchestrator) slice rows of ``w``
and ``b``.  Layers without a lazy interface materialize the rows they need.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class LazyParams:
    """w (P, H), b (P,); hidden (B, H), or the fused one-hidden-layer MLP
    that makes it: summary (B, In), w1 (H, In), b1 (H,)."""
    w: torch.Tensor
    b: torch.Tensor
    hidden: torch.Tensor | None = None
    summary: torch.Tensor | None = None
    w1: torch.Tensor | None = None
    b1: torch.Tensor | None = None

    def hidden_act(self):
        """(B, H): the precomputed hidden, else tanh(summary @ w1.T + b1)."""
        if self.hidden is not None:
            return self.hidden
        return torch.tanh(torch.matmul(self.summary, self.w1.T) + self.b1)

    def rows(self, lo, hi):
        """The slab's parameter columns lo:hi, still factored."""
        return dataclasses.replace(self, w=self.w[lo:hi], b=self.b[lo:hi])

    def materialize(self):
        """(B, P) = hidden @ w.T + b."""
        return torch.matmul(self.hidden_act(), self.w.T) + self.b

    def materialize_T(self):
        """(P, B) = w @ hidden.T + b[:, None]: param-major for the column
        path."""
        return torch.matmul(self.w, self.hidden_act().T) + self.b[:, None]


def materialize_if_lazy(p):
    return p.materialize() if isinstance(p, LazyParams) else p


def for_layer(sl, layer):
    """A layer's parameter columns: kept factored for a layer that takes
    lazy rows (``accepts_lazy_params``), materialized otherwise."""
    if isinstance(sl, LazyParams) and \
            not getattr(layer, "accepts_lazy_params", False):
        return sl.materialize()
    return sl
