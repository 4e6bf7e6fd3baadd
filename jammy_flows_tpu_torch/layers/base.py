"""Functional flow-layer protocol.

PyTorch counterpart of ``jammy_flows_tpu/layers/base.py``.  A layer is a
static configuration object that owns no tensors; its parameters arrive as a
(Bp, P) slab with Bp in {1, B}:

    forward(params, x, log_det)  -> (y, log_det')   # base -> target (sampling)
    inverse(params, y, log_det)  -> (x, log_det')   # target -> base (density)

S2 layers run on the (z, phi) column path instead
(``forward_cols_z``/``inverse_cols_z``, layers/sphere.py).
"""
from __future__ import annotations

import numpy as np


class FlowLayer:
    """Base class: static config only, pure-function mappings."""

    def __init__(self, dimension, always_parametrize_in_embedding_space=0):
        self.dimension = dimension
        self.always_parametrize_in_embedding_space = bool(
            always_parametrize_in_embedding_space)
        self.num_params = 0

    def forward(self, params, x, log_det):
        raise NotImplementedError

    def inverse(self, params, x, log_det):
        raise NotImplementedError

    def default_params(self, rng=None):
        """Initialization vector (num_params,), numpy float64: permanent
        parameters, or the amortization MLP's final-bias target."""
        rng = rng or np.random.default_rng(0)
        return rng.standard_normal(self.num_params)

    @property
    def intrinsic_dim(self):
        return self.dimension

    @property
    def embedded_dim(self):
        return self.dimension

    @property
    def base_dim(self):
        return self.dimension

    def embedding_conditional_return(self, x):
        """Embed target coordinates for downstream autoregressive
        conditioning."""
        return x


def split_params(params, sizes):
    """Split a (B, sum(sizes)) parameter slab into per-block views."""
    out = []
    idx = 0
    for s in sizes:
        out.append(params[:, idx:idx + s])
        idx += s
    return out
