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

    def param_structure(self):
        """Ordered (name, size) pairs of the packed parameter row (the
        named split of ``PDF.obtain_flow_param_structure``); the sizes sum to
        ``num_params``."""
        return [("params", self.num_params)] if self.num_params else []

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

    def transform_target_space(self, x, log_det=0.0, transform_from="default",
                               transform_to="embedding"):
        """Target coordinates from one system ("default", "intrinsic",
        "embedding") to another; the identity for Euclidean and interval
        layers."""
        return x, log_det


def named_parts(layer, parts):
    """The named parts, checked to cover the layer's parameters."""
    if sum(s for _, s in parts) != layer.num_params:
        raise ValueError((type(layer).__name__, parts, layer.num_params))
    return parts


def coordinates_intrinsic(layer, transform_from, transform_to):
    """(whether the coordinates are intrinsic now, whether they are wanted
    intrinsic) for a manifold layer with an embedding."""
    emb = layer.always_parametrize_in_embedding_space
    now = {"default": not emb, "embedding": False}.get(transform_from, True)
    want = {"default": not emb, "intrinsic": True}.get(transform_to, False)
    return now, want


def split_params(params, sizes):
    """Split a (B, sum(sizes)) parameter slab into per-block views."""
    out = []
    idx = 0
    for s in sizes:
        out.append(params[:, idx:idx + s])
        idx += s
    return out
