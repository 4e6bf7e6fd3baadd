"""Parameter conversion between the JAX package and the port."""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params, device="cpu", dtype=None):
    """JAX parameter dict (arrays or numpy arrays, keys "flow_0" and
    "mlp_<k>") -> dict of torch tensors on ``device``.  The packed slabs
    have the same layout in both packages, so values load 1:1; ``dtype``
    (a torch dtype) overrides the source dtype."""
    return {key: torch.as_tensor(np.array(val), dtype=dtype, device=device)
            for key, val in params.items()}


def to_numpy(tree):
    """A tensor, or a dict / list / tuple of them (parameters, gradients),
    as numpy arrays in the same structure, copied to the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return np.asarray(tree)
