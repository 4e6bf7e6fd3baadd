"""Checkpoint/restore of flow parameters and sampler state.

PyTorch counterpart of ``jammy_flows_tpu/utils/checkpoint.py``: one
``torch.save`` file holding ``{"params", "extra_state"}`` (a parameter dict
plus any optimizer or sampler state: tensors, numbers, strings and
dicts / lists / tuples of them), loaded with ``weights_only=True``.  The
JAX package's orbax directories are not read here; JAX parameters cross
over through utils/convert.params_from_jax.
"""
from __future__ import annotations

import pathlib

import torch


def save(path, params, extra_state=None):
    """Save a parameter dict (+ optional sampler/optimizer state) to the
    file ``path``, making its directory; tensors are saved detached."""
    payload = {"params": _detach(params)}
    if extra_state is not None:
        payload["extra_state"] = _detach(extra_state)
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(payload, path)


def restore(path, like_params=None, like_extra_state=None):
    """Restore; pass ``like_*`` trees (e.g. pdf.init_params()) to give each
    tensor the device and dtype of its counterpart there (otherwise they
    load on the CPU).  Returns (params, extra_state|None)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    params = payload["params"]
    extra = payload.get("extra_state")
    if like_params is not None:
        params = _like(params, like_params)
    if like_extra_state is not None and extra is not None:
        extra = _like(extra, like_extra_state)
    return params, extra


def _detach(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detach(v) for v in tree)
    return tree


def _like(tree, like):
    """tree's tensors on the device and in the dtype of like's."""
    if isinstance(tree, torch.Tensor) and isinstance(like, torch.Tensor):
        return tree.to(device=like.device, dtype=like.dtype)
    if isinstance(tree, dict):
        return {k: _like(v, like[k]) if k in like else v
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_like(v, w) for v, w in zip(tree, like))
    return tree
