"""Data-driven initialization of a chain of Euclidean layers.

PyTorch counterpart of ``jammy_flows_tpu/models/init.py``, run on the host
in float64 with numpy and scipy as there: the layers are visited from the
last to the first; an offset takes the data's mean, a `t` layer a
covariance fit (scipy.optimize.minimize of the reverse KL divergence), a
classic `g` layer a householder rotation fitted to the data's principal
axes (scipy.optimize.minimize, from the same random draws) and mixture
means from the data's percentiles, and the data is decorrelated and
gaussianized on the way, so each earlier layer sees what the later ones
leave.  ``PDF.init_params(data=...)`` calls it for a Euclidean first
sub-pdf.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg
import torch
from scipy.optimize import minimize

from ..ops import logistic_kde, matrix, rotations


def _householder(vs, n_iter, dim):
    """The (dim, dim) householder matrix of the raw vectors vs, in float64
    on the CPU."""
    t = torch.as_tensor(np.asarray(vs, dtype=np.float64).reshape(
        1, n_iter, dim))
    return rotations.householder_matrix(t)[0].numpy()


def _fit_householder_to_orthogonal(target_matrix, n_iter, dim, rng):
    """Householder parameters whose rotation maps the diagonal test vector
    as the orthogonal ``target_matrix`` does."""
    test_vec = np.ones(dim) / np.sqrt(dim)
    v2 = target_matrix @ test_vec

    def loss(a):
        return -float((_householder(a, n_iter, dim) @ test_vec) @ v2)

    start = rng.standard_normal(n_iter * dim)
    return minimize(loss, start)["x"]


def _mvn_lower(layer, a, dim):
    """The lower-triangular factor of a `t` layer's covariance parameters
    a (num_cov_params,)."""
    single, full, off = layer._unpack(torch.as_tensor(a[None, :]))
    if layer.cov_type == "diagonal_symmetric":
        return np.eye(dim) * float(np.exp(single[0, 0].item()))
    if layer.cov_type == "diagonal":
        return np.diag(np.exp(full[0].numpy()))
    return matrix.build_lower_triangular(dim, full, off)[0][0].numpy()


def _fit_mvn_to_cov(layer, target_cov, dim, rng):
    """`t` layer parameters whose L L^T fits ``target_cov`` by reverse KL;
    returns them and the whitening matrix of the fit."""
    inv_target = scipy.linalg.pinv(target_cov)
    _, logdet_target = np.linalg.slogdet(target_cov)

    def loss(a):
        lower = _mvn_lower(layer, a, dim)
        pred = lower @ lower.T
        _, logdet_pred = np.linalg.slogdet(pred)
        return 0.5 * (np.trace(inv_target @ pred) - logdet_pred
                      + logdet_target - dim)

    start = rng.standard_normal(layer.num_cov_params)
    res = minimize(loss, start)
    lower = _mvn_lower(layer, res["x"], dim)
    _, sigma, r = scipy.linalg.svd(scipy.linalg.pinv(lower @ lower.T))
    return res["x"], np.sqrt(sigma)[:, None] * r


def find_init_pars_of_chained_blocks(layers, data, rng,
                                     mvn_min_max_sv_ratio=1e-4):
    """The init vector (numpy, sum of the layers' num_params) of a chain of
    Euclidean layers for data (N, D), drawing from the numpy generator
    ``rng`` as the JAX package does."""
    from ..layers.euclidean import GaussianizationFlow, MultivariateNormal

    cur = np.asarray(data, dtype=np.float64)
    dim = cur.shape[1]
    all_params = []
    for layer_ind, layer in enumerate(reversed(layers)):
        parts = []
        if getattr(layer, "model_offset", 0):
            means = cur.mean(axis=0, keepdims=True)
            parts.append(means[0])
            cur = cur - means
        if isinstance(layer, MultivariateNormal):
            if layer.cov_type != "identity":
                l, sigma, r = scipy.linalg.svd(cur.T @ cur / cur.shape[0])
                fixed = (l * np.maximum(sigma, mvn_min_max_sv_ratio
                                        * sigma.max())) @ r
                pars, whiten = _fit_mvn_to_cov(layer, fixed, dim, rng)
                parts.append(pars)
                cur = cur @ whiten.T
        elif isinstance(layer, GaussianizationFlow) and \
                layer.nonlinear_stretch_type == "classic":
            if layer.rotation_mode == "householder" and \
                    layer.num_rotation_params > 0:
                if dim < 30 and layer_ind == 0:
                    _, _, r = scipy.linalg.svd(cur.T @ cur)
                    vs = _fit_householder_to_orthogonal(
                        r, layer.householder_iter, dim, rng)
                else:
                    vs = rng.standard_normal(layer.num_rotation_params)
                parts.append(vs)
                # the inverse rotation: x @ R = R^T x
                cur = cur @ _householder(vs, layer.householder_iter, dim)
            elif layer.rotation_mode != "none":
                parts.append(np.zeros(layer.num_rotation_params))
            k = layer.num_kde
            percentiles = np.percentile(cur, np.linspace(0, 100, k), axis=0)
            parts.append((percentiles if layer.center_mean == 0
                          else percentiles[:-1]).flatten())
            diffs = percentiles[1:, :] - percentiles[:-1, :]
            bw = np.log(np.maximum(diffs.min(axis=0), 1e-6) * 1.5)
            bw_full = np.broadcast_to(bw[None, :], (k, dim))
            parts.append(bw_full.flatten())
            if layer.fit_normalization:
                parts.append(np.ones(k * dim))
            if layer.add_skewness:
                parts.append(np.zeros(k * dim))
            # gaussianize the data for the next (earlier) layer; the
            # mixture's parameters (K, D, 1)
            cur = logistic_kde.gaussianize_value(
                torch.as_tensor(cur), torch.as_tensor(percentiles[..., None]),
                torch.as_tensor(np.ascontiguousarray(bw_full[..., None])),
                torch.zeros((k, dim, 1), dtype=torch.float64),
                layer.inverse_function_type).numpy()
        else:
            parts.append(layer.default_params(rng))
        vec = np.concatenate(parts) if parts else np.zeros(0)
        if len(vec) != layer.num_params:
            raise ValueError((type(layer).__name__, len(vec),
                              layer.num_params))
        all_params.append(vec)
    return np.concatenate(all_params[::-1])
