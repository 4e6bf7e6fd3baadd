"""vMF and ZLP-Kent approximations on S2.

PyTorch counterpart of ``jammy_flows_tpu/utils/vmf_kent.py``, itself the
equivalent of helper_fns/approximation_coverage_calculation.py,
helper_fns/approximation_samplers.py and main/zlp_kent_ml_fit.py
(arXiv:2510.04762 Kent-like construction): closed-form vMF HPD coverage,
zlp-Kent log-pdf / sampler / Monte-Carlo coverage, and a batched
maximum-likelihood zlp-Kent fit (quaternion rotation parametrization) done
with a batched Adam and a batched damped Newton (torch.func) instead of the
reference's masked-Adam + Newton host loop.  The closed forms and samplers
are the JAX package's numpy code.
"""
from __future__ import annotations

import math

import numpy as np
import torch

LOG_4PI = math.log(4.0 * math.pi)


def _normalize_rows(x, eps=1e-15):
    x = np.asarray(x, dtype=float)
    return x / np.clip(np.linalg.norm(x, axis=-1, keepdims=True), eps, None)


def _stable_log_sinh_np(x):
    x = np.asarray(x, dtype=float)
    small = x < 20.0
    out = np.where(small, np.log(np.sinh(np.where(small, x, 1.0))),
                   x - math.log(2.0) + np.log1p(-np.exp(-2.0 * np.where(small, 20.0, x))))
    return out


def vmf_coverage_s2_batch(target_x, mu, kappa):
    """Exact HPD coverage of target points under batched vMF fits
    (approximation_coverage_calculation.py:37-91):
    c = (1 - e^{k(z-1)}) / (1 - e^{-2k})."""
    target_x = _normalize_rows(target_x)
    mu = _normalize_rows(mu)
    kappa = np.asarray(kappa, dtype=float).reshape(-1)
    z = np.clip(np.sum(target_x * mu, axis=1), -1.0, 1.0)
    out = np.ones_like(kappa)
    m = kappa > 0
    num = 1.0 - np.exp(kappa[m] * (z[m] - 1.0))
    den = 1.0 - np.exp(-2.0 * kappa[m])
    out[m] = num / den
    return np.clip(out, 0.0, 1.0)


def sample_vmf_s2(mu, kappa, n, rng=None):
    """Exact vMF sampler on S2 via inverse-CDF in z
    (approximation_samplers.py:25-56)."""
    rng = rng or np.random.default_rng(0)
    mu = _normalize_rows(np.atleast_2d(mu))[0]
    u = rng.uniform(size=n)
    # z ~ (k/(2 sinh k)) e^{kz}: z = 1 + log(u + (1-u) e^{-2k})/k
    z = 1.0 + np.log(u + (1.0 - u) * np.exp(-2.0 * kappa)) / kappa
    z = np.clip(z, -1.0, 1.0)
    phi = rng.uniform(0, 2 * np.pi, size=n)
    rho = np.sqrt(np.clip(1 - z**2, 0, None))
    local = np.stack([rho * np.cos(phi), rho * np.sin(phi), z], axis=1)
    # frame with e3 = mu
    ref = np.array([0.0, 0.0, 1.0]) if abs(mu[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
    t1 = ref - mu * (ref @ mu)
    t1 /= np.linalg.norm(t1)
    t2 = np.cross(mu, t1)
    frame = np.stack([t1, t2, mu], axis=1)
    return local @ frame.T


def _rotation_from_gammas(gamma1, gamma2, gamma3):
    """Batched rotations with columns (gamma2, gamma3, gamma1)
    (approximation_coverage_calculation.py:94-114)."""
    gamma1 = _normalize_rows(gamma1)
    gamma2 = gamma2 - np.sum(gamma2 * gamma1, axis=1, keepdims=True) * gamma1
    gamma2 = _normalize_rows(gamma2)
    g3 = _normalize_rows(np.cross(gamma1, gamma2))
    flip = np.sum(g3 * gamma3, axis=1) < 0.0
    gamma2[flip] *= -1.0
    g3[flip] *= -1.0
    return np.stack([gamma2, g3, gamma1], axis=-1)


def zlpkent_logpdf_s2_batch(target_x, gamma1, gamma2, gamma3, kappa, u):
    """Exact batched zlp-Kent log-pdf
    (approximation_coverage_calculation.py:116-163).

    target_x: (B, 3) one point per batch item, or (B, N, 3) N points per
    batch item; Kent parameters batched (B, ...).  Returns (B,) or (B, N).
    """
    target_x = _normalize_rows(target_x)
    kappa = np.asarray(kappa, dtype=float).reshape(-1)
    u = np.asarray(u, dtype=float).reshape(-1)
    R = _rotation_from_gammas(gamma1, gamma2, gamma3)
    if target_x.ndim == 3:
        Y = np.einsum("bni,bij->bnj", target_x, R)
        kappa = kappa[:, None]
        u = u[:, None]
    else:
        Y = np.einsum("bi,bij->bj", target_x, R)
    inv_u = 1.0 / u
    r2 = (Y[..., 0] * inv_u)**2 + (Y[..., 1] * u)**2 + Y[..., 2]**2
    r = np.sqrt(np.clip(r2, 1e-300, None))
    z_base = Y[..., 2] / r
    log_norm = np.log(kappa) - LOG_4PI - _stable_log_sinh_np(kappa)
    return log_norm + kappa * z_base - 1.5 * np.log(r2)


def sample_zlpkent_s2_batch(gamma1, gamma2, gamma3, kappa, u, n_ref, seed=0):
    """Batched zlp-Kent sampler: uniform base -> stable Fisher zoom ->
    diag(u, 1/u, 1) projection -> rotation
    (approximation_coverage_calculation.py:166-230)."""
    gamma1 = np.asarray(gamma1, float)
    B = gamma1.shape[0]
    kappa = np.asarray(kappa, float).reshape(-1)
    u = np.asarray(u, float).reshape(-1)
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(B, n_ref, 3))
    base /= np.linalg.norm(base, axis=2, keepdims=True)
    z0 = np.clip(base[:, :, 2], -1.0, 1.0)
    kk = kappa[:, None]
    log_term = np.logaddexp(np.log1p(z0), np.log1p(-z0) - 2.0 * kk)
    z1 = np.clip(1.0 + (log_term - np.log(2.0)) / kk, -1.0, 1.0)
    phi = np.arctan2(base[:, :, 1], base[:, :, 0])
    rho1 = np.sqrt(np.clip(1.0 - z1**2, 0.0, None))
    zoom = np.stack([rho1 * np.cos(phi), rho1 * np.sin(phi), z1], axis=-1)
    uu = u[:, None]
    y = np.stack([uu * zoom[:, :, 0], (1.0 / uu) * zoom[:, :, 1],
                  zoom[:, :, 2]], axis=-1)
    y /= np.linalg.norm(y, axis=2, keepdims=True)
    R = _rotation_from_gammas(gamma1, np.asarray(gamma2, float),
                              np.asarray(gamma3, float))
    return np.einsum("bnj,bij->bni", y, R)


def coverage_from_logpdf_samples(ref_logpdf, target_logpdf, weights=None):
    """HPD coverage from reference-sample log-pdfs: fraction of reference
    draws with density >= target density
    (approximation_coverage_calculation.py:233-346)."""
    ref_logpdf = np.asarray(ref_logpdf)
    target_logpdf = np.asarray(target_logpdf).reshape(-1, 1)
    if weights is None:
        return (ref_logpdf >= target_logpdf).mean(axis=1)
    w = np.asarray(weights)
    w = w / w.sum(axis=1, keepdims=True)
    return ((ref_logpdf >= target_logpdf) * w).sum(axis=1)


def zlp_kent_coverage(target_samples, gamma1, gamma2, gamma3, kappa, u,
                      num_samples_per_bitem=10000, seed=0):
    """Monte-Carlo HPD coverage of targets under fitted zlp-Kent models
    (approximation_coverage_calculation.py:349-373)."""
    B = np.asarray(gamma1).shape[0]
    ref = sample_zlpkent_s2_batch(gamma1, gamma2, gamma3, kappa, u,
                                  num_samples_per_bitem, seed=seed)
    ref_lp = np.stack([
        zlpkent_logpdf_s2_batch(
            ref[b], np.repeat(np.asarray(gamma1)[b:b + 1],
                              num_samples_per_bitem, axis=0),
            np.repeat(np.asarray(gamma2)[b:b + 1], num_samples_per_bitem, axis=0),
            np.repeat(np.asarray(gamma3)[b:b + 1], num_samples_per_bitem, axis=0),
            np.repeat(np.asarray(kappa).reshape(-1)[b:b + 1],
                      num_samples_per_bitem),
            np.repeat(np.asarray(u).reshape(-1)[b:b + 1],
                      num_samples_per_bitem))
        for b in range(B)])
    tgt_lp = zlpkent_logpdf_s2_batch(target_samples, gamma1, gamma2, gamma3,
                                     kappa, u)
    return coverage_from_logpdf_samples(ref_lp, tgt_lp)




# ---------------------------------------------------------------------------
# batched ML fit (torch)
# ---------------------------------------------------------------------------

# optax.adam's defaults: b1, b2 and eps (outside the square root)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _rotmat_from_quat_raw(q):
    """The rotation of the normalized quaternion q = (a, i, j, k)."""
    q = q / torch.linalg.norm(q)
    a, i, j, k = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1 - 2 * (j**2 + k**2), 2 * (i * j - a * k),
                     2 * (i * k + j * a)]),
        torch.stack([2 * (i * j + a * k), 1 - 2 * (i**2 + k**2),
                     2 * (j * k - i * a)]),
        torch.stack([2 * (i * k - j * a), 2 * (j * k + i * a),
                     1 - 2 * (i**2 + j**2)])])


def _stable_log_sinh(x):
    small = x < 20.0
    xs = torch.where(small, x, torch.ones_like(x))
    return torch.where(small, torch.log(torch.sinh(xs)),
                       x - math.log(2.0) + torch.log1p(
                           -torch.exp(-2.0 * torch.clamp(x, min=20.0))))


def _zlpkent_negloglike_flat(vec, X):
    """Mean negative log-likelihood of samples X (N, 3) under a zlp-Kent
    with parameters vec = (log_kappa, raw_u, qraw[4])
    (zlp_kent_ml_fit.py:201-260)."""
    log_kappa, raw_u, qraw = vec[0], vec[1], vec[2:6]
    kappa = torch.clamp(torch.exp(log_kappa), min=1e-10)
    L = 0.5 * torch.log1p(kappa / 3.0)
    safe_log_u = raw_u * L / torch.sqrt(L**2 + raw_u**2 + 1e-30)
    u = torch.exp(safe_log_u)
    R = _rotmat_from_quat_raw(qraw)
    Y = X @ R                                      # = R^T applied per row
    r2 = torch.clamp((Y[:, 0] / u)**2 + (Y[:, 1] * u)**2 + Y[:, 2]**2,
                     min=1e-15)
    z3 = Y[:, 2] / torch.sqrt(r2)
    log_norm = torch.log(kappa) - LOG_4PI - _stable_log_sinh(kappa)
    ll = log_norm + kappa * z3 - 1.5 * torch.log(r2)
    return -torch.mean(ll)


def fit_zlpkent_batch_quat(samples, num_steps=300, learning_rate=5e-2,
                           newton_steps=0, grad_tol=None):
    """Batched ML fit of zlp-Kent distributions to sample sets.

    samples: (B, N, 3) unit vectors, a tensor (the fit runs on its device,
    in its dtype) or a numpy array (on the CPU).  Returns a dict of numpy
    arrays: gamma1/2/3 (B,3), kappa (B,), u (B,), loglike (B,), grad_norm
    (B,).  Each item's parameters (log kappa, raw u, a raw quaternion) take
    ``num_steps`` of Adam as ``optax.adam(learning_rate)`` defines it (the
    batch's losses are independent and Adam is elementwise, so one batched
    update is the JAX package's vmapped one), then up to ``newton_steps``
    of a damped Newton (Levenberg-Marquardt on the 6 free parameters; the
    quaternion's scale gauge is handled by the damping) with per-item
    gradients and Hessians from ``torch.func``.

    ``grad_tol``: an item leaves the Newton loop once its mean-NLL gradient
    norm is at most ``grad_tol`` (and keeps its parameters and damping from
    then on, as the JAX package's vmapped while-loop keeps a stopped item's
    carry); ``grad_norm`` in the output reports the achieved value.
    """
    from torch.func import grad, hessian, vmap

    X = torch.as_tensor(samples)
    B, N = X.shape[0], X.shape[1]

    # init: Banerjee kappa from resultant, quaternion aligning e_z -> mean
    resultant = X.mean(dim=1)
    rbar = torch.clamp(torch.linalg.norm(resultant, dim=-1), 1e-6, 1 - 1e-6)
    mean_dir = resultant / rbar[:, None]
    kappa0 = rbar * (3.0 - rbar**2) / (1.0 - rbar**2)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=X.dtype, device=X.device)
    dots = mean_dir @ ez
    axis = torch.linalg.cross(ez.expand_as(mean_dir), mean_dir, dim=-1)
    q0 = torch.cat([(1.0 + dots)[:, None], axis], dim=1)
    q0 = q0 / torch.linalg.norm(q0, dim=1, keepdim=True)
    V = torch.cat([torch.log(kappa0)[:, None], torch.zeros_like(kappa0)[:, None],
                   q0], dim=1)

    nll = vmap(_zlpkent_negloglike_flat)
    grads = vmap(grad(_zlpkent_negloglike_flat))
    m = torch.zeros_like(V)
    v = torch.zeros_like(V)
    for t in range(1, num_steps + 1):
        g = grads(V, X)
        m = (1.0 - ADAM_B1) * g + ADAM_B1 * m
        v = (1.0 - ADAM_B2) * g * g + ADAM_B2 * v
        m_hat = m / (1.0 - ADAM_B1**t)
        v_hat = v / (1.0 - ADAM_B2**t)
        V = V - learning_rate * (m_hat / (torch.sqrt(v_hat) + ADAM_EPS))

    if newton_steps:
        hess = vmap(hessian(_zlpkent_negloglike_flat))
        tol = 0.0 if grad_tol is None else grad_tol
        lam = torch.full((B,), 1e-4, dtype=V.dtype, device=V.device)
        eye = torch.eye(6, dtype=V.dtype, device=V.device)
        for _ in range(newton_steps):
            g = grads(V, X)
            active = torch.linalg.norm(g, dim=1) > tol
            if not bool(active.any()):
                break
            # solve_ex: a singular damped Hessian gives a non-finite step,
            # which the acceptance test below rejects, instead of raising
            delta = torch.linalg.solve_ex(
                hess(V, X) + lam[:, None, None] * eye, g[:, :, None])[0][..., 0]
            v_new = V - delta
            better = (nll(v_new, X) < nll(V, X)) \
                & torch.isfinite(v_new).all(dim=1)
            V = torch.where((active & better)[:, None], v_new, V)
            lam = torch.where(active, torch.clamp(
                torch.where(better, lam * 0.3, lam * 10.0), 1e-8, 1e6), lam)

    gnorm = torch.linalg.norm(grads(V, X), dim=1)
    loglike = -nll(V, X) * N
    kappa = torch.exp(V[:, 0])
    L = 0.5 * torch.log1p(kappa / 3.0)
    raw = V[:, 1]
    u = torch.exp(raw * L / torch.sqrt(L**2 + raw**2 + 1e-30))
    R = vmap(_rotmat_from_quat_raw)(V[:, 2:6])

    def host(t):
        return t.detach().cpu().numpy()
    return {"gamma1": host(R[:, :, 2]), "gamma2": host(R[:, :, 0]),
            "gamma3": host(R[:, :, 1]), "kappa": host(kappa), "u": host(u),
            "loglike": host(loglike), "grad_norm": host(gnorm)}
