"""Logistic-mixture KDE math of the Gaussianization flow.

PyTorch counterpart of ``jammy_flows_tpu/ops/logistic_kde.py``.

  * log CDF / log SF / log PDF of a normalized logistic mixture, with the
    JAX package's hand-written tangent rule when the pdf is asked for, and
    of the skewed mixture (per-component exponents and +-1 signs: the f32
    ``skew_mixture_logs`` the per-layer kernels share, the f64 log-space
    chain; plain autograd, as the JAX package differentiates it);
  * the four inverse-Gaussian-CDF passes (isigmoid, inormal_partly_precise,
    inormal_partly_crude, inormal_full_pade) and their log-derivatives, each
    with the f64 branch (exact ndtri / erfinv) and the f32 branch (the
    log-space seam and erfinv-from-ln_fac formulation the CUDA block kernel
    shares, csrc/gf_common.cuh).

Shapes follow the JAX package: x is (B, D); mixture parameters are (K, D, Bp)
with Bp in {1, B}; reductions run over axis 0.
"""
from __future__ import annotations

import math

import torch

from .special import (log_one_plus_exp_x_to_a_minus_1, logaddexp, softplus,
                      sum_to)

PADE_BOUND = 0.5e-7
PADE_A = 0.147
SQRT2 = math.sqrt(2.0)
LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
LOG_4 = math.log(4.0)
LOG_CENTER_DERIV = math.log(2.506628)
FULL_PADE_F32_CENTER = 0.1
SQRT_HALF_PI = math.sqrt(math.pi / 2.0)
ERFINV_SLOPE = math.sqrt(math.pi) / 2.0
ERFINV_CUBIC = math.pi / 12.0
# central seam of the erfinv argument reconstruction (ln_fac > -1 uses the
# difference form cdf - sf; see the JAX module for the derivation)
LIN_SEAM_LNFAC = -1.0
# the mixture's fallback lanes: taken where every component lies beyond
# this many width-units (|c| > FALLBACK_SEAM), as csrc/gf_common.cuh
# FALLBACK_SEAM; read at each call, so that a probe can move it
FALLBACK_SEAM = 55.0
LOG_SEAM = math.log(4.0 * PADE_BOUND * (1.0 - PADE_BOUND))


def _tiny(t):
    return torch.finfo(t.dtype).tiny


def _linear_logs_primal(common, norm_w, log_norm_w, inv_widths,
                        log_inv_widths, need_pdf):
    tiny = _tiny(common)
    u = torch.clamp(common, -60.0, 60.0)
    e = torch.exp(u)
    r = 1.0 / (1.0 + e)
    sig = e * r
    F = torch.sum(norm_w * sig, dim=0)
    SF = torch.sum(norm_w * r, dim=0)
    neg_all = torch.amax(common, dim=0) < -FALLBACK_SEAM
    pos_all = torch.amin(common, dim=0) > FALLBACK_SEAM
    mc = torch.amax(log_norm_w + torch.clamp(common, max=0.0), dim=0)
    ms = torch.amax(log_norm_w - torch.clamp(common, min=0.0), dim=0)
    log_cdf = torch.where(neg_all, mc, torch.log(torch.clamp(F, min=tiny)))
    log_sf = torch.where(pos_all, ms, torch.log(torch.clamp(SF, min=tiny)))
    if not need_pdf:
        return (log_cdf, log_sf, None), None
    P = torch.sum((norm_w * inv_widths) * (sig * r), dim=0)
    far = torch.amin(torch.abs(common), dim=0) > FALLBACK_SEAM
    mp = torch.amax(log_norm_w + log_inv_widths - torch.abs(common), dim=0)
    log_pdf = torch.where(far, mp, torch.log(torch.clamp(P, min=tiny)))
    return (log_cdf, log_sf, log_pdf), (sig, r, F, SF, P, neg_all, pos_all,
                                        far)


class _LinearLogsPdf(torch.autograd.Function):
    """(log_cdf, log_sf, log_pdf) with the JAX package's hand-written tangent
    rule (``_linear_logs_pdf_jvp``); ``backward`` is its transpose.

    Interior lanes: dF/du_k = w_k s_k r_k, dSF/du_k = -w_k s_k r_k,
    dP/du_k = w_k iw_k s_k r_k (1 - 2 s_k), the u-tangent gated by the +-60
    clip.  Fallback lanes (every component beyond 55 width-units) carry only
    the coordinate tangent of the dominant max-term, selected by the one-hot
    ``mvals >= max(mvals)`` (not normalized over ties); the log_norm_w and
    log_inv_widths tangents are dropped there, as in the JAX rule."""

    @staticmethod
    def forward(ctx, common, norm_w, log_norm_w, inv_widths, log_inv_widths):
        outs, res = _linear_logs_primal(common, norm_w, log_norm_w,
                                        inv_widths, log_inv_widths, True)
        ctx.save_for_backward(common, norm_w, log_norm_w, inv_widths,
                              log_inv_widths, *res)
        return outs

    @staticmethod
    def backward(ctx, g_cdf, g_sf, g_pdf):
        (common, norm_w, log_norm_w, inv_widths, log_inv_widths,
         sig, r, F, SF, P, neg_all, pos_all, far) = ctx.saved_tensors
        tiny = _tiny(common)
        zero = torch.zeros((), dtype=common.dtype, device=common.device)
        g_cdf = zero if g_cdf is None else g_cdf
        g_sf = zero if g_sf is None else g_sf
        g_pdf = zero if g_pdf is None else g_pdf
        # interior lanes: cotangents of F, SF, P
        cF = torch.where(neg_all, 0.0, g_cdf / torch.clamp(F, min=tiny))
        cSF = torch.where(pos_all, 0.0, g_sf / torch.clamp(SF, min=tiny))
        cP = torch.where(far, 0.0, g_pdf / torch.clamp(P, min=tiny))
        sr = sig * r
        wsr = norm_w * sr
        g_nw = cF * sig + cSF * r + (cP * inv_widths) * sr
        g_iw = (cP * norm_w) * sr
        g_u = wsr * (cF - cSF) + ((wsr * inv_widths) * (1.0 - 2.0 * sig)) * cP
        g_c = torch.where(torch.abs(common) < 60.0, g_u, 0.0)
        # fallback lanes: the dominant max-term's coordinate tangent
        mvals = log_norm_w + log_inv_widths - torch.abs(common)
        oh = (mvals >= torch.amax(mvals, dim=0, keepdim=True)).to(common.dtype)
        ga = torch.where(neg_all, g_cdf, 0.0) + torch.where(far, g_pdf, 0.0)
        gb = torch.where(pos_all, -g_sf, 0.0) - torch.where(far, g_pdf, 0.0)
        g_c = g_c + oh * (torch.where(common < 0.0, ga, 0.0)
                          + torch.where(common > 0.0, gb, 0.0))
        return (g_c, sum_to(g_nw, norm_w.shape), None,
                sum_to(g_iw, inv_widths.shape), None)


def mixture_linear_logs(common, norm_w, log_norm_w, inv_widths,
                        log_inv_widths, need_pdf):
    """(log_cdf, log_sf, log_pdf|None) of a normalized logistic mixture by
    linear odds-space accumulation, with the +-60 clip and the far-tail
    max-term fallback lanes (every component beyond 55 width-units).  With
    ``need_pdf`` the gradient is the JAX package's hand-written rule
    (:class:`_LinearLogsPdf`); without it, plain autograd as in JAX."""
    if need_pdf:
        return _LinearLogsPdf.apply(common, norm_w, log_norm_w, inv_widths,
                                    log_inv_widths)
    return _linear_logs_primal(common, norm_w, log_norm_w, inv_widths, None,
                               False)[0]


def _lse0(v):
    """Max-shifted logsumexp over axis 0 in primitive ops, as the JAX
    package's ``_lse0`` (the skewed chain shared with the kernels)."""
    m = torch.amax(v, dim=0)
    return m + torch.log(torch.sum(torch.exp(v - m[None]), dim=0))


def skew_mixture_logs(common, log_inv_widths, log_norm_w, log_skew, signs,
                      need_pdf):
    """(log_cdf, log_sf, log_pdf|None) of a normalized skewed-logistic
    mixture: exponents a_k = exp(log_skew) and +-1 ``signs`` (K, 1, 1).  The
    float32 formulation the CUDA per-layer kernels share
    (csrc/gf_common.cuh ``skew_eval``); its gradient is plain autograd, as in
    the JAX package.  common (K, D, B); the others (K, D, 1|B)."""
    a = torch.exp(log_skew)
    sc = signs * common
    pos = signs > 0.0
    sp_nc = softplus(-common)
    sp_c = softplus(common)
    log_pdf = None
    if need_pdf:
        log_pdfs = (-sc + log_inv_widths + log_skew
                    - (a + 1.0) * softplus(-sc) + log_norm_w)
        log_pdf = _lse0(log_pdfs)
    log_cdfs = torch.where(
        pos, -a * sp_nc,
        log_one_plus_exp_x_to_a_minus_1(common, a) - a * sp_c) + log_norm_w
    log_sfs = torch.where(
        pos, log_one_plus_exp_x_to_a_minus_1(-common, a) - a * sp_nc,
        -a * sp_c) + log_norm_w
    return _lse0(log_cdfs), _lse0(log_sfs), log_pdf


def logistic_mixture_log_quantities(x, means, log_widths, log_norms,
                                    calculate_pdf=True, log_skew=None,
                                    skew_signs=None):
    """(log_cdf, log_sf, log_pdf) of the logistic mixture at x (B, D);
    params (K, D, Bp); outputs (B, D).  With ``log_skew`` (K, D, Bp) and
    ``skew_signs`` (K, 1, 1) the mixture is skewed (float32: the kernels'
    :func:`skew_mixture_logs`; float64: the log-space chain)."""
    xT = x.T[None, :, :]
    common = (xT - means) * torch.exp(-log_widths)
    individual_normalizers = log_norms - torch.logsumexp(log_norms, dim=0,
                                                         keepdim=True)
    if log_skew is not None:
        return _skew_log_quantities(common, log_widths, individual_normalizers,
                                    log_skew, skew_signs, calculate_pdf)
    if x.dtype == torch.float32:
        log_cdf, log_sf, log_pdf = mixture_linear_logs(
            common, torch.exp(individual_normalizers), individual_normalizers,
            torch.exp(-log_widths), -log_widths, calculate_pdf)
        return log_cdf.T, log_sf.T, (log_pdf.T if log_pdf is not None
                                     else None)
    sp_neg = softplus(-common)
    log_pdf = None
    if calculate_pdf:
        log_pdfs = -common - log_widths - 2.0 * sp_neg + individual_normalizers
        log_pdf = torch.logsumexp(log_pdfs, dim=0).T
    log_cdfs = -sp_neg + individual_normalizers
    log_sfs = -common - sp_neg + individual_normalizers
    return (torch.logsumexp(log_cdfs, dim=0).T,
            torch.logsumexp(log_sfs, dim=0).T, log_pdf)


def _skew_log_quantities(common, log_widths, lnw, log_skew, signs,
                         calculate_pdf):
    """The skewed branch of :func:`logistic_mixture_log_quantities`
    (``logistic_kde.py:277-303`` of the JAX package); outputs (B, D)."""
    if common.dtype == torch.float32:
        log_cdf, log_sf, log_pdf = skew_mixture_logs(
            common, -log_widths, lnw, log_skew, signs, calculate_pdf)
        return log_cdf.T, log_sf.T, (log_pdf.T if log_pdf is not None
                                     else None)
    a = torch.exp(log_skew)
    log_pdf = None
    if calculate_pdf:
        log_pdfs = (-signs * common - log_widths + log_skew
                    - (a + 1.0) * softplus(-signs * common) + lnw)
        log_pdf = torch.logsumexp(log_pdfs, dim=0).T
    pos = signs > 0
    log_cdfs = torch.where(
        pos, -a * softplus(-common),
        log_one_plus_exp_x_to_a_minus_1(common, a) - a * softplus(common)) \
        + lnw
    log_sfs = torch.where(
        pos, log_one_plus_exp_x_to_a_minus_1(-common, a)
        - a * softplus(-common), -a * softplus(common)) + lnw
    return (torch.logsumexp(log_cdfs, dim=0).T,
            torch.logsumexp(log_sfs, dim=0).T, log_pdf)


def erfinv_f32_args_from_logs(log_cdf, log_sf, ln_fac_mid):
    """(x, w) = (2*cdf - 1, -log(1 - x^2)) for the erfinv polynomial,
    f32-stable everywhere (see LIN_SEAM_LNFAC)."""
    near = ln_fac_mid > LIN_SEAM_LNFAC
    sign = torch.where(log_cdf >= log_sf, 1.0, -1.0).to(log_cdf.dtype)
    u = torch.where(near, 1.0, 1.0 - torch.exp(ln_fac_mid))
    x_sqrt = sign * torch.sqrt(torch.clamp(u, min=_tiny(log_cdf)))
    x_lin = torch.exp(log_cdf) - torch.exp(log_sf)
    x = torch.where(near, x_lin, x_sqrt)
    x_c = torch.clamp(x_lin, -0.99, 0.99)
    w = torch.where(near, -torch.log(1.0 - x_c * x_c), -ln_fac_mid)
    return x, w


def _lnfac_f32_stable(log_cdf, log_sf, ln_fac_raw, tiny):
    """ln_fac = log(4 c (1-c)) with the central region recomputed from the
    difference form 2c-1 = cdf - sf."""
    x_lin = torch.exp(log_cdf) - torch.exp(log_sf)
    x_c = torch.clamp(x_lin, -0.99, 0.99)
    lf_lin = torch.log(torch.clamp(1.0 - x_c * x_c, min=tiny))
    near = ln_fac_raw > LIN_SEAM_LNFAC
    return torch.where(near, torch.clamp(lf_lin, max=-tiny),
                       torch.clamp(ln_fac_raw, max=-tiny))


_P_SMALL = (3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
            -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_P_BIG = (0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
          -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32_poly(x, w):
    """Single-precision erfinv(x) with w = -log(1 - x^2) precomputed
    (Giles 2012)."""
    small = w < 5.0
    ws = torch.where(small, w - 2.5,
                     torch.sqrt(torch.clamp(w, min=5.0)) - 3.0)
    p_small = torch.full_like(ws, 2.81022636e-08)
    for c in _P_SMALL:
        p_small = p_small * ws + c
    p_big = torch.full_like(ws, -0.000200214257)
    for c in _P_BIG:
        p_big = p_big * ws + c
    return torch.where(small, p_small, p_big) * x


def _pade_total_factor(ln_fac, tiny):
    """|sqrt(2) erfinv(2c-1)| via the Winitzki pade approximation from
    ln_fac = log(4 c (1-c)) <= 0 (sanitized)."""
    c = 2.0 / (math.pi * PADE_A)
    combined = c + ln_fac / 2.0
    pos_entry = 2.0 * (torch.sqrt(torch.clamp(combined**2 - ln_fac / PADE_A,
                                              min=tiny)) - combined)
    return torch.sqrt(torch.clamp(pos_entry, min=tiny))


def icdf_pass(log_cdf, log_sf, inverse_function_type):
    """Map mixture-CDF space to an unbounded coordinate."""
    if inverse_function_type == "isigmoid":
        return log_cdf - log_sf
    tiny = _tiny(log_cdf)
    cdf = torch.exp(log_cdf)
    ln_fac_raw = log_cdf + log_sf + LOG_4
    f32 = log_cdf.dtype == torch.float32

    if "partly" in inverse_function_type:
        if f32:
            good = ln_fac_raw > LOG_SEAM
            ln_fac_mid = torch.where(good, ln_fac_raw, -1.0)
            xx, ww = erfinv_f32_args_from_logs(log_cdf, log_sf, ln_fac_mid)
            val = SQRT2 * erfinv_f32_poly(xx, ww)
            right = (~good) & (log_cdf >= log_sf)
        else:
            good = (cdf > PADE_BOUND) & (cdf < 1.0 - PADE_BOUND) \
                & (ln_fac_raw > LOG_SEAM)
            cdf_good = torch.where(good, cdf, 0.5)
            val = torch.special.ndtri(cdf_good)
            right = log_cdf >= log_sf
        ln_fac = torch.where(good, -1.0, ln_fac_raw)
        if inverse_function_type == "inormal_partly_crude":
            total_factor = torch.sqrt(torch.clamp(-2.0 * (ln_fac - LOG_4),
                                                  min=tiny)) - 0.4717
        else:
            total_factor = _pade_total_factor(ln_fac, tiny)
        return torch.where(good, val,
                           torch.where(right, total_factor, -total_factor))

    if f32:
        x_lin = torch.exp(log_cdf) - torch.exp(log_sf)
        near = torch.abs(x_lin) <= FULL_PADE_F32_CENTER
        ln_fac = torch.where(near, -1.0,
                             _lnfac_f32_stable(log_cdf, log_sf, ln_fac_raw,
                                               tiny))
        total_factor = _pade_total_factor(ln_fac, tiny)
        val = torch.where(log_cdf >= log_sf, total_factor, -total_factor)
        series = SQRT_HALF_PI * x_lin * (1.0 + ERFINV_CUBIC * x_lin * x_lin)
        return torch.where(near, series, val)
    ln_fac = torch.clamp(ln_fac_raw, max=-tiny)
    total_factor = _pade_total_factor(ln_fac, tiny)
    return torch.where(cdf > 0.5, total_factor, -total_factor)


def _pade_log_total(ln_fac, tiny):
    c = 2.0 / (math.pi * PADE_A)
    F = ln_fac / 2.0 + c
    F2 = torch.sqrt(torch.clamp(F**2 - ln_fac / PADE_A, min=tiny))
    log_numerator = torch.log(torch.clamp(-(F - 1.0 / PADE_A - F2), min=tiny))
    log_denominator = (0.5 * math.log(8.0)
                       + 0.5 * torch.log(torch.clamp(F2 - F, min=tiny))
                       + torch.log(torch.clamp(F2, min=tiny)))
    return log_numerator - log_denominator


def icdf_log_derivative(log_cdf, log_sf, log_pdf, inverse_function_type):
    """log |d icdf_pass / dx| including the mixture pdf factor."""
    if inverse_function_type == "isigmoid":
        return logaddexp(-log_sf, -log_cdf) + log_pdf
    tiny = _tiny(log_cdf)
    cdf = torch.exp(log_cdf)
    ln_fac_raw = log_cdf + log_sf + LOG_4
    f32 = log_cdf.dtype == torch.float32

    if "partly" in inverse_function_type:
        if f32:
            good = ln_fac_raw > LOG_SEAM
            ln_fac_mid = torch.where(good, ln_fac_raw, -1.0)
            xx, ww = erfinv_f32_args_from_logs(log_cdf, log_sf, ln_fac_mid)
            ei = erfinv_f32_poly(xx, ww)
            middle = LOG_SQRT_2PI + ei**2 + log_pdf
        else:
            good = (cdf > PADE_BOUND) & (cdf < 1.0 - PADE_BOUND) \
                & (ln_fac_raw > LOG_SEAM)
            cdf_good = torch.where(good, cdf, 0.5)
            middle = (LOG_SQRT_2PI
                      + torch.special.erfinv(2.0 * cdf_good - 1.0)**2
                      + log_pdf)
        ln_fac = torch.where(good, -1.0, ln_fac_raw)
        if inverse_function_type == "inormal_partly_crude":
            total_factor = -0.5 * torch.log(torch.clamp(
                -(ln_fac - LOG_4) * 2.0, min=tiny)) - (ln_fac - LOG_4)
        else:
            extra = torch.log(torch.clamp(torch.abs(1.0 - 2.0 * cdf),
                                          min=tiny))
            total_factor = _pade_log_total(ln_fac, tiny) - (ln_fac - LOG_4) \
                + extra
        return torch.where(good, middle, total_factor + log_pdf)

    if f32:
        x_lin = torch.exp(log_cdf) - torch.exp(log_sf)
        abs_x = torch.abs(x_lin)
        near_center = abs_x <= FULL_PADE_F32_CENTER
        ln_fac = torch.where(near_center, -1.0,
                             _lnfac_f32_stable(log_cdf, log_sf, ln_fac_raw,
                                               tiny))
        ei_lin = ERFINV_SLOPE * x_lin * (1.0 + ERFINV_CUBIC * x_lin * x_lin)
        center = LOG_CENTER_DERIV + ei_lin * ei_lin + log_pdf
    else:
        abs_x = torch.abs(1.0 - 2.0 * cdf)
        near_center = (cdf >= 0.49999) & (cdf <= 0.50001)
        ln_fac = torch.where(near_center, -1.0,
                             torch.clamp(ln_fac_raw, max=-tiny))
        center = LOG_CENTER_DERIV + log_pdf
    extra = torch.log(torch.clamp(abs_x, min=tiny))
    full = _pade_log_total(ln_fac, tiny) - (ln_fac - LOG_4) + log_pdf + extra
    return torch.where(near_center, center, full)


def gaussianize_forward(x, means, log_widths, log_norms,
                        inverse_function_type, log_skew=None,
                        skew_signs=None):
    """x -> (icdf_pass(x), log|d/dx|): the analytic (density) direction;
    skewed when ``log_skew`` / ``skew_signs`` are given."""
    log_cdf, log_sf, log_pdf = logistic_mixture_log_quantities(
        x, means, log_widths, log_norms, True, log_skew, skew_signs)
    val = icdf_pass(log_cdf, log_sf, inverse_function_type)
    log_deriv = icdf_log_derivative(log_cdf, log_sf, log_pdf,
                                    inverse_function_type)
    return val, log_deriv


def gaussianize_value(x, means, log_widths, log_norms,
                      inverse_function_type, log_skew=None, skew_signs=None):
    """Value-only variant (used inside the Newton iteration)."""
    log_cdf, log_sf, _ = logistic_mixture_log_quantities(
        x, means, log_widths, log_norms, False, log_skew, skew_signs)
    return icdf_pass(log_cdf, log_sf, inverse_function_type)
