"""Plain PyTorch versions of the Gaussianization-flow kernel bodies.

Counterparts of the shared bodies in ``jammy_flows_tpu/ops/pallas_gf.py``:
the iCDF passes of the kernels, the mixture value/derivative evaluations, the
regulator prep of raw parameter slabs, the component-quantile bracket, the
bracket-safeguarded Newton solve and the per-layer pieces of the sample
backward (reconstruction and implicit step).  The CUDA block kernels
implement the same expressions in csrc/gf_common.cuh; the TPU layout
(sublane fold, Mosaic workarounds, block sizes) is not carried over.

Layout: x is (D, C); a mixture is (means, inv_widths, log_norm_w[,
log_skew, signs]), each (K, D, 1|C) (signs (K, 1, 1)), already regulated
and normalized over K (axis 0); log_skew None for the plain mixture.
"""
from __future__ import annotations

import math

import torch

from . import logistic_kde
from .special import logaddexp, softplus

N_NEWTON = 4       # no bisection phase (N_BISECT = 0 in the JAX package)
LO, HI = -1e5, 1e5

_SQRT2 = 1.4142135623730951
_LOG_SQRT_2PI = 0.9189385332046727
_PADE_A = logistic_kde.PADE_A
_LOG_4 = logistic_kde.LOG_4
_LOG_SEAM = logistic_kde.LOG_SEAM
_TINY_K = 1e-37      # the partly_precise kernel branch's own floor


def icdf_pass_kernel(log_cdf, log_sf, ift):
    """Kernel variant of logistic_kde.icdf_pass (f32 formulation)."""
    if ift == "isigmoid":
        return log_cdf - log_sf
    if ift in ("inormal_partly_crude", "inormal_full_pade"):
        return logistic_kde.icdf_pass(log_cdf, log_sf, ift)
    if ift != "inormal_partly_precise":
        raise ValueError(f"unknown inverse_function_type {ift}")
    tiny = _TINY_K
    ln_fac_raw = log_cdf + log_sf + _LOG_4
    good = ln_fac_raw > _LOG_SEAM
    ln_fac_mid = torch.where(good, ln_fac_raw, -1.0)
    xx, ww = logistic_kde.erfinv_f32_args_from_logs(log_cdf, log_sf,
                                                    ln_fac_mid)
    val = _SQRT2 * logistic_kde.erfinv_f32_poly(xx, ww)
    ln_fac = torch.where(good, -1.0, ln_fac_raw)
    c = 2.0 / (3.141592653589793 * _PADE_A)
    combined = c + ln_fac / 2.0
    pos_entry = 2.0 * (torch.sqrt(torch.clamp(combined**2 - ln_fac / _PADE_A,
                                              min=tiny)) - combined)
    total_factor = torch.sqrt(torch.clamp(pos_entry, min=tiny))
    right = (~good) & (log_cdf >= log_sf)
    return torch.where(good, val,
                       torch.where(right, total_factor, -total_factor))


def icdf_log_deriv_kernel(log_cdf, log_sf, log_pdf, ift):
    """Kernel variant of logistic_kde.icdf_log_derivative (f32 branch)."""
    if ift == "isigmoid":
        return logaddexp(-log_sf, -log_cdf) + log_pdf
    if ift in ("inormal_partly_crude", "inormal_full_pade"):
        return logistic_kde.icdf_log_derivative(log_cdf, log_sf, log_pdf, ift)
    if ift != "inormal_partly_precise":
        raise ValueError(f"unknown inverse_function_type {ift}")
    tiny = _TINY_K
    ln_fac_raw = log_cdf + log_sf + _LOG_4
    good = ln_fac_raw > _LOG_SEAM
    ln_fac_mid = torch.where(good, ln_fac_raw, -1.0)
    xx, ww = logistic_kde.erfinv_f32_args_from_logs(log_cdf, log_sf,
                                                    ln_fac_mid)
    ei = logistic_kde.erfinv_f32_poly(xx, ww)
    middle = _LOG_SQRT_2PI + ei**2 + log_pdf
    ln_fac = torch.where(good, -1.0, ln_fac_raw)
    c = 2.0 / (3.141592653589793 * _PADE_A)
    F = ln_fac / 2.0 + c
    F2 = torch.sqrt(torch.clamp(F**2 - ln_fac / _PADE_A, min=tiny))
    log_num = torch.log(torch.clamp(-(F - 1.0 / _PADE_A - F2), min=tiny))
    log_den = (0.5 * 2.0794415416798357
               + 0.5 * torch.log(torch.clamp(F2 - F, min=tiny))
               + torch.log(torch.clamp(F2, min=tiny)))
    cdf = torch.exp(log_cdf)
    extra = torch.log(torch.clamp(torch.abs(1.0 - 2.0 * cdf), min=tiny))
    total_factor = log_num - log_den - (ln_fac - _LOG_4) + extra
    return torch.where(good, middle, total_factor + log_pdf)


def _unpack_mix(mix):
    """(means, inv_widths, log_norm_w, log_skew|None, signs|None) of a
    3-tuple (plain) or 5-tuple (skewed or not) mixture."""
    if len(mix) == 3:
        return (*mix, None, None)
    return mix


def _skew_logs(x, mix, need_pdf):
    means, inv_widths, log_norm_w, log_skew, signs = mix
    common = (x[None, :, :] - means) * inv_widths
    return logistic_kde.skew_mixture_logs(common, torch.log(inv_widths),
                                          log_norm_w, log_skew, signs,
                                          need_pdf)


def mixture_value_deriv(x, mix, deriv_mode, ift):
    """Gaussianization value (iCDF pass of the mixture CDF) and derivative,
    density-direction form (with the far-tail fallback lanes; the skewed
    mixture's log-space chain).  x: (D, C); deriv_mode: None | "exp" |
    "log"."""
    means, inv_widths, log_norm_w, log_skew, _ = _unpack_mix(mix)
    need_pdf = deriv_mode is not None
    if log_skew is not None:
        log_cdf, log_sf, log_pdf = _skew_logs(x, _unpack_mix(mix), need_pdf)
    else:
        common = (x[None, :, :] - means) * inv_widths
        log_cdf, log_sf, log_pdf = logistic_kde.mixture_linear_logs(
            common, torch.exp(log_norm_w), log_norm_w, inv_widths,
            torch.log(inv_widths) if need_pdf else None, need_pdf)
    val = icdf_pass_kernel(log_cdf, log_sf, ift)
    if deriv_mode is None:
        return val, None
    log_deriv = icdf_log_deriv_kernel(log_cdf, log_sf, log_pdf, ift)
    if deriv_mode == "log":
        return val, log_deriv
    return val, torch.exp(log_deriv)


def mixture_value_deriv_solve(x, mix, deriv_mode, ift):
    """Lean solve-side twin of :func:`mixture_value_deriv`: the same
    expressions as its non-fallback branch (bracketed iterates never reach
    the fallback), plus the isigmoid Newton shortcut pdf/(F*SF).  The skewed
    mixture has no lean twin: it evaluates the density-direction chain (the
    isigmoid shortcut then in log space)."""
    mix = _unpack_mix(mix)
    means, inv_widths, log_norm_w, log_skew, _ = mix
    if log_skew is not None:
        log_cdf, log_sf, log_pdf = _skew_logs(x, mix, deriv_mode is not None)
        val = icdf_pass_kernel(log_cdf, log_sf, ift)
        if deriv_mode is None:
            return val, None
        if deriv_mode == "exp" and ift == "isigmoid":
            return val, torch.exp(log_pdf - log_cdf - log_sf)
        log_deriv = icdf_log_deriv_kernel(log_cdf, log_sf, log_pdf, ift)
        if deriv_mode == "log":
            return val, log_deriv
        return val, torch.exp(log_deriv)
    tiny = 1e-37
    common = (x[None, :, :] - means) * inv_widths
    norm_w = torch.exp(log_norm_w)
    u = torch.clamp(common, -60.0, 60.0)
    e = torch.exp(u)
    r = 1.0 / (1.0 + e)
    sig = e * r
    F = torch.sum(norm_w * sig, dim=0)
    SF = torch.sum(norm_w * r, dim=0)
    log_cdf = torch.log(torch.clamp(F, min=tiny))
    log_sf = torch.log(torch.clamp(SF, min=tiny))
    val = icdf_pass_kernel(log_cdf, log_sf, ift)
    if deriv_mode is None:
        return val, None
    P = torch.sum((norm_w * inv_widths) * (sig * r), dim=0)
    if deriv_mode == "exp" and ift == "isigmoid":
        return val, P / torch.clamp(F * SF, min=tiny)
    log_pdf = torch.log(torch.clamp(P, min=tiny))
    log_deriv = icdf_log_deriv_kernel(log_cdf, log_sf, log_pdf, ift)
    if deriv_mode == "log":
        return val, log_deriv
    return val, torch.exp(log_deriv)


def gauss_value(s, mix, ift):
    """Density-direction value of one layer's mixture pass at its solve
    output s: the analytic reconstruction step of the sample backward
    (layer l-1's output from s_l, no re-solve)."""
    return mixture_value_deriv(s, mix, None, ift)[0]


def implicit_step(s, mix, ift, gs, gld):
    """One layer's implicit-function step of the sample backward
    (``pallas_gf_block.py:406-417``).  With (val, ld) = the density pass at
    the solve output s, fp = dval/ds and lx = dld/ds, the cotangent of the
    layer's input is c = (gs + gld * lx) / fp, and the mixture parameters
    take the VJP of (val, ld) with cotangents (-c, gld).  Returns (c, val,
    ld) with val and ld still attached to ``mix``'s graph; s is constant.

    fp and lx are tangents, which the JAX package (``jax.jvp``) and the
    kernels take in forward mode, where a NaN primal reaches them; reverse
    mode drops it where the mixture rule gates every component's
    coordinate (a NaN root: |c| < 60 is false) and gives fp = 0, c = +-inf.
    So fp is NaN wherever the pass's value or log-derivative is."""
    s = s.detach().requires_grad_()
    val, ld = mixture_value_deriv(s, mix, "log", ift)
    fp, = torch.autograd.grad(val.sum(), s, retain_graph=True)
    lx, = torch.autograd.grad(ld.sum(), s, retain_graph=True)
    fp = torch.where(torch.isnan(val) | torch.isnan(ld), torch.nan, fp)
    return (gs + gld * lx) / fp, val, ld


def logit_phi(x):
    """logit(Phi(x)) for the standard normal, f32-stable in both tails
    (Abramowitz & Stegun 26.2.17 tail polynomial)."""
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.2316419 * ax)
    poly = t * (0.319381530 + t * (-0.356563782 + t * (
        1.781477937 + t * (-1.821255978 + t * 1.330274429))))
    log_tail = -0.5 * ax * ax - _LOG_SQRT_2PI + torch.log(poly)
    log_head = torch.log1p(-torch.exp(log_tail))
    return torch.where(x >= 0.0, log_head - log_tail, log_tail - log_head)


def _log1m_exp_series(u):
    """log(1 - e^u) for u < 0: the series log(-u) + log1p(u/2 + u^2/6 +
    u^3/24) above u = -0.1, else log1p(-e^u)."""
    us = torch.where(u > -0.1, u, -0.1)
    series = torch.log(-us) + torch.log1p(us * (0.5 + us * (
        1.0 / 6.0 + us * (1.0 / 24.0))))
    ul = torch.where(u > -0.1, -0.1, u)
    return torch.where(u > -0.1, series, torch.log1p(-torch.exp(ul)))


def component_bracket(target, mix, ift):
    """Exact initial bracket from the mixture-quantile bound: F^-1(q) lies
    between the smallest and largest component quantiles, m_k + s_k *
    logit(q) for a plain logistic component and m_k +- s_k * logit(p),
    p = q^(1/a) resp. (1-q)^(1/a), for a skewed one.  Returns (lo, hi,
    q_k)."""
    means, inv_widths, _, log_skew, signs = _unpack_mix(mix)
    t = target if ift == "isigmoid" else logit_phi(target)
    if log_skew is None:
        q_k = means + t[None, :, :] / inv_widths
    else:
        pos = signs > 0.0
        log_q = -softplus(-t)[None, :, :]
        log_1mq = -softplus(t)[None, :, :]
        log_p = torch.where(pos, log_q, log_1mq) / torch.exp(log_skew)
        u = torch.clamp(log_p, max=-torch.finfo(log_p.dtype).tiny)
        logit_p = log_p - _log1m_exp_series(u)
        q_k = means + torch.where(pos, logit_p, -logit_p) / inv_widths
    lo = torch.amin(q_k, dim=0)
    hi = torch.amax(q_k, dim=0)
    if ift == "isigmoid" and log_skew is None:
        margin = 1e-4 * (hi - lo) + 1e-5
    else:
        margin = 0.05 * (hi - lo) + 0.5
    return lo - margin, hi + margin, q_k


def prep_raw_params(slabs, prep):
    """Regulators + mixture-weight normalization on raw (K, D, 1|C) slabs.

    slabs = (means, lw_raw[, ln_raw][, se_raw]); prep = (width_regulator,
    norm_regulator_or_None, fit_normalization[, exponent_regulator_or_None,
    skew_signs_or_None]).  Returns the 5-tuple mixture (means, inv_widths,
    log_norm_w, log_skew|None, signs|None); the signs (K, 1, 1) follow the
    +1-prefix pattern of the skew signs, made from their count of +1."""
    width_reg, norm_reg, fit_norm = prep[:3]
    exp_reg = prep[3] if len(prep) > 3 else None
    means, lw_raw = slabs[0], slabs[1]
    idx = 2
    lw = width_reg(lw_raw)
    inv_widths = torch.exp(-lw)
    if fit_norm:
        ln_raw = slabs[idx]
        idx += 1
        ln = norm_reg(ln_raw) if norm_reg is not None else ln_raw
        m = torch.amax(ln, dim=0, keepdim=True)
        log_norm_w = ln - (m + torch.log(torch.sum(torch.exp(ln - m), dim=0,
                                                   keepdim=True)))
    else:
        log_norm_w = torch.full_like(lw, -math.log(lw.shape[0]))
    if exp_reg is None:
        return means, inv_widths, log_norm_w, None, None
    log_skew = exp_reg(slabs[idx])
    n_pos = skew_n_pos(prep[4])
    signs = torch.where(torch.arange(len(prep[4]), device=lw.device) < n_pos,
                        1.0, -1.0).to(lw.dtype).reshape(-1, 1, 1)
    return means, inv_widths, log_norm_w, log_skew, signs


def skew_n_pos(signs):
    """The count of +1 skew signs; they must form a +1-prefix pattern."""
    n_pos = sum(1 for s in signs if s > 0)
    if not all((s > 0) == (i < n_pos) for i, s in enumerate(signs)):
        raise ValueError("skew signs must be a +1-prefix pattern")
    return n_pos


def solve(target, mix, ift):
    """Bracket-safeguarded Newton solve: component-quantile bracket, then a
    weighted-quantile start (plain isigmoid) or a regula-falsi start from
    two bracket-validity evaluations (inormal_*, and every skewed mixture),
    then N_NEWTON Newton steps
    that fall back to the bisection midpoint when they leave the bracket."""
    log_norm_w = mix[2]
    lo, hi, q_k = component_bracket(target, mix, ift)
    if ift == "isigmoid" and _unpack_mix(mix)[3] is None:
        x = torch.sum(torch.exp(log_norm_w) * q_k, dim=0)
        x = torch.minimum(torch.maximum(x, lo), hi)
    else:
        vlo, _ = mixture_value_deriv_solve(lo, mix, None, ift)
        vhi, _ = mixture_value_deriv_solve(hi, mix, None, ift)
        good = (vlo <= target) & (vhi >= target)
        t = (target - vlo) / torch.clamp(vhi - vlo, min=1e-30)
        x_rf = lo + t * (hi - lo)
        lo = torch.where(good, lo, LO)
        hi = torch.where(good, hi, HI)
        x = torch.where(good, x_rf, 0.0)
    for _ in range(N_NEWTON):
        val, deriv = mixture_value_deriv_solve(x, mix, "exp", ift)
        right = val < target
        lo = torch.where(right, x, lo)
        hi = torch.where(right, hi, x)
        x_new = x - (val - target) / deriv
        bad = (~torch.isfinite(x_new)) | (x_new < lo) | (x_new > hi)
        x = torch.where(bad, 0.5 * (lo + hi), x_new)
    return x
