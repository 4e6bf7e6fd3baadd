"""Per-layer Gaussianization-flow passes: one `g` layer's mixture pass.

PyTorch counterpart of the public API of ``jammy_flows_tpu/ops/pallas_gf.py``
(TPU kernels ``_gf_kernel_call`` forward / sample / inverse and
``_gf_bwd_call``), under the JAX package's names:

  density direction  (val, log|dval/dx|) = mixture iCDF pass of x
      gf_forward_pallas (prepared), gf_forward_raw, gf_forward_lazy
  sample direction   x = Newton solve of the pass at the target, and
                     log|dval/dx| at x
      gf_sample_raw, gf_sample_lazy
  solve alone        gf_inverse_pallas (prepared), gf_inverse_raw

Three parameter interfaces ("iface"):
  prepared: (means, inv_widths, log_norm_w) made outside the kernel from the
            regulated parameters (``_prepare``, the JAX ``_prepare_xla``);
  raw:      the pre-regulator slabs (means, lw_raw[, ln_raw][, se_raw]); the
            regulators, the weight normalization and the skew exponents run
            in the kernel;
  lazy:     hidden (B, H) and the layer's final MLP rows wcat (P_l, H),
            bcat (P_l,): the kernel makes each row's parameters
            b_j + w_j . hidden itself, so the (B, P_l) slab is never stored.
Prepared and raw slabs are (K, D) broadcast or (K, D, B) per row (B minor).
A raw or lazy mixture may be skewed (prep[3] the exponent regulator, prep[4]
the +-1 signs, a +1-prefix pattern).

Gradients: the raw and lazy entry points are ``torch.autograd.Function``s
whose backward is the per-layer backward (the density body: the VJP of the
pass; the sample body: the implicit-function VJP of the solve and its
log-derivative), broadcast and lazy w / b gradients summed over rows.
``gf_forward_pallas``'s backward is the VJP of the plain formulation
(``logistic_kde.gaussianize_forward``), as in the JAX package;
``gf_inverse_*`` take no gradient (``make_inverse_fn`` wraps the solve).

Every entry point takes (B, D) rows.  On a CUDA tensor it launches the
hand-written kernel (csrc/gf_layer.cu: T4 forward, T5 sample, T6 inverse;
csrc/gf_layer_bwd.cu: T7) and counts the launch in ``LAUNCHES``; on a CPU
tensor it runs the plain PyTorch version below.  It never falls back from
the kernel to the plain version.  The lazy interface takes every hidden
width up to ``gf_block.MAX_KERNEL_H`` (1024); ``layers/euclidean.py`` routes
a wider MLP to materialized rows, as the JAX package's ``lazy_kernel_eligible``
does.  ``MAX_KERNEL_KD`` is not ported: beyond the kernel's own limits the
wrapper raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import gf, logistic_kde
from .gf_block import IFT_CODES, KERNEL_MAX_D, KERNEL_MAX_K, _check
from .special import IDENTITY

LAUNCHES = {"forward_prepared": 0, "inverse_prepared": 0,
            "forward_raw": 0, "sample_raw": 0, "inverse_raw": 0,
            "forward_lazy": 0, "sample_lazy": 0,
            "forward_bwd_raw": 0, "sample_bwd_raw": 0,
            "forward_bwd_lazy": 0, "sample_bwd_lazy": 0}

_MODES = {"forward": 0, "sample": 1, "inverse": 2}


def reset_launch_counts():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions ((D, B) layout inside, as the TPU kernel body)
# ---------------------------------------------------------------------------

def _lazy_slabs(hidden, w, b, kd):
    """The final MLP product b_j + w_j . hidden, split into (K, D, B)
    groups in slab order (``_lazy_slabs``, ``pallas_gf.py:482``)."""
    k, d = kd
    p = torch.matmul(w, hidden.T) + b[:, None]
    return [p[i:i + k * d].reshape(k, d, p.shape[-1])
            for i in range(0, w.shape[0], k * d)]


def _mix(iface, params, prep, kd):
    """The 5-tuple mixture of a call's parameters, (K, D, 1|B) slabs."""
    if iface == "lazy":
        return gf.prep_raw_params(_lazy_slabs(*params, kd), prep)
    ps = [t if t.ndim == 3 else t[:, :, None] for t in params]
    if iface == "prepared":
        return (*ps, None, None)
    return gf.prep_raw_params(ps, prep)


def layer_plain(mode, iface, x, params, ift, prep=None, kd=None):
    """The plain version of an entry point, in the wrapper's layout: x (B, D)
    (the target for "sample" / "inverse").  Returns (val, ld) for
    "forward", (root, ld) for "sample", the root for "inverse"."""
    mix = _mix(iface, params, prep, kd)
    xt = x.T
    if mode == "forward":
        val, ld = gf.mixture_value_deriv(xt, mix, "log", ift)
        return val.T.contiguous(), ld.T.contiguous()
    root = gf.solve(xt, mix, ift)
    if mode == "inverse":
        return root.T.contiguous()
    _, ld = gf.mixture_value_deriv_solve(root, mix, "log", ift)
    return root.T.contiguous(), ld.T.contiguous()


def _grads(out, inputs, cts):
    got = torch.autograd.grad(out, inputs, cts, allow_unused=True)
    return [torch.zeros_like(i) if g is None else g
            for i, g in zip(inputs, got)]


def layer_bwd_plain(body, iface, x, params, g1, g2, ift, prep, kd=None):
    """The plain version of the per-layer backward (``_forward_bwd_body`` /
    ``_sample_bwd_body``), in the wrapper's layout.  body "forward": x is the
    density input, (g1, g2) the cotangents of (val, ld); returns (gx, grads).
    body "sample": x is the solve output, (g1, g2) the cotangents of (x, ld);
    with fp = dval/dx and lx = dld/dx, c = (g1 + g2 lx) / fp is the target's
    cotangent and the parameters take the VJP of (val, ld) for (-c, g2);
    returns (c, grads).  grads match ``params`` in shape."""
    with torch.enable_grad():
        ps = [p.detach().requires_grad_() for p in params]
        mix = _mix(iface, ps, prep, kd)
        if body == "forward":
            xs = x.detach().requires_grad_()
            val, ld = gf.mixture_value_deriv(xs.T, mix, "log", ift)
            gx, *gp = _grads((val, ld), [xs, *ps], (g1.T, g2.T))
            return gx, gp
        c, val, ld = gf.implicit_step(x.T, mix, ift, g1.T, g2.T)
        gp = _grads((val, ld), ps, (-c, g2.T))
    return c.T.contiguous(), gp


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gf_layer_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, p]
    lib.gf_layer_launch.restype = i
    lib.gf_layer_error_string.argtypes = [i]
    lib.gf_layer_error_string.restype = ctypes.c_char_p


def _declare_bwd(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gf_layer_bwd_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p,
                                        p, p, p, p, i, p, p, p]
    lib.gf_layer_bwd_launch.restype = i
    lib.gf_layer_bwd_blocks.argtypes = [i, i, i, i, i, p]
    lib.gf_layer_bwd_blocks.restype = i
    lib.gf_layer_bwd_scratch.argtypes = [i, i, i]
    lib.gf_layer_bwd_scratch.restype = i
    lib.gf_layer_bwd_error_string.argtypes = [i]
    lib.gf_layer_bwd_error_string.restype = ctypes.c_char_p


def _prep_parts(prep):
    """(fit_norm, n_pos, skew, regulators) of a raw / lazy prep spec."""
    width_reg, norm_reg, fit_norm = prep[:3]
    exp_reg = prep[3] if len(prep) > 3 else None
    n_pos = gf.skew_n_pos(prep[4]) if exp_reg is not None else 0
    regs = (width_reg, norm_reg if norm_reg is not None else IDENTITY,
            exp_reg if exp_reg is not None else IDENTITY)
    return bool(fit_norm), n_pos, exp_reg is not None, regs


def _kernel_args(iface, x, params, ift, prep, kd):
    """Check a call's tensors against what the kernels take; returns (meta
    ints after the mode, regulator floats, parameter pointers)."""
    b_rows, d = x.shape
    dev = x.device
    _check("x", x, (b_rows, d), dev)
    if iface == "lazy":
        k = kd[0]
        if kd[1] != d:
            raise ValueError(f"lazy layer of dimension {kd[1]} for {d}-wide x")
    else:
        k = params[0].shape[0]
    if k > KERNEL_MAX_K or d > KERNEL_MAX_D:
        raise ValueError(f"layer (k={k}, d={d}) exceeds the CUDA kernel's "
                         "limits")
    if iface == "prepared":
        fit_norm, n_pos, skew, regs = False, 0, False, (IDENTITY,) * 3
        n_groups = 3
    else:
        fit_norm, n_pos, skew, regs = _prep_parts(prep)
        n_groups = 2 + fit_norm + skew
    hid = 0
    ptrs = [0] * 7
    if iface == "lazy":
        hidden, w, b = params
        hid = hidden.shape[-1]
        _check("hidden", hidden, (b_rows, hid), dev)
        _check("wcat", w, (n_groups * k * d, hid), dev)
        _check("bcat", b, (n_groups * k * d,), dev)
        ptrs[4:] = [hidden.data_ptr(), w.data_ptr(), b.data_ptr()]
        per_row = False
    else:
        if len(params) != n_groups:
            raise ValueError(f"{len(params)} parameter slabs, expected "
                             f"{n_groups}")
        per_row = params[0].ndim == 3
        shape = (k, d, b_rows) if per_row else (k, d)
        for i, t in enumerate(params):
            _check(f"slab {i}", t, shape, dev)
            ptrs[i] = t.data_ptr()
    ints = [int(iface == "lazy"), int(skew), int(iface == "prepared"),
            int(per_row), b_rows, k, d, hid, int(fit_norm), n_pos,
            IFT_CODES[ift]] + [r.kernel_args()[0] for r in regs]
    floats = [v for r in regs for v in r.kernel_args()[1:]]
    return ints, floats, ptrs, n_groups, per_row, k


def _c_arrays(ints, floats):
    return ((ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * len(floats))(*floats))


def _launch(mode, iface, x, params, ift, prep, kd):
    ints, floats, ptrs, _, _, _ = _kernel_args(iface, x, params, ift, prep,
                                               kd)
    out = torch.empty_like(x)
    ld = torch.empty_like(x) if mode != "inverse" else None
    if x.shape[0] > 0:
        from . import cuda_build
        lib = cuda_build.load("gf_layer", _declare)
        c_ints, c_floats = _c_arrays([_MODES[mode]] + ints, floats)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.gf_layer_launch(c_ints, c_floats, x.data_ptr(),
                                     out.data_ptr(),
                                     0 if ld is None else ld.data_ptr(),
                                     *ptrs, stream)
        if rc != 0:
            msg = lib.gf_layer_error_string(rc).decode()
            raise RuntimeError(f"gf_layer kernel launch failed ({rc}): {msg}")
        LAUNCHES[f"{mode}_{iface}"] += 1
    return out if mode == "inverse" else (out, ld)


def _launch_bwd(body, iface, x, params, g1, g2, ift, prep, kd):
    """T7 on the card: returns (gx, grads) as :func:`layer_bwd_plain`."""
    ints, floats, ptrs, n_groups, per_row, k = _kernel_args(
        iface, x, params, ift, prep, kd)
    b_rows, d = x.shape
    dev = x.device
    _check("g1", g1, (b_rows, d), dev)
    _check("g2", g2, (b_rows, d), dev)
    hid = ints[7]
    gx = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=dev)
    gslab = torch.zeros((n_groups, k, d, b_rows), **f32) if per_row else None
    gh = torch.zeros((b_rows, hid), **f32) if iface == "lazy" else None
    n_flat = 0 if per_row else (n_groups * k * d * (hid + 1)
                                if iface == "lazy" else n_groups * k * d)
    flat = torch.zeros(n_flat, **f32)
    if b_rows > 0:
        from . import cuda_build
        lib = cuda_build.load("gf_layer_bwd", _declare_bwd)
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        lazy = int(iface == "lazy")
        # the lazy tile and the broadcast partials depend on the parameter
        # rows of one dimension; the broadcast grid on the kernel's
        # occupancy
        n_piece = n_groups * k
        c_ints, c_floats = _c_arrays([int(body == "sample")] + ints, floats)
        n_blocks = lib.gf_layer_bwd_blocks(lazy, b_rows, hid, n_sm, n_piece,
                                           c_ints)
        partials = torch.zeros((n_blocks, n_flat), **f32)
        # where the lazy dh columns do not stay in shared memory
        n_scratch = n_blocks * lib.gf_layer_bwd_scratch(lazy, hid, n_piece)
        scratch = torch.empty(n_scratch, **f32) if n_scratch else None
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.gf_layer_bwd_launch(
                c_ints, c_floats, x.data_ptr(), g1.data_ptr(), g2.data_ptr(),
                gx.data_ptr(), *ptrs,
                0 if gslab is None else gslab.data_ptr(),
                0 if gh is None else gh.data_ptr(), partials.data_ptr(),
                n_blocks, 0 if scratch is None else scratch.data_ptr(),
                flat.data_ptr(), stream)
        if rc != 0:
            msg = lib.gf_layer_bwd_error_string(rc).decode()
            raise RuntimeError(f"gf_layer_bwd kernel launch failed ({rc}): "
                               f"{msg}")
        LAUNCHES[f"{body}_bwd_{iface}"] += 1
    if iface == "lazy":
        p_l = n_groups * k * d
        return gx, [gh, flat[:p_l * hid].view(p_l, hid), flat[p_l * hid:]]
    if per_row:
        return gx, list(gslab.unbind(0))
    return gx, list(flat.view(n_groups, k, d).unbind(0))


def kernel_occupancy(name, k, d, hid, n_groups, skew=True):
    """(blocks per SM, threads per block, dynamic shared memory bytes) of
    the kernel ``name`` (a ``LAUNCHES`` key: forward_lazy, sample_lazy,
    forward_bwd_lazy, sample_bwd_lazy, and with broadcast slabs
    forward_raw, sample_raw, inverse_raw, forward_prepared,
    inverse_prepared, forward_bwd_raw, sample_bwd_raw) at a layer of K = k,
    D = d, hidden width hid (lazy) and n_groups parameter groups, from the
    CUDA occupancy API on the current device."""
    from . import cuda_build
    bwd = "_bwd_" in name
    lib = (cuda_build.load("gf_layer_bwd", _declare_bwd) if bwd
           else cuda_build.load("gf_layer", _declare))
    fn = lib.gf_layer_bwd_occupancy if bwd else lib.gf_layer_occupancy
    i = ctypes.c_int
    fn.argtypes = [i, i, i, i, i, i, i, ctypes.c_void_p] + [i] * (not bwd)
    fn.restype = i
    out = (ctypes.c_int * 3)()
    prepared = name.endswith("_prepared")
    rc = fn(_MODES[name.split("_")[0]], int(name.endswith("_lazy")),
            int(skew and not prepared), k, d, hid, n_groups, out,
            *[int(prepared)] * (not bwd))
    if rc != 0:
        raise RuntimeError(f"occupancy query of {name} failed ({rc})")
    return tuple(out)


def bcast_grid(mode, n, params, prep, iface="raw"):
    """(blocks, rows per tile) of the grid T4-T6 take with broadcast slabs
    (raw, or prepared: prep None) for n rows on the current device:
    persistent blocks, the occupancy API's blocks per SM x SMs at most,
    each walking tiles of rows."""
    from . import cuda_build
    lib = cuda_build.load("gf_layer", _declare)
    lib.gf_layer_grid.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.gf_layer_grid.restype = ctypes.c_int
    one = torch.zeros((1, params[0].shape[1]), device=params[0].device)
    ints, _, _, _, _, _ = _kernel_args(iface, one, params, "isigmoid", prep,
                                       None)
    ints[4] = n     # the rows (B), after lazy, skew, prepared, per_row
    c_ints, _ = _c_arrays([_MODES[mode]] + ints, [])
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(params[0].device):
        rc = lib.gf_layer_grid(c_ints, out)
    if rc != 0:
        raise RuntimeError(f"gf_layer grid query failed ({rc})")
    return tuple(out)


def _run(mode, iface, x, params, ift, prep, kd):
    if x.is_cuda:
        return _launch(mode, iface, x, params, ift, prep, kd)
    return layer_plain(mode, iface, x, params, ift, prep, kd)


def _run_bwd(body, iface, x, params, g1, g2, ift, prep, kd):
    if x.is_cuda:
        return _launch_bwd(body, iface, x, params, g1.contiguous(),
                           g2.contiguous(), ift, prep, kd)
    return layer_bwd_plain(body, iface, x, params, g1, g2, ift, prep, kd)


class _Layer(torch.autograd.Function):
    """A raw or lazy forward / sample entry point with the per-layer
    backward: the density direction saves its input x, the sample direction
    its output (as ``_gf_forward_raw_fwd`` / ``_gf_sample_raw_fwd``)."""

    @staticmethod
    def forward(ctx, mode, iface, ift, prep, kd, x, *params):
        out, ld = _run(mode, iface, x, params, ift, prep, kd)
        ctx.setup = (mode, iface, ift, prep, kd)
        ctx.save_for_backward(x if mode == "forward" else out, *params)
        return out, ld

    @staticmethod
    def backward(ctx, g1, g2):
        mode, iface, ift, prep, kd = ctx.setup
        res, *params = ctx.saved_tensors
        g1 = torch.zeros_like(res) if g1 is None else g1
        g2 = torch.zeros_like(res) if g2 is None else g2
        gx, grads = _run_bwd(mode, iface, res, tuple(params), g1, g2, ift,
                             prep, kd)
        return (None,) * 5 + (gx, *grads)


def _slabs(slabs):
    """(K, D, 1) broadcast slabs as (K, D), every slab contiguous."""
    if slabs[0].shape[-1] == 1:
        return tuple(t[..., 0].contiguous() for t in slabs)
    return tuple(t.contiguous() for t in slabs)


def _lazy_params(hidden, ws, bs):
    return (hidden.contiguous(), torch.cat(list(ws), dim=0).contiguous(),
            torch.cat(list(bs), dim=0).contiguous())


def gf_forward_raw(x, slabs, ift, prep):
    """Density-direction pass on raw slabs (means, lw_raw[, ln_raw]
    [, se_raw]), (K, D, 1|B): -> (val (B, D), ld (B, D))."""
    return _Layer.apply("forward", "raw", ift, prep, None, x.contiguous(),
                        *_slabs(slabs))


def gf_sample_raw(target, slabs, ift, prep):
    """Sampling-direction pass on raw slabs: Newton solve and the
    log-derivative at the root in one launch -> (x (B, D), ld (B, D))."""
    return _Layer.apply("sample", "raw", ift, prep, None, target.contiguous(),
                        *_slabs(slabs))


def gf_inverse_raw(target, slabs, ift, prep):
    """The solve alone on raw slabs (no gradient: ``make_inverse_fn``
    wraps it) -> x (B, D)."""
    return _run("inverse", "raw", target.contiguous(), _slabs(slabs), ift,
                prep, None)


def gf_forward_lazy(x, hidden, ws, bs, ift, prep, kd):
    """Density-direction pass with the final MLP product in the kernel:
    hidden (B, H), ws / bs the per-group (K*D, H) / (K*D,) rows in slab
    order, kd = (K, D) -> (val, ld)."""
    return _Layer.apply("forward", "lazy", ift, prep, tuple(kd),
                        x.contiguous(), *_lazy_params(hidden, ws, bs))


def gf_sample_lazy(target, hidden, ws, bs, ift, prep, kd):
    """Sampling-direction pass with the final MLP product in the kernel
    (see gf_forward_lazy) -> (x, ld)."""
    return _Layer.apply("sample", "lazy", ift, prep, tuple(kd),
                        target.contiguous(), *_lazy_params(hidden, ws, bs))


def _prepare(means, log_widths, log_norms):
    """(means, inv_widths, log_norm_w) of the prepared interface
    (``_prepare_xla``): a broadcast (K, D, 1) slab squeezed to (K, D)."""
    if means.shape[-1] == 1:
        means, log_widths, log_norms = (means[..., 0], log_widths[..., 0],
                                        log_norms[..., 0])
    lnw = log_norms - torch.logsumexp(log_norms, dim=0, keepdim=True)
    return (means.contiguous(), torch.exp(-log_widths).contiguous(),
            lnw.contiguous())


class _ForwardPrepared(torch.autograd.Function):
    """gf_forward_pallas: the kernel forward; the backward is the VJP of the
    plain formulation (``_gf_forward_bwd``, ``pallas_gf.py:848-860``)."""

    @staticmethod
    def forward(ctx, ift, x, means, log_widths, log_norms):
        ctx.ift = ift
        ctx.save_for_backward(x, means, log_widths, log_norms)
        return _run("forward", "prepared", x,
                    _prepare(means, log_widths, log_norms), ift, None, None)

    @staticmethod
    def backward(ctx, g_val, g_ld):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            val, ld = logistic_kde.gaussianize_forward(*inputs, ctx.ift)
            cts = [torch.zeros_like(val) if g is None else g
                   for g in (g_val, g_ld)]
            return (None, *_grads((val, ld), inputs, cts))


def gf_forward_pallas(x, means, log_widths, log_norms, ift="isigmoid"):
    """Density-direction pass on prepared parameters (width-regulated
    log_widths, norm-regulated log_norms), (K, D, 1|B) -> (val, ld)."""
    return _ForwardPrepared.apply(ift, x.contiguous(), means, log_widths,
                                  log_norms)


def gf_inverse_pallas(target, means, log_widths, log_norms, ift="isigmoid"):
    """Solve gaussianization(x) = target for x on prepared parameters (no
    gradient: the solver inside ``make_inverse_fn``) -> x (B, D)."""
    with torch.no_grad():
        return _run("inverse", "prepared", target.contiguous(),
                    _prepare(means, log_widths, log_norms), ift, None, None)
