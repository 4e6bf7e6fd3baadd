"""Whole-block Gaussianization flow: a `gggg` stack in one kernel launch.

PyTorch counterpart of ``jammy_flows_tpu/ops/pallas_gf_block.py``: the
forward (``_block_call``), its backward (``_block_bwd_call``) and the fused
NLL value-and-gradient (``_block_fused_call``).

  density (target -> base, log_prob), layers in reverse:
      x -= offset;  x = R_l^T x;  (x, ld_l) = mixture iCDF pass of x
  sample (base -> target), layers in order:
      x = Newton solve of the mixture pass;  ld += ld_l(x);  x = R_l x;  x += offset

Both return (x, ld) with ld per dimension, (B, d); the caller adds (density)
or subtracts (sample) its sum over d.

Parameters per layer, in the rows of one (P,) vector or of the final MLP
weight: [offset (d, last layer)] + [householder vs (it*d)] + [means (k*d)] +
[log_width raw (k*d)] + [log_norm raw (k*d, fit_normalization)].  Three
parameter modes (``mode``, the JAX ``_make_slabs``' ``lazy`` flag):
  "perm":  one broadcast (P,) vector (permanent parameters);
  "lazy2": the fused amortization MLP ``w @ tanh(w1 @ summary + b1) + b``
           evaluated inside the kernel, so the (B, P) slab is never stored;
  "lazy":  the MLP's hidden activations (B, H), made outside (any MLP that
           splits at its final matrix), and the final ``w``, ``b``: the
           kernel makes each row's parameters ``w @ hidden + b`` itself.

Gradients: the four forward entry points are ``torch.autograd.Function``s
whose backward is the block backward, as the JAX package's custom VJPs are.
The density backward differentiates the whole chain (saving x); the sample
backward saves the output y, reconstructs each layer's solve output from it
and chains per-layer implicit-function steps (no re-solve).  The fused NLL
entry points (perm and lazy2, as in the JAX package) run the density forward
and its backward in one call with the cotangents (wv * val, wl) known in
advance.

Every public entry point takes (B, d) rows.  On a CUDA tensor it launches the
hand-written kernel (csrc/gf_block.cu forward, csrc/gf_block_bwd.cu backward
and fused NLL) and counts the launch in ``LAUNCHES``; on a CPU tensor it runs
the plain PyTorch version below.  It never falls back from the kernel to the
plain version.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from . import gf
from .special import IDENTITY

IFT_CODES = {"isigmoid": 0, "inormal_partly_precise": 1,
             "inormal_partly_crude": 2, "inormal_full_pade": 3}
# limits of the CUDA kernels (csrc/gf_block*.cu): their register/local
# arrays and argument struct are sized by these.  They do not steer routing:
# a CUDA block beyond them raises in the wrapper
KERNEL_MAX_K = 64
KERNEL_MAX_D = 32
KERNEL_MAX_LAYERS = 16
# routing, as the JAX package routes (ops/pallas_gf.py:1067, there a VMEM
# guard for the in-kernel final product): an MLP whose final hidden width
# exceeds it takes materialized rows instead of the lazy interfaces
# (models/pdf.py, layers/euclidean.py).  Every H up to it launches.
MAX_KERNEL_H = 1024
# the widest conditional summary the fused MLP (lazy2) takes
# (models/pdf.py:502-503 of the JAX package); wider ones take "lazy"
MAX_FUSED_SUMMARY = 128

MODES = {"perm": 0, "lazy2": 1, "lazy": 2}      # the C interfaces' codes
# launch-counter suffix per mode ("lazyh": precomputed hidden, a name apart
# from the per-layer counters of ops/gf_layer.py)
_COUNTER = {"perm": "perm", "lazy2": "lazy2", "lazy": "lazyh"}

LAUNCHES = {"density_perm": 0, "sample_perm": 0,
            "density_lazy2": 0, "sample_lazy2": 0,
            "density_lazyh": 0, "sample_lazyh": 0,
            "density_bwd_perm": 0, "density_bwd_lazy2": 0,
            "density_bwd_lazyh": 0,
            "sample_bwd_perm": 0, "sample_bwd_lazy2": 0,
            "sample_bwd_lazyh": 0,
            "nll_perm": 0, "nll_lazy2": 0}


def reset_launch_counts():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# ---------------------------------------------------------------------------
# static layout bookkeeping
# ---------------------------------------------------------------------------

def layer_meta(has_offset, rot_it, has_ln, ift):
    return (bool(has_offset), int(rot_it), bool(has_ln), str(ift))


def _layer_rows(k, d, lm):
    has_off, rot_it, has_ln = lm[:3]
    return (d if has_off else 0) + rot_it * d + (2 + has_ln) * k * d


def block_rows(k, d, layers):
    return sum(_layer_rows(k, d, lm) for lm in layers)


def _slice_layer(rows2d, k, d, lm):
    """Split one layer's (rows, C) slab into (off, rot, means, lw, ln)."""
    has_off, rot_it, has_ln = lm[:3]
    kd = k * d
    i = 0

    def take(n):
        nonlocal i
        out = rows2d[i:i + n]
        i += n
        return out

    off = take(d) if has_off else None
    rot = take(rot_it * d) if rot_it else None
    means = take(kd)
    lw = take(kd)
    ln = take(kd) if has_ln else None
    return off, rot, means, lw, ln


def block_meta(layers_objs):
    """(prep, meta) when a sub-manifold's layer list runs as one block, else
    None (``pallas_gf_block.py:757-796``).  Every layer must be a
    GaussianizationFlow with the classic stretch, no skewness, no
    center_mean, no tail Newton refinement, householder or no rotation and
    a known iCDF type, all with the same (num_kde, dimension, regulators);
    the iCDF type may differ per layer.  prep = (width_reg, norm_reg|None,
    fit_norm); meta = (k, d, per-layer layer_meta tuples)."""
    from ..layers.euclidean import GaussianizationFlow
    if not layers_objs:
        return None
    first = layers_objs[0]
    metas = []
    for lay in layers_objs:
        if type(lay) is not GaussianizationFlow:
            return None
        if (lay.nonlinear_stretch_type != "classic" or lay.add_skewness
                or lay.center_mean or getattr(lay, "hp_tail_newton", 0)
                or lay.inverse_function_type not in IFT_CODES
                or lay.rotation_mode not in ("householder", "none")):
            return None
        if (lay.num_kde != first.num_kde or lay.dimension != first.dimension
                or lay._kernel_prep != first._kernel_prep):
            return None
        metas.append(layer_meta(lay.model_offset, lay.householder_iter,
                                bool(lay.fit_normalization),
                                lay.inverse_function_type))
    return first._kernel_prep[:3], (first.num_kde, first.dimension,
                                    tuple(metas))


# ---------------------------------------------------------------------------
# plain PyTorch versions (layout (d, B), as the TPU kernel body)
# ---------------------------------------------------------------------------

def _hh_rotate(x, rot, it, d, inverse):
    """Householder product on (d, C) columns; rot is (it*d, 1|C).  Forward
    applies the reflections in reversed order, inverse in ascending order
    (as ops/rotations.householder_apply)."""
    rg = rot.reshape(it, d, rot.shape[-1])
    order = range(it) if inverse else reversed(range(it))
    for i in order:
        v = rg[i]
        v = v / torch.sqrt(torch.sum(v * v, dim=0, keepdim=True) + 1e-20)
        x = x - 2.0 * v * torch.sum(v * x, dim=0, keepdim=True)
    return x


def round_tf32(x):
    """float32 -> TF32 as ``cvt.rna.tf32.f32`` rounds (csrc/mma_tf32.cuh):
    to nearest with ties away from zero, 10 mantissa bits kept and the low
    13 bits of the float32 zero.  Adding half a TF32 ulp to the bit pattern
    and truncating does it, the sign being a bit of its own."""
    u = x.contiguous().view(torch.int32)
    r = torch.bitwise_and(u + 0x1000, -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def matmul_3xtf32(a, b, passes=3):
    """The float32 product a (M, K) @ b (K, N) as the lazy2 kernels' tile
    products make it on the tensor cores (csrc/mma_tf32.cuh), emulated:
    each factor split into TF32 parts hi = round_tf32(x), lo =
    round_tf32(x - hi); per k step of 8 (one m16n8k8 instruction) the
    products lo*hi, hi*lo, hi*hi, each added to the float32 accumulator in
    that order (the step's 8 products summed exactly, then rounded once);
    lo*lo is dropped.  ``passes=1`` is a single TF32 product (hi*hi only),
    which keeps about 3 decimal digits.  A plain version of the numerics
    for the tests; the kernels never call it."""
    a_hi = round_tf32(a)
    b_hi = round_tf32(b)
    a_lo = round_tf32(a - a_hi)
    b_lo = round_tf32(b - b_hi)
    terms = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))[3 - passes:]
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, a.shape[1], 8):
        for fa, fb in terms:
            step = torch.matmul(fa[:, k0:k0 + 8].double(),
                                fb[k0:k0 + 8].double())
            acc = (acc.double() + step).float()
    return acc


def _make_slabs(param_arrays, k, d, layers, mode, matmul=torch.matmul):
    """Per-layer (off, rot, (means, lw, ln)) slabs with (rows, 1|B) columns.

    "perm": [pvec (P, 1)].  "lazy": [hidden (H, B), w (P, H), b (P, 1)].
    "lazy2" (fused MLP): [summary (In, B), w1 (H, In), b1 (H, 1), w (P, H),
    b (P, 1)].  ``matmul`` makes the parameter rows w @ hidden (e.g.
    :func:`matmul_3xtf32`, the kernels' own numerics)."""
    if mode == "lazy2":
        summary, w1, b1, w, b = param_arrays
        hidden = torch.tanh(torch.matmul(w1, summary) + b1)
        p = matmul(w, hidden) + b
    elif mode == "lazy":
        hidden, w, b = param_arrays
        p = matmul(w, hidden) + b
    else:
        p = param_arrays[0]
    out = []
    row = 0
    for lm in layers:
        n = _layer_rows(k, d, lm)
        off, rot, means, lw, ln = _slice_layer(p[row:row + n], k, d, lm)
        row += n
        cols = means.shape[-1]
        mix = (means.reshape(k, d, cols), lw.reshape(k, d, cols),
               None if ln is None else ln.reshape(k, d, cols))
        out.append((off, rot, mix))
    return out


def _prep_mix(raw, prep):
    m3, lw3, ln3 = raw
    slabs = (m3, lw3) if ln3 is None else (m3, lw3, ln3)
    return gf.prep_raw_params(slabs, prep)


def block_density_plain(x, param_arrays, prep, meta, mode,
                        matmul=torch.matmul):
    """(x (d, B), params) -> (base (d, B), ld_sum (d, B))."""
    k, d, layers = meta
    slabs = _make_slabs(param_arrays, k, d, layers, mode, matmul)
    ld_sum = torch.zeros_like(x)
    for li in reversed(range(len(layers))):
        off, rot, raw = slabs[li]
        _, rot_it, _, ift = layers[li]
        if off is not None:
            x = x - off
        if rot is not None:
            x = _hh_rotate(x, rot, rot_it, d, inverse=True)
        x, ld = gf.mixture_value_deriv(x, _prep_mix(raw, prep), "log", ift)
        ld_sum = ld_sum + ld
    return x, ld_sum


def block_sample_plain(z, param_arrays, prep, meta, mode,
                       matmul=torch.matmul):
    """(z (d, B), params) -> (target (d, B), ld_sum (d, B)); ld_sum is
    sum_l log|d gauss_l/dx| at the solutions (the caller subtracts it)."""
    k, d, layers = meta
    slabs = _make_slabs(param_arrays, k, d, layers, mode, matmul)
    x = z
    ld_sum = torch.zeros_like(z)
    for li in range(len(layers)):
        off, rot, raw = slabs[li]
        _, rot_it, _, ift = layers[li]
        mix = _prep_mix(raw, prep)
        x = gf.solve(x, mix, ift)
        _, ld = gf.mixture_value_deriv_solve(x, mix, "log", ift)
        ld_sum = ld_sum + ld
        if rot is not None:
            x = _hh_rotate(x, rot, rot_it, d, inverse=False)
        if off is not None:
            x = x + off
    return x, ld_sum


def _leaves(tensors):
    return [t.detach().requires_grad_() for t in tensors]


def _grads(out, inputs, cts):
    got = torch.autograd.grad(out, inputs, cts, allow_unused=True)
    return [torch.zeros_like(i) if g is None else g
            for i, g in zip(inputs, got)]


def block_density_bwd_plain(x, param_arrays, g_out, g_ld, prep, meta, mode):
    """VJP of :func:`block_density_plain` (d, B layout): the whole chain
    differentiated, as ``_make_block_density_bwd`` does.  Returns (gx,
    [grads of param_arrays])."""
    with torch.enable_grad():
        xs, *ps = _leaves([x, *param_arrays])
        out, ld = block_density_plain(xs, ps, prep, meta, mode)
        gx, *gp = _grads((out, ld), [xs, *ps], (g_out, g_ld))
    return gx, gp


def block_sample_bwd_plain(y, param_arrays, g_out, g_ld, prep, meta, mode):
    """VJP of :func:`block_sample_plain` from its output y (d, B), as
    ``_make_block_sample_bwd`` computes it: each layer's solve output is
    reconstructed from y (s_l = R_l^T (out_l - off_l), out_{l-1} =
    gauss_l(s_l)), then the cotangents chain backwards through the out-ops
    (rotation, offset) and the per-layer implicit step
    (:func:`gf.implicit_step`).  Returns (gz, [grads of param_arrays])."""
    k, d, layers = meta
    with torch.enable_grad():
        ps = _leaves(param_arrays)
        slabs = _make_slabs(ps, k, d, layers, mode)
        with torch.no_grad():
            s_list = [None] * len(layers)
            out = y
            for li in reversed(range(len(layers))):
                off, rot, raw = slabs[li]
                _, rot_it, _, ift = layers[li]
                s = out if off is None else out - off
                if rot is not None:
                    s = _hh_rotate(s, rot, rot_it, d, inverse=True)
                s_list[li] = s
                if li > 0:
                    out = gf.gauss_value(s, _prep_mix(raw, prep), ift)
        # parameter cotangents of every layer's terms, summed into one
        # scalar with the cotangents held constant
        total = 0.0
        g = g_out
        for li in reversed(range(len(layers))):
            off, rot, raw = slabs[li]
            _, rot_it, _, ift = layers[li]
            s = s_list[li].detach().requires_grad_()
            yy = s
            if rot is not None:
                yy = _hh_rotate(yy, rot, rot_it, d, inverse=False)
            if off is not None:
                yy = yy + off
            gs, = torch.autograd.grad(yy, s, g, retain_graph=True)
            total = total + (yy * g).sum()
            c, val, ld = gf.implicit_step(s_list[li], _prep_mix(raw, prep),
                                          ift, gs, g_ld)
            total = total + (val * (-c)).sum() + (ld * g_ld).sum()
            g = c
        gp = _grads(total, ps, None)
    return g, gp


def _to_cols(params, mode):
    """Wrapper layout -> the plain versions' (d, B) layout."""
    if mode == "lazy2":
        summary, w1, b1, w, b = params
        return (summary.T, w1, b1[:, None], w, b[:, None])
    if mode == "lazy":
        hidden, w, b = params
        return (hidden.T, w, b[:, None])
    return (params[0][:, None],)


def _from_cols(grads, mode):
    if mode == "lazy2":
        gs, gw1, gb1, gw, gb = grads
        return (gs.T.contiguous(), gw1, gb1[:, 0], gw, gb[:, 0])
    if mode == "lazy":
        gh, gw, gb = grads
        return (gh.T.contiguous(), gw, gb[:, 0])
    return (grads[0][:, 0],)


def block_plain(direction, x, params, prep, meta, mode, matmul=torch.matmul):
    """The plain PyTorch version of an entry point, in the wrapper's own
    layout: x (B, d); params (pvec,), (summary (B, In), w1, b1 (H,), w,
    b (P,)) or (hidden (B, H), w, b).  Returns (out (B, d), ld (B, d)).
    ``matmul`` makes the amortized modes' parameter rows."""
    fn = block_density_plain if direction == "density" else block_sample_plain
    out, ld = fn(x.T, _to_cols(params, mode), prep, meta, mode, matmul)
    return out.T.contiguous(), ld.T.contiguous()


def block_bwd_plain(direction, x_or_y, params, g_out, g_ld, prep, meta,
                    mode):
    """The plain version of the block backward, in the wrapper's layout:
    x_or_y is the density input x or the sample output y (B, d); g_out,
    g_ld (B, d) the cotangents of (out, ld).  Returns (gx (B, d), grads of
    params in their own shapes: (gpvec,), (gsummary (B, In), gw1, gb1, gw,
    gb) or (ghidden (B, H), gw, gb))."""
    fn = block_density_bwd_plain if direction == "density" \
        else block_sample_bwd_plain
    gx, gp = fn(x_or_y.T, _to_cols(params, mode), g_out.T, g_ld.T, prep,
                meta, mode)
    return gx.T.contiguous(), _from_cols(gp, mode)


def block_nll_plain(x, params, prep, meta, mode, wv, wl):
    """The plain version of the fused NLL call: the density forward, then
    its backward with the cotangents (wv * val, wl).  Returns (val, ld, gx,
    grads) in the wrapper's layout."""
    val, ld = block_plain("density", x, params, prep, meta, mode)
    gx, gp = block_bwd_plain("density", x, params, wv * val,
                             torch.full_like(ld, wl), prep, meta, mode)
    return val, ld, gx, gp


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gf_block_launch.argtypes = [i, i, p, p, p, i, p, p, p, p, p, p, p,
                                    i, i, i, p, p, p]
    lib.gf_block_launch.restype = i
    lib.gf_block_occupancy.argtypes = [i, i, i, i, p, p]
    lib.gf_block_occupancy.restype = i
    # absent from the libraries built before the perm forward's tile loop
    # (tools/tile_breakdown.py --csrc of an older tree)
    if hasattr(lib, "gf_block_perm_grid"):
        lib.gf_block_perm_grid.argtypes = [i, i, i, p, p]
        lib.gf_block_perm_grid.restype = i
        lib.gf_block_recip_mismatches.argtypes = [ctypes.c_uint,
                                                  ctypes.c_uint, p, p]
        lib.gf_block_recip_mismatches.restype = i
    lib.gf_block_error_string.argtypes = [i]
    lib.gf_block_error_string.restype = ctypes.c_char_p


def _declare_bwd(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gf_block_bwd_launch.argtypes = [i, i, p, p, p, f, f, p, p, p, i,
                                        p, p, p, p, p, p, p, i, i, i, p, p,
                                        p, p, i, p, p, p]
    lib.gf_block_bwd_launch.restype = i
    lib.gf_block_bwd_blocks.argtypes = [i, i, i, i, i, i, p]
    lib.gf_block_bwd_blocks.restype = i
    lib.gf_block_bwd_scratch.argtypes = [i, i, i, p]
    lib.gf_block_bwd_scratch.restype = i
    lib.gf_block_bwd_occupancy.argtypes = [i, i, i, i, p, p]
    lib.gf_block_bwd_occupancy.restype = i
    lib.gf_block_bwd_error_string.argtypes = [i]
    lib.gf_block_bwd_error_string.restype = ctypes.c_char_p


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 for the CUDA block kernel, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _kernel_args(x, params, prep, meta, mode):
    """Check a call's tensors against what the kernels take; returns
    (parameter pointers, n_in, hid, n_params, meta ints, regulator
    floats) in the order of the C interfaces."""
    k, d, layers = meta
    b_rows = x.shape[0]
    n_params = block_rows(k, d, layers)
    dev = x.device
    _check("x", x, (b_rows, d), dev)
    if k > KERNEL_MAX_K or d > KERNEL_MAX_D or len(layers) > KERNEL_MAX_LAYERS:
        raise ValueError(f"block (k={k}, d={d}, {len(layers)} layers) exceeds "
                         "the CUDA kernel's limits")
    if mode == "lazy2":
        summary, w1, b1, w, b = params
        n_in, hid = summary.shape[1], w1.shape[0]
        for name, t, shape in (("summary", summary, (b_rows, n_in)),
                               ("w1", w1, (hid, n_in)), ("b1", b1, (hid,)),
                               ("w", w, (n_params, hid)),
                               ("b", b, (n_params,))):
            _check(name, t, shape, dev)
        ptrs = [0, summary.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                w.data_ptr(), b.data_ptr(), 0]
    elif mode == "lazy":
        hidden, w, b = params
        n_in, hid = 0, hidden.shape[1]
        for name, t, shape in (("hidden", hidden, (b_rows, hid)),
                               ("w", w, (n_params, hid)),
                               ("b", b, (n_params,))):
            _check(name, t, shape, dev)
        ptrs = [0, 0, 0, 0, w.data_ptr(), b.data_ptr(), hidden.data_ptr()]
    else:
        (pvec,) = params
        _check("pvec", pvec, (n_params,), dev)
        n_in = hid = 0
        ptrs = [pvec.data_ptr(), 0, 0, 0, 0, 0, 0]
    c_ints, c_floats = _meta_args(prep, meta)
    return ptrs, n_in, hid, n_params, c_ints, c_floats


def _meta_args(prep, meta):
    """The C interfaces' meta ints and regulator floats."""
    k, d, layers = meta
    width_reg, norm_reg, fit_norm = prep
    norm_reg = norm_reg if norm_reg is not None else IDENTITY
    ints = [k, d, len(layers), int(bool(fit_norm)),
            width_reg.kernel_args()[0], norm_reg.kernel_args()[0]]
    for has_off, rot_it, has_ln, ift in layers:
        ints += [int(has_off), int(rot_it), int(has_ln), IFT_CODES[ift]]
    floats = list(width_reg.kernel_args()[1:]) + \
        list(norm_reg.kernel_args()[1:])
    return ((ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * len(floats))(*floats))


def kernel_occupancy(name, prep, meta, hid=0):
    """(blocks per SM, threads per block, dynamic shared memory bytes) of
    the kernel behind launch counter ``name`` (e.g. "density_lazy2",
    "nll_lazy2", "sample_bwd_perm") for a block (prep, meta) with an MLP
    hidden width ``hid``, by cudaOccupancyMaxActiveBlocksPerMultiprocessor
    on the current device."""
    from . import cuda_build
    parts = name.split("_")
    mode = {v: k for k, v in _COUNTER.items()}[parts[-1]]
    n_params = block_rows(meta[0], meta[1], meta[2])
    c_ints, _ = _meta_args(prep, meta)
    out = (ctypes.c_int * 3)()
    if parts[0] == "nll" or parts[1] == "bwd":
        lib = cuda_build.load("gf_block_bwd", _declare_bwd)
        rc = lib.gf_block_bwd_occupancy(_BWD_MODES[parts[0]], MODES[mode],
                                        hid, n_params, c_ints, out)
    else:
        lib = cuda_build.load("gf_block", _declare)
        rc = lib.gf_block_occupancy(int(parts[0] == "sample"), MODES[mode],
                                    hid, n_params, c_ints, out)
    if rc != 0:
        raise RuntimeError(f"occupancy query for {name} failed ({rc})")
    return tuple(out)


def perm_grid(direction, n, prep, meta):
    """(blocks, rows per tile) of the T1 perm kernel's grid for n rows on
    the current device: persistent blocks, (occupancy API blocks per SM)
    x SMs at most, each walking tiles of rows."""
    from . import cuda_build
    lib = cuda_build.load("gf_block", _declare)
    c_ints, _ = _meta_args(prep, meta)
    out = (ctypes.c_int * 2)()
    rc = lib.gf_block_perm_grid(int(direction == "sample"), n,
                                block_rows(*meta), c_ints, out)
    if rc != 0:
        raise RuntimeError(f"perm grid query failed ({rc})")
    return tuple(out)


def recip_mismatches(device, lo=1.0, hi=2.0 ** 88):
    """How many float32 d in [lo, hi) the perm forward's reciprocal of
    1 + e (csrc/gf_common.cuh recip_ge1: rcp.approx and one Newton step,
    no range check) gives other bits than the IEEE 1.0f / d: the card's
    exhaustive check, every float of the range (1 + e lies in [1, 1 +
    e^60], below 2^88)."""
    from . import cuda_build
    lib = cuda_build.load("gf_block", _declare)
    bits = struct.unpack("<2I", struct.pack("<2f", lo, hi))
    count = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        rc = lib.gf_block_recip_mismatches(
            int(bits[0]), int(bits[1]), count.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"reciprocal check failed ({rc})")
    return int(count.item())


def _launch(x, params, prep, meta, mode, direction):
    ptrs, n_in, hid, n_params, c_ints, c_floats = _kernel_args(
        x, params, prep, meta, mode)
    b_rows = x.shape[0]
    out = torch.empty_like(x)
    ld = torch.empty_like(x)
    if b_rows == 0:
        return out, ld
    from . import cuda_build
    lib = cuda_build.load("gf_block", _declare)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gf_block_launch(int(direction == "sample"), MODES[mode],
                                 x.data_ptr(), out.data_ptr(), ld.data_ptr(),
                                 b_rows, *ptrs, n_in, hid, n_params,
                                 c_ints, c_floats, stream)
    if rc != 0:
        msg = lib.gf_block_error_string(rc).decode()
        raise RuntimeError(f"gf_block kernel launch failed ({rc}): {msg}")
    LAUNCHES[f"{direction}_{_COUNTER[mode]}"] += 1
    return out, ld


_BWD_MODES = {"density": 0, "sample": 1, "nll": 2}


def _launch_bwd(kind, x, params, g_out, g_ld, prep, meta, mode, wv=0.0,
                wl=0.0):
    """T2 (kind "density" / "sample": x is the density input or the sample
    output) or T3 (kind "nll", perm and lazy2: the density forward with
    cotangents (wv * val, wl)).  Returns (val, ld, gx, grads) with val, ld
    None unless T3; grads in the wrapper's layout."""
    if kind == "nll" and mode == "lazy":
        raise ValueError("no fused NLL on precomputed hidden activations")
    ptrs, n_in, hid, n_params, c_ints, c_floats = _kernel_args(
        x, params, prep, meta, mode)
    b_rows, d = x.shape
    dev = x.device
    if kind != "nll":
        _check("g_out", g_out, (b_rows, d), dev)
        _check("g_ld", g_ld, (b_rows, d), dev)
    val = ld = None
    if kind == "nll":
        val = torch.empty_like(x)
        ld = torch.empty_like(x)
    gx = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=dev)
    n_mlp = n_params * hid + n_params
    n_flat = {"perm": n_params, "lazy": n_mlp,
              "lazy2": hid * n_in + hid + n_mlp}[mode]
    flat = torch.zeros(n_flat, **f32)
    # the per-row gradient: gsummary (lazy2) or ghidden (lazy)
    grow = None if mode == "perm" else torch.zeros(
        (b_rows, n_in if mode == "lazy2" else hid), **f32)
    if b_rows > 0:
        from . import cuda_build
        lib = cuda_build.load("gf_block_bwd", _declare_bwd)
        # the kernel's grid, chosen by the library: persistent blocks, each
        # with a private partial of the broadcast gradients (and, where the
        # dh columns do not fit in shared memory, a scratch for them); in
        # perm mode each block writes its partial once, else adds to it
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        code = MODES[mode]
        n_blocks = lib.gf_block_bwd_blocks(_BWD_MODES[kind], code, b_rows,
                                           hid, n_params, n_sm, c_ints)
        if n_blocks < 1:
            raise ValueError(f"block backward: no tile of the kernel fits "
                             f"this block (mode {mode}, H={hid})")
        partials = (torch.empty if mode == "perm" else torch.zeros)(
            (n_blocks, n_flat), **f32)
        n_scratch = n_blocks * lib.gf_block_bwd_scratch(code, hid, n_params,
                                                        c_ints)
        scratch = torch.empty(n_scratch, **f32) if n_scratch else None
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.gf_block_bwd_launch(
                _BWD_MODES[kind], code, x.data_ptr(),
                0 if g_out is None else g_out.data_ptr(),
                0 if g_ld is None else g_ld.data_ptr(), float(wv), float(wl),
                0 if val is None else val.data_ptr(),
                0 if ld is None else ld.data_ptr(), gx.data_ptr(), b_rows,
                *ptrs, n_in, hid, n_params, c_ints, c_floats,
                0 if grow is None else grow.data_ptr(),
                partials.data_ptr(), n_blocks,
                0 if scratch is None else scratch.data_ptr(),
                flat.data_ptr(), stream)
        if rc != 0:
            msg = lib.gf_block_bwd_error_string(rc).decode()
            raise RuntimeError(f"gf_block_bwd kernel launch failed ({rc}): "
                               f"{msg}")
        LAUNCHES[f"{'nll' if kind == 'nll' else kind + '_bwd'}_"
                 f"{_COUNTER[mode]}"] += 1
    if mode == "perm":
        return val, ld, gx, (flat,)
    gw = flat[n_flat - n_mlp:n_flat - n_params].view(n_params, hid)
    gb = flat[n_flat - n_params:]
    if mode == "lazy":
        return val, ld, gx, (grow, gw, gb)
    o1 = hid * n_in
    return val, ld, gx, (grow, flat[:o1].view(hid, n_in), flat[o1:o1 + hid],
                         gw, gb)


def _run(x, params, prep, meta, mode, direction):
    if x.is_cuda:
        return _launch(x, params, prep, meta, mode, direction)
    return block_plain(direction, x, params, prep, meta, mode)


def _run_bwd(direction, res, params, g_out, g_ld, prep, meta, mode):
    if res.is_cuda:
        _, _, gx, grads = _launch_bwd(direction, res, params,
                                      g_out.contiguous(), g_ld.contiguous(),
                                      prep, meta, mode)
        return gx, grads
    return block_bwd_plain(direction, res, params, g_out, g_ld, prep, meta,
                           mode)


class _Block(torch.autograd.Function):
    """One forward entry point with the block backward: the density
    direction saves its input x, the sample direction its output y (as
    ``_bdl_fwd`` / ``_bsl_fwd`` / ``_bdl2_fwd`` / ``_bsl2_fwd`` /
    ``_bdp_fwd`` / ``_bsp_fwd``)."""

    @staticmethod
    def forward(ctx, direction, mode, prep, meta, x, *params):
        out, ld = _run(x, params, prep, meta, mode, direction)
        ctx.setup = (direction, mode, prep, meta)
        ctx.save_for_backward(x if direction == "density" else out, *params)
        return out, ld

    @staticmethod
    def backward(ctx, g_out, g_ld):
        direction, mode, prep, meta = ctx.setup
        res, *params = ctx.saved_tensors
        g_out = torch.zeros_like(res) if g_out is None else g_out
        g_ld = torch.zeros_like(res) if g_ld is None else g_ld
        gx, grads = _run_bwd(direction, res, tuple(params), g_out, g_ld,
                             prep, meta, mode)
        return (None, None, None, None, gx, *grads)


def gf_block_density_perm(x, pvec, prep, meta):
    """x (B, d), pvec (P,) -> (base (B, d), ld (B, d))."""
    return _Block.apply("density", "perm", prep, meta, x, pvec)


def gf_block_sample_perm(z, pvec, prep, meta):
    """z (B, d) base draws, pvec (P,) -> (target (B, d), ld (B, d))."""
    return _Block.apply("sample", "perm", prep, meta, z, pvec)


def gf_block_density_lazy(x, hidden, w, b, prep, meta):
    """Amortized density block on precomputed hidden activations: x (B, d),
    hidden (B, H), w (P, H), b (P,) -> (base (B, d), ld (B, d))
    (``pallas_gf_block.py:625``, whose b is (P, 1))."""
    return _Block.apply("density", "lazy", prep, meta, x, hidden, w, b)


def gf_block_sample_lazy(z, hidden, w, b, prep, meta):
    """Amortized sampling block on precomputed hidden activations (shapes as
    gf_block_density_lazy; ``pallas_gf_block.py:647``)."""
    return _Block.apply("sample", "lazy", prep, meta, z, hidden, w, b)


def gf_block_density_lazy2(x, summary, w1, b1, w, b, prep, meta):
    """Fused-MLP density block: x (B, d), summary (B, In), w1 (H, In),
    b1 (H,), w (P, H), b (P,) -> (base (B, d), ld (B, d))."""
    return _Block.apply("density", "lazy2", prep, meta, x, summary, w1, b1,
                        w, b)


def gf_block_sample_lazy2(z, summary, w1, b1, w, b, prep, meta):
    """Fused-MLP sampling block (see gf_block_density_lazy2)."""
    return _Block.apply("sample", "lazy2", prep, meta, z, summary, w1, b1,
                        w, b)


def _run_nll(x, params, prep, meta, mode, wv, wl):
    if x.is_cuda:
        return _launch_bwd("nll", x, params, None, None, prep, meta, mode,
                           wv, wl)
    return block_nll_plain(x, params, prep, meta, mode, wv, wl)


def gf_block_nll_perm(x, pvec, prep, meta, wv, wl):
    """Fused NLL value and gradient, permanent parameters: the density
    forward and its VJP for the cotangents (wv * base, wl) in one call.
    Returns (base (B, d), ld (B, d), gx (B, d), (gpvec (P,),))."""
    return _run_nll(x, (pvec,), prep, meta, "perm", wv, wl)


def gf_block_nll_lazy2(x, summary, w1, b1, w, b, prep, meta, wv, wl):
    """Fused NLL value and gradient, fused-MLP parameters (shapes as
    gf_block_density_lazy2).  Returns (base, ld, gx, (gsummary (B, In),
    gw1 (H, In), gb1 (H,), gw (P, H), gb (P,)))."""
    return _run_nll(x, (summary, w1, b1, w, b), prep, meta, "lazy2", wv, wl)
