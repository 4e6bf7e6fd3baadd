"""Whole-block Gaussianization flow: a `gggg` stack in one kernel launch.

PyTorch counterpart of ``jammy_flows_tpu/ops/pallas_gf_block.py``
(``_block_call`` / ``_make_block_kernel``, forward direction only).

  density (target -> base, log_prob), layers in reverse:
      x -= offset;  x = R_l^T x;  (x, ld_l) = mixture iCDF pass of x
  sample (base -> target), layers in order:
      x = Newton solve of the mixture pass;  ld += ld_l(x);  x = R_l x;  x += offset

Both return (x, ld) with ld per dimension, (B, d); the caller adds (density)
or subtracts (sample) its sum over d.

Parameters per layer, in the rows of one (P,) vector or of the final MLP
weight: [offset (d, last layer)] + [householder vs (it*d)] + [means (k*d)] +
[log_width raw (k*d)] + [log_norm raw (k*d, fit_normalization)].  Two
parameter modes:
  perm:  one broadcast (P,) vector (permanent parameters);
  lazy2: the fused amortization MLP ``w @ tanh(w1 @ summary + b1) + b``
         evaluated inside the kernel, so the (B, P) slab is never stored.

Every public entry point takes (B, d) rows.  On a CUDA tensor it launches the
hand-written kernel of csrc/gf_block.cu and counts the launch in
``LAUNCHES``; on a CPU tensor it runs the plain PyTorch version below.  It
never falls back from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import gf
from .special import IDENTITY

IFT_CODES = {"isigmoid": 0, "inormal_partly_precise": 1,
             "inormal_partly_crude": 2, "inormal_full_pade": 3}
# limits of the CUDA kernel (csrc/gf_block.cu): its register/local arrays
# and argument struct are sized by these.  They do not steer routing: a CUDA
# block beyond them raises in the wrapper
KERNEL_MAX_K = 64
KERNEL_MAX_D = 32
KERNEL_MAX_LAYERS = 16

LAUNCHES = {"density_perm": 0, "sample_perm": 0,
            "density_lazy2": 0, "sample_lazy2": 0}


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
    None.  Every layer must be a GaussianizationFlow (the port's takes only
    the classic stretch with householder or no rotation) with shared
    (num_kde, dimension, regulators); the iCDF type may differ per layer.
    meta = (k, d, per-layer layer_meta tuples)."""
    from ..layers.euclidean import GaussianizationFlow
    if not layers_objs:
        return None
    first = layers_objs[0]
    metas = []
    for lay in layers_objs:
        if type(lay) is not GaussianizationFlow:
            return None
        if (lay.num_kde != first.num_kde or lay.dimension != first.dimension
                or lay._kernel_prep != first._kernel_prep):
            return None
        metas.append(layer_meta(lay.model_offset, lay.householder_iter,
                                bool(lay.fit_normalization),
                                lay.inverse_function_type))
    return first._kernel_prep, (first.num_kde, first.dimension, tuple(metas))


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


def _make_slabs(param_arrays, k, d, layers, lazy):
    """Per-layer (off, rot, (means, lw, ln)) slabs with (rows, 1|B) columns.

    lazy=False: [pvec (P, 1)].  lazy=True (fused MLP): [summary (In, B),
    w1 (H, In), b1 (H, 1), w (P, H), b (P, 1)]."""
    if lazy:
        summary, w1, b1, w, b = param_arrays
        hidden = torch.tanh(torch.matmul(w1, summary) + b1)
        p = torch.matmul(w, hidden) + b
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


def block_density_plain(x, param_arrays, prep, meta, lazy):
    """(x (d, B), params) -> (base (d, B), ld_sum (d, B))."""
    k, d, layers = meta
    slabs = _make_slabs(param_arrays, k, d, layers, lazy)
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


def block_sample_plain(z, param_arrays, prep, meta, lazy):
    """(z (d, B), params) -> (target (d, B), ld_sum (d, B)); ld_sum is
    sum_l log|d gauss_l/dx| at the solutions (the caller subtracts it)."""
    k, d, layers = meta
    slabs = _make_slabs(param_arrays, k, d, layers, lazy)
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


def block_plain(direction, x, params, prep, meta, lazy):
    """The plain PyTorch version of an entry point, in the wrapper's own
    layout: x (B, d); params (pvec,) or (summary (B, In), w1, b1 (H,), w,
    b (P,)).  Returns (out (B, d), ld (B, d))."""
    if lazy:
        summary, w1, b1, w, b = params
        cols = (summary.T, w1, b1[:, None], w, b[:, None])
    else:
        cols = (params[0][:, None],)
    fn = block_density_plain if direction == "density" else block_sample_plain
    out, ld = fn(x.T, cols, prep, meta, lazy)
    return out.T.contiguous(), ld.T.contiguous()


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gf_block_launch.argtypes = [i, i, p, p, p, i, p, p, p, p, p, p,
                                    i, i, i, p, p, p]
    lib.gf_block_launch.restype = i
    lib.gf_block_error_string.argtypes = [i]
    lib.gf_block_error_string.restype = ctypes.c_char_p


def _library():
    from . import cuda_build
    return cuda_build.load("gf_block", _declare)


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
    if t.requires_grad:
        raise RuntimeError(f"{name} requires grad: the block kernel's "
                           "backward is not ported yet (training slice)")


def _launch(x, params, prep, meta, lazy, direction):
    k, d, layers = meta
    b_rows = x.shape[0]
    n_params = block_rows(k, d, layers)
    dev = x.device
    _check("x", x, (b_rows, d), dev)
    if k > KERNEL_MAX_K or d > KERNEL_MAX_D or len(layers) > KERNEL_MAX_LAYERS:
        raise ValueError(f"block (k={k}, d={d}, {len(layers)} layers) exceeds "
                         "the CUDA kernel's limits")
    if lazy:
        summary, w1, b1, w, b = params
        n_in, hid = summary.shape[1], w1.shape[0]
        for name, t, shape in (("summary", summary, (b_rows, n_in)),
                               ("w1", w1, (hid, n_in)), ("b1", b1, (hid,)),
                               ("w", w, (n_params, hid)),
                               ("b", b, (n_params,))):
            _check(name, t, shape, dev)
        ptrs = [0, summary.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                w.data_ptr(), b.data_ptr()]
    else:
        (pvec,) = params
        _check("pvec", pvec, (n_params,), dev)
        n_in = hid = 0
        ptrs = [pvec.data_ptr(), 0, 0, 0, 0, 0]
    width_reg, norm_reg, fit_norm = prep
    norm_reg = norm_reg if norm_reg is not None else IDENTITY
    ints = [k, d, len(layers), int(bool(fit_norm)),
            width_reg.kernel_args()[0], norm_reg.kernel_args()[0]]
    for has_off, rot_it, has_ln, ift in layers:
        ints += [int(has_off), int(rot_it), int(has_ln), IFT_CODES[ift]]
    floats = list(width_reg.kernel_args()[1:]) + \
        list(norm_reg.kernel_args()[1:])
    c_ints = (ctypes.c_int * len(ints))(*ints)
    c_floats = (ctypes.c_float * len(floats))(*floats)

    out = torch.empty_like(x)
    ld = torch.empty_like(x)
    if b_rows == 0:
        return out, ld
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gf_block_launch(int(direction == "sample"), int(lazy),
                                 x.data_ptr(), out.data_ptr(), ld.data_ptr(),
                                 b_rows, *ptrs, n_in, hid, n_params,
                                 c_ints, c_floats, stream)
    if rc != 0:
        msg = lib.gf_block_error_string(rc).decode()
        raise RuntimeError(f"gf_block kernel launch failed ({rc}): {msg}")
    LAUNCHES[f"{direction}_{'lazy2' if lazy else 'perm'}"] += 1
    return out, ld


def _run(x, params, prep, meta, lazy, direction):
    if x.is_cuda:
        return _launch(x, params, prep, meta, lazy, direction)
    return block_plain(direction, x, params, prep, meta, lazy)


def gf_block_density_perm(x, pvec, prep, meta):
    """x (B, d), pvec (P,) -> (base (B, d), ld (B, d))."""
    return _run(x, (pvec,), prep, meta, False, "density")


def gf_block_sample_perm(z, pvec, prep, meta):
    """z (B, d) base draws, pvec (P,) -> (target (B, d), ld (B, d))."""
    return _run(z, (pvec,), prep, meta, False, "sample")


def gf_block_density_lazy2(x, summary, w1, b1, w, b, prep, meta):
    """Fused-MLP density block: x (B, d), summary (B, In), w1 (H, In),
    b1 (H,), w (P, H), b (P,) -> (base (B, d), ld (B, d))."""
    return _run(x, (summary, w1, b1, w, b), prep, meta, True, "density")


def gf_block_sample_lazy2(z, summary, w1, b1, w, b, prep, meta):
    """Fused-MLP sampling block (see gf_block_density_lazy2)."""
    return _run(z, (summary, w1, b1, w, b), prep, meta, True, "sample")
