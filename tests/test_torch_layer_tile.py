"""The per-layer lazy kernels' parameter rows as a tile stage makes them.

csrc/gf_layer.cu and csrc/gf_layer_bwd.cu (lazy interface) make a layer's
parameter rows b_j + w_j . hidden one dimension at a time: for dimension dd
the piece of n_groups * K rows g K D + k D + dd (slab column j = g K + k is
row j D + dd), as a 3xTF32 tile product on the tensor cores
(csrc/tile_rows.cuh ``rows_product``), into a slab whose column each row's
thread reads.  Here that row map is mirrored in Python and multiplied
through ``gf_block.matmul_3xtf32`` (the tensor-core numerics emulated); the
slabs it assembles must reproduce the port's plain ``gf_layer._lazy_slabs``
and the JAX package's ``_lazy_slabs`` (ops/pallas_gf.py), each within a few
float32 ulps of the float64 product, and the skewed ``forward_lazy`` plain
version fed those rows must stay within the kernels' 3e-4 of its float64
version.  Runs on the CPU (JAX on the CPU too).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jammy_flows_tpu.ops import pallas_gf
from jammy_flows_tpu_torch.ops import gf_block as gb
from jammy_flows_tpu_torch.ops import gf_layer as gl
from jammy_flows_tpu_torch.ops.special import (log_bounded_exp_fn,
                                               width_regulator_fn)
from torch_one_thread import _one_torch_thread  # noqa: F401

N_ROWS = 96
ULPS = 8               # "a few": a float32 matmul itself lies ~5 away
EPS32 = 2.0 ** -24     # half an ulp of 1 in float32
TOL_DENSITY = 3e-4     # kernel vs plain, the density direction


def _lazy_case(k, d, n_groups, hid, seed=0):
    """hidden (B, H), wcat (P, H), bcat (P,) from a seed, P = n_groups K d:
    biases of the spread of a layer's raw slabs, w scaled so that a row's
    parameters keep that spread at any hidden width."""
    rng = np.random.default_rng(seed)
    hidden = np.tanh(rng.normal(size=(N_ROWS, hid)))
    w = 0.2 * np.sqrt(24 / hid) * rng.normal(size=(n_groups * k * d, hid))
    b = rng.normal(size=n_groups * k * d)
    return tuple(torch.as_tensor(a, dtype=torch.float32)
                 for a in (hidden, w, b))


def piece_rows(k, d, n_groups, dd):
    """The parameter rows of dimension dd's piece, in slab-column order
    (csrc/gf_layer_src.cuh ``PieceRows``): column j = g K + k holds row
    g K d + k d + dd."""
    return [(g * k + kk) * d + dd for g in range(n_groups) for kk in range(k)]


def tile_slabs(hidden, w, b, kd, n_groups):
    """The slabs (n_groups of (K, d, B)) as the tile stage makes them: one
    3xTF32 product per dimension's piece, scattered to its rows."""
    k, d = kd
    out = torch.empty((n_groups * k * d, hidden.shape[0]))
    for dd in range(d):
        rows = piece_rows(k, d, n_groups, dd)
        piece = gb.matmul_3xtf32(hidden, w[rows].T) + b[rows]
        out[rows] = piece.T
    return [out[i:i + k * d].reshape(k, d, -1)
            for i in range(0, out.shape[0], k * d)]


def _ulps(slabs, hidden, w, b, kd):
    """Largest distance of slabs from the float64 rows, in units of 2^-24
    (|w| @ |hidden| + |b|) (an ulp of each row's summed magnitude)."""
    ref = w.double() @ hidden.double().T + b.double()[:, None]
    scale = w.double().abs() @ hidden.double().abs().T + \
        b.double().abs()[:, None]
    got = torch.cat([s.reshape(-1, hidden.shape[0]) for s in slabs])
    return float(((got.double() - ref).abs() / (EPS32 * scale)).max())


@pytest.mark.parametrize("hid", [12, 128])
@pytest.mark.parametrize("n_groups", [2, 3, 4])
@pytest.mark.parametrize("k,d", [(3, 1), (3, 4), (10, 1), (10, 4)])
def test_piece_rows_reproduce_the_lazy_slabs(k, d, n_groups, hid):
    hidden, w, b = _lazy_case(k, d, n_groups, hid)
    kd = (k, d)
    for dd in range(d):
        assert piece_rows(k, d, n_groups, dd) == \
            [j * d + dd for j in range(n_groups * k)]
    rows = sorted(r for dd in range(d) for r in piece_rows(k, d, n_groups,
                                                           dd))
    assert rows == list(range(n_groups * k * d))
    tile = tile_slabs(hidden, w, b, kd, n_groups)
    port = gl._lazy_slabs(hidden, w, b, kd)
    ref = pallas_gf._lazy_slabs(
        [jnp.asarray(hidden.numpy().T), jnp.asarray(w.numpy()),
         jnp.asarray(b.numpy()[:, None])], kd)
    ref = [torch.as_tensor(np.array(s)) for s in ref]
    assert [s.shape for s in tile] == [s.shape for s in port] == \
        [s.shape for s in ref] == [(k, d, N_ROWS)] * n_groups
    assert all(s.dtype == torch.float32 for s in tile + port + ref)
    for slabs in (tile, port, ref):
        assert _ulps(slabs, hidden, w, b, kd) < ULPS


@pytest.mark.parametrize("hid", [12, 128])
@pytest.mark.parametrize("ift", ["isigmoid", "inormal_partly_precise"])
def test_skewed_forward_lazy_on_tile_rows_holds_the_limit(ift, hid):
    """The skewed flagship layer's shape (K = 10, d = 4, four groups: means,
    log-widths, log-norms, skew exponents)."""
    k, d = 10, 4
    hidden, w, b = _lazy_case(k, d, 4, hid, seed=1)
    signs = tuple([1.0] * (k // 2) + [-1.0] * (k - k // 2))
    prep = (width_regulator_fn(0, 1, 0.01, 100, 0), None, True,
            log_bounded_exp_fn(0.1, 9.0, center=True), signs)
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(N_ROWS, d)),
                        dtype=torch.float32)
    got = gl.layer_plain("forward", "raw", x,
                         tile_slabs(hidden, w, b, (k, d), 4), ift, prep)
    ref = gl.layer_plain("forward", "lazy", x.double(),
                         (hidden.double(), w.double(), b.double()), ift,
                         prep, (k, d))
    for a, r in zip(got, ref):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        assert float((a.double() - r).abs().max()) < TOL_DENSITY
