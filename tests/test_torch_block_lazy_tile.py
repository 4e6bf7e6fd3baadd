"""The block's lazy mode: its parameter rows as the tile stage makes them.

csrc/gf_block.cu and csrc/gf_block_bwd.cu (lazy mode, precomputed hidden
activations) make a block's parameter rows b_j + w_j . hidden one piece at
a time, as a 3xTF32 tile product on the tensor cores (csrc/tile_rows.cuh
``rows_product``) into a shared slab whose column each row's thread reads.
A piece is a layer's offset and reflection rows (``SpanRows``, kept through
the layer) or one dimension's 3K mixture rows (``MixRows``: means,
log-widths, log-norms of dimension dd).  Here those row maps are mirrored
in Python and multiplied through ``gf_block.matmul_3xtf32`` (the
tensor-core numerics emulated); the rows they assemble must reproduce the
port's plain ``gf_block._make_slabs(..., "lazy")`` and the JAX package's
``_block_slabs_lazy`` (ops/pallas_gf_block.py), each within a few float32
ulps of the float64 product, and the plain block on those numerics must
stay within the kernels' limits of its float64 version.  Runs on the CPU
(JAX on the CPU too).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jammy_flows_tpu.ops import pallas_gf_block as jblk
from jammy_flows_tpu_torch import pdf
from jammy_flows_tpu_torch.ops import gf_block as gb
from torch_one_thread import _one_torch_thread  # noqa: F401

N_ROWS = 200
ULPS = 8               # "a few": a float32 matmul itself lies ~5 away
EPS32 = 2.0 ** -24     # half an ulp of 1 in float32
TOL = {"density": 3e-4, "sample": 3e-3}   # kernel vs plain
SHAPES = {"e3": ("e3", "gggg", 2, 0),      # (pdf, conditional input, block)
          "flagship": ("e4+s2+e4", "gggg+f+gggg", None, 2)}


def _case(shape, hid, seed=0):
    """A lazy block of ``shape`` with "16-<hid>" MLPs: its (prep, meta) and
    x (B, d), hidden (B, H), w (P, H), b (P,) from the block's own MLP
    (init_params moved by 0.02 N(0, 1)) on a random summary, all drawn with
    numpy from ``seed``."""
    target, flows, cond, k = SHAPES[shape]
    p = pdf(target, flows, conditional_input_dim=cond,
            amortization_mlp_dims=f"16-{hid}", device="cpu")
    prep, meta = p._block_meta[k]
    mlp = p.mlp_predictors[k]
    # the block takes the lazy mode: an MLP that splits at its final
    # matrix, not the fused one-hidden-layer one
    assert mlp.supports_penultimate() and not mlp.supports_full_fusion()
    rng = np.random.default_rng(seed)
    flat = p.init_params(seed=0)[f"mlp_{k}"]
    flat = flat + torch.as_tensor(0.02 * rng.normal(size=flat.shape),
                                  dtype=torch.float32)
    summary = torch.as_tensor(rng.normal(size=(N_ROWS, mlp.input_dim)),
                              dtype=torch.float32)
    hidden = mlp.apply_penultimate(flat, summary).detach().contiguous()
    w, b = (t.detach().contiguous() for t in mlp.final_layer_weights(flat))
    x = torch.as_tensor(0.8 * rng.normal(size=(N_ROWS, meta[1])),
                        dtype=torch.float32)
    return prep, meta, x, hidden, w, b


def span_rows(k, d, lm, row0):
    """A layer's offset and reflection rows (csrc/gf_block_src.cuh
    ``SpanRows``): slab column j is row row0 + j."""
    has_off, rot_it = lm[:2]
    return [row0 + j for j in range((d if has_off else 0) + rot_it * d)]


def mix_rows(k, d, lm, row0, dd):
    """Dimension dd's mixture rows (``MixRows``): column g K + kk is row
    (m0, lw0, ln0)[g] + kk d + dd, g over means, log-widths and (with
    fit_normalization) log-norms."""
    has_off, rot_it, has_ln = lm[:3]
    m0 = row0 + (d if has_off else 0) + rot_it * d
    return [m0 + g * k * d + kk * d + dd for g in range(2 + has_ln)
            for kk in range(k)]


def pieces(meta):
    """Every piece of a block in the kernels' order: per layer its span,
    then its d mixture pieces."""
    k, d, layers = meta
    row0, out = 0, []
    for lm in layers:
        out.append(span_rows(k, d, lm, row0))
        out += [mix_rows(k, d, lm, row0, dd) for dd in range(d)]
        row0 += gb._layer_rows(k, d, lm)
    return out


def tile_rows(hidden, w, b, meta):
    """The (P, B) parameter rows as the tile stage makes them: one 3xTF32
    product hidden . w_piece^T + b per piece, scattered to its rows."""
    out = torch.empty((w.shape[0], hidden.shape[0]))
    for rows in pieces(meta):
        if rows:
            out[rows] = (gb.matmul_3xtf32(hidden, w[rows].T) + b[rows]).T
    return out


def _flat(slabs, k, d):
    """Per-layer (off, rot, (means, lw, ln)) slabs back to (P, B) rows."""
    rows = []
    for off, rot, (m3, lw3, ln3) in slabs:
        rows += [t for t in (off, rot) if t is not None]
        rows += [t.reshape(k * d, -1) for t in (m3, lw3, ln3)
                 if t is not None]
    return torch.cat([torch.as_tensor(np.array(t)) for t in rows])


def _ulps(got, hidden, w, b):
    """Largest distance of (P, B) rows from the float64 rows, in units of
    2^-24 (|w| @ |hidden| + |b|) (an ulp of each row's summed magnitude)."""
    ref = w.double() @ hidden.double().T + b.double()[:, None]
    scale = w.double().abs() @ hidden.double().abs().T + \
        b.double().abs()[:, None]
    return float(((got.double() - ref).abs() / (EPS32 * scale)).max())


@pytest.mark.parametrize("hid", [12, 16])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_pieces_reproduce_the_lazy_slabs(shape, hid):
    prep, meta, x, hidden, w, b = _case(shape, hid)
    k, d, layers = meta
    assert sorted(r for rows in pieces(meta) for r in rows) == \
        list(range(gb.block_rows(k, d, layers))) == list(range(w.shape[0]))
    tile = tile_rows(hidden, w, b, meta)
    port = _flat(gb._make_slabs((hidden.T, w, b[:, None]), k, d, layers,
                                "lazy"), k, d)
    ref = _flat(jblk._block_slabs_lazy(
        jnp.asarray(hidden.numpy().T), jnp.asarray(w.numpy()),
        jnp.asarray(b.numpy()[:, None]), k, d, layers, 1), k, d)
    assert tile.shape == port.shape == ref.shape == (w.shape[0], N_ROWS)
    assert tile.dtype == port.dtype == ref.dtype == torch.float32
    for rows in (tile, port, ref):
        assert _ulps(rows, hidden, w, b) < ULPS


@pytest.mark.parametrize("direction", ["density", "sample"])
@pytest.mark.parametrize("hid", [12, 16])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_block_on_tile_numerics_holds_the_limit(shape, hid, direction):
    prep, meta, x, hidden, w, b = _case(shape, hid, seed=1)
    got = gb.block_plain(direction, x, (hidden, w, b), prep, meta, "lazy",
                         matmul=gb.matmul_3xtf32)
    ref = gb.block_plain(direction, x.double(),
                         (hidden.double(), w.double(), b.double()), prep,
                         meta, "lazy")
    for a, r in zip(got, ref):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        assert float((a.double() - r).abs().max()) < TOL[direction]
