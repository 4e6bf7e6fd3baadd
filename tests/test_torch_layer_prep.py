"""T4 / T6 with prepared broadcast slabs and T6 with raw broadcast slabs on
the card (csrc/gf_layer.cu ``gf_layer_prep_kernel`` and
``gf_layer_bcast_kernel``: persistent blocks, the mixtures prepared once
per block, T6's solve rolled), the per-row prepared calls beside them, and
every solve kernel's bracket at a NaN parameter, held against the plain
versions.

Every test needs a CUDA device and skips without one; the file imports no
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_layer_prep.py

Batches at the tile and grid edges: 0, 1, 127, 129 rows and a full wave of
the grid's blocks (blocks per SM x SMs x 128 rows) +- 1, where one block
walks a second tile; K = 10 (the compile-time instantiation) and K = 7,
D = 3 (the generic one); all four iCDF types; broadcast and per-row slabs.
Limits: 3e-4 for the density direction, 3e-3 for the Newton solve
(tests/test_torch_cuda.py TOL).  Rows the reference's 4-step solve leaves
unconverged are held as tests/test_torch_layer_raw_fwd.py ``_hold`` holds
them: at most FLIPS elements a call may leave the limit, each matching
another answer of the reference's solve or lying on a row unconverged in
float64.

NaN (every solve): one component of one dimension of a layer's parameters
made NaN on the card (0/0).  The plain versions keep it in the solve's
bracket (torch.amin / amax / clamp), so a plain isigmoid root is NaN
there; every kernel's root is NaN in exactly the plain version's places,
and the outputs the NaN does not reach in the plain version keep the bits
of the same kernel's result without it.  The skewed solve (regula-falsi start) agreed
before the bracket's repair too.
"""
import numpy as np
import pytest
import torch

from jammy_flows_tpu_torch import pdf
from jammy_flows_tpu_torch.ops import gf, gf_block as gb, gf_layer as gl
from jammy_flows_tpu_torch.ops.special import IDENTITY
from test_torch_cuda import (FLAGSHIP, IFTS, TOL, _block_args, _layer_case,
                             _lazy_args, _lazy_model)
from test_torch_layer_raw_fwd import FLIPS

pytestmark = pytest.mark.cuda

BATCHES = ("0", "1", "127", "129", "wave-1", "wave+1")
NAN_IFTS = ("isigmoid", "inormal_partly_precise")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _rows(which, iface, params, prep):
    if not which.startswith("wave"):
        return int(which)
    blocks, rows = gl.bcast_grid("inverse", 1 << 30, params, prep,
                                 iface=iface)
    return blocks * rows + (1 if which.endswith("+1") else -1)


def _x(n, d, seed, dev):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=(n, d)),
                           dtype=torch.float32, device=dev)


def _hold(mode, iface, got, ref, x, params, ift, prep, tol):
    """tests/test_torch_layer_raw_fwd.py ``_hold`` for any interface: every
    output within tol of ``ref``, but for at most FLIPS elements of a
    solve, each within tol of the plain version on the CPU or of the
    float64 path, or on a row whose 4-step solve the reference leaves
    unconverged in float64 (its root tol or more from the root after 50
    steps)."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    off = torch.zeros_like(got[0], dtype=torch.bool)
    for a, r in zip(got, ref):
        off |= (a - r).abs() >= tol
    if not bool(off.any()):
        return
    assert mode != "forward" and int(off.sum()) <= FLIPS, (mode, ift)

    def plain(xx, ps):
        out = gl.layer_plain(mode, iface, xx, ps, ift, prep)
        return out if isinstance(out, tuple) else (out,)

    p64 = tuple(p.double() for p in params)
    answers = [plain(x.cpu(), tuple(p.cpu() for p in params)),
               plain(x.double(), p64)]
    n_newton = gf.N_NEWTON
    gf.N_NEWTON = 50
    try:
        conv = plain(x.double(), p64)[0]
    finally:
        gf.N_NEWTON = n_newton
    held = (answers[1][0] - conv).abs() >= tol
    for ans in answers:
        on = torch.ones_like(off)
        for a, r in zip(got, ans):
            on &= (a.double() - r.to(a.device).double()).abs() < tol
        held |= on
    assert not bool((off & ~held).any()), ift


def _raw_of(prepared):
    """The prepared mixture (means, inverse widths, log weights) as raw
    slabs under identity regulators with the weights normalized: (slabs,
    prep)."""
    means, iw, lnw = prepared
    return (means, -torch.log(iw), lnw), (IDENTITY, None, True, None, None)


def _prep_case(iface, per_row, kd, which, dev, seed):
    """x and the parameters of one call; a wave batch is the broadcast
    grid's (per-row slabs are then made at that many rows)."""
    k, d = kd
    params, _, _ = _layer_case("prepared", False, 0, k, d, 1, dev,
                               seed=seed)
    prep = None
    if iface == "raw":
        params, prep = _raw_of(params)
    n = _rows(which, iface, params, prep)
    if per_row:
        params, _, _ = _layer_case("prepared", True, 0, k, d, n, dev,
                                   seed=seed)
        if iface == "raw":
            params, prep = _raw_of(params)
    return _x(n, d, seed + 1, dev), params, prep


@pytest.mark.parametrize("which", BATCHES)
@pytest.mark.parametrize("kd", [(10, 4), (7, 3)])
@pytest.mark.parametrize("iface,per_row", [("prepared", False),
                                           ("prepared", True),
                                           ("raw", False)])
def test_prep_kernels_match_plain(dev, iface, per_row, kd, which):
    """T6 (and T4 on prepared slabs) against layer_plain on every iCDF
    type; two launches bit-equal; T4 at T6's roots gives the plain
    version's log-derivative there within the density limit."""
    seed = 400 + 10 * per_row + kd[0] + (iface == "raw")
    x, params, prep = _prep_case(iface, per_row, kd, which, dev, seed)
    modes = ("inverse", "forward") if iface == "prepared" else ("inverse",)
    for ift in IFTS:
        roots = None
        for mode in modes:
            arg = x if mode == "inverse" else roots
            key = f"{mode}_{iface}"
            before = gl.LAUNCHES[key]
            got = gl._run(mode, iface, arg, params, ift, prep, None)
            again = gl._run(mode, iface, arg, params, ift, prep, None)
            assert gl.LAUNCHES[key] == before + 2 * (len(x) > 0)
            ref = gl.layer_plain(mode, iface, arg, params, ift, prep)
            torch.cuda.synchronize()
            tol = TOL["density" if mode == "forward" else "sample"]
            outs = got if isinstance(got, tuple) else (got,)
            for a, b, r in zip(outs, again if isinstance(again, tuple)
                               else (again,),
                               ref if isinstance(ref, tuple) else (ref,)):
                assert a.shape == r.shape and torch.isfinite(a).all()
                assert torch.equal(a, b), (mode, ift)
            if len(x):
                _hold(mode, iface, got, ref, arg, params, ift, prep, tol)
            if mode == "inverse":
                roots = got


@pytest.mark.parametrize("iface", ["prepared", "raw"])
def test_prep_bcast_grid_walks_tiles(dev, iface):
    """The broadcast grid: the occupancy API's blocks per SM x SMs, at most
    one block per 128-row tile."""
    params, _, _ = _layer_case("prepared", False, 0, 10, 4, 1, dev)
    prep = None
    if iface == "raw":
        params, prep = _raw_of(params)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    modes = ("forward", "inverse") if iface == "prepared" else ("inverse",)
    for mode in modes:
        per_sm = gl.kernel_occupancy(f"{mode}_{iface}", 10, 4, 0, 3,
                                     skew=False)[0]
        assert per_sm >= 1
        assert gl.bcast_grid(mode, 1 << 30, params, prep, iface=iface) == \
            (per_sm * n_sm, 128)
        assert gl.bcast_grid(mode, 300, params, prep, iface=iface) == \
            (3, 128)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("kd", [(10, 4), (7, 3)])
def test_inverse_raw_matches_inverse_prepared(dev, kd, per_row):
    """T6 raw and T6 prepared on the same mixture (raw slabs under identity
    regulators, the prepared slabs made from them by ``_prepare``): the
    same roots within the solve's limit, unconverged rows held as
    ``_hold`` holds them against the prepared interface's answers."""
    k, d = kd
    n = 4099
    rng = np.random.default_rng(500 + k + per_row)
    shp = (k, d, n) if per_row else (k, d)
    raw = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev) for a in
                (rng.normal(size=shp), -1.0 + 0.5 * rng.normal(size=shp),
                 rng.normal(size=shp)))
    prep = (IDENTITY, None, True, None, None)
    prepared = gl._prepare(*(t[..., None] if not per_row else t
                             for t in raw))
    x = _x(n, d, 501 + k, dev)
    for ift in IFTS:
        got = gl._run("inverse", "raw", x, raw, ift, prep, None)
        ref = gl._run("inverse", "prepared", x, prepared, ift, None, None)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        _hold("inverse", "prepared", got, ref, x, prepared, ift, None,
              TOL["sample"])


# ---------------------------------------------------------------------------
# a NaN parameter in every solve's bracket
# ---------------------------------------------------------------------------

def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _check_nan(got, clean, ref, ref_clean, nan_root):
    """NaN in exactly the plain version's places (in the root, when
    ``nan_root``: the plain isigmoid start), and every output the NaN does
    not reach in the plain version (equal to its result without the NaN)
    equal to the kernel's result without the NaN, bit for bit.  A bisected
    regula-falsi root is finite but moved, so it counts as reached."""
    got, clean, ref, ref_clean = map(_tuple, (got, clean, ref, ref_clean))
    for a, r in zip(got, ref):
        assert torch.equal(torch.isnan(a), torch.isnan(r))
    assert bool(torch.isnan(got[0]).any()) == nan_root
    n_kept = 0
    for a, c, r, rc in zip(got, clean, ref, ref_clean):
        kept = r == rc
        n_kept += int(kept.sum())
        assert torch.equal(a[kept], c[kept])
    assert n_kept


def _mean_row(meta, layer, comp, dim):
    """The parameter row of a block's mixture mean (layer, component,
    dimension) in the block's (P,) vector and its MLP's final rows."""
    k, d, layers = meta
    idx = torch.arange(gb.block_rows(k, d, layers), dtype=torch.float64)
    means = gb._make_slabs([idx[:, None]], k, d, layers, "perm")[layer][2][0]
    return int(means[comp, dim, 0])


@pytest.mark.parametrize("ift", NAN_IFTS)
@pytest.mark.parametrize("mode", ["perm", "lazy2", "lazy"])
def test_block_sample_kernels_keep_a_component_nan(dev, mode, ift):
    """T1 sample perm / lazy2 / lazy with one mixture mean of the block's
    last layer made NaN (in flow_0, or in the final MLP bias b): the root of
    that dimension and its log-derivative are NaN where the plain
    version's are."""
    k = 0 if mode == "perm" else 2
    p = _lazy_model(64, dev) if mode == "lazy" else pdf(*FLAGSHIP,
                                                        device=dev)
    prep, (kk, d, layers) = p._block_meta[k]
    meta = (kk, d, tuple((*lm[:3], ift) for lm in layers))
    if mode == "lazy":
        x, clean = _lazy_args(p, k, 1000, 600, dev)
    else:
        _, x, clean = _block_args(p, k, 1000, 600, dev)
    j = _mean_row(meta, len(layers) - 1, 3, 2)
    params = list(clean)
    params[-1] = params[-1].clone()
    params[-1][j] = torch.zeros((), device=dev) / 0.0
    params = tuple(params)
    got = gb._launch(x, params, prep, meta, mode, "sample")
    want = gb._launch(x, clean, prep, meta, mode, "sample")
    ref, ref_clean = (gb.block_plain("sample", x, ps, prep, meta, mode)
                      for ps in (params, clean))
    torch.cuda.synchronize()
    _check_nan(got, want, ref, ref_clean, ift == "isigmoid")


# (name, mode, interface, per row, skewed): every per-layer solve
NAN_LAYER_CASES = [
    ("T5 raw broadcast", "sample", "raw", False, 0),
    ("T5 raw per row", "sample", "raw", True, 0),
    ("T5 lazy", "sample", "lazy", False, 0),
    ("T6 prepared broadcast", "inverse", "prepared", False, 0),
    ("T6 prepared per row", "inverse", "prepared", True, 0),
    ("T6 raw broadcast", "inverse", "raw", False, 0),
    ("T6 raw per row", "inverse", "raw", True, 0),
    ("T5 raw broadcast skewed", "sample", "raw", False, 1),
    ("T5 raw per row skewed", "sample", "raw", True, 1),
    ("T5 lazy skewed", "sample", "lazy", False, 1),
    ("T6 raw broadcast skewed", "inverse", "raw", False, 1),
]


@pytest.mark.parametrize("kd", [(10, 4), (7, 3)])
@pytest.mark.parametrize("name,mode,iface,per_row,skew", NAN_LAYER_CASES)
def test_layer_solves_keep_a_component_nan(dev, name, mode, iface, per_row,
                                           skew, kd):
    """One component of one dimension NaN (a mean in the prepared slabs,
    a raw log-width, the lazy bias of a mean row; per row: at row 5 only),
    through each per-layer solve kernel: NaN places as the plain
    version's, the other rows bit-equal to the clean launch."""
    k, d = kd
    n = 1000
    params, prep, lkd = _layer_case(iface, per_row, skew, k, d, n, dev,
                                    seed=700 + k + skew)
    x = _x(n, d, 701, dev)
    bad = [t.clone() for t in params]
    nan = torch.zeros((), device=dev) / 0.0
    if iface == "lazy":
        bad[2][3 * d + 1] = nan         # group 0 (means), component 3
    else:
        slab = bad[0 if iface == "prepared" else 1]
        if per_row:
            slab[3, 1, 5] = nan
        else:
            slab[3, 1] = nan
    for ift in NAN_IFTS:
        got = gl._run(mode, iface, x, tuple(bad), ift, prep, lkd)
        clean = gl._run(mode, iface, x, params, ift, prep, lkd)
        ref, ref_clean = (gl.layer_plain(mode, iface, x, ps, ift, prep, lkd)
                          for ps in (tuple(bad), params))
        torch.cuda.synchronize()
        _check_nan(got, clean, ref, ref_clean,
                   ift == "isigmoid" and not skew)
