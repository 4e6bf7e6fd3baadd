"""T4 / T5 with raw broadcast slabs on the card (csrc/gf_layer.cu
``gf_layer_bcast_kernel``: persistent blocks, the mixtures prepared once
per block, T5's solve rolled), held against the plain versions.

Every test needs a CUDA device and skips without one; the file imports no
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_layer_raw_fwd.py

Batches at the tile and grid edges: 0, 1, 127, 129 rows and a full wave of
the grid's blocks (blocks per SM x SMs x 128 rows) +- 1; K = 10 (the
compile-time instantiation) and K = 7, D = 3 (the generic one); skewed and
plain; fit_norm on and off; all four iCDF types.  Limits: the JAX
package's kernel-vs-XLA limits, 3e-4 for the density direction and 3e-3
for the Newton solve (tests/test_torch_cuda.py TOL).  The reference's
4-step solve leaves 5-10% of the generic mixture's rows unconverged in
float32 (its float64 root 3e-3 or more from the root after 50 steps),
where a Newton-or-bisect decision can flip on rounding: one element of
each wave batch, 0.527 apart, takes one branch in the plain version on
the card and the other in the kernel and in the plain version on the
CPU.  Up to FLIPS such elements a call are held to another answer of the
reference's solve instead (``_hold``).
"""
import numpy as np
import pytest
import torch

from jammy_flows_tpu_torch.ops import gf, gf_layer as gl
from test_torch_cuda import IFTS, TOL, _layer_case

pytestmark = pytest.mark.cuda

BATCHES = ("0", "1", "127", "129", "wave-1", "wave+1")
# sample elements a call may leave the plain version by the limit (_hold)
FLIPS = 5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _rows(which, params, prep):
    if not which.startswith("wave"):
        return int(which)
    blocks, rows = gl.bcast_grid("sample", 1 << 30, params, prep)
    return blocks * rows + (1 if which.endswith("+1") else -1)


def _case(skew, fit, kd, which, dev, seed):
    k, d = kd
    params, prep, _ = _layer_case("raw", False, skew, k, d, 1, dev,
                                  seed=seed, fit=fit)
    n = _rows(which, params, prep)
    x = torch.as_tensor(np.random.default_rng(seed + 1).normal(size=(n, d)),
                        dtype=torch.float32, device=dev)
    return x, params, prep


def _hold(mode, got, ref, x, params, ift, prep, tol):
    """Every output within tol of the plain version's, but for at most
    FLIPS elements of the sample direction, each of which must lie within
    tol of one other answer of the reference's 4-step solve: the plain
    version's on the CPU (float32, its own rounding), or the float64
    path's; or lie on a row whose 4-step solve the reference leaves
    unconverged even in float64 (its root tol or more from the root after
    50 steps).  There a Newton-or-bisect decision flips on float32
    rounding, in the kernel as in the plain version."""
    off = torch.zeros_like(got[0], dtype=torch.bool)
    for a, r in zip(got, ref):
        off |= (a - r).abs() >= tol
    if not bool(off.any()):
        return
    assert mode == "sample" and int(off.sum()) <= FLIPS, (mode, ift)
    p64 = tuple(p.double() for p in params)
    answers = [gl.layer_plain(mode, "raw", x.cpu(), tuple(p.cpu() for p in
                                                          params), ift, prep),
               gl.layer_plain(mode, "raw", x.double(), p64, ift, prep)]
    n_newton = gf.N_NEWTON
    gf.N_NEWTON = 50
    try:
        conv = gl.layer_plain(mode, "raw", x.double(), p64, ift, prep)[0]
    finally:
        gf.N_NEWTON = n_newton
    held = (answers[1][0] - conv).abs() >= tol
    for ans in answers:
        on = torch.ones_like(off)
        for a, r in zip(got, ans):
            on &= (a.double() - r.to(a.device).double()).abs() < tol
        held |= on
    assert not bool((off & ~held).any()), ift


@pytest.mark.parametrize("which", BATCHES)
@pytest.mark.parametrize("kd", [(10, 4), (7, 3)])
@pytest.mark.parametrize("skew,fit", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_raw_bcast_fwd_kernels_match_plain(dev, skew, fit, kd, which):
    """Both directions against layer_plain on every iCDF type; two
    launches bit-equal; the density pass at T5's roots gives T5's ld bit
    for bit (the two share their evaluation's code)."""
    seed = 300 + 10 * skew + 5 * fit + kd[0]
    x, params, prep = _case(skew, fit, kd, which, dev, seed)
    for ift in IFTS:
        for mode in ("forward", "sample"):
            before = gl.LAUNCHES[f"{mode}_raw"]
            got = gl._run(mode, "raw", x, params, ift, prep, None)
            again = gl._run(mode, "raw", x, params, ift, prep, None)
            assert gl.LAUNCHES[f"{mode}_raw"] == before + 2 * (len(x) > 0)
            ref = gl.layer_plain(mode, "raw", x, params, ift, prep)
            torch.cuda.synchronize()
            tol = TOL["density" if mode == "forward" else "sample"]
            for a, b, r in zip(got, again, ref):
                assert a.shape == r.shape and torch.isfinite(a).all()
                assert torch.equal(a, b), (mode, ift)
            if len(x):
                _hold(mode, got, ref, x, params, ift, prep, tol)
            if mode == "sample" and len(x):
                _, ld = gl._run("forward", "raw", got[0], params, ift, prep,
                                None)
                assert torch.equal(ld, got[1]), ift


@pytest.mark.parametrize("skew", [0, 1])
def test_raw_bcast_grid_walks_tiles(dev, skew):
    """The grid: the occupancy API's blocks per SM x SMs, at most one block
    per 128-row tile."""
    params, prep, _ = _layer_case("raw", False, skew, 10, 4, 1, dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for mode in ("forward", "sample"):
        per_sm = gl.kernel_occupancy(f"{mode}_raw", 10, 4, 0, len(params),
                                     skew=bool(skew))[0]
        assert per_sm >= 1
        assert gl.bcast_grid(mode, 1 << 30, params, prep) == \
            (per_sm * n_sm, 128)
        assert gl.bcast_grid(mode, 300, params, prep) == (3, 128)


@pytest.mark.parametrize("skew", [0, 1])
@pytest.mark.parametrize("where", ["x", "slab"])
def test_raw_bcast_fwd_kernels_keep_nan_as_plain(dev, skew, where):
    """A NaN made on the card (0/0) in a row of x, or in one component of
    one dimension's slab, reaches the outputs of both directions exactly
    where it reaches the plain versions' (the plain mixture's isigmoid
    solve keeps a NaN slab's NaN in its bracket, as torch.amin / clamp do);
    the rows it does not reach keep the clean run's bits."""
    x, params, prep = _case(skew, 1, (10, 4), "1000", dev, seed=77)
    zero = torch.zeros((), device=dev)
    xn, pn = x.clone(), [t.clone() for t in params]
    if where == "x":
        xn[5, 1] = zero / zero
    else:
        pn[1][3, 2] = zero / zero
    for ift in ("isigmoid", "inormal_partly_precise"):
        for mode in ("forward", "sample"):
            got = gl._run(mode, "raw", xn, tuple(pn), ift, prep, None)
            clean = gl._run(mode, "raw", x, params, ift, prep, None)
            ref = gl.layer_plain(mode, "raw", xn, tuple(pn), ift, prep)
            torch.cuda.synchronize()
            # the density pass always carries it; a bracketed solve at a
            # NaN target may end on a finite bisection point, as plain
            if mode == "forward":
                assert any(bool(torch.isnan(a).any()) for a in got)
            for a, r in zip(got, ref):
                assert torch.equal(torch.isnan(a), torch.isnan(r)), \
                    (mode, ift)
            rows = ~torch.stack([torch.isnan(r).any(dim=1)
                                 for r in ref]).any(dim=0)
            rows[5] = rows[5] and where != "x"    # the NaN input's row
            for a, c in zip(got, clean):
                assert torch.equal(a[rows], c[rows])
