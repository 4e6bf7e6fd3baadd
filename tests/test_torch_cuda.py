"""The CUDA kernels on the card, held against their plain PyTorch versions:
the block forward (csrc/gf_block.cu), its backward and the fused NLL
(csrc/gf_block_bwd.cu) in every parameter mode, gradients through every
entry point, the per-layer kernels (csrc/gf_layer*.cu), every backward
kernel at the widest hidden layer the routing sends to it (H = 1024), and
the chain-rate probe (csrc/chain_peak.cu).

Every test here needs a CUDA device and skips without one.  The file imports
no JAX, so on a machine with the card it runs without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from jammy_flows_tpu_torch import pdf
from jammy_flows_tpu_torch.ops import gf_block as gb

pytestmark = pytest.mark.cuda

FLAGSHIP = ("e4+s2+e4", "gggg+f+gggg")
# kernel vs plain version: the JAX package's kernel-vs-XLA limits,
# density values 3e-4, the sample direction's Newton solve 3e-3
TOL = {"density": 3e-4, "sample": 3e-3}
# backward and fused NLL vs plain version, relative norm per gradient: the
# JAX package's kernel-vs-XLA gradient limits (tests/test_tpu_kernels.py)
TOL_GRAD = {"density": 1e-4, "nll": 1e-4, "sample": 3e-4}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _block_args(p, k, n, seed, dev):
    """Inputs of sub-manifold k's block: (mode, x, params), all from
    ``seed`` (numpy for x, a torch generator of its own for the rest:
    never the global one, whose state the tests before would set)."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    par = p.init_params(seed=0)
    d = p._block_meta[k][1][1]
    x = torch.as_tensor(0.8 * rng.normal(size=(n, d)), dtype=torch.float32,
                        device=dev)
    mlp = p.mlp_predictors[k]
    if mlp is None:
        pvec = par["flow_0"] + 0.1 * torch.randn(par["flow_0"].shape,
                                                 generator=g, device=dev)
        return "perm", x, (pvec,)
    flat = par[f"mlp_{k}"]
    w1, b1 = mlp.first_layer_weights(flat)
    w, b = mlp.final_layer_weights(flat)
    w = (w + 0.02 * torch.randn(w.shape, generator=g, device=dev))
    summary = torch.randn((n, mlp.input_dim), generator=g, device=dev)
    return "lazy2", x, (summary, w1.contiguous(), b1.contiguous(),
                        w.contiguous(), b.contiguous())


def _check_block(p, k, dev, direction, n=4096, seed=0):
    prep, meta = p._block_meta[k]
    mode, x, params = _block_args(p, k, n, seed, dev)
    name = f"{direction}_{mode}"
    before = gb.LAUNCHES[name]
    out, ld = getattr(gb, f"gf_block_{name}")(x, *params, prep, meta)
    assert gb.LAUNCHES[name] == before + 1
    ref_out, ref_ld = gb.block_plain(direction, x, params, prep, meta, mode)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(ld).all()
    assert float((out - ref_out).abs().max()) < TOL[direction]
    assert float((ld - ref_ld).abs().max()) < TOL[direction]


@pytest.mark.parametrize("k", [0, 2])
@pytest.mark.parametrize("direction", ["density", "sample"])
def test_flagship_kernel_matches_plain(dev, direction, k):
    """k=0: perm (flow_0); k=2: lazy2 with the 7-wide summary."""
    _check_block(pdf(*FLAGSHIP, device=dev), k, dev, direction)


@pytest.mark.parametrize("direction", ["density", "sample"])
def test_generic_shape_kernel_matches_plain(dev, direction):
    """Shapes off the flagship's compile-time instantiation (K=7, d=3,
    no fit_normalization, two iCDF types) take the generic kernel."""
    g = {"num_kde": 7, "fit_normalization": 0,
         "inverse_function_type": "inormal_full_pade"}
    opts = {"g": g, (0, 1): {"g": dict(g, inverse_function_type=
                                       "inormal_partly_crude")}}
    p = pdf("e3", "ggg", options_overwrite=opts, conditional_input_dim=2,
            device=dev)
    _check_block(p, 0, dev, direction, n=1000)


@pytest.mark.parametrize("direction", ["density", "sample"])
def test_wide_summary_kernel_matches_plain(dev, direction):
    """A 200-wide conditional input: the kernel reads the summary row by
    row from global memory, so its width is not limited."""
    p = pdf("e4", "gggg", conditional_input_dim=200, device=dev)
    _check_block(p, 0, dev, direction, n=1000)


def test_kernel_rejects_what_it_does_not_take(dev):
    p = pdf(*FLAGSHIP, device=dev)
    prep, meta = p._block_meta[0]
    pvec = p.init_params(seed=0)["flow_0"]
    x = torch.zeros((8, 4), device=dev)
    with pytest.raises(TypeError):
        gb.gf_block_density_perm(x.double(), pvec, prep, meta)
    with pytest.raises(TypeError):
        gb.gf_block_nll_perm(x.double(), pvec, prep, meta, 1.0, -1.0)
    with pytest.raises(ValueError):
        gb.gf_block_density_perm(x, pvec.cpu(), prep, meta)
    # more mixture components than the kernel's register arrays hold: the
    # wrapper raises, it does not fall back to the plain version
    wide = pdf("e2", "g", options_overwrite={"g": {"num_kde": 65}},
               device=dev)
    prep_w, meta_w = wide._block_meta[0]
    with pytest.raises(ValueError):
        gb.gf_block_density_perm(torch.zeros((8, 2), device=dev),
                                 wide.init_params(seed=0)["flow_0"], prep_w,
                                 meta_w)


def test_card_log_prob_matches_cpu_f64(dev):
    p_gpu = pdf(*FLAGSHIP, device=dev)
    par = p_gpu.init_params(seed=0)
    x = p_gpu.sample(par, samplesize=4096,
                     generator=torch.Generator(device=dev).manual_seed(0))[0]
    gb.reset_launch_counts()
    lp = p_gpu.log_prob(par, x)[0]
    assert gb.LAUNCHES["density_perm"] == 1
    assert gb.LAUNCHES["density_lazy2"] == 1
    p_cpu = pdf(*FLAGSHIP, device="cpu")
    par64 = {k: v.double().cpu() for k, v in par.items()}
    lp64 = p_cpu.log_prob(par64, x.double().cpu())[0]
    assert float((lp.double().cpu() - lp64).abs().max()) < 1e-3


def _rel(a, b):
    return float((a.double() - b.double()).norm()
                 / max(float(b.double().norm()), 1e-30))


def _check_bwd(p, k, dev, n, seed=0):
    """T2 (both directions) and T3 of sub-manifold k's block against
    block_bwd_plain / block_nll_plain on the same inputs; T3's val / ld
    equal the forward kernel's, and a second T3 call gives the same
    gradients, bit for bit."""
    prep, meta = p._block_meta[k]
    mode, x, params = _block_args(p, k, n, seed, dev)
    _check_bwd_mode(x, params, prep, meta, mode, dev, ("density", "sample"),
                    seed=seed + 1)
    wv, wl = 1.0 / n, -1.0 / n
    before = gb.LAUNCHES[f"nll_{mode}"]
    val, ld, gx, gp = getattr(gb, f"gf_block_nll_{mode}")(
        x, *params, prep, meta, wv, wl)
    assert gb.LAUNCHES[f"nll_{mode}"] == before + 1
    out, ld1 = getattr(gb, f"gf_block_density_{mode}")(x, *params, prep, meta)
    again = getattr(gb, f"gf_block_nll_{mode}")(x, *params, prep, meta, wv, wl)
    ref = gb.block_nll_plain(x, params, prep, meta, mode, wv, wl)
    torch.cuda.synchronize()
    assert torch.equal(val, out) and torch.equal(ld, ld1)
    for got, same in zip((gx, *gp), (again[2], *again[3])):
        assert torch.equal(got, same)
    for got, r in zip((gx, *gp), (ref[2], *ref[3])):
        assert _rel(got, r) < TOL_GRAD["nll"]


@pytest.mark.parametrize("k", [0, 2])
def test_flagship_bwd_kernels_match_plain(dev, k):
    """k=0: perm; k=2: lazy2 with the 7-wide summary; a ragged batch."""
    _check_bwd(pdf(*FLAGSHIP, device=dev), k, dev, n=4099)


def test_generic_shape_bwd_kernels_match_plain(dev):
    g = {"num_kde": 7, "fit_normalization": 0,
         "inverse_function_type": "inormal_full_pade"}
    opts = {"g": g, (0, 1): {"g": dict(g, inverse_function_type=
                                       "inormal_partly_crude")}}
    p = pdf("e3", "ggg", options_overwrite=opts, conditional_input_dim=2,
            device=dev)
    _check_bwd(p, 0, dev, n=1000)


def test_wide_summary_bwd_kernels_match_plain(dev):
    """A 200-wide summary: gsummary and gw1 come from the kernel's
    hidden-layer pass, which reads the summary from global memory."""
    _check_bwd(pdf("e4", "gggg", conditional_input_dim=200, device=dev), 0,
               dev, n=1000)


@pytest.mark.parametrize("hid,n_in,n", [(12, 3, 1000), (16, 10, 1000),
                                        (128, 3, 4099), (128, 7, 4099),
                                        (128, 10, 4099), (1024, 3, 1000)])
def test_lazy2_tile_kernels_match_plain(dev, hid, n_in, n):
    """The lazy2 kernels, whose parameter rows are 3xTF32 tensor-core tile
    products (T1 both directions, T2 both bodies, T3), against their plain
    versions: hidden widths that are not multiples of 8 (12), 16, the
    flagship's 128 and the widest the routing sends (1024); summaries 3, 7
    and 10 wide; batches that are not a multiple of the tile.  T3's val /
    ld equal T1's and two T3 calls give equal gradients, bit for bit."""
    p = pdf("e4", "gggg", conditional_input_dim=n_in,
            amortization_mlp_dims=str(hid), device=dev)
    assert p.mlp_predictors[0].first_layer_weights(
        p.init_params(seed=0)["mlp_0"])[0].shape == (hid, n_in)
    for direction in ("density", "sample"):
        _check_block(p, 0, dev, direction, n=n)
    _check_bwd(p, 0, dev, n)


def test_lazy2_tiles_hold_two_blocks_per_sm(dev):
    """At the flagship's H = 128 the lazy2 kernels' tile (128 rows, 4
    warps, ~111 KB of shared memory) leaves room for a second block: 8
    warps per SM, T1 and T2 / T3 alike."""
    p = pdf(*FLAGSHIP, device=dev)
    prep, meta = p._block_meta[2]
    for name in ("density_lazy2", "sample_lazy2", "density_bwd_lazy2",
                 "sample_bwd_lazy2", "nll_lazy2"):
        blocks, threads, _ = gb.kernel_occupancy(name, prep, meta, 128)
        assert threads == 128 and blocks >= 2, (name, blocks, threads)


def test_gradients_through_every_entry_point(dev):
    """autograd of log_prob and of sample on the card launches the backward
    kernels of both blocks and agrees with the port's CPU path."""
    p = pdf(*FLAGSHIP, device=dev)
    par = {k: v + 0.02 * torch.randn(v.shape, device=dev)
           for k, v in p.init_params(seed=0).items()}
    x = p.sample(par, samplesize=2048,
                 generator=torch.Generator(device=dev).manual_seed(0))[0]
    z = torch.randn((2048, 10), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    p_cpu = pdf(*FLAGSHIP, device="cpu")
    par_cpu = {k: v.cpu() for k, v in par.items()}

    def nll(pp, pd, xx):
        return -pd.log_prob(pp, xx)[0].mean()

    def samp(pp, pd, zz):
        s, ld = pd.all_layer_forward(pp, zz, torch.zeros(zz.shape[0],
                                                         device=zz.device))
        return (s**2).mean() - 0.1 * ld.mean()

    for fn, arg, names in ((nll, x, ("density_bwd_perm", "density_bwd_lazy2")),
                           (samp, z, ("sample_bwd_perm", "sample_bwd_lazy2"))):
        gb.reset_launch_counts()
        _, g_card = p._value_and_grad(lambda pp: fn(pp, p, arg), par)
        torch.cuda.synchronize()
        for name in names:
            assert gb.LAUNCHES[name] == 1, (name, dict(gb.LAUNCHES))
        _, g_cpu = p_cpu._value_and_grad(
            lambda pp: fn(pp, p_cpu, arg.cpu()), par_cpu)
        for key in g_card:
            assert torch.isfinite(g_card[key]).all()
            assert _rel(g_card[key].cpu(), g_cpu[key]) < 3e-3, key


def test_fused_nll_matches_autograd_on_card(dev):
    """nll_value_and_grad (T3 per block) against autograd of
    -log_prob().mean() (T1 + T2) on the card."""
    p = pdf(*FLAGSHIP, conditional_input_dim=3, device=dev)
    par = {k: v + 0.02 * torch.randn(v.shape, device=dev)
           for k, v in p.init_params(seed=0).items()}
    ci = torch.randn((4096, 3), device=dev)
    x = p.sample(par, conditional_input=ci,
                 generator=torch.Generator(device=dev).manual_seed(0))[0]
    gb.reset_launch_counts()
    l1, g1 = p.nll_value_and_grad(par, x, ci)
    assert gb.LAUNCHES["nll_lazy2"] == 2
    assert gb.LAUNCHES["density_lazy2"] == 0
    l2, g2 = p._value_and_grad(
        lambda pp: -p.log_prob(pp, x, ci)[0].mean(), par)
    assert abs(float(l1) - float(l2)) < 1e-4
    for key in g1:
        assert _rel(g1[key], g2[key]) < 1e-4, key


def _nan_inputs(p, what, n, dev):
    """The flagship's lazy2 block (block 2) with one NaN, made on the card
    as 0/0 (CUDA's canonical NaN, 0x7fffffff): in row 5 of the summary, or
    in one entry of the final weight w.  Returns (prep, meta, x, clean
    params, params with the NaN)."""
    prep, meta = p._block_meta[2]
    _, x, params = _block_args(p, 2, n, 0, dev)
    summary, w1, b1, w, b = params
    zero = torch.zeros((), device=dev)
    nan = zero / zero
    if what == "summary":
        summary = summary.clone()
        summary[5, 1] = nan
    else:
        w = w.clone()
        w[9, 7] = nan
    return prep, meta, x, params, (summary, w1, b1, w, b)


def _same_nans(got, ref):
    assert torch.equal(torch.isnan(got), torch.isnan(ref))


@pytest.mark.parametrize("what", ["summary", "w"])
def test_lazy2_kernels_keep_nan_as_plain(dev, what):
    """A NaN in the summary or in w reaches T1 lazy2's and T3 lazy2's
    outputs exactly where it reaches the plain versions' (the 3xTF32 split
    and the mixture's max / min keep it); the rows it does not reach are
    the kernels' results without the NaN, bit for bit."""
    p = pdf(*FLAGSHIP, device=dev)
    n = 1000
    prep, meta, x, clean, params = _nan_inputs(p, what, n, dev)
    for direction in ("density", "sample"):
        fn = getattr(gb, f"gf_block_{direction}_lazy2")
        got, want = fn(x, *params, prep, meta), fn(x, *clean, prep, meta)
        ref = gb.block_plain(direction, x, params, prep, meta, "lazy2")
        torch.cuda.synchronize()
        bad = torch.isnan(ref[0]).any(dim=1)
        assert bad[5]
        for a, r, c in zip(got, ref, want):
            _same_nans(a, r)
            assert torch.equal(a[~bad], c[~bad])
    wv, wl = 1.0 / n, -1.0 / n
    val, ld, gx, gp = gb.gf_block_nll_lazy2(x, *params, prep, meta, wv, wl)
    c_val, c_ld, c_gx, c_gp = gb.gf_block_nll_lazy2(x, *clean, prep, meta,
                                                    wv, wl)
    ref = gb.block_nll_plain(x, params, prep, meta, "lazy2", wv, wl)
    torch.cuda.synchronize()
    bad = torch.isnan(ref[0]).any(dim=1)
    for a, r, c in zip((val, ld, gx, gp[0]), (ref[0], ref[1], ref[2],
                                              ref[3][0]),
                       (c_val, c_ld, c_gx, c_gp[0])):
        _same_nans(a, r)
        assert torch.equal(a[~bad], c[~bad])
    for a, r in zip(gp[1:], ref[3][1:]):
        _same_nans(a, r)


def _perm_repeats(p, k, dev, n):
    """T2 (both bodies) and T3 in perm mode, each launched twice on the
    same inputs: the same bits."""
    prep, meta = p._block_meta[k]
    mode, x, params = _block_args(p, k, n, 3, dev)
    assert mode == "perm"
    g = torch.Generator(device=dev).manual_seed(4)
    g_out = torch.randn(x.shape, generator=g, device=dev)
    g_ld = torch.randn(x.shape, generator=g, device=dev)
    y = gb._launch(x, params, prep, meta, mode, "sample")[0]
    for kind, res in (("density", x), ("sample", y), ("nll", x)):
        a, b = (gb._launch_bwd(kind, res, params, g_out, g_ld, prep, meta,
                               mode, 1.0 / n, -1.0 / n) for _ in range(2))
        torch.cuda.synchronize()
        for u, v in zip((*a[:3], *a[3]), (*b[:3], *b[3])):
            assert (u is None and v is None) or torch.equal(u, v), kind


@pytest.mark.parametrize("n", [1, 31, 129, 262_145])
def test_perm_bwd_kernels_match_plain_and_repeat(dev, n):
    """The perm backward (T2 both bodies, T3) at batches of one row, less
    than a warp, one row past a tile and one row past the training batch:
    against the plain versions, and bit-equal across two launches."""
    p = pdf(*FLAGSHIP, device=dev)
    _check_bwd(p, 0, dev, n)
    _perm_repeats(p, 0, dev, n)


def test_generic_shape_perm_bwd_kernels(dev):
    """The generic instantiation (K = 7, d = 3: not the flagship's K = 10,
    d = 4) in perm mode: against the plain versions, and bit-equal across
    two launches."""
    g = {"num_kde": 7, "fit_normalization": 0,
         "inverse_function_type": "inormal_full_pade"}
    opts = {"g": g, (0, 1): {"g": dict(g, inverse_function_type=
                                       "inormal_partly_crude")}}
    p = pdf("e3", "ggg", options_overwrite=opts, device=dev)
    _check_bwd(p, 0, dev, n=1000)
    _perm_repeats(p, 0, dev, 1000)


def _perm_model(shape, dev):
    """The flagship (its block 0 is perm mode) or the generic K = 7, d = 3
    shape in perm mode."""
    if shape == "flagship":
        return pdf(*FLAGSHIP, device=dev)
    g = {"num_kde": 7, "fit_normalization": 0,
         "inverse_function_type": "inormal_full_pade"}
    opts = {"g": g, (0, 1): {"g": dict(g, inverse_function_type=
                                       "inormal_partly_crude")}}
    return pdf("e3", "ggg", options_overwrite=opts, device=dev)


# batches at the edges of the T1 perm kernel's tile loop: one row, one row
# short of and past a 128-row block, and one row short of and past a full
# wave (every persistent block one tile)
PERM_FWD_BATCHES = ("1", "127", "129", "wave-1", "wave+1")


def _perm_fwd_rows(which, direction, prep, meta):
    if which[0].isdigit():
        return int(which)
    blocks, rows = gb.perm_grid(direction, 1 << 30, prep, meta)
    return blocks * rows + (1 if which.endswith("+1") else -1)


@pytest.mark.parametrize("which", PERM_FWD_BATCHES)
@pytest.mark.parametrize("direction", ["density", "sample"])
@pytest.mark.parametrize("shape", ["flagship", "generic"])
def test_perm_fwd_kernels_at_tile_edges(dev, shape, direction, which):
    """T1 perm (persistent blocks walking tiles of rows) at ragged batches
    that cross its tile loop: against the plain version, bit-equal across
    two launches, and, density, T3's val / ld equal to T1's bit for bit."""
    p = _perm_model(shape, dev)
    prep, meta = p._block_meta[0]
    n = _perm_fwd_rows(which, direction, prep, meta)
    mode, x, params = _block_args(p, 0, n, 5, dev)
    out, ld = gb._launch(x, params, prep, meta, mode, direction)
    out2, ld2 = gb._launch(x, params, prep, meta, mode, direction)
    ref_out, ref_ld = gb.block_plain(direction, x, params, prep, meta, mode)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(ld).all()
    assert float((out - ref_out).abs().max()) < TOL[direction]
    assert float((ld - ref_ld).abs().max()) < TOL[direction]
    assert torch.equal(out, out2) and torch.equal(ld, ld2)
    if direction == "density":
        val, ld3, _, _ = gb._launch_bwd("nll", x, params, None, None, prep,
                                        meta, mode, 1.0 / n, -1.0 / n)
        assert torch.equal(val, out) and torch.equal(ld3, ld)


def test_test_inputs_come_from_their_seed_alone(dev):
    """The inputs of the kernel-vs-plain tests (_block_args, _lazy_args)
    are the same whatever torch's global generator drew before.  They once
    took their random parameters from it, so that the tests before one in
    the same process chose its parameters: test_perm_fwd_kernels_at_tile_
    edges then failed now and then, on draws that put one of its 168,961
    rows on the layer-0 iCDF's float32 seam (cdf = 0.5e-7, where the erfinv
    polynomial gives way to the Pade approximation with a jump of ~3e-3),
    so that the kernel and its plain version, a float32 rounding apart,
    took different sides of it."""
    p = pdf(*FLAGSHIP, device=dev)
    p_lazy = pdf(*FLAGSHIP, amortization_mlp_dims="64-64", device=dev)
    for make in (lambda: _block_args(p, 0, 129, 5, dev)[1:],
                 lambda: _block_args(p, 2, 129, 5, dev)[1:],
                 lambda: _lazy_args(p_lazy, 2, 129, 5, dev)):
        first = make()
        torch.randn(1000, device=dev)
        again = make()
        for a, b in zip((first[0], *first[1]), (again[0], *again[1])):
            assert torch.equal(a, b)


def test_perm_density_fallback_lanes_t3_equals_t1(dev):
    """Rows far in the tails (every component beyond 55 widths) take the
    density's fallback lanes, where T1 perm reads lnw + log(iw) prepared
    once per block and T3 adds its own log(iw): the same bits."""
    p = pdf(*FLAGSHIP, device=dev)
    prep, meta = p._block_meta[0]
    mode, x, params = _block_args(p, 0, 4096, 6, dev)
    x[::3] *= 300.0
    out, ld = gb._launch(x, params, prep, meta, mode, "density")
    val, ld3, _, _ = gb._launch_bwd("nll", x, params, None, None, prep, meta,
                                    mode, 1.0, -1.0)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(ld).all()
    assert torch.equal(val, out) and torch.equal(ld3, ld)


def test_perm_reciprocal_is_the_ieee_one(dev):
    """The T1 perm kernels' reciprocal of 1 + e (rcp.approx and one Newton
    step, recip_ge1) gives the IEEE reciprocal's bits for every float32 in
    [1, 2^88): 1 + e lies in [1, 1 + e^60]."""
    assert gb.recip_mismatches(dev) == 0


# ---------------------------------------------------------------------------
# the per-layer kernels (csrc/gf_layer.cu T4-T6, csrc/gf_layer_bwd.cu T7)
# ---------------------------------------------------------------------------

from jammy_flows_tpu_torch.ops import gf_layer as gl  # noqa: E402
from jammy_flows_tpu_torch.ops.special import (  # noqa: E402
    log_bounded_exp_fn, width_regulator_fn)

IFTS = ("isigmoid", "inormal_partly_precise", "inormal_partly_crude",
        "inormal_full_pade")


def _layer_case(iface, per_row, skew, k, d, n, dev, seed=0, fit=1, hid=24):
    """(params, prep, kd) of one per-layer call with parameters drawn from a
    seed: prepared (means, inverse widths, log weights), raw slabs or lazy
    (hidden, wcat, bcat; w scaled so that a row's parameters keep their
    spread at any hidden width)."""
    rng = np.random.default_rng(seed)
    signs = tuple([1.0] * (k // 2) + [-1.0] * (k - k // 2))
    prep = (width_regulator_fn(0, 1, 0.01, 100, 0), None, bool(fit),
            log_bounded_exp_fn(0.1, 9.0, center=True) if skew else None,
            signs if skew else None)
    shp = (k, d, n) if per_row else (k, d)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    if iface == "prepared":
        ln = rng.normal(size=shp)
        return (t(rng.normal(size=shp)), t(1.0 / (0.3 + rng.uniform(size=shp))),
                t(ln - np.log(np.exp(ln).sum(0, keepdims=True)))), prep, None
    groups = [rng.normal(size=shp), -1.0 + 0.5 * rng.normal(size=shp)] + \
        [rng.normal(size=shp)] * fit + [0.8 * rng.normal(size=shp)] * skew
    if iface == "raw":
        return tuple(t(g) for g in groups), prep, None
    w = 0.2 * np.sqrt(24 / hid) * rng.normal(size=(len(groups) * k * d, hid))
    b = np.concatenate([g.reshape(-1) for g in groups])
    return (t(np.tanh(rng.normal(size=(n, hid)))), t(w), t(b)), prep, (k, d)


LAYER_CASES = [("prepared", False, 0), ("prepared", True, 0),
               ("raw", False, 0), ("raw", True, 0), ("raw", False, 1),
               ("raw", True, 1), ("lazy", False, 0), ("lazy", False, 1)]


@pytest.mark.parametrize("kd", [(10, 4), (7, 3)])
@pytest.mark.parametrize("iface,per_row,skew", LAYER_CASES)
def test_layer_kernels_match_plain(dev, iface, per_row, skew, kd):
    """T4-T6 against the plain versions: every interface, broadcast and per
    row, skewed and not, all four iCDF types, a ragged batch (K=10 takes the
    compile-time instantiation, K=7 the generic one)."""
    k, d = kd
    n = 1000
    params, prep, lkd = _layer_case(iface, per_row, skew, k, d, n, dev)
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(n, d)),
                        dtype=torch.float32, device=dev)
    modes = {"prepared": ("forward", "inverse"), "lazy": ("forward", "sample"),
             "raw": ("forward", "sample", "inverse")}[iface]
    for ift in IFTS:
        for mode in modes:
            before = gl.LAUNCHES[f"{mode}_{iface}"]
            got = gl._run(mode, iface, x, params, ift, prep, lkd)
            assert gl.LAUNCHES[f"{mode}_{iface}"] == before + 1
            ref = gl.layer_plain(mode, iface, x, params, ift, prep, lkd)
            torch.cuda.synchronize()
            tol = TOL["density" if mode == "forward" else "sample"]
            for a, b in zip(got if isinstance(got, tuple) else (got,),
                            ref if isinstance(ref, tuple) else (ref,)):
                assert torch.isfinite(a).all()
                assert float((a - b).abs().max()) < tol, (mode, ift)


@pytest.mark.parametrize("kd", [(10, 4), (7, 3)])
@pytest.mark.parametrize("iface,per_row,skew", [c for c in LAYER_CASES
                                                if c[0] != "prepared"])
def test_layer_bwd_kernels_match_plain(dev, iface, per_row, skew, kd):
    """T7, both bodies, against layer_bwd_plain: relative norm of every
    gradient (x or the target, the slabs or hidden / w / b)."""
    k, d = kd
    n = 1000
    params, prep, lkd = _layer_case(iface, per_row, skew, k, d, n, dev)
    rng = np.random.default_rng(2)
    x, g1, g2 = (torch.as_tensor(rng.normal(size=(n, d)), dtype=torch.float32,
                                 device=dev) for _ in range(3))
    for ift in IFTS:
        for body in ("forward", "sample"):
            res = x if body == "forward" else gl._run(
                "sample", iface, x, params, ift, prep, lkd)[0]
            name = f"{body}_bwd_{iface}"
            before = gl.LAUNCHES[name]
            gx, gp = gl._launch_bwd(body, iface, res, params, g1, g2, ift,
                                    prep, lkd)
            assert gl.LAUNCHES[name] == before + 1
            rgx, rgp = gl.layer_bwd_plain(body, iface, res, params, g1, g2,
                                          ift, prep, lkd)
            torch.cuda.synchronize()
            for got, ref in zip((gx, *gp), (rgx, *rgp)):
                assert got.shape == ref.shape and torch.isfinite(got).all()
                tol = TOL_GRAD["density" if body == "forward" else "sample"]
                assert _rel(got, ref) < tol, (name, ift, _rel(got, ref))


def _raw_bwd_blocks(body, params, prep, n, dev):
    """The grid T7 takes with raw broadcast slabs for n rows (the occupancy
    API's blocks per SM times the SMs, at most one block per tile)."""
    from jammy_flows_tpu_torch.ops import cuda_build
    lib = cuda_build.load("gf_layer_bwd", gl._declare_bwd)
    one = torch.zeros((1, params[0].shape[1]), device=dev)
    ints, floats, _, n_groups, _, k = gl._kernel_args("raw", one, params,
                                                      "isigmoid", prep, None)
    c_ints, _ = gl._c_arrays([int(body == "sample")] + ints, floats)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return lib.gf_layer_bwd_blocks(0, n, 0, n_sm, n_groups * k, c_ints)


@pytest.mark.parametrize("kd", [(10, 4), (7, 3)])
@pytest.mark.parametrize("skew", [0, 1])
@pytest.mark.parametrize("fit", [0, 1])
def test_layer_raw_bcast_bwd_matches_plain_and_repeats(dev, kd, skew, fit):
    """T7 with raw broadcast slabs (warp sums into warp-private partials,
    the block's regulator derivatives), both bodies, against
    layer_bwd_plain at the unchanged limits, on a batch of more tiles than
    twice the grid's blocks (every block walks several; the last warp
    ragged); two launches bit-equal.  K = 10 takes the compile-time
    instantiation (20-40 values a piece: two warp passes when skewed with
    fit_norm), K = 7, D = 3 the generic one."""
    k, d = kd
    seed = 200 + 20 * skew + 10 * fit + k
    params, prep, _ = _layer_case("raw", False, skew, k, d, 1, dev,
                                  seed=seed, fit=fit)
    per_sm = {body: gl.kernel_occupancy(f"{body}_bwd_raw", k, d, 0,
                                        len(params), skew=bool(skew))[0]
              for body in ("forward", "sample")}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n = (2 * max(per_sm.values()) * n_sm + 1) * 128 + 77
    rng = np.random.default_rng(seed + 1)
    x, g1, g2 = (torch.as_tensor(rng.normal(size=(n, d)), dtype=torch.float32,
                                 device=dev) for _ in range(3))
    ift = ("isigmoid", "inormal_partly_precise")[(skew + fit) % 2]
    for body in ("forward", "sample"):
        assert _raw_bwd_blocks(body, params, prep, n, dev) == \
            per_sm[body] * n_sm
        res = x if body == "forward" else gl._run(
            "sample", "raw", x, params, ift, prep, None)[0]
        a, b = (gl._launch_bwd(body, "raw", res, params, g1, g2, ift, prep,
                               None) for _ in range(2))
        rgx, rgp = gl.layer_bwd_plain(body, "raw", res, params, g1, g2, ift,
                                      prep)
        torch.cuda.synchronize()
        for u, v in zip((a[0], *a[1]), (b[0], *b[1])):
            assert torch.equal(u, v), body
        for got, ref in zip((a[0], *a[1]), (rgx, *rgp)):
            assert got.shape == ref.shape and torch.isfinite(got).all()
            tol = TOL_GRAD["density" if body == "forward" else "sample"]
            assert _rel(got, ref) < tol, (body, _rel(got, ref))


def test_gradients_through_layer_entry_points(dev):
    """autograd through gf_forward_raw / gf_sample_raw / gf_forward_lazy /
    gf_sample_lazy (T7) and gf_forward_pallas (the plain VJP) on the card
    agrees with the same calls on the CPU."""
    n, k, d = 512, 10, 4
    x = torch.randn((n, d), generator=torch.Generator().manual_seed(0))
    for iface, per_row, skew in (("raw", False, 1), ("raw", True, 0),
                                 ("lazy", False, 1), ("prepared", True, 0)):
        params, prep, lkd = _layer_case(iface, per_row, skew, k, d, n, "cpu")
        grads = []
        for device in (dev, torch.device("cpu")):
            ps = [p.to(device).requires_grad_() for p in params]
            xx = x.to(device).requires_grad_()
            if iface == "prepared":
                outs = [gl.gf_forward_pallas(xx, ps[0], -torch.log(ps[1]),
                                             ps[2], "isigmoid")]
            elif iface == "raw":
                outs = [gl.gf_forward_raw(xx, ps, "isigmoid", prep),
                        gl.gf_sample_raw(xx, ps, "isigmoid", prep)]
            else:
                ws = [ps[1][i * k * d:(i + 1) * k * d] for i in range(4)]
                bs = [ps[2][i * k * d:(i + 1) * k * d] for i in range(4)]
                outs = [gl.gf_forward_lazy(xx, ps[0], ws, bs, "isigmoid",
                                           prep, lkd),
                        gl.gf_sample_lazy(xx, ps[0], ws, bs, "isigmoid",
                                          prep, lkd)]
            loss = sum((o[0]**2).mean() + o[1].mean() for o in outs)
            grads.append(torch.autograd.grad(loss, [xx, *ps]))
        for a, b in zip(*grads):
            assert torch.isfinite(a).all()
            assert _rel(a.cpu(), b) < 1e-3, iface


def test_layer_wrapper_refuses(dev):
    params, prep, _ = _layer_case("raw", False, 1, 10, 4, 8, dev)
    x = torch.zeros((8, 4), device=dev)
    with pytest.raises(TypeError):
        gl.gf_forward_raw(x.double(), params, "isigmoid", prep)
    with pytest.raises(ValueError):
        gl.gf_forward_raw(x, (params[0].cpu(),) + params[1:], "isigmoid",
                          prep)
    with pytest.raises(ValueError):
        gl.gf_forward_raw(x[:, :3], params, "isigmoid", prep)
    with pytest.raises(ValueError):
        gl._run("forward", "raw", x, (params[0].t(),) + params[1:],
                "isigmoid", prep, None)
    # more components than the kernel's register arrays hold: it raises, it
    # does not fall back to the plain version
    wide, prep_w, _ = _layer_case("raw", False, 0, 65, 4, 8, dev)
    with pytest.raises(ValueError):
        gl.gf_forward_raw(x, wide, "isigmoid", prep_w)


@pytest.mark.parametrize("opts", [{"g": {"add_skewness": 1}},
                                  {"g": {"center_mean": 1}}])
def test_per_layer_flagship_on_card(dev, opts):
    """The skewed / mean-centred flagship runs layer by layer on the card
    (no block kernel) and its log_prob agrees with the port's f64 CPU
    path."""
    p = pdf(*FLAGSHIP, options_overwrite=opts, device=dev)
    assert p._block_meta[0] is None and p._block_meta[2] is None
    par = p.init_params(seed=0)
    x = p.sample(par, samplesize=4096,
                 generator=torch.Generator(device=dev).manual_seed(0))[0]
    gb.reset_launch_counts()
    gl.reset_launch_counts()
    lp = p.log_prob(par, x)[0]
    torch.cuda.synchronize()
    assert not any(gb.LAUNCHES.values())
    fwd = ("forward_raw", "forward_lazy") if "add_skewness" in opts["g"] \
        else ("forward_prepared",)
    assert sum(gl.LAUNCHES[k] for k in fwd) == 8, dict(gl.LAUNCHES)
    p_cpu = pdf(*FLAGSHIP, options_overwrite=opts, device="cpu")
    par64 = {k: v.double().cpu() for k, v in par.items()}
    lp64 = p_cpu.log_prob(par64, x.double().cpu())[0]
    assert float((lp.double().cpu() - lp64).abs().max()) < 1e-3


def _model_lazy_calls(hid, n, dev):
    """Every per-layer lazy call (T4 / T5 lazy, both T7 lazy bodies) of the
    skewed unconditional flagship with amortization_mlp_dims = hid (its
    block-2 layers take hidden rows of that width): sample, then log_prob
    of n rows drawn by a second jittered model, and autograd of
    -log_prob().mean() and of a sample objective; each call recorded as
    (name, mode or body, inputs, ift, prep, kd)."""
    p = pdf(*FLAGSHIP, options_overwrite={"g": {"add_skewness": 1}},
            amortization_mlp_dims=str(hid), device=dev)
    g = torch.Generator(device=dev).manual_seed(hid)

    def jitter(scale):
        return {k: v + (0.02 if k.startswith("mlp_") else scale)
                * torch.randn(v.shape, generator=g, device=dev)
                for k, v in p.init_params(seed=0).items()}

    par = jitter(0.02)
    calls = []
    run, run_bwd = gl._run, gl._run_bwd

    def fwd(mode, iface, x, params, ift, prep, kd):
        if iface == "lazy":
            calls.append((f"{mode}_lazy", mode, (x.clone(), params), ift,
                          prep, kd))
        return run(mode, iface, x, params, ift, prep, kd)

    def bwd(body, iface, x, params, g1, g2, ift, prep, kd):
        if iface == "lazy":
            calls.append((f"{body}_bwd_lazy", body,
                          (x.clone(), params, g1.contiguous().clone(),
                           g2.contiguous().clone()), ift,
                          prep, kd))
        return run_bwd(body, iface, x, params, g1, g2, ift, prep, kd)

    gl._run, gl._run_bwd = fwd, bwd
    try:
        with torch.no_grad():
            x = p.sample(jitter(0.1), samplesize=n, generator=g)[0]
            p.sample(par, samplesize=n, generator=g)
            p.log_prob(par, x)
        p._value_and_grad(lambda pp: -p.log_prob(pp, x)[0].mean(), par)
        z = torch.randn((n, p.total_base_dim), generator=g, device=dev)
        p._value_and_grad(lambda pp: p.all_layer_forward(
            pp, z, torch.zeros(n, device=dev))[0].pow(2).mean(), par)
    finally:
        gl._run, gl._run_bwd = run, run_bwd
    assert {c[2][1][0].shape[1] for c in calls} == {hid}
    return calls


@pytest.mark.parametrize("hid,n", [(12, 1000), (200, 4099), (1024, 333)])
def test_layer_lazy_tile_kernels_across_widths(dev, hid, n):
    """The lazy instances of T4 / T5 / T7 (3xTF32 tile products) on the
    skewed flagship's own layer calls at hidden widths from 12 (not a
    multiple of the 8-wide k step) to 1024 (the backward's 32-row tiles, dh
    in the global scratch), on row counts that are not a multiple of the
    tile, against their plain versions on the same inputs."""
    calls = _model_lazy_calls(hid, n, dev)
    assert {c[0] for c in calls} == {"forward_lazy", "sample_lazy",
                                     "forward_bwd_lazy", "sample_bwd_lazy"}
    torch.set_grad_enabled(False)
    for name, mode, args, ift, prep, kd in calls:
        if "_bwd_" in name:
            x, params, g1, g2 = args
            gx, gp = gl._launch_bwd(mode, "lazy", x, params, g1, g2, ift,
                                    prep, kd)
            rgx, rgp = gl.layer_bwd_plain(mode, "lazy", x, params, g1, g2,
                                          ift, prep, kd)
            torch.cuda.synchronize()
            for got, ref in zip((gx, *gp), (rgx, *rgp)):
                assert got.shape == ref.shape and torch.isfinite(got).all()
                tol = TOL_GRAD["density" if mode == "forward" else "sample"]
                assert _rel(got, ref) < tol, (name, _rel(got, ref))
        else:
            x, params = args
            got = gl._launch(mode, "lazy", x, params, ift, prep, kd)
            ref = gl.layer_plain(mode, "lazy", x, params, ift, prep, kd)
            torch.cuda.synchronize()
            for a, b in zip(got, ref):
                assert torch.isfinite(a).all()
                assert float((a - b).abs().max()) < TOL[
                    "density" if mode == "forward" else "sample"], name
    torch.set_grad_enabled(True)


@pytest.mark.parametrize("hid", [12, 128, 1024])
def test_layer_lazy_bwd_repeats(dev, hid):
    """T7 lazy, both bodies, gives the same bits on two launches (persistent
    blocks walking the tiles in a fixed order, partials summed in block
    order)."""
    n, k, d = 3001, 10, 4
    params, prep, lkd = _layer_case("lazy", False, 1, k, d, n, dev, hid=hid)
    rng = np.random.default_rng(5)
    x, g1, g2 = (torch.as_tensor(rng.normal(size=(n, d)), dtype=torch.float32,
                                 device=dev) for _ in range(3))
    for body in ("forward", "sample"):
        res = x if body == "forward" else gl._run(
            "sample", "lazy", x, params, "isigmoid", prep, lkd)[0]
        a, b = (gl._launch_bwd(body, "lazy", res, params, g1, g2, "isigmoid",
                               prep, lkd) for _ in range(2))
        torch.cuda.synchronize()
        for u, v in zip((a[0], *a[1]), (b[0], *b[1])):
            assert torch.equal(u, v), body


@pytest.mark.parametrize("what", ["hidden", "w"])
def test_layer_lazy_kernels_keep_nan_as_plain(dev, what):
    """A NaN made on the card (0/0) in hidden or in w reaches T4 lazy's, T5
    lazy's and T7 lazy's (density body) outputs exactly where it reaches
    the plain versions'; rows whose per-row outputs it does not reach keep
    the clean run's bits."""
    n, k, d = 1000, 10, 4
    clean, prep, lkd = _layer_case("lazy", False, 1, k, d, n, dev, hid=128)
    rng = np.random.default_rng(6)
    x, g1, g2 = (torch.as_tensor(rng.normal(size=(n, d)), dtype=torch.float32,
                                 device=dev) for _ in range(3))
    hidden, w, b = (t.clone() for t in clean)
    zero = torch.zeros((), device=dev)
    if what == "hidden":
        hidden[5, 1] = zero / zero
    else:
        w[9, 7] = zero / zero
    params = (hidden, w, b)
    calls = [(lambda ps, m=m: gl._launch(m, "lazy", x, ps, "isigmoid", prep,
                                         lkd),
              lambda m=m: gl.layer_plain(m, "lazy", x, params, "isigmoid",
                                         prep, lkd), 2)
             for m in ("forward", "sample")]
    calls.append((lambda ps: (lambda r: (r[0], r[1][0], *r[1][1:]))(
        gl._launch_bwd("forward", "lazy", x, ps, g1, g2, "isigmoid", prep,
                       lkd)),
        lambda: (lambda r: (r[0], r[1][0], *r[1][1:]))(gl.layer_bwd_plain(
            "forward", "lazy", x, params, g1, g2, "isigmoid", prep, lkd)), 2))
    for kernel, plain, n_per_row in calls:
        got, want, ref = kernel(params), kernel(clean), plain()
        torch.cuda.synchronize()
        assert any(bool(torch.isnan(a).any()) for a in got)
        for a, r in zip(got, ref):
            _same_nans(a, r)
        rows = ~torch.stack([torch.isnan(r).any(dim=1)
                             for r in ref[:n_per_row]]).any(dim=0)
        for a, c in zip(got[:n_per_row], want[:n_per_row]):
            assert torch.equal(a[rows], c[rows])


# ---------------------------------------------------------------------------
# the block's lazy mode (precomputed hidden), every backward kernel at the
# widest hidden layer the routing sends to it, the chain-rate probe (T8)
# ---------------------------------------------------------------------------

def _lazy_args(p, k, n, seed, dev):
    """Inputs of sub-manifold k's block in the lazy mode: x and (hidden, w,
    b), the hidden activations made by the block's own (jittered) MLP from a
    random summary; all from ``seed``, as _block_args."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    d = p._block_meta[k][1][1]
    x = torch.as_tensor(0.8 * rng.normal(size=(n, d)), dtype=torch.float32,
                        device=dev)
    mlp = p.mlp_predictors[k]
    flat = p.init_params(seed=0)[f"mlp_{k}"]
    flat = flat + 0.02 * torch.randn(flat.shape, generator=g, device=dev)
    summary = torch.randn((n, mlp.input_dim), generator=g, device=dev)
    hidden = mlp.apply_penultimate(flat, summary).contiguous()
    w, b = mlp.final_layer_weights(flat)
    return x, (hidden, w.contiguous(), b.contiguous())


def _check_bwd_mode(x, params, prep, meta, mode, dev, directions, seed=1):
    """T2 in ``directions`` (the sample body at the forward kernel's output)
    against block_bwd_plain, one counted launch each."""
    g = torch.Generator(device=dev).manual_seed(seed)
    g_out = torch.randn(x.shape, generator=g, device=dev)
    g_ld = torch.randn(x.shape, generator=g, device=dev)
    suffix = gb._COUNTER[mode]
    for direction in directions:
        res = x if direction == "density" else gb._launch(
            x, params, prep, meta, mode, "sample")[0]
        name = f"{direction}_bwd_{suffix}"
        before = gb.LAUNCHES[name]
        _, _, gx, gp = gb._launch_bwd(direction, res, params, g_out, g_ld,
                                      prep, meta, mode)
        assert gb.LAUNCHES[name] == before + 1
        ref_gx, ref_gp = gb.block_bwd_plain(direction, res, params, g_out,
                                            g_ld, prep, meta, mode)
        torch.cuda.synchronize()
        for got, ref in zip((gx, *gp), (ref_gx, *ref_gp)):
            assert got.shape == ref.shape and torch.isfinite(got).all()
            assert _rel(got, ref) < TOL_GRAD[direction], (name, _rel(got, ref))


def test_lazy_mode_kernels_match_plain(dev):
    """The lazy mode on the "64-64" flagship's block 2 (a 10-wide summary,
    64-wide hidden), a ragged batch: both forward kernels and both backward
    bodies against the plain versions; no fused NLL in this mode."""
    p = pdf(*FLAGSHIP, conditional_input_dim=3, amortization_mlp_dims="64-64",
            device=dev)
    prep, meta = p._block_meta[2]
    x, params = _lazy_args(p, 2, 4099, 0, dev)
    _check_lazy_fwd(x, params, prep, meta, entry_points=True)
    _check_bwd_mode(x, params, prep, meta, "lazy", dev, ("density", "sample"))
    with pytest.raises(ValueError):
        gb._launch_bwd("nll", x, params, None, None, prep, meta, "lazy",
                       1.0, -1.0)


# the block's lazy mode on the "64-64" flagship's own block 2 with the
# MLP's last hidden width changed: 12 (not a multiple of the 8-wide k
# step), 200 (dh in the global scratch), 1024 (32-row tiles); the
# flagship's 64 (dh in shared memory) is test_lazy_mode_kernels_match_
# plain's
LAZY_WIDTHS = (12, 200, 1024)
LAZY_BATCHES = ("1", "127", "129", "wave-1", "wave+1")


def _lazy_model(hid, dev):
    """The flagship with "64-<hid>" MLPs: block 2 takes the lazy mode on
    hidden rows of width hid."""
    return pdf(*FLAGSHIP, amortization_mlp_dims=f"64-{hid}", device=dev)


def _check_lazy_fwd(x, params, prep, meta, entry_points=False):
    """T1 lazy, both directions, against the plain version, one counted
    launch each (through the entry points gf_block_*_lazy, or the
    launcher)."""
    for direction in ("density", "sample"):
        name = f"{direction}_lazyh"
        before = gb.LAUNCHES[name]
        out, ld = (getattr(gb, f"gf_block_{direction}_lazy")(
            x, *params, prep, meta) if entry_points else
            gb._launch(x, params, prep, meta, "lazy", direction))
        assert gb.LAUNCHES[name] == before + 1
        ref_out, ref_ld = gb.block_plain(direction, x, params, prep, meta,
                                         "lazy")
        torch.cuda.synchronize()
        assert torch.isfinite(out).all() and torch.isfinite(ld).all()
        assert float((out - ref_out).abs().max()) < TOL[direction]
        assert float((ld - ref_ld).abs().max()) < TOL[direction]


@pytest.mark.parametrize("hid", LAZY_WIDTHS)
def test_lazy_tile_kernels_across_widths(dev, hid):
    """T1 and T2 lazy (3xTF32 tile products) at the widths of LAZY_WIDTHS
    on 4,099 rows (not a multiple of any tile): both forward directions and
    both backward bodies against their plain versions."""
    p = _lazy_model(hid, dev)
    prep, meta = p._block_meta[2]
    x, params = _lazy_args(p, 2, 4099, 0, dev)
    assert params[0].shape[1] == hid
    _check_lazy_fwd(x, params, prep, meta)
    _check_bwd_mode(x, params, prep, meta, "lazy", dev, ("density", "sample"))


def test_lazy_tiles_hold_three_forward_blocks_per_sm(dev):
    """At the "64-64" flagship's H = 64 the lazy forward's tile (128 rows,
    its slabs' rows rounded to 8 / 16: ~73 KB) lets three blocks share an
    SM (12 warps); the backward, with dh in shared memory beside the tile
    (~107 KB), two, as many as its registers allow."""
    p = _lazy_model(64, dev)
    prep, meta = p._block_meta[2]
    for name, want in (("density_lazyh", 3), ("sample_lazyh", 3),
                       ("density_bwd_lazyh", 2), ("sample_bwd_lazyh", 2)):
        blocks, threads, _ = gb.kernel_occupancy(name, prep, meta, 64)
        assert threads == 128 and blocks >= want, (name, blocks, threads)


@pytest.mark.parametrize("which", LAZY_BATCHES)
def test_lazy_kernels_at_tile_edges(dev, which):
    """The lazy kernels at H = 64 on one row, one row short of and past a
    128-row tile, and one row short of and past a full wave: T1 (a block
    per tile) at (blocks per SM) x SMs tiles, T2 (persistent blocks, two
    per SM) at 2 x SMs tiles, where one block walks a second tile of one
    row."""
    p = _lazy_model(64, dev)
    prep, meta = p._block_meta[2]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for name in ("density_lazyh", "density_bwd_lazyh"):
        n = int(which) if which[0].isdigit() else None
        if n is None:
            per_sm, rows, _ = gb.kernel_occupancy(name, prep, meta, 64)
            per_sm = 2 if "_bwd_" in name else per_sm
            n = per_sm * n_sm * rows + (1 if which.endswith("+1") else -1)
        x, params = _lazy_args(p, 2, n, 3, dev)
        if "_bwd_" in name:
            _check_bwd_mode(x, params, prep, meta, "lazy", dev,
                            ("density", "sample"))
        else:
            _check_lazy_fwd(x, params, prep, meta)


@pytest.mark.parametrize("hid", [12, 64, 1024])
def test_lazy_bwd_repeats(dev, hid):
    """T2 lazy, both bodies, gives the same bits on two launches
    (persistent blocks walking the tiles in a fixed order, partials summed
    in block order), on a batch where each block walks about three
    tiles."""
    p = _lazy_model(hid, dev)
    prep, meta = p._block_meta[2]
    _, rows, _ = gb.kernel_occupancy("density_bwd_lazyh", prep, meta, hid)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n = 3 * 2 * n_sm * rows - 5
    x, params = _lazy_args(p, 2, n, 4, dev)
    g = torch.Generator(device=dev).manual_seed(4)
    g_out, g_ld = (torch.randn(x.shape, generator=g, device=dev)
                   for _ in range(2))
    y = gb._launch(x, params, prep, meta, "lazy", "sample")[0]
    for body, res in (("density", x), ("sample", y)):
        a, b = (gb._launch_bwd(body, res, params, g_out, g_ld, prep, meta,
                               "lazy") for _ in range(2))
        torch.cuda.synchronize()
        for u, v in zip((a[2], *a[3]), (b[2], *b[3])):
            assert torch.equal(u, v), body


@pytest.mark.parametrize("what", ["hidden", "x"])
def test_lazy_kernels_keep_nan_as_plain(dev, what):
    """A NaN made on the card (0/0) in row 5 of the hidden rows (both
    directions) or of x (the density direction: the sample direction's
    solve, in the plain version as in the kernel, turns a NaN base draw
    into a finite point) reaches T1 lazy's and T2 lazy's outputs exactly
    where it reaches the plain versions' (the hidden tile's copy and the
    cotangents keep it through the TF32 split); the per-row outputs of the
    rows it does not reach keep the clean run's bits."""
    p = _lazy_model(64, dev)
    prep, meta = p._block_meta[2]
    x, clean = _lazy_args(p, 2, 1000, 6, dev)
    zero = torch.zeros((), device=dev)
    hidden, xs = clean[0].clone(), x.clone()
    (hidden if what == "hidden" else xs)[5, 2] = zero / zero
    params = (hidden, *clean[1:])
    g = torch.Generator(device=dev).manual_seed(7)
    g_out, g_ld = (torch.randn(x.shape, generator=g, device=dev)
                   for _ in range(2))

    def check(got, want, ref, n_per_row):
        bad = torch.stack([torch.isnan(r).any(dim=1)
                           for r in ref[:n_per_row]]).any(dim=0)
        assert bad[5]
        for a, r in zip(got, ref):
            _same_nans(a, r)
        for a, c in zip(got[:n_per_row], want[:n_per_row]):
            assert torch.equal(a[~bad], c[~bad])

    for direction in ("density", "sample")[:2 if what == "hidden" else 1]:
        got = gb._launch(xs, params, prep, meta, "lazy", direction)
        want = gb._launch(x, clean, prep, meta, "lazy", direction)
        ref = gb.block_plain(direction, xs, params, prep, meta, "lazy")
        torch.cuda.synchronize()
        check(got, want, ref, 2)
        res, res_c = ((xs, x) if direction == "density" else
                      (got[0], want[0]))
        _, _, gx, gp = gb._launch_bwd(direction, res, params, g_out, g_ld,
                                      prep, meta, "lazy")
        _, _, cgx, cgp = gb._launch_bwd(direction, res_c, clean, g_out, g_ld,
                                        prep, meta, "lazy")
        rgx, rgp = gb.block_bwd_plain(direction, res, params, g_out, g_ld,
                                      prep, meta, "lazy")
        torch.cuda.synchronize()
        check((gx, *gp), (cgx, *cgp), (rgx, *rgp), 2)


@pytest.mark.parametrize("kernel", ["t2_lazy2", "t3_lazy2", "t2_lazy",
                                    "t7_lazy"])
def test_backward_kernels_at_the_widest_hidden_layer(dev, kernel):
    """H = 1024 (MAX_KERNEL_H): the hidden and dh columns no longer fit in
    shared memory together, so dh goes to a global scratch; every backward
    kernel the routing sends such an MLP to launches and matches its plain
    version on 4,096 rows (T2 lazy2 and lazy both bodies, T3 lazy2, T7 lazy
    both bodies)."""
    n = 4096
    if kernel == "t7_lazy":
        params, prep, lkd = _layer_case("lazy", False, 0, 10, 4, n, dev,
                                        hid=1024)
        rng = np.random.default_rng(3)
        x, g1, g2 = (torch.as_tensor(rng.normal(size=(n, 4)),
                                     dtype=torch.float32, device=dev)
                     for _ in range(3))
        for body in ("forward", "sample"):
            res = x if body == "forward" else gl._run(
                "sample", "lazy", x, params, "isigmoid", prep, lkd)[0]
            name = f"{body}_bwd_lazy"
            before = gl.LAUNCHES[name]
            gx, gp = gl._launch_bwd(body, "lazy", res, params, g1, g2,
                                    "isigmoid", prep, lkd)
            assert gl.LAUNCHES[name] == before + 1
            rgx, rgp = gl.layer_bwd_plain(body, "lazy", res, params, g1, g2,
                                          "isigmoid", prep, lkd)
            torch.cuda.synchronize()
            for got, ref in zip((gx, *gp), (rgx, *rgp)):
                assert got.shape == ref.shape and torch.isfinite(got).all()
                tol = TOL_GRAD["density" if body == "forward" else "sample"]
                assert _rel(got, ref) < tol, (name, _rel(got, ref))
        return
    p = pdf("e4", "gggg", conditional_input_dim=3,
            amortization_mlp_dims="1024", device=dev)
    prep, meta = p._block_meta[0]
    if kernel == "t2_lazy":
        x, params = _lazy_args(p, 0, n, 0, dev)
        assert params[0].shape == (n, 1024)
        _check_bwd_mode(x, params, prep, meta, "lazy", dev,
                        ("density", "sample"))
        return
    mode, x, params = _block_args(p, 0, n, 0, dev)
    assert mode == "lazy2" and params[1].shape[0] == 1024
    if kernel == "t2_lazy2":
        _check_bwd_mode(x, params, prep, meta, mode, dev,
                        ("density", "sample"))
        return
    wv, wl = 1.0 / n, -1.0 / n
    before = gb.LAUNCHES["nll_lazy2"]
    val, ld, gx, gp = gb.gf_block_nll_lazy2(x, *params, prep, meta, wv, wl)
    assert gb.LAUNCHES["nll_lazy2"] == before + 1
    ref = gb.block_nll_plain(x, params, prep, meta, mode, wv, wl)
    torch.cuda.synchronize()
    assert float((val - ref[0]).abs().max()) < TOL["density"]
    for got, r in zip((gx, *gp), (ref[2], *ref[3])):
        assert torch.isfinite(got).all()
        assert _rel(got, r) < TOL_GRAD["nll"]


def test_chain_probe_kernels_match_plain(dev):
    """T8: each op's chain kernel against the plain chain (16 steps on the
    probe's 1,048,576 elements, spread over [start, start + 0.1]), one
    counted launch each; the probe's slope gives a positive rate."""
    from jammy_flows_tpu_torch.tools import transcendental_peak as tp
    for op in tp.OPS:
        x0 = tp.initial(op, dev)
        x = x0 + 0.1 * torch.rand(x0.shape, device=dev)
        before = tp.LAUNCHES[f"chain_{op}"]
        got = tp.chain(x, op, 16)
        assert tp.LAUNCHES[f"chain_{op}"] == before + 1
        ref = tp.chain_plain(x, op, 16)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert float((got - ref).abs().max()) < 1e-5, op
    rate, t_lo, t_hi = tp.measure_peak("fma", dev)
    assert rate > 0 and t_hi > t_lo
