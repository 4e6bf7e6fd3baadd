"""The CUDA block kernels on the card, held against their plain PyTorch
versions: the forward (csrc/gf_block.cu), the backward and the fused NLL
(csrc/gf_block_bwd.cu), and gradients through every entry point.

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
    """Inputs of sub-manifold k's block: (mode, x, params)."""
    rng = np.random.default_rng(seed)
    par = p.init_params(seed=0)
    d = p._block_meta[k][1][1]
    x = torch.as_tensor(0.8 * rng.normal(size=(n, d)), dtype=torch.float32,
                        device=dev)
    mlp = p.mlp_predictors[k]
    if mlp is None:
        pvec = par["flow_0"] + 0.1 * torch.randn(par["flow_0"].shape,
                                                 device=dev)
        return "perm", x, (pvec,)
    flat = par[f"mlp_{k}"]
    w1, b1 = mlp.first_layer_weights(flat)
    w, b = mlp.final_layer_weights(flat)
    w = (w + 0.02 * torch.randn(w.shape, device=dev)).contiguous()
    summary = torch.randn((n, mlp.input_dim), device=dev)
    return "lazy2", x, (summary, w1.contiguous(), b1.contiguous(), w,
                        b.contiguous())


def _check_block(p, k, dev, direction, n=4096, seed=0):
    prep, meta = p._block_meta[k]
    mode, x, params = _block_args(p, k, n, seed, dev)
    name = f"{direction}_{mode}"
    before = gb.LAUNCHES[name]
    out, ld = getattr(gb, f"gf_block_{name}")(x, *params, prep, meta)
    assert gb.LAUNCHES[name] == before + 1
    ref_out, ref_ld = gb.block_plain(direction, x, params, prep, meta,
                                     mode == "lazy2")
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
    equal the forward kernel's."""
    prep, meta = p._block_meta[k]
    mode, x, params = _block_args(p, k, n, seed, dev)
    lazy = mode == "lazy2"
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    g_out = torch.randn(x.shape, generator=g, device=dev)
    g_ld = torch.randn(x.shape, generator=g, device=dev)
    for direction in ("density", "sample"):
        res = x if direction == "density" else getattr(
            gb, f"gf_block_sample_{mode}")(x, *params, prep, meta)[0]
        name = f"{direction}_bwd_{mode}"
        before = gb.LAUNCHES[name]
        _, _, gx, gp = gb._launch_bwd(direction, res, params, g_out, g_ld,
                                      prep, meta, lazy)
        assert gb.LAUNCHES[name] == before + 1
        ref_gx, ref_gp = gb.block_bwd_plain(direction, res, params, g_out,
                                            g_ld, prep, meta, lazy)
        torch.cuda.synchronize()
        for got, ref in zip((gx, *gp), (ref_gx, *ref_gp)):
            assert got.shape == ref.shape and torch.isfinite(got).all()
            assert _rel(got, ref) < TOL_GRAD[direction], (name, _rel(got, ref))
    wv, wl = 1.0 / n, -1.0 / n
    before = gb.LAUNCHES[f"nll_{mode}"]
    val, ld, gx, gp = getattr(gb, f"gf_block_nll_{mode}")(
        x, *params, prep, meta, wv, wl)
    assert gb.LAUNCHES[f"nll_{mode}"] == before + 1
    out, ld1 = getattr(gb, f"gf_block_density_{mode}")(x, *params, prep, meta)
    ref = gb.block_nll_plain(x, params, prep, meta, lazy, wv, wl)
    torch.cuda.synchronize()
    assert torch.equal(val, out) and torch.equal(ld, ld1)
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
