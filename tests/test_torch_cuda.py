"""The CUDA block kernel on the card, held against its plain PyTorch version.

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
    with pytest.raises(RuntimeError):
        gb.gf_block_density_perm(x, pvec.clone().requires_grad_(), prep, meta)
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
