"""The circle and interval layers on the card: the repo's examples
``pdf("s1+s2+e2", "m+f+gg", conditional_input_dim=2)``, ``pdf("e2+s1",
"gg+o")`` and ``pdf("i1_-5.5_10.0", "r", conditional_input_dim=2)`` at full
width (chip_smoke.py's circle and interval phase).  Their float32
all_layer_forward and log_prob on the card (the gg blocks through T1 lazy2
or perm, the circle and interval layers plain PyTorch) against the port's
float64 CPU path on the same parameters, base draws and conditional input,
with the block launches each makes; and the first model's
nll_value_and_grad (T3 lazy2) against the float64 gradient.

Every test needs a CUDA device and skips without one; the file imports no
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_s1_interval_cuda.py
"""
import numpy as np
import pytest
import torch

from jammy_flows_tpu_torch import pdf
from jammy_flows_tpu_torch.ops import gf_block as gb, gf_layer as gl

pytestmark = pytest.mark.cuda

N = 4096
# card float32 against the float64 CPU path: chip_smoke.py's limits
# (TOL_CROSS for log_prob and the gradients' relative norms) and the
# sample direction's kernel-vs-plain limit for all_layer_forward
TOL_LOG_PROB = 1e-3
TOL_SAMPLE = 3e-3
TOL_GRAD = 1e-3
MODELS = {
    "s1+s2+e2 conditional": ("s1+s2+e2", "m+f+gg", 2),
    "e2+s1 unconditional": ("e2+s1", "gg+o", None),
    "interval conditional": ("i1_-5.5_10.0", "r", 2),
}
# block launches of one all_layer_forward + log_prob
LAUNCHES = {
    "s1+s2+e2 conditional": {"sample_lazy2": 1, "density_lazy2": 1},
    "e2+s1 unconditional": {"sample_perm": 1, "density_perm": 1},
    "interval conditional": {},
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _setup(name, dev, seed):
    """The model on the card and on the CPU, init_params(seed=0) with every
    parameter moved by 0.02 N(0, 1), base draws and a conditional input,
    all from a numpy seed (float32, on the CPU)."""
    defs, flows, cond = MODELS[name]
    p = pdf(defs, flows, conditional_input_dim=cond, device=dev)
    p_cpu = pdf(defs, flows, conditional_input_dim=cond, device="cpu")
    rng = np.random.default_rng(seed)
    par = {k: v + torch.as_tensor(0.02 * rng.normal(size=v.shape),
                                  dtype=v.dtype)
           for k, v in p_cpu.init_params(seed=0).items()}
    z = torch.as_tensor(rng.normal(size=(N, p.total_base_dim)),
                        dtype=torch.float32)
    ci = None if cond is None else torch.as_tensor(
        rng.normal(size=(N, cond)), dtype=torch.float32)
    return p, p_cpu, par, z, ci


def _to(t, where, dtype=None):
    return None if t is None else t.to(where, dtype)


@pytest.mark.parametrize("name", list(MODELS))
def test_card_matches_the_f64_cpu_path(dev, name):
    p, p_cpu, par, z, ci = _setup(name, dev, seed=1)
    par64 = {k: v.double() for k, v in par.items()}
    x_ref, ld_ref = p_cpu.all_layer_forward(
        par64, z.double(), torch.zeros(N, dtype=torch.float64),
        _to(ci, "cpu", torch.float64))
    lp_ref = p_cpu.log_prob(par64, x_ref,
                            conditional_input=_to(ci, "cpu",
                                                  torch.float64))[0]
    gb.reset_launch_counts()
    gl.reset_launch_counts()
    par_d = {k: v.to(dev) for k, v in par.items()}
    x, ld = p.all_layer_forward(par_d, z.to(dev), torch.zeros(N, device=dev),
                                _to(ci, dev))
    lp = p.log_prob(par_d, _to(x_ref, dev, torch.float32),
                    conditional_input=_to(ci, dev))[0]
    torch.cuda.synchronize()
    assert not any(gl.LAUNCHES.values())
    assert {k: v for k, v in gb.LAUNCHES.items() if v} == LAUNCHES[name]
    for a in (x, ld, lp):
        assert torch.isfinite(a).all()
    assert float((x.cpu().double() - x_ref).abs().max()) < TOL_SAMPLE
    assert float((ld.cpu().double() - ld_ref).abs().max()) < TOL_SAMPLE
    assert float((lp.cpu().double() - lp_ref).abs().max()) < TOL_LOG_PROB


def test_trained_model_gradient_matches_f64(dev):
    """nll_value_and_grad of the first model on the card: one T3 lazy2
    launch, the gradient within TOL_GRAD (relative norm) of the float64
    CPU path's."""
    name = "s1+s2+e2 conditional"
    p, p_cpu, par, z, ci = _setup(name, dev, seed=2)
    with torch.no_grad():
        x = p_cpu.all_layer_forward(par, z, torch.zeros(N), ci)[0]
    gb.reset_launch_counts()
    _, g = p.nll_value_and_grad({k: v.to(dev) for k, v in par.items()},
                                x.to(dev), ci.to(dev))
    torch.cuda.synchronize()
    assert {k: v for k, v in gb.LAUNCHES.items() if v} == {"nll_lazy2": 1}
    _, g64 = p_cpu.nll_value_and_grad({k: v.double() for k, v in par.items()},
                                      x.double(), ci.double())
    for key, ref in g64.items():
        got = g[key].cpu().double()
        assert torch.isfinite(got).all()
        assert float((got - ref).norm() / ref.norm()) < TOL_GRAD, key
