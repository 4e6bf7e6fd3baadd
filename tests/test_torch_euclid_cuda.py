"""The remaining Euclidean options on the card: the angles and
triangular_combination rotations, high_precision_tail_newton (with and
without skew), the rq_splines stretch and the affine flow `t`, each on the
flagship at full width, unconditional and conditional.  Their float32
log_prob and all_layer_forward on the card (the per-layer kernels where the
option keeps them, plain PyTorch where the JAX package has no kernel)
against the port's plain CPU path on the same parameters, base draws and
rows, with the per-layer launches each route makes; and the skewed
tail-Newton flagship's sample -> log_prob roundtrip on the card.

Every test needs a CUDA device and skips without one; the file imports no
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_euclid_cuda.py
"""
import numpy as np
import pytest
import torch

from jammy_flows_tpu_torch import pdf
from jammy_flows_tpu_torch.ops import gf_block as gb, gf_layer as gl
from test_torch_cuda import FLAGSHIP, TOL

pytestmark = pytest.mark.cuda

N = 4096
TOL_ROUNDTRIP_Q999 = 1e-3        # tests/test_tpu_kernels.py
SKEW_TAIL = {"g": {"add_skewness": 1, "high_precision_tail_newton": 2}}
MODELS = {
    "angles": (FLAGSHIP, {"g": {"rotation_mode": "angles"}}),
    "triangular-combination": (FLAGSHIP, {
        "g": {"rotation_mode": "triangular_combination"}}),
    "tail-newton": (FLAGSHIP, {"g": {"high_precision_tail_newton": 2}}),
    "skewed-tail-newton": (FLAGSHIP, SKEW_TAIL),
    "splines": (FLAGSHIP, {"g": {"nonlinear_stretch_type": "rq_splines"}}),
    "affine": (("e4+s2+e4", "t+f+t"), {"t": {"cov_type": "full"}}),
}
# per-layer launches of log_prob + all_layer_forward (chip_smoke.py's
# serving counts): a rotation keeps the raw broadcast (block 0) and lazy
# interfaces; tail Newton the prepared solve and density pass at the
# refined root, and T4 raw in log_prob; with skew T4 raw in both
_ROT = {None: {"sample_raw": 4, "sample_lazy": 4, "forward_raw": 4,
               "forward_lazy": 4},
        3: {"sample_lazy": 8, "forward_lazy": 8}}
_TAIL = {"inverse_prepared": 8, "forward_prepared": 8, "forward_raw": 8}
LAUNCHES = {"angles": _ROT, "triangular-combination": _ROT,
            "tail-newton": {None: _TAIL, 3: _TAIL},
            "skewed-tail-newton": {None: {"forward_raw": 16},
                                   3: {"forward_raw": 16}},
            "splines": {None: {}, 3: {}}, "affine": {None: {}, 3: {}}}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _pair(name, cond, dev):
    defs, opts = MODELS[name]
    kw = dict(options_overwrite=opts, conditional_input_dim=cond)
    return pdf(*defs, device=dev, **kw), pdf(*defs, device="cpu", **kw)


def _params(p_cpu, seed):
    """init_params(seed=0) with every parameter moved by 0.02 N(0, 1), from
    a numpy seed."""
    rng = np.random.default_rng(seed)
    return {k: v + torch.as_tensor(0.02 * rng.normal(size=v.shape),
                                   dtype=v.dtype)
            for k, v in p_cpu.init_params(seed=0).items()}


@pytest.mark.parametrize("cond", [None, 3], ids=["unconditional",
                                                 "conditional"])
@pytest.mark.parametrize("name", list(MODELS))
def test_card_matches_the_cpu_plain_path(dev, name, cond):
    p, p_cpu = _pair(name, cond, dev)
    assert p._block_meta[0] is None and p._block_meta[2] is None
    par = _params(p_cpu, seed=1)
    rng = np.random.default_rng(2)
    z = torch.as_tensor(rng.normal(size=(N, p.total_base_dim)),
                        dtype=torch.float32)
    ci = None if cond is None else torch.as_tensor(
        rng.normal(size=(N, cond)), dtype=torch.float32)
    x_ref, ld_ref = p_cpu.all_layer_forward(par, z, torch.zeros(N), ci)
    lp_ref = p_cpu.log_prob(par, x_ref, conditional_input=ci)[0]

    def card(t):
        return None if t is None else t.to(dev)

    gb.reset_launch_counts()
    gl.reset_launch_counts()
    x, ld = p.all_layer_forward({k: card(v) for k, v in par.items()},
                                card(z), torch.zeros(N, device=dev), card(ci))
    lp = p.log_prob({k: card(v) for k, v in par.items()}, card(x_ref),
                    conditional_input=card(ci))[0]
    torch.cuda.synchronize()
    assert not any(gb.LAUNCHES.values())
    assert {k: v for k, v in gl.LAUNCHES.items() if v} == \
        LAUNCHES[name][cond]
    for a in (x, ld, lp):
        assert torch.isfinite(a).all()
    assert float((x.cpu() - x_ref).abs().max()) < TOL["sample"]
    assert float((ld.cpu() - ld_ref).abs().max()) < TOL["sample"]
    assert float((lp.cpu() - lp_ref).abs().max()) < TOL["density"]


def test_skewed_tail_newton_roundtrip_on_card(dev):
    """The skewed tail-Newton flagship's sampled log q on the card agrees
    with its log_prob at the samples: the density pass at the refined root
    keeps the skew (the JAX package's float32 path drops it)."""
    p = pdf(*FLAGSHIP, options_overwrite=SKEW_TAIL, device=dev)
    par = {k: v.to(dev) for k, v in _params(
        pdf(*FLAGSHIP, options_overwrite=SKEW_TAIL, device="cpu"),
        seed=3).items()}
    x, _, lq, _ = p.sample(par, samplesize=65536,
                           generator=torch.Generator(device=dev).manual_seed(4))
    lp = p.log_prob(par, x)[0]
    torch.cuda.synchronize()
    assert torch.isfinite(lq).all() and torch.isfinite(lp).all()
    assert torch.quantile((lp - lq).abs(), 0.999).item() < TOL_ROUNDTRIP_Q999
