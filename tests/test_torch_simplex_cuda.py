"""The simplex layers and the fully amortized model on the card, at full
width (chip_smoke.py's simplex phase): ``pdf("a2", "w",
conditional_input_dim=2)``, ``pdf("a3", "w")``, ``pdf("a2", "u")`` and
``fully_amortized_pdf("e2+s1", "gg+o", conditional_input_dim=3)``.  Their
float32 all_layer_forward and log_prob on the card against the port's
float64 CPU path on the same parameters, base draws and conditional input,
with the launches each makes (none for the simplex models; the fully
amortized one's gg block runs T5 / T4 raw on per-row slabs); every
per-row raw call (T4, T5, the T7 density body of the log_prob gradient)
against its plain version on the same inputs; the conditional `w` model's
nll_value_and_grad and the fully amortized model's log_prob gradient
against the float64 gradient.

Every test needs a CUDA device and skips without one; the file imports no
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_simplex_cuda.py
"""
import numpy as np
import pytest
import torch

from jammy_flows_tpu_torch import PDF, fully_amortized_pdf, pdf
from jammy_flows_tpu_torch.ops import gf_block as gb, gf_layer as gl

pytestmark = pytest.mark.cuda

N = 4096
# chip_smoke.py's limits: card float32 against the float64 CPU path
# (TOL_CROSS for log_prob and the gradients' relative norms), the sample
# direction's and the kernels' against their plain versions
TOL_LOG_PROB = 1e-3
TOL_SAMPLE = 3e-3
TOL_GRAD = 1e-3
TOL_DENSITY = 3e-4
TOL_BWD = 1e-4
MODELS = {
    "a2 w conditional": (pdf, "a2", "w", 2),
    "a3 w unconditional": (pdf, "a3", "w", None),
    "a2 u unconditional": (pdf, "a2", "u", None),
    "fully amortized e2+s1": (fully_amortized_pdf, "e2+s1", "gg+o", 3),
}
# per-layer launches of one all_layer_forward + log_prob
LAUNCHES = {"fully amortized e2+s1": {"sample_raw": 2, "forward_raw": 2}}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _setup(name, dev, seed):
    """The model on the card and on the CPU, init_params(seed=0) with every
    parameter moved by 0.02 N(0, 1) (the `u` layer's four by 0.3), base
    draws and a conditional input, all from a numpy seed (float32, on the
    CPU)."""
    ctor, defs, flows, cond = MODELS[name]
    p = ctor(defs, flows, conditional_input_dim=cond, device=dev)
    p_cpu = ctor(defs, flows, conditional_input_dim=cond, device="cpu")
    rng = np.random.default_rng(seed)
    par = {k: v + torch.as_tensor((0.3 if v.numel() < 8 else 0.02)
                                  * rng.normal(size=v.shape), dtype=v.dtype)
           for k, v in p_cpu.init_params(seed=0).items()}
    base_dim = getattr(p_cpu, "inner_pdf", p_cpu).total_base_dim
    z = torch.as_tensor(rng.normal(size=(N, base_dim)), dtype=torch.float32)
    ci = None if cond is None else torch.as_tensor(
        rng.normal(size=(N, cond)), dtype=torch.float32)
    return p, p_cpu, par, z, ci


def _to(t, where, dtype=None):
    return None if t is None else t.to(where, dtype)


class _Recorder:
    """Every per-layer call's inputs and outputs, as copies (the wrapped
    call still launches its kernel)."""

    def __init__(self, monkeypatch):
        self.calls = []
        run, run_bwd = gl._run, gl._run_bwd

        def fwd(mode, iface, x, params, ift, prep, kd):
            out = run(mode, iface, x, params, ift, prep, kd)
            self.calls.append((mode, iface, x.clone(),
                               tuple(t.clone() for t in params), None, ift,
                               prep, kd, tuple(o.clone() for o in out)))
            return out

        def bwd(body, iface, x, params, g1, g2, ift, prep, kd):
            gx, grads = run_bwd(body, iface, x, params, g1, g2, ift, prep, kd)
            self.calls.append((body, "bwd", x.clone(),
                               tuple(t.clone() for t in params),
                               (g1.clone(), g2.clone()), ift, prep, kd,
                               (gx.clone(), *(g.clone() for g in grads))))
            return gx, grads

        monkeypatch.setattr(gl, "_run", fwd)
        monkeypatch.setattr(gl, "_run_bwd", bwd)

    def check(self):
        """Each call against its plain version: density 3e-4, sample 3e-3
        (max |diff|), the T7 body 1e-4 relative to each output's largest."""
        assert self.calls
        for mode, iface, x, params, cts, ift, prep, kd, outs in self.calls:
            assert params[0].ndim == 3       # per-row slabs
            if iface == "bwd":
                gx, grads = gl.layer_bwd_plain(mode, "raw", x, params, *cts,
                                               ift, prep, kd)
                for a, b in zip(outs, (gx, *grads)):
                    scale = max(float(b.abs().max()), 1e-30)
                    assert float((a - b).abs().max()) / scale < TOL_BWD
                continue
            ref = gl.layer_plain(mode, iface, x, params, ift, prep, kd)
            tol = TOL_DENSITY if mode == "forward" else TOL_SAMPLE
            for a, b in zip(outs, ref):
                assert torch.isfinite(a).all()
                assert float((a - b).abs().max()) < tol


@pytest.mark.parametrize("name", list(MODELS))
def test_card_matches_the_f64_cpu_path(dev, monkeypatch, name):
    p, p_cpu, par, z, ci = _setup(name, dev, seed=1)
    par64 = {k: v.double() for k, v in par.items()}
    x_ref, ld_ref = p_cpu.all_layer_forward(
        par64, z.double(), torch.zeros(N, dtype=torch.float64),
        _to(ci, "cpu", torch.float64))
    # both paths read the same rows: the float32 ones (rounding a row near
    # the simplex's faces to float32 moves its log-density by up to ~5e-4)
    x32 = x_ref.float()
    lp_ref = p_cpu.log_prob(par64, x32.double(),
                            conditional_input=_to(ci, "cpu",
                                                  torch.float64))[0]
    rec = _Recorder(monkeypatch)
    gb.reset_launch_counts()
    gl.reset_launch_counts()
    par_d = {k: v.to(dev) for k, v in par.items()}
    x, ld = p.all_layer_forward(par_d, z.to(dev), torch.zeros(N, device=dev),
                                _to(ci, dev))
    lp = p.log_prob(par_d, x32.to(dev), conditional_input=_to(ci, dev))[0]
    torch.cuda.synchronize()
    assert not any(gb.LAUNCHES.values())
    assert {k: v for k, v in gl.LAUNCHES.items() if v} == \
        LAUNCHES.get(name, {})
    for a in (x, ld, lp):
        assert torch.isfinite(a).all()
    assert float((x.cpu().double() - x_ref).abs().max()) < TOL_SAMPLE
    assert float((ld.cpu().double() - ld_ref).abs().max()) < TOL_SAMPLE
    assert float((lp.cpu().double() - lp_ref).abs().max()) < TOL_LOG_PROB
    if name in LAUNCHES:
        rec.check()


@pytest.mark.parametrize("name", ["a2 w conditional", "fully amortized e2+s1"])
def test_gradient_matches_f64(dev, monkeypatch, name):
    """The conditional `w` model's nll_value_and_grad (no kernel) and the
    fully amortized model's log_prob gradient (T4 raw and the T7 density
    body per row, each against its plain version) on the card, within
    TOL_GRAD (relative norm) of the float64 CPU path's."""
    p, p_cpu, par, z, ci = _setup(name, dev, seed=2)
    with torch.no_grad():
        x = p_cpu.all_layer_forward(par, z, torch.zeros(N), ci)[0]
    par_d = {k: v.to(dev) for k, v in par.items()}
    par64 = {k: v.double() for k, v in par.items()}
    rec = _Recorder(monkeypatch)
    gl.reset_launch_counts()
    if name.startswith("fully"):
        _, g = PDF._value_and_grad(lambda pp: -p.log_prob(
            pp, x.to(dev), ci.to(dev))[0].mean(), par_d)
        _, g64 = PDF._value_and_grad(lambda pp: -p_cpu.log_prob(
            pp, x.double(), ci.double())[0].mean(), par64)
    else:
        _, g = p.nll_value_and_grad(par_d, x.to(dev), ci.to(dev))
        _, g64 = p_cpu.nll_value_and_grad(par64, x.double(), ci.double())
    torch.cuda.synchronize()
    assert {k: v for k, v in gl.LAUNCHES.items() if v} == (
        {"forward_raw": 2, "forward_bwd_raw": 2} if name in LAUNCHES else {})
    if name in LAUNCHES:
        rec.check()
    for key, ref in g64.items():
        got = g[key].cpu().double()
        assert torch.isfinite(got).all()
        assert float((got - ref).norm() / ref.norm()) < TOL_GRAD, key
