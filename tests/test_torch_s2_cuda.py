"""The s2 options of `f` and the exponential map `v` on the card: the
production S2 recipe ``pdf("s2", "f" * 15)`` with PRODUCTION_F, the
conditional flagship with that `f`, and the `v` fixtures' models at their
10 components (chip_smoke.py's sphere phase), at full width and 4,096 rows.

* float32 all_layer_forward and log_prob on the card against the port's
  float64 CPU path on the same parameters, base draws and conditional
  input, with the block launches each makes (the flagship's gggg blocks
  through T1 lazy2; the `f` and `v` layers launch nothing): log_prob within
  1e-3 of float64; the samples and their log-det no farther from float64
  than the port's float32 CPU path's, plus 3e-3 (near a pole the float32
  (theta, phi) path of the production `f` stack lies up to ~3e-3 from
  float64 in both packages: the JAX package's 2.7e-3 in the log-det, at
  theta = 0.0125).  Where the sampling direction is the float32 sphere
  solve (the conditional `v` models), which stops ~1e-3 rad from the root
  in the JAX package's float32 path as in the port's, the samples are held
  by their roundtrip instead: log_prob of the card's samples against their
  log-density, q999 < 1e-3 (chip_smoke.py's limit);
* every T1 call of the flagship with the production `f` against its plain
  version on the same inputs;
* nll_value_and_grad of the flagship with the production `f` (two T3
  lazy2 launches) and of the conditional exponential `v` model (autograd
  through the exponential map's log-det) against the port's float32 CPU
  path (the production `f` stack's float32 gradient lies ~5e-3 from
  float64 in both packages), and to float64 no farther than that path
  plus 1e-3.

Every test needs a CUDA device and skips without one; the file imports no
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_s2_cuda.py
"""
import numpy as np
import pytest
import torch

from chip_smoke import PRODUCTION_F
from jammy_flows_tpu_torch import pdf
from jammy_flows_tpu_torch.ops import gf_block as gb, gf_layer as gl

pytestmark = pytest.mark.cuda

N = 4096
# chip_smoke.py's limits: log_prob and the gradients' relative norms 1e-3
# (TOL_CROSS), the sample direction and kernel-vs-plain sample 3e-3, the
# kernel-vs-plain density 3e-4
TOL_LOG_PROB = 1e-3
TOL_SAMPLE = 3e-3
TOL_DENSITY = 3e-4
TOL_GRAD = 1e-3
MODELS = {
    "production s2": ("s2", "f" * 15, PRODUCTION_F, None),
    "flagship production f": ("e4+s2+e4", "gggg+f+gggg", PRODUCTION_F, 3),
    "v exponential conditional": ("s2", "v", {"v": {
        "exp_map_type": "exponential"}}, 2),
    "v splines conditional": ("s2", "v", {"v": {"exp_map_type": "splines"}},
                              2),
    "v exponential sample-natural": ("s2", "v", {"v": {
        "exp_map_type": "exponential", "natural_direction": 1}}, None),
}
# models whose sampling direction solves
SAMPLE_SOLVED = ("v exponential conditional", "v splines conditional")
TOL_ROUNDTRIP_Q999 = 1e-3
# block launches of one all_layer_forward + log_prob
LAUNCHES = {name: {} for name in MODELS}
LAUNCHES["flagship production f"] = {"sample_lazy2": 2, "density_lazy2": 2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _jittered(p_cpu, rng, flow_scale=0.0):
    """init_params(seed=0) with every MLP weight moved by 0.02 N(0, 1) and
    the permanent ones by flow_scale N(0, 1), from a numpy generator."""
    return {k: v + torch.as_tensor(
        (0.02 if k.startswith("mlp_") else flow_scale)
        * rng.normal(size=v.shape), dtype=v.dtype)
        for k, v in p_cpu.init_params(seed=0).items()}


def _setup(name, dev, seed):
    """The model on the card and on the CPU, its jittered parameters, base
    draws and a conditional input, all from a numpy seed (float32, on the
    CPU)."""
    defs, flows, opts, cond = MODELS[name]
    kw = dict(options_overwrite=opts, conditional_input_dim=cond)
    p = pdf(defs, flows, device=dev, **kw)
    p_cpu = pdf(defs, flows, device="cpu", **kw)
    rng = np.random.default_rng(seed)
    par = _jittered(p_cpu, rng)
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
    assert float((lp.cpu().double() - lp_ref).abs().max()) < TOL_LOG_PROB
    if name in SAMPLE_SOLVED:
        log_base = -0.5 * (z.to(dev)**2).sum(dim=1) - np.log(2 * np.pi)
        lp_x = p.log_prob(par_d, x, conditional_input=_to(ci, dev))[0]
        d = (lp_x - (log_base - ld)).abs()
        assert torch.quantile(d, 0.999).item() < TOL_ROUNDTRIP_Q999
        return
    x32, ld32 = p_cpu.all_layer_forward(par, z, torch.zeros(N), ci)
    for got, own, ref in ((x, x32, x_ref), (ld, ld32, ld_ref)):
        own_err = float((own.double() - ref).abs().max())
        assert float((got.cpu().double() - ref).abs().max()) \
            < own_err + TOL_SAMPLE


def test_flagship_block_calls_match_plain(dev, monkeypatch):
    """Every T1 lazy2 call of the flagship with the production `f` (sample,
    then log_prob of the samples) against gf_block.block_plain on its
    inputs."""
    p, _, par, z, ci = _setup("flagship production f", dev, seed=2)
    calls = []
    run = gb._run

    def recorded(x, params, prep, meta, mode, direction):
        out, ld = run(x, params, prep, meta, mode, direction)
        calls.append((x.clone(), tuple(q.clone() for q in params), prep,
                      meta, mode, direction, out.clone(), ld.clone()))
        return out, ld

    monkeypatch.setattr(gb, "_run", recorded)
    par_d = {k: v.to(dev) for k, v in par.items()}
    x, _ = p.all_layer_forward(par_d, z.to(dev), torch.zeros(N, device=dev),
                               ci.to(dev))
    p.log_prob(par_d, x, conditional_input=ci.to(dev))
    assert [c[4:6] for c in calls] == [("lazy2", "sample")] * 2 + \
        [("lazy2", "density")] * 2
    for xi, params, prep, meta, mode, direction, out, ld in calls:
        ref_out, ref_ld = gb.block_plain(direction, xi, params, prep, meta,
                                         mode)
        tol = TOL_DENSITY if direction == "density" else TOL_SAMPLE
        assert float((out - ref_out).abs().max()) < tol
        assert float((ld - ref_ld).abs().max()) < tol


def _training_rows(name, p_cpu, z, ci):
    """Rows away from the trained model, where its gradient is not a sum of
    cancelling per-row terms: the flagship's drawn from another jittered
    model (its flow_0 moved by 0.1 N(0, 1)); the `v` model's, whose density
    is nearly uniform at init whatever its weights, uniform in a polar cap
    (theta in (0.2, 1.2))."""
    rng = np.random.default_rng(4)
    if name.startswith("v "):
        return torch.as_tensor(np.stack([rng.uniform(0.2, 1.2, N),
                                         rng.uniform(0.0, 2 * np.pi, N)],
                                        axis=1), dtype=torch.float32)
    other = _jittered(p_cpu, rng, flow_scale=0.1)
    with torch.no_grad():
        return p_cpu.all_layer_forward(other, z, torch.zeros(N), ci)[0]


@pytest.mark.parametrize("name", ["flagship production f",
                                  "v exponential conditional"])
def test_trained_model_gradient(dev, name):
    """nll_value_and_grad on the card (_training_rows): the block launches
    (two T3 lazy2 for the flagship, none for `v`), the gradient within
    TOL_GRAD (relative norm) of the port's float32 CPU path, and no farther
    from its float64 path than that float32 path is, plus TOL_GRAD."""
    p, p_cpu, par, z, ci = _setup(name, dev, seed=3)
    x = _training_rows(name, p_cpu, z, ci)
    gb.reset_launch_counts()
    _, g = p.nll_value_and_grad({k: v.to(dev) for k, v in par.items()},
                                x.to(dev), ci.to(dev))
    torch.cuda.synchronize()
    want = {"nll_lazy2": 2} if name.startswith("flagship") else {}
    assert {k: v for k, v in gb.LAUNCHES.items() if v} == want
    _, g32 = p_cpu.nll_value_and_grad(par, x, ci)
    _, g64 = p_cpu.nll_value_and_grad({k: v.double() for k, v in par.items()},
                                      x.double(), ci.double())
    for key in g64:
        got = g[key].cpu().double()
        assert torch.isfinite(got).all()
        ref32, ref64 = g32[key].double(), g64[key]
        assert float((got - ref32).norm() / ref32.norm()) < TOL_GRAD, key
        own = float((ref32 - ref64).norm() / ref64.norm())
        assert float((got - ref64).norm() / ref64.norm()) < own + TOL_GRAD, \
            key
