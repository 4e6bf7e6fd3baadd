"""The manifold CNF `c` and the PDF-level options on the card (chip_smoke.py's
cnf and options phases), at full width and 2,048 rows:

* ``pdf("s2", "c")`` at the registry's defaults (dopri5), its rk4 form and
  the conditional flagship with `c` between its gggg blocks: float32
  all_layer_forward and log_prob on the card against the port's float64
  CPU path on the same parameters, base draws and conditional input, with
  the block launches each makes (T1 lazy2 for the flagship's blocks, none
  for `c`): log_prob within 1e-3, the samples and their log-det no farther
  from float64 than the port's float32 CPU path's, plus 3e-3; each ODE
  integration under its ``max_steps``;
* the gradients: nll_value_and_grad (the continuous adjoint for dopri5,
  rk4's checkpointed steps; the flagship's two T3 lazy2 launches beside
  the `c` sub-pdf's autograd pass) against the port's float64 CPU path
  within 1e-3 (relative norm);
* every T1 lazy2 call of the flagship with `c` against its plain version
  on the same inputs;
* the options model (``"e4+s2+e4", "gggg+f+gggg"`` with one conditional
  input per sub-pdf, 3, 2 and 2 wide, and a standalone Poisson head,
  initialized from data): failsafe sampling in embedding coordinates
  (every returned row within the tolerance of its log_prob or its last
  draw), log_prob with forced embedding coordinates and log_mean_poisson
  against the float64 CPU path, its NLL through autograd (T1 / T2 lazy2)
  against the float64 CPU path.

Every test needs a CUDA device and skips without one; the file imports no
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cnf_cuda.py
"""
import numpy as np
import pytest
import torch

from jammy_flows_tpu_torch import pdf
from jammy_flows_tpu_torch.ops import gf_block as gb, gf_layer as gl
from jammy_flows_tpu_torch.ops import odeint

pytestmark = pytest.mark.cuda

N = 2048
# chip_smoke.py's limits: log_prob and the gradients' relative norms 1e-3
# (TOL_CROSS, TOL_CROSS_GRAD), the sample direction and kernel-vs-plain
# sample 3e-3, kernel-vs-plain density 3e-4
TOL_LOG_PROB = 1e-3
TOL_SAMPLE = 3e-3
TOL_DENSITY = 3e-4
TOL_GRAD = 1e-3
MODELS = {
    "c dopri5": ("s2", "c", None, None),
    "c rk4": ("s2", "c", {"c": {"solver": "rk4"}}, None),
    "flagship c": ("e4+s2+e4", "gggg+c+gggg", None, 3),
}
# block launches of one all_layer_forward + log_prob, of one NLL gradient
LAUNCHES = {"c dopri5": {}, "c rk4": {},
            "flagship c": {"sample_lazy2": 2, "density_lazy2": 2}}
NLL_LAUNCHES = {"c dopri5": {}, "c rk4": {}, "flagship c": {"nll_lazy2": 2}}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _jittered(p_cpu, rng, flow_scale=0.0, init=None):
    """init_params(seed=0) (or ``init``) with every MLP weight moved by
    0.02 N(0, 1) and the other parameters by flow_scale N(0, 1), from a
    numpy generator."""
    init = p_cpu.init_params(seed=0) if init is None else init
    return {k: v + torch.as_tensor(
        (0.02 if k.startswith("mlp_") else flow_scale)
        * rng.normal(size=v.shape), dtype=v.dtype)
        for k, v in init.items()}


def _setup(name, dev, seed):
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
    return p, p_cpu, par, z, ci, rng


def _to(t, where, dtype=None):
    if isinstance(t, list):
        return [c.to(where, dtype) for c in t]
    return None if t is None else t.to(where, dtype)


def _counts():
    return {k: v for k, v in {**gb.LAUNCHES, **gl.LAUNCHES}.items() if v}


@pytest.mark.parametrize("name", list(MODELS))
def test_card_matches_the_f64_cpu_path(dev, name):
    p, p_cpu, par, z, ci, _ = _setup(name, dev, seed=1)
    par64 = {k: v.double() for k, v in par.items()}
    x_ref, ld_ref = p_cpu.all_layer_forward(
        par64, z.double(), torch.zeros(N, dtype=torch.float64),
        _to(ci, "cpu", torch.float64))
    lp_ref = p_cpu.log_prob(par64, x_ref,
                            conditional_input=_to(ci, "cpu",
                                                  torch.float64))[0]
    gb.reset_launch_counts()
    gl.reset_launch_counts()
    odeint.ODE_SOLVES.clear()
    par_d = {k: v.to(dev) for k, v in par.items()}
    x, ld = p.all_layer_forward(par_d, z.to(dev), torch.zeros(N, device=dev),
                                _to(ci, dev))
    lp = p.log_prob(par_d, _to(x_ref, dev, torch.float32),
                    conditional_input=_to(ci, dev))[0]
    torch.cuda.synchronize()
    assert _counts() == LAUNCHES[name]
    assert not any(at_max for *_, at_max in odeint.ODE_SOLVES)
    for a in (x, ld, lp):
        assert torch.isfinite(a).all()
    assert float((lp.cpu().double() - lp_ref).abs().max()) < TOL_LOG_PROB
    x32, ld32 = p_cpu.all_layer_forward(par, z, torch.zeros(N), ci)
    for got, own, ref in ((x, x32, x_ref), (ld, ld32, ld_ref)):
        own_err = float((own.double() - ref).abs().max())
        assert float((got.cpu().double() - ref).abs().max()) \
            < own_err + TOL_SAMPLE


@pytest.mark.parametrize("name", list(MODELS))
def test_gradient_matches_the_f64_cpu_path(dev, name):
    """nll_value_and_grad on rows drawn from another jittered model (its
    permanent parameters moved by 0.1 N(0, 1)): the block launches, the
    adjoint's integrations under max_steps, the gradient within TOL_GRAD of
    the float64 CPU path."""
    p, p_cpu, par, z, ci, rng = _setup(name, dev, seed=3)
    other = _jittered(p_cpu, rng, flow_scale=0.1)
    with torch.no_grad():
        x = p_cpu.all_layer_forward(other, z, torch.zeros(N), ci)[0]
    gb.reset_launch_counts()
    gl.reset_launch_counts()
    odeint.ODE_SOLVES.clear()
    _, g = p.nll_value_and_grad({k: v.to(dev) for k, v in par.items()},
                                x.to(dev), _to(ci, dev))
    torch.cuda.synchronize()
    assert _counts() == NLL_LAUNCHES[name]
    assert not any(at_max for *_, at_max in odeint.ODE_SOLVES)
    if name != "c rk4":
        assert "adjoint" in {k for k, *_ in odeint.ODE_SOLVES}
    _, g64 = p_cpu.nll_value_and_grad({k: v.double() for k, v in par.items()},
                                      x.double(), _to(ci, "cpu",
                                                      torch.float64))
    for key in g64:
        got = g[key].cpu().double()
        assert torch.isfinite(got).all()
        assert float((got - g64[key]).norm() / g64[key].norm()) < TOL_GRAD, \
            key


def test_flagship_block_calls_match_plain(dev, monkeypatch):
    """Every T1 lazy2 call of the flagship with `c` (sample, then log_prob
    of the samples) against gf_block.block_plain on its inputs."""
    p, _, par, z, ci, _ = _setup("flagship c", dev, seed=2)
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


def test_options_model(dev):
    """The options model on the card: data-driven init, failsafe sampling in
    embedding coordinates, log_prob (forced embedding coordinates),
    log_mean_poisson and the NLL gradient (autograd: T1 / T2 lazy2)
    against the float64 CPU path."""
    kw = dict(conditional_input_dim=[3, 2, 2], predict_log_normalization=True)
    p = pdf("e4+s2+e4", "gggg+f+gggg", device=dev, **kw)
    p_cpu = pdf("e4+s2+e4", "gggg+f+gggg", device="cpu", **kw)
    rng = np.random.default_rng(5)
    ci = [torch.as_tensor(rng.normal(size=(N, w)), dtype=torch.float32)
          for w in (3, 2, 2)]
    z = torch.as_tensor(rng.normal(size=(N, p.total_base_dim)),
                        dtype=torch.float32)
    with torch.no_grad():
        rows = p_cpu.all_layer_forward(_jittered(p_cpu, rng, 0.1), z,
                                       torch.zeros(N), ci)[0]
    par = _jittered(p_cpu, rng, init=p_cpu.init_params(seed=0,
                                                       data=rows[:, :4]))
    par_d = {k: v.to(dev) for k, v in par.items()}
    par64 = {k: v.double() for k, v in par.items()}
    ci_d, ci64 = _to(ci, dev), _to(ci, "cpu", torch.float64)
    tol = 1e-3
    xs, _, lp_s, _ = p.sample(par_d, conditional_input=ci_d,
                              generator=torch.Generator(device=dev)
                              .manual_seed(6),
                              failsafe_crosscheck_tolerance=tol,
                              force_embedding_coordinates=True)
    assert xs.shape == (N, p.total_target_dim_embedded)
    lp_e = p.log_prob(par_d, xs, conditional_input=ci_d,
                      force_embedding_coordinates=True)[0]
    lp_ref = p_cpu.log_prob(par64, xs.cpu().double(), conditional_input=ci64,
                            force_embedding_coordinates=True)[0]
    assert float((lp_e.cpu().double() - lp_ref).abs().max()) < TOL_LOG_PROB
    assert torch.quantile((lp_e - lp_s).abs(), 0.999).item() < 1e-3
    lm = p.log_mean_poisson(par_d, ci_d)
    lm_ref = p_cpu.log_mean_poisson(par64, ci64)
    assert float((lm.cpu().double() - lm_ref).abs().max()) < TOL_LOG_PROB
    gb.reset_launch_counts()
    x_def = p.transform_target_space(xs, transform_from="embedding",
                                     transform_to="default")[0]
    _, g = p.nll_value_and_grad(par_d, x_def, ci_d)
    torch.cuda.synchronize()
    assert _counts() == {"density_lazy2": 2, "density_bwd_lazy2": 2}
    _, g64 = p_cpu.nll_value_and_grad(par64, x_def.cpu().double(), ci64)
    for key in g64:
        if key == "poisson_mlp":
            assert not g[key].any()
            continue
        got = g[key].cpu().double()
        assert float((got - g64[key]).norm() / g64[key].norm()) < TOL_GRAD, \
            key
