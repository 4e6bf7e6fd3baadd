"""The diagnostics, checkpoints and CLI on the card (chip_smoke.py's
diagnostics and cli phases), on the conditional flagship
``pdf("e4+s2+e4", "gggg+f+gggg", conditional_input_dim=3)`` at 2,048 rows:

* ``all_layer_forward_subdims`` / ``all_layer_inverse_subdims`` in float32
  on the card against the port's float64 CPU path on the same parameters,
  base draws and conditional input (every per-sub-manifold log-det within
  1e-3), with the block launches each makes (T1 lazy2 per block);
* ``_marginal_entropy`` of a 32 x 32 block on shared targets against the
  float64 CPU path;
* ``entropy``, ``entropy_iterative`` and ``entropy_device`` equal on one
  generator state; the entropy's gradient (T1 / T2 lazy2) finite;
* ``coverage_scan_device`` against ``coverage_and_or_pdf_scan`` on one
  generator state (an ``"e4", "gggg"`` grid scan);
* ``marginal_moments_device`` against ``marginal_moments`` on the same
  draws;
* a checkpoint of card tensors restored bit-equal on the card, and
  ``python -m jammy_flows_tpu_torch ... --platform default`` through
  ``main``.

Every test needs a CUDA device and skips without one; the file imports no
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_diagnostics_cuda.py
"""
import json

import numpy as np
import pytest
import torch

from jammy_flows_tpu_torch import pdf
from jammy_flows_tpu_torch.__main__ import main
from jammy_flows_tpu_torch.ops import gf_block as gb
from jammy_flows_tpu_torch.utils import checkpoint

pytestmark = pytest.mark.cuda

N = 2048
FLAGSHIP = ("e4+s2+e4", "gggg+f+gggg")
# chip_smoke.py's limits: card f32 against the CPU f64 path (TOL_CROSS),
# the entropy twins (TOL_ENTROPY), the scans (TOL_SCAN), moments
# (TOL_MOMENTS, relative)
TOL_CROSS = 1e-3
TOL_ENTROPY = 1e-5
TOL_SCAN = 1e-4
TOL_MOMENTS = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _model(dev, seed, defs=FLAGSHIP):
    p = pdf(*defs, conditional_input_dim=3, device=dev)
    p_cpu = pdf(*defs, conditional_input_dim=3, device="cpu")
    rng = np.random.default_rng(seed)
    par = {k: v + torch.as_tensor(0.02 * rng.normal(size=v.shape),
                                  dtype=v.dtype)
           for k, v in p_cpu.init_params(seed=0).items()}
    ci = torch.as_tensor(rng.normal(size=(N, 3)), dtype=torch.float32)
    return p, p_cpu, par, ci, rng


def _on(params, dev, dtype=None):
    return {k: v.to(device=dev, dtype=dtype or v.dtype)
            for k, v in params.items()}


def test_subdim_mappings_against_cpu_f64(dev):
    p, p_cpu, par, ci, rng = _model(dev, 0)
    z = torch.as_tensor(rng.normal(size=(N, p.total_base_dim)),
                        dtype=torch.float32)
    par64 = _on(par, "cpu", torch.float64)
    gb.reset_launch_counts()
    with torch.no_grad():
        x, ld = p.all_layer_forward_subdims(_on(par, dev), z.to(dev),
                                            ci.to(dev),
                                            force_embedding_coordinates=True)
        b, lb = p.all_layer_inverse_subdims(_on(par, dev), x, ci.to(dev),
                                            force_embedding_coordinates=True)
    torch.cuda.synchronize()
    assert {k: v for k, v in gb.LAUNCHES.items() if v} == \
        {"sample_lazy2": 2, "density_lazy2": 2}
    xc, ldc = p_cpu.all_layer_forward_subdims(
        par64, z.double(), ci.double(), force_embedding_coordinates=True)
    bc, lbc = p_cpu.all_layer_inverse_subdims(
        par64, x.double().cpu(), ci.double(), force_embedding_coordinates=True)
    assert (x.double().cpu() - xc).abs().max() < TOL_CROSS
    assert (b.double().cpu() - bc).abs().max() < TOL_CROSS
    for k in ld:
        assert (ld[k].double().cpu() - ldc[k]).abs().max() < TOL_CROSS
        assert (lb[k].double().cpu() - lbc[k]).abs().max() < TOL_CROSS


def test_marginal_entropy_against_cpu_f64(dev):
    p, p_cpu, par, ci, _ = _model(dev, 1)
    S = 32
    ds = ci[:1].repeat_interleave(S, dim=0)
    with torch.no_grad():
        targets = p.sample_with_subdim_logprobs(
            _on(par, dev), torch.Generator(device=dev).manual_seed(2), S,
            ds.to(dev))[0]
        for k in (1, 2):
            e = p._marginal_entropy(_on(par, dev), targets, ds.to(dev), k, S,
                                    1, True, False, S)
            ec = p_cpu._marginal_entropy(_on(par, "cpu", torch.float64),
                                         targets.double().cpu(), ds.double(),
                                         k, S, 1, True, False, S)
            assert (e.double().cpu() - ec).abs().max() < TOL_CROSS


def test_entropy_twins_and_gradient(dev):
    p, _, par, ci, _ = _model(dev, 3)
    par = _on(par, dev)
    ci1 = ci[:2].to(dev)
    subs = (-1, 0, 1, 2)

    def gen():
        return torch.Generator(device=dev).manual_seed(4)

    with torch.no_grad():
        ent = p.entropy(par, gen(), sub_manifolds=subs, conditional_input=ci1,
                        samplesize=64)
        it = p.entropy_iterative(par, gen(), sub_manifolds=subs,
                                 conditional_input=ci1, samplesize=64,
                                 iterative_samplesize=16)
        dv = p.entropy_device(par, gen(), sub_manifolds=subs,
                              conditional_input=ci1, samplesize=64)
    for k, v in ent.items():
        assert torch.isfinite(v).all()
        assert (it[k] - v).abs().max() < TOL_ENTROPY
        assert (dv[str(k)] - v).abs().max() < TOL_ENTROPY
    leaves = {k: v.detach().requires_grad_() for k, v in par.items()}
    e = p.entropy(leaves, gen(), sub_manifolds=(-1, 1),
                  conditional_input=ci1, samplesize=64)
    grads = torch.autograd.grad((e["total"] + e[1]).sum(),
                                list(leaves.values()))
    assert all(torch.isfinite(g).all() and g.norm() > 0 for g in grads)


def test_device_scan_matches_host_scan(dev):
    p, _, par, ci, _ = _model(dev, 5, defs=("e4", "gggg"))
    par = _on(par, dev)
    ci = ci[:8].to(dev)
    with torch.no_grad():
        labels = p.sample(par, conditional_input=ci,
                          generator=torch.Generator(device=dev)
                          .manual_seed(6))[0]
        host = p.coverage_and_or_pdf_scan(
            par, labels=labels, conditional_input=ci,
            exact_coverage_calculation=True, calculate_MAP=True,
            samples_per_event=1296,
            generator=torch.Generator(device=dev).manual_seed(7))
        dv = p.coverage_scan_device(
            par, labels, conditional_input=ci, samples_per_event=1296,
            generator=torch.Generator(device=dev).manual_seed(7))
    assert np.abs(dv["real_cov_values"].cpu().numpy()
                  - host["real_cov_values"]).max() < TOL_SCAN
    np.testing.assert_array_equal(dv["map_positions"].cpu().numpy(),
                                  host["map_positions"])


def test_moments_device_matches_host(dev):
    p, _, par, ci, _ = _model(dev, 8)
    par = _on(par, dev)
    ci = ci[:16].to(dev)
    host = p.marginal_moments(par, torch.Generator(device=dev).manual_seed(9),
                              conditional_input=ci, samplesize=256)
    with torch.no_grad():
        dv = p.marginal_moments_device(
            par, torch.Generator(device=dev).manual_seed(9),
            conditional_input=ci, samplesize=256)
    for k, v in dv.items():
        ref = torch.as_tensor(host[k]).double()
        err = (v.double().cpu() - ref).abs().max() / ref.abs().max()
        assert err < TOL_MOMENTS, k


def test_checkpoint_and_cli_on_the_card(dev, tmp_path):
    p, p_cpu, par, _, rng = _model(dev, 10)
    par = _on(par, dev)
    checkpoint.save(tmp_path / "c.pt", par, extra_state={"m": [par["mlp_0"]]})
    back, extra = checkpoint.restore(tmp_path / "c.pt", like_params=par,
                                     like_extra_state={"m": [par["mlp_0"]]})
    assert all(torch.equal(back[k], v) and back[k].device == v.device
               for k, v in par.items())
    assert torch.equal(extra["m"][0], par["mlp_0"])
    u = pdf(*FLAGSHIP, device="cpu")
    with torch.no_grad():
        x = u.sample(u.init_params(seed=0), samplesize=512,
                     generator=torch.Generator().manual_seed(11))[0]
    np.save(tmp_path / "x.npy", x.numpy())
    main(["fit", "--pdf-defs", FLAGSHIP[0], "--flow-defs", FLAGSHIP[1],
          "--data", str(tmp_path / "x.npy"), "--out", str(tmp_path / "m"),
          "--steps", "3", "--lr", "1e-3", "--no-data-init"])
    main(["sample", "--model", str(tmp_path / "m"), "-n", "512", "--out",
          str(tmp_path / "s.npy")])
    s = np.load(tmp_path / "s.npy")
    assert s.shape == (512, 10) and np.isfinite(s).all()
    spec = json.loads((tmp_path / "m" / "model.json").read_text())
    assert spec["pdf_defs"] == FLAGSHIP[0]
