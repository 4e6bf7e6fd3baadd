"""Whole-block gggg op of the port against the JAX package's whole-block
Pallas kernels (run in interpret mode, as tests/test_pallas_interpret.py
runs them on the CPU), at the flagship shapes: K=10, d=4, 4 layers with
householder iter 4, fit_normalization, an offset on the last layer (P=548),
inormal_partly_precise on layer 0 and isigmoid on layers 1-3; lazy2 with the
128-wide hidden layer and 7- and 3-wide summaries.

On the CPU the port's entry points run their plain PyTorch version
(tests/test_torch_cuda.py holds the CUDA kernel against it on the card)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jammy_flows_tpu.ops.pallas_gf as pg
import jammy_flows_tpu.ops.pallas_gf_block as jblk
from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch.ops import gf_block as tblk
from torch_one_thread import _one_torch_thread  # noqa: F401

B = 1024
# the JAX package's kernel-vs-XLA limits (tests/test_pallas_interpret.py):
# density values 3e-4, the sample direction's Newton solve 3e-3
TOL = {"density": 3e-4, "sample": 3e-3}


@pytest.fixture(autouse=True, scope="module")
def interpret_mode():
    prev = pg._INTERPRET
    pg._INTERPRET = True
    jax.clear_caches()
    yield
    pg._INTERPRET = prev
    jax.clear_caches()


@pytest.fixture(scope="module")
def flagship():
    jp = jpdf("e4+s2+e4", "gggg+f+gggg")
    tp = tpdf("e4+s2+e4", "gggg+f+gggg", device="cpu")
    return jp, tp


def _inputs(n_in, seed, p=548, hid=128):
    """Random block parameters with per-row variation (numpy, shared)."""
    rng = np.random.default_rng(seed)
    jp = jpdf("e4+s2+e4", "gggg+f+gggg")
    flow0 = np.asarray(jp.init_params(seed=0, dtype=jnp.float64)["flow_0"])
    f32 = np.float32
    return dict(
        x=(0.8 * rng.normal(size=(B, 4))).astype(f32),
        pvec=(flow0 + 0.1 * rng.normal(size=p)).astype(f32),
        summary=rng.normal(size=(B, n_in)).astype(f32),
        w1=(rng.normal(size=(hid, n_in)) / np.sqrt(n_in)).astype(f32),
        b1=(0.1 * rng.normal(size=hid)).astype(f32),
        w=(0.02 * rng.normal(size=(p, hid))).astype(f32),
        b=(flow0 + 0.1 * rng.normal(size=p)).astype(f32))


def test_block_meta_matches_jax(flagship):
    jp, tp = flagship
    for k in (0, 2):
        jprep, jmeta = jp._block_info(k)
        tprep, tmeta = tp._block_meta[k]
        assert tmeta == jmeta
        assert tblk.block_rows(*tmeta) == 548
        assert tprep[2] == jprep[2]
        x = np.linspace(-30, 30, 301)
        for jr, tr in zip(jprep[:2], tprep[:2]):
            np.testing.assert_allclose(tr(torch.as_tensor(x)).numpy(),
                                       jr(jnp.asarray(x)), rtol=1e-12)
    assert tp._block_meta[1] is None


@pytest.mark.parametrize("direction", ["density", "sample"])
def test_perm_block_matches_interpret_kernel(flagship, direction):
    jp, tp = flagship
    a = _inputs(7, seed=1)
    jprep, jmeta = jp._block_info(0)
    tprep, tmeta = tp._block_meta[0]
    jfn = getattr(jblk, f"gf_block_{direction}_perm")
    tfn = getattr(tblk, f"gf_block_{direction}_perm")
    jo, jl = jfn(jnp.asarray(a["x"]), jnp.asarray(a["pvec"]), jprep, jmeta)
    to, tl = tfn(torch.as_tensor(a["x"]), torch.as_tensor(a["pvec"]), tprep,
                 tmeta)
    assert to.shape == (B, 4) and tl.shape == (B, 4)
    assert float(np.abs(to.numpy() - np.asarray(jo)).max()) < TOL[direction]
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) < TOL[direction]


@pytest.mark.parametrize("n_in", [7, 3])
@pytest.mark.parametrize("direction", ["density", "sample"])
def test_lazy2_block_matches_interpret_kernel(flagship, direction, n_in):
    jp, tp = flagship
    a = _inputs(n_in, seed=2)
    jprep, jmeta = jp._block_info(2)
    tprep, tmeta = tp._block_meta[2]
    jfn = getattr(jblk, f"gf_block_{direction}_lazy2")
    tfn = getattr(tblk, f"gf_block_{direction}_lazy2")
    j = [jnp.asarray(a[k]) for k in ("x", "summary", "w1", "b1", "w", "b")]
    jo, jl = jfn(*j[:5], j[5][:, None], jprep, jmeta)
    to, tl = tfn(*[torch.as_tensor(a[k]) for k in
                   ("x", "summary", "w1", "b1", "w", "b")], tprep, tmeta)
    assert float(np.abs(to.numpy() - np.asarray(jo)).max()) < TOL[direction]
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) < TOL[direction]


def test_sample_then_density_roundtrip(flagship):
    """The plain block's two directions invert each other."""
    _, tp = flagship
    a = {k: torch.as_tensor(v) for k, v in _inputs(7, seed=3).items()}
    prep, meta = tp._block_meta[2]
    args = (a["summary"], a["w1"], a["b1"], a["w"], a["b"], prep, meta)
    x, ld_s = tblk.gf_block_sample_lazy2(a["x"], *args)
    z, ld_d = tblk.gf_block_density_lazy2(x, *args)
    assert float((z - a["x"]).abs().max()) < 1e-3
    assert float((ld_s.sum(-1) - ld_d.sum(-1)).abs().max()) < 1e-3


def test_wrapper_checks_inputs():
    x = torch.zeros((4, 4))
    tblk._check("x", x, (4, 4), x.device)
    with pytest.raises(TypeError):
        tblk._check("x", x.double(), (4, 4), x.device)
    with pytest.raises(ValueError):
        tblk._check("x", x, (4, 3), x.device)
    with pytest.raises(ValueError):
        tblk._check("x", torch.zeros((4, 8))[:, ::2], (4, 4), x.device)
    # the kernels have a backward: a tensor that requires grad is taken
    tblk._check("x", x.clone().requires_grad_(), (4, 4), x.device)
