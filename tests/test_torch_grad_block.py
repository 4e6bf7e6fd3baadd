"""The block backward (T2) and fused NLL (T3) plain versions of the port
against the JAX package's whole-block Pallas kernels in interpret mode, as
tests/test_pallas_interpret.py runs them on the CPU.

The block is an e3 `gggg` stack whose four layers take the four iCDF types
(inormal_partly_precise, isigmoid, inormal_partly_crude, inormal_full_pade),
householder rotations, fit_normalization and an offset on the last layer;
perm (one parameter vector) and lazy2 (a 16-wide fused MLP on a 3-wide
summary).  The sample direction's backward is the JAX package's implicit
chain (reconstruction from the output, per-layer implicit steps), which the
port's plain version follows instead of differentiating its Newton solve.

Inputs are made with numpy from a seed and handed to both packages."""
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

B = 512
IFTS = ("inormal_partly_precise", "isigmoid", "inormal_partly_crude",
        "inormal_full_pade")
# relative norm of each gradient against the interpret-mode kernels: the JAX
# package's own kernel-vs-XLA gradient limits (tests/test_tpu_kernels.py),
# 1e-4 for the density chain and the fused NLL, 3e-4 for the sample chain
TOL = {"density": 1e-4, "nll": 1e-4, "sample": 3e-4}
# the fused call's values against the forward entry point (same chain)
TOL_VALUES = 1e-5


@pytest.fixture(autouse=True, scope="module")
def interpret_mode():
    prev = pg._INTERPRET
    pg._INTERPRET = True
    jax.clear_caches()
    yield
    pg._INTERPRET = prev
    jax.clear_caches()


@pytest.fixture(scope="module")
def blocks():
    opts = {(0, i): {"g": {"inverse_function_type": ift}}
            for i, ift in enumerate(IFTS)}
    kw = dict(options_overwrite=opts, conditional_input_dim=3,
              amortization_mlp_dims="16")
    jp, tp = jpdf("e3", "gggg", **kw), tpdf("e3", "gggg", device="cpu", **kw)
    jprep, jmeta = jp._block_info(0)
    tprep, tmeta = tp._block_meta[0]
    assert tmeta == jmeta and [lm[3] for lm in tmeta[2]] == list(IFTS)
    return (jprep, jmeta), (tprep, tmeta)


def _inputs(meta, seed, hid=16, n_in=3):
    k, d, layers = meta
    p = tblk.block_rows(k, d, layers)
    rng = np.random.default_rng(seed)
    tp = tpdf("e3", "gggg", device="cpu")
    base = tp.init_params(seed=0, dtype=torch.float64)["flow_0"].numpy()
    f32 = np.float32
    return dict(
        x=(0.8 * rng.normal(size=(B, d))).astype(f32),
        g_out=rng.normal(size=(B, d)).astype(f32),
        g_ld=rng.normal(size=(B, d)).astype(f32),
        pvec=(base + 0.1 * rng.normal(size=p)).astype(f32),
        summary=rng.normal(size=(B, n_in)).astype(f32),
        w1=(rng.normal(size=(hid, n_in)) / np.sqrt(n_in)).astype(f32),
        b1=(0.1 * rng.normal(size=hid)).astype(f32),
        w=(0.05 * rng.normal(size=(p, hid))).astype(f32),
        b=(base + 0.1 * rng.normal(size=p)).astype(f32))


def _params(a, lazy):
    names = ("summary", "w1", "b1", "w", "b") if lazy else ("pvec",)
    return tuple(torch.as_tensor(a[n]) for n in names)


def _jax_cols(a, lazy):
    if lazy:
        return (jnp.asarray(a["summary"]).T, jnp.asarray(a["w1"]),
                jnp.asarray(a["b1"])[:, None], jnp.asarray(a["w"]),
                jnp.asarray(a["b"])[:, None])
    return (jnp.asarray(a["pvec"])[:, None],)


def _jax_grads_like_port(gp, lazy):
    """The JAX kernels' parameter grads in the port wrapper's shapes."""
    if lazy:
        return (np.asarray(gp[0]).T, np.asarray(gp[1]),
                np.asarray(gp[2])[:, 0], np.asarray(gp[3]),
                np.asarray(gp[4])[:, 0])
    return (np.asarray(gp[0])[:, 0],)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("lazy", [False, True], ids=["perm", "lazy2"])
@pytest.mark.parametrize("direction", ["density", "sample"])
def test_block_bwd_plain_matches_interpret_kernel(blocks, direction, lazy):
    (jprep, jmeta), (tprep, tmeta) = blocks
    a = _inputs(tmeta, seed=5)
    params = _params(a, lazy)
    mode = "lazy2" if lazy else "perm"
    res = torch.as_tensor(a["x"])
    if direction == "sample":
        res = tblk.block_plain("sample", res, params, tprep, tmeta, mode)[0]
    g_out, g_ld = torch.as_tensor(a["g_out"]), torch.as_tensor(a["g_ld"])
    gx, gp = tblk.block_bwd_plain(direction, res, params, g_out, g_ld, tprep,
                                  tmeta, mode)
    jgx, jgp = jblk._run_block_bwd(
        jnp.asarray(res.numpy()), _jax_cols(a, lazy), jnp.asarray(a["g_out"]),
        jnp.asarray(a["g_ld"]), jprep, jmeta, "lazy2" if lazy else False,
        direction)
    assert _rel(gx.numpy(), jgx) < TOL[direction]
    for got, ref in zip(gp, _jax_grads_like_port(jgp, lazy)):
        assert got.shape == ref.shape
        assert np.isfinite(got.numpy()).all()
        assert _rel(got.numpy(), ref) < TOL[direction]


@pytest.mark.parametrize("lazy", [False, True], ids=["perm", "lazy2"])
def test_block_nll_plain_matches_interpret_kernel(blocks, lazy):
    (jprep, jmeta), (tprep, tmeta) = blocks
    a = _inputs(tmeta, seed=6)
    params = _params(a, lazy)
    x = torch.as_tensor(a["x"])
    wv, wl = 1.0 / B, -1.0 / B
    if lazy:
        fn_t, fn_j = tblk.gf_block_nll_lazy2, jblk.gf_block_nll_lazy2
        jargs = (jnp.asarray(a["summary"]), jnp.asarray(a["w1"]),
                 jnp.asarray(a["b1"]), jnp.asarray(a["w"]),
                 jnp.asarray(a["b"])[:, None])
    else:
        fn_t, fn_j = tblk.gf_block_nll_perm, jblk.gf_block_nll_perm
        jargs = (jnp.asarray(a["pvec"]),)
    val, ld, gx, gp = fn_t(x, *params, tprep, tmeta, wv, wl)
    jval, jld, jgx, jgp = fn_j(jnp.asarray(a["x"]), *jargs, jprep, jmeta, wv,
                               wl)
    for got, ref in ((val, jval), (ld, jld)):
        assert float(np.abs(got.numpy() - np.asarray(ref)).max()) < 3e-4
    assert _rel(gx.numpy(), jgx) < TOL["nll"]
    jgp = tuple(np.asarray(g) for g in jgp)
    if lazy:
        jgp = jgp[:4] + (jgp[4][:, 0],)
    for got, ref in zip(gp, jgp):
        assert got.shape == ref.shape
        if float(np.linalg.norm(ref)) == 0.0:
            assert float(got.abs().max()) < 1e-6
        else:
            assert _rel(got.numpy(), ref) < TOL["nll"]
    # the fused call's values are the forward entry point's
    fwd = tblk.block_plain("density", x, params, tprep, tmeta,
                           "lazy2" if lazy else "perm")
    assert float((val - fwd[0]).abs().max()) < TOL_VALUES
    assert float((ld - fwd[1]).abs().max()) < TOL_VALUES


@pytest.mark.parametrize("direction", ["density", "sample"])
def test_entry_points_take_gradients_through_the_block(blocks, direction):
    """autograd through a forward entry point reaches every input and
    equals block_bwd_plain on the same cotangents."""
    _, (tprep, tmeta) = blocks
    a = _inputs(tmeta, seed=7)
    x = torch.as_tensor(a["x"]).requires_grad_()
    params = [t.requires_grad_() for t in _params(a, True)]
    fn = getattr(tblk, f"gf_block_{direction}_lazy2")
    out, ld = fn(x, *params, tprep, tmeta)
    g_out, g_ld = torch.as_tensor(a["g_out"]), torch.as_tensor(a["g_ld"])
    got = torch.autograd.grad((out, ld), [x, *params], (g_out, g_ld))
    res = x.detach() if direction == "density" else out.detach()
    ref_gx, ref_gp = tblk.block_bwd_plain(direction, res, tuple(
        p.detach() for p in params), g_out, g_ld, tprep, tmeta, "lazy2")
    for g, r in zip(got, (ref_gx, *ref_gp)):
        assert torch.equal(g, r)
