"""The per-layer entry points of the port (ops/gf_layer.py, the plain
versions of the T4-T7 kernels on the CPU) against the JAX package's
``pallas_gf`` public functions with their Pallas kernels in interpret mode,
as tests/test_pallas_interpret.py runs them.

Every interface (prepared, raw, lazy), broadcast and per-row parameters,
skewed and not, isigmoid and inormal_partly_precise: values of the forward
(T4), sample (T5) and inverse (T6) entry points, and the gradients of the
raw and lazy ones (both T7 bodies) and of ``gf_forward_pallas`` (the plain
VJP) against ``jax.vjp`` of the JAX custom-VJP functions.  Also the
``block_meta`` repair: stacks the JAX package keeps off the whole-block
kernel (skewness, center_mean) are rejected.

Inputs are made with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jammy_flows_tpu.ops.pallas_gf as pg
from jammy_flows_tpu.ops import special as jspecial
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch.ops import gf_block as tblk
from jammy_flows_tpu_torch.ops import gf_layer as gl
from jammy_flows_tpu_torch.ops import special as tspecial
from torch_one_thread import _one_torch_thread  # noqa: F401

K, D, B, H = 10, 4, 256, 16
# the JAX package's kernel-vs-XLA limits (tests/test_pallas_interpret.py,
# tests/test_tpu_kernels.py): density values 3e-4, the sample / inverse
# solve 3e-3; gradients as relative norms, 1e-4 for the density body and
# the prepared VJP, 3e-4 for the sample body
TOL = {"forward": 3e-4, "sample": 3e-3, "inverse": 3e-3}
TOL_GRAD = {"forward": 1e-4, "sample": 3e-4}


@pytest.fixture(autouse=True, scope="module")
def interpret_mode():
    prev = pg._INTERPRET
    pg._INTERPRET = True
    jax.clear_caches()
    yield
    pg._INTERPRET = prev
    jax.clear_caches()


def _preps(skew):
    signs = tuple([1.0] * (K // 2) + [-1.0] * (K - K // 2))
    t = (tspecial.width_regulator_fn(0, 1, 0.01, 100, 0), None, True,
         tspecial.log_bounded_exp_fn(0.1, 9.0, center=True) if skew else None,
         signs if skew else None)
    j = (jspecial.width_regulator_fn(0, 1, 0.01, 100, 0), None, True,
         jspecial.log_bounded_exp_fn(0.1, 9.0, center=True) if skew else None,
         signs if skew else None)
    return t, j


def _inputs(iface, per_row, skew, seed):
    """x (B, D), cotangents, and the parameters in numpy, f32."""
    rng = np.random.default_rng(seed)
    cols = B if per_row else 1
    f32 = np.float32
    x = rng.normal(size=(B, D)).astype(f32)
    g1, g2 = (rng.normal(size=(B, D)).astype(f32) for _ in range(2))
    if iface == "prepared":
        return x, g1, g2, [rng.normal(size=(K, D, cols)).astype(f32),
                           np.log(0.3 + rng.uniform(size=(K, D, cols))).astype(f32),
                           rng.normal(size=(K, D, cols)).astype(f32)]
    groups = [rng.normal(size=(K, D, cols)),
              -1.0 + 0.5 * rng.normal(size=(K, D, cols)),
              rng.normal(size=(K, D, cols))] + \
        [0.8 * rng.normal(size=(K, D, cols))] * skew
    if iface == "raw":
        return x, g1, g2, [g.astype(f32) for g in groups]
    hidden = np.tanh(rng.normal(size=(B, H))).astype(f32)
    ws = [(0.2 * rng.normal(size=(K * D, H))).astype(f32) for _ in groups]
    bs = [g[..., 0].reshape(-1).astype(f32) for g in groups]
    return x, g1, g2, [hidden, ws, bs]


def _call(pkg, mode, iface, x, params, ift, prep):
    """The entry point of one package on its own arrays."""
    mod = gl if pkg == "torch" else pg
    if iface == "prepared":
        fn = mod.gf_forward_pallas if mode == "forward" \
            else mod.gf_inverse_pallas
        return fn(x, *params, ift)
    if iface == "raw":
        return getattr(mod, f"gf_{mode}_raw")(x, tuple(params), ift, prep)
    hidden, ws, bs = params
    return getattr(mod, f"gf_{mode}_lazy")(x, hidden, tuple(ws), tuple(bs),
                                           ift, prep, (K, D))


def _flat(params):
    return [p for group in params
            for p in (group if isinstance(group, list) else [group])]


def _unflat(flat, like):
    out, i = [], 0
    for group in like:
        if isinstance(group, list):
            out.append(list(flat[i:i + len(group)]))
            i += len(group)
        else:
            out.append(flat[i])
            i += 1
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


CASES = [  # iface, per_row, skew, ift
    ("prepared", False, 0, "isigmoid"),
    ("prepared", True, 0, "inormal_partly_precise"),
    ("raw", False, 0, "inormal_partly_precise"),
    ("raw", True, 0, "isigmoid"),
    ("raw", False, 1, "isigmoid"),
    ("raw", True, 1, "inormal_partly_precise"),
    ("lazy", False, 0, "isigmoid"),
    ("lazy", False, 1, "inormal_partly_precise"),
]


@pytest.mark.parametrize("iface,per_row,skew,ift", CASES)
def test_entry_points_match_interpret_kernels(iface, per_row, skew, ift):
    x, g1, g2, params = _inputs(iface, per_row, skew, seed=len(iface) + skew)
    tprep, jprep = _preps(skew)
    modes = {"prepared": ("forward", "inverse"), "lazy": ("forward", "sample"),
             "raw": ("forward", "sample", "inverse")}[iface]
    flat = _flat(params)
    for mode in modes:
        tin = [torch.as_tensor(p).requires_grad_() for p in flat]
        tx = torch.as_tensor(x).requires_grad_()
        got = _call("torch", mode, iface, tx, _unflat(tin, params), ift, tprep)
        if mode == "inverse":
            ref = jax.jit(lambda xx, *ps: _call(
                "jax", mode, iface, xx, _unflat(ps, params), ift, jprep))(
                    jnp.asarray(x), *map(jnp.asarray, flat))
            assert np.abs(got.detach().numpy() - np.asarray(ref)).max() \
                < TOL[mode]
            continue
        # values and the VJP for the cotangents (g1, g2) of (out, ld)
        ref, vjp = jax.vjp(lambda xx, *ps: _call(
            "jax", mode, iface, xx, _unflat(list(ps), params), ift, jprep),
            jnp.asarray(x), *map(jnp.asarray, flat))
        for a, b in zip(got, ref):
            assert np.abs(a.detach().numpy() - np.asarray(b)).max() < TOL[mode]
        jg = vjp((jnp.asarray(g1), jnp.asarray(g2)))
        tg = torch.autograd.grad(got, [tx, *tin],
                                 (torch.as_tensor(g1), torch.as_tensor(g2)))
        for a, b in zip(tg, jg):
            assert a.shape == b.shape
            assert _rel(a.numpy(), b) < TOL_GRAD[mode], (mode, _rel(a, b))


def test_block_meta_rejects_skewed_and_centred_stacks():
    """A skewed or mean-centred `gggg` stack must not run the whole-block
    kernel (it has neither option), as the JAX block_meta decides; the plain
    flagship stack still does."""
    for opts in ({"g": {"add_skewness": 1}}, {"g": {"center_mean": 1}}):
        p = tpdf("e4", "gggg", options_overwrite=opts, device="cpu")
        assert tblk.block_meta(p.layer_list[0]) is None
        assert p._block_meta[0] is None
    p = tpdf("e4", "gggg", device="cpu")
    prep, meta = tblk.block_meta(p.layer_list[0])
    assert len(prep) == 3 and meta[:2] == (10, 4)


def test_inverse_raw_is_the_sample_solve():
    """gf_inverse_raw (no caller in the JAX package) is the sample entry
    point's solve without the log-derivative, and inverts the forward pass
    (nine rows in ten: four Newton steps need not converge on every row of
    a random per-row mixture, in either package)."""
    x, _, _, params = _inputs("raw", True, 1, seed=9)
    tprep, _ = _preps(1)
    slabs = tuple(torch.as_tensor(p) for p in params)
    ift = "inormal_partly_precise"
    val, _ = gl.gf_forward_raw(torch.as_tensor(x), slabs, ift, tprep)
    back = gl.gf_inverse_raw(val, slabs, ift, tprep)
    assert torch.equal(back, gl.gf_sample_raw(val, slabs, ift, tprep)[0])
    err = (back - torch.as_tensor(x)).abs().max(dim=1).values
    assert float(torch.quantile(err, 0.9)) < 3e-3
