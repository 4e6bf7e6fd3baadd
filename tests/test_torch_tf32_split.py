"""Why the lazy2 kernels make their parameter rows in 3xTF32 on the tensor
cores (csrc/mma_tf32.cuh) and not in one TF32 pass.

At the flagship's shapes (P = 548 parameter rows, a 128-wide hidden layer,
512 rows of seeded inputs through block 2's own jittered MLP), with the
tensor-core product emulated in plain PyTorch (``gf_block.matmul_3xtf32``:
cvt.rna rounding to TF32, three products per k step of 8, float32
accumulation):

* the 3xTF32 rows lie within a few float32 ulps of the float64 product, as
  close as a float32 matmul;
* a single TF32 pass lies thousands of ulps away;
* the plain lazy2 density fed 3xTF32 rows stays inside the kernels' 3e-4
  limit against the plain float32 version; fed single-TF32 rows it does
  not.

Runs on the CPU; no JAX is involved (the kernels' numerics, not parity).
"""
import numpy as np
import pytest
import torch

from jammy_flows_tpu_torch import pdf
from jammy_flows_tpu_torch.ops import gf_block as gb
from torch_one_thread import _one_torch_thread  # noqa: F401

N_ROWS = 512
TOL_DENSITY = 3e-4     # kernel vs plain, the density direction
ULPS = 8               # "a few": float32 matmul itself lies ~5 away
EPS32 = 2.0 ** -24     # half an ulp of 1 in float32


@pytest.fixture(scope="module")
def flagship_rows():
    """(x, params, prep, meta) of the flagship's lazy2 block 2 at N_ROWS
    rows, and hidden (H, N_ROWS), w (P, H)."""
    p = pdf("e4+s2+e4", "gggg+f+gggg", device="cpu")
    prep, meta = p._block_meta[2]
    mlp = p.mlp_predictors[2]
    rng = np.random.default_rng(0)
    flat = p.init_params(seed=0)["mlp_2"]
    flat = flat + torch.as_tensor(0.02 * rng.normal(size=flat.shape),
                                  dtype=torch.float32)
    w1, b1 = mlp.first_layer_weights(flat)
    w, b = mlp.final_layer_weights(flat)
    summary = torch.as_tensor(rng.normal(size=(N_ROWS, mlp.input_dim)),
                              dtype=torch.float32)
    x = torch.as_tensor(0.8 * rng.normal(size=(N_ROWS, 4)),
                        dtype=torch.float32)
    hidden = torch.tanh(w1 @ summary.T + b1[:, None])
    params = (summary, w1.contiguous(), b1.contiguous(), w.contiguous(),
              b.contiguous())
    assert w.shape == (548, 128)
    return x, params, prep, meta, hidden, w


def _ulps(rows, hidden, w):
    """Largest distance of rows from the float64 product, in units of
    2^-24 |w| @ |hidden| (an ulp of each row's summed magnitude)."""
    ref = w.double() @ hidden.double()
    scale = w.double().abs() @ hidden.double().abs()
    return float(((rows.double() - ref).abs() / (EPS32 * scale)).max())


def test_round_tf32_is_cvt_rna():
    x = torch.tensor([1.0, 1 + 2.0**-11, 1 + 2.0**-10 + 2.0**-11,
                      -(1 + 2.0**-11), 1 + 2.0**-12, float("inf")])
    want = [1.0, 1 + 2.0**-10, 1 + 2.0**-9, -(1 + 2.0**-10), 1.0,
            float("inf")]
    assert gb.round_tf32(x).tolist() == want


def test_3xtf32_rows_within_a_few_ulps_of_f64(flagship_rows):
    _, _, _, _, hidden, w = flagship_rows
    assert _ulps(gb.matmul_3xtf32(w, hidden), hidden, w) < ULPS
    assert _ulps(w @ hidden, hidden, w) < ULPS


def test_single_tf32_rows_are_not(flagship_rows):
    _, _, _, _, hidden, w = flagship_rows
    assert _ulps(gb.matmul_3xtf32(w, hidden, passes=1), hidden, w) > 100 * ULPS


def test_lazy2_density_with_3xtf32_rows_holds_the_limit(flagship_rows):
    x, params, prep, meta, _, _ = flagship_rows
    ref = gb.block_plain("density", x, params, prep, meta, "lazy2")

    def err(passes):
        out = gb.block_plain(
            "density", x, params, prep, meta, "lazy2",
            matmul=lambda a, b: gb.matmul_3xtf32(a, b, passes))
        return max(float((o - r).abs().max()) for o, r in zip(out, ref))

    assert err(3) < TOL_DENSITY / 10
    assert err(1) > TOL_DENSITY
