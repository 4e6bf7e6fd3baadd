"""The chain-rate probe's plain chain (jammy_flows_tpu_torch/tools/
transcendental_peak.py) against the TPU probe's kernel body
``_chain_kernel`` (tools/transcendental_peak.py) run in Pallas interpret
mode on the CPU: a 16-step dependent chain of each operation on shared
inputs spread over the range the chain keeps them in."""
import importlib.util
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from jammy_flows_tpu_torch.tools import transcendental_peak as tp
from torch_one_thread import _one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
ROWS, LANES = 8, 1024       # the TPU probe's block
N_OPS = 16
# float32 library differences between XLA's and PyTorch's CPU kernels,
# carried along 16 steps of contracting (or norm-preserving) maps
TOL = 1e-5
# each op's inputs: the probe's start value and a spread inside the range
# its chain stays in
RANGES = {"exp": (-1.0, 0.0), "log": (0.3, 2.0), "softplus": (-2.0, 2.0),
          "sin": (-0.9, 1.1), "arccos": (-1.0, 1.2), "fma": (-2.0, 2.0)}


@pytest.fixture(scope="module")
def jax_probe():
    """The TPU probe's module, loaded from its file; its import-time
    default of JAX_COMPILATION_CACHE_DIR is undone afterwards."""
    key = "JAX_COMPILATION_CACHE_DIR"
    before = os.environ.get(key)
    spec = importlib.util.spec_from_file_location(
        "tpu_transcendental_peak", ROOT / "tools" / "transcendental_peak.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        if before is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = before
    return mod


@pytest.mark.parametrize("op", tp.OPS)
def test_plain_chain_matches_interpret_kernel(jax_probe, op):
    lo, hi = RANGES[op]
    rng = np.random.default_rng(tp.OPS.index(op))
    x = rng.uniform(lo, hi, size=(ROWS, 2 * LANES)).astype(np.float32)
    x[0, 0] = 0.7 if op == "log" else -0.5
    spec = pl.BlockSpec((ROWS, LANES), lambda i: (0, i))
    ref = pl.pallas_call(
        jax_probe._chain_kernel(N_OPS, op),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32), grid=(2,),
        in_specs=[spec], out_specs=spec, interpret=True)(jnp.asarray(x))
    got = tp.chain(torch.as_tensor(x.reshape(-1)), op, N_OPS)
    ref = np.asarray(ref).reshape(-1)
    assert np.isfinite(ref).all() and torch.isfinite(got).all()
    assert float(np.abs(got.numpy() - ref).max()) < TOL


def test_initial_values_and_counts():
    x = tp.initial("log", "cpu", n=8)
    assert x.dtype == torch.float32 and float(x[0]) == pytest.approx(0.7)
    assert float(tp.initial("exp", "cpu", n=8)[0]) == -0.5
    assert tp.N_ELEMS == 1_048_576
    tp.reset_launch_counts()
    tp.chain(x, "log", 3)       # the plain version launches nothing
    assert not any(tp.LAUNCHES.values())
    with pytest.raises(ValueError):
        tp.chain(x, "tanh", 3)
    with pytest.raises(RuntimeError):
        tp.measure_peak("exp", "cpu")
