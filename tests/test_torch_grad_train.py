"""The port's trainer against the JAX package's ``train.fit``.

* five full-batch float64 Adam steps: loss history and final parameters
  against JAX's optax run on the same data and initial parameters;
* the learning-rate schedules and global-norm clipping against optax's;
* a float32 CPU fit (the fused NLL calls' plain versions) lowers the loss,
  and with a checkpoint path saves a restorable checkpoint.

Inputs are made with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu import train as jtrain
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch import train as ttrain
from jammy_flows_tpu_torch.utils import checkpoint
from jammy_flows_tpu_torch.utils.convert import params_from_jax, to_numpy
from torch_one_thread import _one_torch_thread  # noqa: F401

# float64: the same algorithm and optimizer arithmetic, rounding only
TOL_F64 = 1e-7
N = 128


def _data(p, seed):
    rng = np.random.default_rng(seed)
    x = 0.6 * rng.normal(size=(N, p.total_target_dim))
    for k, d in enumerate(p.pdf_defs_list):
        if d == "s2":
            lo, _ = p.target_dim_indices[k]
            x[:, lo] = 1.2 + 0.2 * x[:, lo]
            x[:, lo + 1] = 1.0 + 0.2 * x[:, lo + 1]
    return x


@pytest.mark.parametrize("schedule", [None, "warmup_cosine"])
def test_f64_fit_matches_jax(schedule):
    kw = dict(conditional_input_dim=3, amortization_mlp_dims="16")
    jp = jpdf("e4+s2+e4", "gggg+f+gggg", **kw)
    tp = tpdf("e4+s2+e4", "gggg+f+gggg", device="cpu", **kw)
    par = {k: np.asarray(v) for k, v in jp.init_params(
        seed=0, dtype=jnp.float64).items()}
    x = _data(tp, seed=1)
    ci = np.random.default_rng(2).normal(size=(N, 3))
    fit_kw = dict(num_steps=5, learning_rate=1e-2, schedule=schedule,
                  clip_norm=5.0)
    jpar, jloss = jtrain.fit(jp, {k: jnp.asarray(v) for k, v in par.items()},
                             jnp.asarray(x), conditional_input=jnp.asarray(ci),
                             **fit_kw)
    tpar, tloss = ttrain.fit(tp, params_from_jax(par), torch.as_tensor(x),
                             conditional_input=torch.as_tensor(ci), **fit_kw)
    assert tloss.shape == (5,) and np.isfinite(tloss).all()
    np.testing.assert_allclose(tloss, np.asarray(jloss), rtol=TOL_F64)
    for key, v in to_numpy(tpar).items():
        ref = np.asarray(jpar[key])
        assert np.linalg.norm(v - ref) / np.linalg.norm(ref) < TOL_F64, key
    assert not np.array_equal(to_numpy(tpar)["mlp_0"], par["mlp_0"])


@pytest.mark.parametrize("schedule", ["cosine", "warmup_cosine"])
def test_schedules_match_optax(schedule):
    n, lr = 40, 3e-3
    ref = {"cosine": optax.cosine_decay_schedule(lr, n),
           "warmup_cosine": optax.warmup_cosine_decay_schedule(
               0.0, lr, max(1, n // 20), n)}[schedule]
    for step in range(n + 3):
        assert abs(ttrain.learning_rate_at(step, lr, schedule, n)
                   - float(ref(step))) < 1e-12
    assert ttrain.learning_rate_at(7, lr, None, n) == lr
    with pytest.raises(ValueError):
        ttrain.learning_rate_at(0, lr, "linear", n)


@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(3)
    grads = {"a": rng.normal(size=7), "b": rng.normal(size=(3, 2))}
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, None)
    got = ttrain.clip_by_global_norm(
        {k: torch.as_tensor(v) for k, v in grads.items()}, max_norm)
    for key in grads:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-12)


def test_f32_fit_on_cpu_lowers_the_loss(tmp_path):
    tp = tpdf("e4+s2+e4", "gggg+f+gggg", device="cpu",
              amortization_mlp_dims="16")
    par = tp.init_params(seed=0)
    x = torch.as_tensor(_data(tp, seed=4), dtype=torch.float32)
    new, losses = ttrain.fit(tp, par, x, num_steps=8, learning_rate=1e-2,
                             batch_size=64,
                             generator=torch.Generator().manual_seed(0))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert sorted(new) == sorted(par)
    assert all(not v.requires_grad for v in new.values())
    # a checkpoint path saves the fitted parameters once, at the end
    one, _ = ttrain.fit(tp, par, x, num_steps=1, checkpoint_path=tmp_path)
    saved, _ = checkpoint.restore(tmp_path / "step_00000001", like_params=par)
    assert all(torch.equal(saved[k], v) for k, v in one.items())
