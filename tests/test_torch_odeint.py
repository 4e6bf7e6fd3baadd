"""The port's adaptive ODE solver (jammy_flows_tpu_torch/ops/odeint.py)
against the JAX package's (jammy_flows_tpu/ops/odeint.py).

* the five tableaus: the same constants and orders, rows summing to c, both
  weight vectors to 1;
* every method on y' = -theta y against its closed form, forward and
  backward in time, with the adjoint gradients against theirs;
* the step control: on a toy nonlinear ODE the port's loop takes the JAX
  loop's accepted and attempted steps, in float64 and float32, and records
  them in ``ODE_SOLVES``;
* the continuous adjoint on that ODE (a tuple state, a tuple of arguments)
  against ``jax.grad`` of the JAX package's ``odeint`` in float64 at 1e-9.

Inputs are made with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jammy_flows_tpu.ops import odeint as jode
from jammy_flows_tpu_torch.ops import odeint as tode
from torch_one_thread import _one_torch_thread  # noqa: F401

METHODS = sorted(tode.TABLEAUS)


@pytest.mark.parametrize("name", METHODS)
def test_tableau_matches_jax(name):
    tab, ref = tode.TABLEAUS[name], jode.TABLEAUS[name]
    assert tab.order == ref.order
    assert (tab.c, tab.a, tab.b_sol, tab.b_err) == \
        (ref.c, ref.a, ref.b_sol, ref.b_err)
    for ci, row in zip(tab.c, tab.a):
        assert abs(sum(row) - ci) < 1e-12
    assert abs(sum(tab.b_sol) - 1.0) < 1e-12
    assert abs(sum(tab.b_err)) < 1e-12


@pytest.mark.parametrize("name", METHODS)
def test_linear_decay_closed_form(name):
    """y(t1) = y0 exp(-theta (t1 - t0)) both ways in time; the adjoint's
    d/dy0 and d/dtheta of sum(y1) against the closed form, within 300 times
    the tolerance the method is given, relative (1e-10 at order 5 and up,
    1e-8 at 3, 1e-7 at 2)."""
    tol = {8: 1e-10, 5: 1e-10, 3: 1e-8, 2: 1e-7}[tode.TABLEAUS[name].order]
    y0 = torch.tensor([2.0, -3.0], dtype=torch.float64, requires_grad=True)
    theta = torch.tensor([0.7], dtype=torch.float64, requires_grad=True)

    def f(t, y, args):
        return (-args[0] * y[0],)

    for t0, t1 in ((0.0, 1.5), (1.5, 0.0)):
        (y1,) = tode.odeint(f, (y0,), (theta,), t0, t1, tol, tol,
                            max_steps=100000, method=name)
        decay = np.exp(-0.7 * (t1 - t0))
        np.testing.assert_allclose(y1.detach().numpy(),
                                   np.array([2.0, -3.0]) * decay,
                                   rtol=300 * tol)
        gy0, gth = torch.autograd.grad(y1.sum(), (y0, theta))
        np.testing.assert_allclose(gy0.numpy(), [decay, decay],
                                   rtol=300 * tol)
        np.testing.assert_allclose(gth.numpy(),
                                   [(2.0 - 3.0) * -(t1 - t0) * decay],
                                   rtol=300 * tol)


def _toy(lib):
    """A toy field on a tuple state (y (4, 2), s (4,)) with a tuple of
    arguments (w (2, 2), b (2,)), written for either package."""
    tanh, dot = (jnp.tanh, jnp.matmul) if lib is jnp else \
        (torch.tanh, torch.matmul)

    def f(t, state, args):
        y, s = state
        w, b = args
        dy = tanh(dot(y, w) + b) * (1.0 + 0.3 * t) - 0.2 * y
        return dy, (y**2).sum(-1) * 0.5
    return f


def _toy_inputs(dtype):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(4, 2)).astype(dtype),
            np.zeros(4, dtype=dtype),
            (0.8 * rng.normal(size=(2, 2))).astype(dtype),
            (0.5 * rng.normal(size=2)).astype(dtype))


@pytest.mark.parametrize("dtype,name", [(np.float64, "dopri5"),
                                        (np.float64, "bosh3"),
                                        (np.float32, "dopri5")])
def test_step_control_matches_jax(dtype, name):
    """The same accepted and attempted steps as the JAX package's loop on
    the same flat state, forward and backward in time; y(t1) within the
    tolerance (1e-12 float64, 1e-5 float32)."""
    y, s, w, b = _toy_inputs(dtype)
    jf, tf = _toy(jnp), _toy(torch)
    y0 = np.concatenate([y.ravel(), s])
    tab_j, tab_t = jode.TABLEAUS[name], tode.TABLEAUS[name]

    def flat_j(t, v):
        dy, ds = jf(t, (v[:8].reshape(4, 2), v[8:]), (w, b))
        return jnp.concatenate([dy.ravel(), ds])

    def flat_t(t, v):
        dy, ds = tf(t, (v[:8].reshape(4, 2), v[8:]),
                    (torch.as_tensor(w), torch.as_tensor(b)))
        return torch.cat([dy.reshape(-1), ds])

    for t0, t1 in ((0.0, 1.0), (1.0, 0.25)):
        yj, steps_j = jax.jit(lambda v: jode._odeint_flat(
            tab_j, flat_j, v, t0, t1, 1e-7, 1e-7, 4096))(jnp.asarray(y0))
        tode.ODE_SOLVES.clear()
        yt = tode._odeint_flat(tab_t, flat_t, torch.as_tensor(y0), t0, t1,
                               1e-7, 1e-7, 4096, "forward")
        (kind, accepted, rejected, at_max), = tode.ODE_SOLVES
        assert kind == "forward" and not at_max
        assert accepted + rejected == int(steps_j)
        tol = 1e-12 if dtype == np.float64 else 1e-5
        assert np.abs(yt.numpy() - np.asarray(yj)).max() < tol


@pytest.mark.parametrize("name", ["dopri5", "adaptive_heun"])
def test_adjoint_matches_jax_grad(name):
    """The continuous adjoint of a loss on both state leaves, with respect
    to the initial state and both arguments, against jax.grad of the JAX
    package's odeint (float64, 1e-9 relative); the backward solve is
    recorded as an adjoint integration."""
    y, s, w, b = _toy_inputs(np.float64)
    jf, tf = _toy(jnp), _toy(torch)
    tol = 1e-8 if name == "dopri5" else 1e-6

    def loss_j(y0, w_, b_):
        y1, s1 = jode.odeint(jf, (y0, jnp.asarray(s)), (w_, b_), 0.0, 1.0,
                             tol, tol, 100000, name)
        return (y1**3).sum() + (s1 * jnp.arange(4.0)).sum()

    val_j, grads_j = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1, 2)))(
        y, w, b)
    leaves = [torch.tensor(a, requires_grad=True) for a in (y, w, b)]
    tode.ODE_SOLVES.clear()
    y1, s1 = tode.odeint(tf, (leaves[0], torch.as_tensor(s)),
                         tuple(leaves[1:]), 0.0, 1.0, tol, tol, 100000, name)
    val_t = (y1**3).sum() + (s1 * torch.arange(4.0, dtype=s1.dtype)).sum()
    grads_t = torch.autograd.grad(val_t, leaves)
    assert [k for k, *_ in tode.ODE_SOLVES] == ["forward", "adjoint"]
    assert abs(val_t.item() - float(val_j)) < 1e-9
    for gt, gj in zip(grads_t, grads_j):
        gj = np.asarray(gj)
        assert np.abs(gt.numpy() - gj).max() < 1e-9 * max(1.0, np.abs(gj).max())
