"""The gradients of the manifold CNF `c` against ``jax.grad`` of the JAX
package, in float64: rk4's backprop through its checkpointed steps (an
unconditional model; dopri5's continuous adjoint is in
tests/test_torch_cnf_adjoint.py with the same check), for
``nll_value_and_grad`` and for a sample objective through
``all_layer_forward``, with log_prob and the samples as the references'
auxiliary outputs.  Limits: 1e-8 on values and 1e-7 relative on
gradients (rk4), 1e-7 and 1e-6 (dopri5: both packages step on the same
error norms, a decision at the accept threshold may differ by an ulp).
The models are tests/test_torch_cnf.py's (16 rows, a hidden layer of 8, 2
charts); one case compiles its two JAX gradients in ~45 s."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from jammy_flows_tpu_torch.utils.convert import params_from_jax
from test_torch_cnf import B, _data, _jit, _pair, _params
from test_torch_grad_pdf import _j, _rel, _t
from torch_one_thread import _one_torch_thread  # noqa: F401

# solver -> (conditional input, tolerance of values, of gradients)
CASES = {"rk4": (None, 1e-8, 1e-7), "dopri5": (2, 1e-7, 1e-6)}


def _sample_objective(x, ld):
    return (x**2).mean() - 0.1 * ld.mean()


def check_gradients(solver):
    """log_prob, the samples and the gradients of the NLL and of the sample
    objective against the JAX package's."""
    cond, tol, tol_g = CASES[solver]
    jp, tp = _pair(solver, cond)
    par = _params(jp, np.float64, seed=7)
    x, z, ci = _data(cond, 8, np.float64)

    @_jit
    def ref(p, x, z, c):
        def nll(pp):
            lp = jp.log_prob(pp, x, conditional_input=c)[0]
            return -lp.mean(), lp

        def sobj(pp):
            xs, ld = jp.all_layer_forward(pp, z, jnp.zeros(B), c)
            return _sample_objective(xs, ld), xs

        return (jax.value_and_grad(nll, has_aux=True)(p),
                jax.value_and_grad(sobj, has_aux=True)(p))

    ((_, lp_j), gn_j), ((_, xs_j), gs_j) = ref(
        {k: jnp.asarray(v) for k, v in par.items()}, _j(x), _j(z), _j(ci))
    tpar = params_from_jax(par)
    loss, gn_t = tp.nll_value_and_grad(tpar, _t(x), _t(ci))
    assert abs(loss.item() + float(np.asarray(lp_j).mean())) < tol
    _, gs_t = tp._value_and_grad(lambda pp: _sample_objective(
        *tp.all_layer_forward(pp, _t(z), torch.zeros(B, dtype=torch.float64),
                              _t(ci))), tpar)
    xs_t = tp.all_layer_forward(tpar, _t(z), torch.zeros(
        B, dtype=torch.float64), _t(ci))[0]
    assert np.abs(xs_t.numpy() - np.asarray(xs_j)).max() < tol
    for got, want in ((gn_t, gn_j), (gs_t, gs_j)):
        assert sorted(got) == sorted(want)
        for key in want:
            assert _rel(got[key].numpy(), want[key]) < tol_g, key


def test_rk4_gradients_match_jax():
    check_gradients("rk4")
