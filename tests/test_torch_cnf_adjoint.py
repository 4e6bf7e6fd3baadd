"""The continuous adjoint of the manifold CNF `c` against ``jax.grad`` of
the JAX package, in float64: dopri5 on a conditional model (the field's
weights predicted per row, so the adjoint carries them per row), for
``nll_value_and_grad`` (the density direction) and a sample objective
through ``all_layer_forward`` (the sampling direction's charts, reversed
in time), with the checks of tests/test_torch_cnf_grad.py (1e-7 on values,
1e-6 relative on gradients)."""
from test_torch_cnf_grad import check_gradients
from torch_one_thread import _one_torch_thread  # noqa: F401


def test_dopri5_adjoint_matches_jax():
    check_gradients("dopri5")
