"""The exponential-map layer `v` and the embedding-space models against the
JAX package, through the pdf entry points (the checks of
tests/test_torch_s2_pdf.py).

* `v`: the four potentials, both mean parametrizations and both natural
  directions, two layers a model: analytic in the density direction and
  solved in the sampling one, conditional (per-row parameters); and the
  converse, unconditional;
* an S1 (``"s1", "mo"``) and an S2 (``"s2", "fy"``) model parametrized in
  embedding space (every layer's flag set, as the JAX package's
  ``set_embedding_flags(True)`` does), on rows;

in float64 at 1e-8, and 1e-6 in a direction that solves (the sphere solve
stops at float64 resolution of 1 - phi . t, a distance of ~1e-8; the JAX
package's fixtures hold its direction at 1e-6), ``nll_value_and_grad``
against ``jax.grad`` at 1e-7 relative (1e-6 through a solve); the
conditional `v` model in float32 too.  Inputs are made with numpy from a
seed and handed to both packages."""
import pytest

from test_torch_s2_pdf import (TOL_F64, TOL_SOLVE, check_f32, check_f64,
                               check_route)
from torch_one_thread import _one_torch_thread  # noqa: F401

# (definitions, flows, options, conditional input dim, embedding space,
# tolerance of (log_prob, all_layer_forward), nll gradient, (z, phi) route)
MODELS = {
    "v density-natural": ("s2", "vv", {
        (0, 0): {"v": {"exp_map_type": "linear", "num_components": 3}},
        (0, 1): {"v": {"exp_map_type": "splines", "num_components": 3,
                       "mean_parametrization": "householder"}}},
        2, False, (TOL_F64, TOL_SOLVE), True, True),
    "v sample-natural": ("s2", "vv", {
        (0, 0): {"v": {"exp_map_type": "quadratic", "natural_direction": 1,
                       "num_components": 3,
                       "mean_parametrization": "householder"}},
        (0, 1): {"v": {"exp_map_type": "exponential",
                       "natural_direction": 1, "num_components": 3}}},
        None, False, (TOL_SOLVE, TOL_F64), True, True),
    "s1 embedding space": ("s1", "mo", {"o": {"add_rotation": 1}}, None,
                           True, (TOL_F64, TOL_F64), True, False),
    "s2 embedding space": ("s2", "fy", {"y": {"add_rotation": 1}}, None,
                           True, (TOL_F64, TOL_F64), True, False),
}


@pytest.mark.parametrize("label", list(MODELS))
def test_f64_matches_jax(monkeypatch, label):
    check_f64(MODELS[label], monkeypatch)


def test_f32_matches_jax(monkeypatch):
    check_f32(MODELS["v density-natural"], monkeypatch)


@pytest.mark.parametrize("label", list(MODELS))
def test_s2_stack_route(monkeypatch, label):
    check_route(MODELS[label], monkeypatch)
