"""Simplex flow layers: the iterative autoregressive flow (`w`) and the
Gumbel-softmax (`u`).

PyTorch counterpart of ``jammy_flows_tpu/layers/simplex.py`` on (B, d) rows
with (Bp, P) parameter slabs.  Neither package has a kernel for simplex
math; the `w` layer's inner pdf runs its interval splines (and MLPs) in
plain PyTorch.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import FlowLayer, coordinates_intrinsic
from ..ops import logistic_kde, manifold
from ..ops.special import LOG_SQRT_2PI


class SimplexLayer(FlowLayer):
    """Base: the Gaussian -> box -> skewed box -> base simplex chain with
    exact log-dets when the layer is the first of a simplex sub-manifold."""

    def __init__(self, dimension=1, always_parametrize_in_embedding_space=0,
                 project_from_gauss_to_simplex=0):
        super().__init__(dimension, always_parametrize_in_embedding_space)
        self.project_from_gauss_to_simplex = int(project_from_gauss_to_simplex)

    def forward(self, params, x, log_det):
        if self.project_from_gauss_to_simplex:
            x, log_det = manifold.gauss_to_box(x, log_det)
            x, log_det = manifold.box_to_skewed_box(x, log_det)
            x, log_det = manifold.box_to_base_simplex(x, log_det)
            if self.always_parametrize_in_embedding_space:
                x, log_det = manifold.base_simplex_to_canonical(x, log_det)
        return self._forward(params, x, log_det)

    def inverse(self, params, x, log_det):
        x, log_det = self._inverse(params, x, log_det)
        if self.project_from_gauss_to_simplex:
            if self.always_parametrize_in_embedding_space:
                x, log_det = manifold.canonical_simplex_to_base(x, log_det)
            x, log_det = manifold.base_simplex_to_box(x, log_det)
            x, log_det = manifold.skewed_box_to_box(x, log_det)
            x, log_det = manifold.box_to_gauss(x, log_det)
        return x, log_det

    @property
    def embedded_dim(self):
        return self.dimension + 1

    @property
    def base_dim(self):
        if self.always_parametrize_in_embedding_space and \
                not self.project_from_gauss_to_simplex:
            return self.dimension + 1
        return self.dimension

    def embedding_conditional_return(self, x):
        """The canonical (d + 1)-simplex point of intrinsic rows."""
        if x.shape[1] == self.dimension:
            x, _ = manifold.base_simplex_to_canonical(x, 0.0)
        return x

    def transform_target_space(self, x, log_det=0.0, transform_from="default",
                               transform_to="embedding"):
        """Intrinsic (base simplex) <-> embedding (canonical simplex)
        coordinates."""
        now, want = coordinates_intrinsic(self, transform_from, transform_to)
        if now and not want:
            return manifold.base_simplex_to_canonical(x, log_det)
        if want and not now:
            return manifold.canonical_simplex_to_base(x, log_det)
        return x, log_det

    def _forward(self, params, x, log_det):
        raise NotImplementedError

    def _inverse(self, params, x, log_det):
        raise NotImplementedError


class InnerLoopSimplex(SimplexLayer):
    """Iterative autoregressive simplex flow - symbol "w".  Maps the base
    simplex to the box and runs an inner passthrough pdf of d autoregressive
    interval RQ-spline pairs there, every parameter of which (its first
    pair's, then each later pair's MLP weights) is this layer's parameter
    slab, row by row when the outer pdf amortizes it."""

    def __init__(self, dimension=1, always_parametrize_in_embedding_space=0,
                 project_from_gauss_to_simplex=0, device=None):
        super().__init__(dimension, always_parametrize_in_embedding_space,
                         project_from_gauss_to_simplex)
        from ..models.pdf import PDF   # deferred: pdf imports the layers
        self.inner_flow = PDF("+".join(["i1_0.0_1.0"] * dimension),
                              "+".join(["rr"] * dimension),
                              options_overwrite={"r": {"num_basis_functions": 10}},
                              amortize_everything=True,
                              amortization_mlp_use_custom_mode=True,
                              use_as_passthrough_instead_of_pdf=True,
                              device=device)
        self.num_inner_params = self.inner_flow.total_number_amortizable_params
        self.num_params += self.num_inner_params

    def param_structure(self):
        return [("inner_flow_params", self.num_inner_params)]

    def _through_box(self, params, x, log_det, inner_map):
        if self.always_parametrize_in_embedding_space:
            x, log_det = manifold.canonical_simplex_to_base(x, log_det)
        x, log_det = manifold.base_simplex_to_box(x, log_det)
        x, log_det = inner_map({}, x, log_det, None,
                               amortization_parameters=params)
        x, log_det = manifold.box_to_base_simplex(x, log_det)
        if self.always_parametrize_in_embedding_space:
            x, log_det = manifold.base_simplex_to_canonical(x, log_det)
        return x, log_det

    def _forward(self, params, x, log_det):
        return self._through_box(params, x, log_det,
                                 self.inner_flow.all_layer_forward)

    def _inverse(self, params, x, log_det):
        return self._through_box(params, x, log_det,
                                 self.inner_flow.all_layer_inverse)

    def default_params(self, rng=None):
        """The inner pdf's slab init, drawn from the caller's generator."""
        return self.inner_flow.default_amortization_params(
            rng or np.random.default_rng(0))


class GumbelSoftmax(SimplexLayer):
    """Gumbel-softmax simplex flow - symbol "u": the log-ratio transform to
    a shifted Gumbel with temperature tau and class log-probabilities as
    parameters, then the Gumbel CDF and the inverse-normal pass of the
    Gaussianization flows.  It takes no projection chain.  Its sampling
    log-det is summed per row, the exact inverse of the density direction's
    (the torch reference sums it over the batch)."""

    def __init__(self, dimension=1, always_parametrize_in_embedding_space=0,
                 project_from_gauss_to_simplex=0):
        super().__init__(dimension, always_parametrize_in_embedding_space,
                         project_from_gauss_to_simplex)
        self.num_params += dimension + 2   # log_tau + (d + 1) log_probs
        self.inverse_function_type = "inormal_partly_precise"

    def param_structure(self):
        return [("log_tau", 1), ("log_probs", self.dimension + 1)]

    def _unpack(self, params):
        return params[:, 0:1], params[:, 1:self.dimension + 2]

    @staticmethod
    def _gumbel_log_quantities(x):
        """(log_cdf, log_sf, log_pdf) of the standard Gumbel.  log_sf takes
        -x above 5; the exact branch sees 0 there, so that its unused
        gradient is not NaN."""
        log_cdf = -torch.exp(-x)
        log_pdf = -x - torch.exp(-x)
        large = x > 5.0
        x_safe = torch.where(large, 0.0, x)
        exact = torch.log(-torch.expm1(-torch.exp(-x_safe)))
        return log_cdf, torch.where(large, -x, exact), log_pdf

    def inverse(self, params, x, log_det):
        """Simplex (d intrinsic coordinates) -> standard normal."""
        log_tau, log_probs = self._unpack(params)
        tiny = torch.finfo(x.dtype).tiny
        d_plus_1 = 1.0 - torch.sum(x, dim=1, keepdim=True)
        log_joined = torch.log(torch.clamp(torch.cat([x, d_plus_1], dim=1),
                                           min=tiny))
        log_det = log_det + (self.dimension * log_tau[:, 0]
                             - torch.sum(log_joined, dim=-1))
        transformed = torch.exp(log_tau) * (
            log_joined[:, :-1] - torch.log(torch.clamp(d_plus_1, min=tiny)))
        normal_gumbel = transformed - log_probs[:, :-1] + log_probs[:, -1:]
        log_cdf, log_sf, log_pdf = self._gumbel_log_quantities(normal_gumbel)
        z = logistic_kde.icdf_pass(log_cdf, log_sf, self.inverse_function_type)
        dld = logistic_kde.icdf_log_derivative(log_cdf, log_sf, log_pdf,
                                               self.inverse_function_type)
        return z, log_det + torch.sum(dld, dim=-1)

    def forward(self, params, z, log_det):
        """Standard normal -> simplex."""
        log_tau, log_probs = self._unpack(params)
        log_uniform = torch.special.log_ndtr(z)
        gumbel = -torch.log(-log_uniform)
        log_det = log_det + torch.sum(
            gumbel - log_uniform - LOG_SQRT_2PI - 0.5 * z**2, dim=-1)
        shifted = gumbel + log_probs[:, :-1] - log_probs[:, -1:]
        args = shifted / torch.exp(log_tau)
        lse = torch.logsumexp(torch.cat([torch.zeros_like(args[:, :1]), args],
                                        dim=1), dim=1, keepdim=True)
        new_coords_log = args - lse
        all_coords_log = torch.cat([new_coords_log, -lse], dim=1)
        log_det = log_det - (self.dimension * log_tau[:, 0]
                             - torch.sum(all_coords_log, dim=-1))
        return torch.exp(new_coords_log), log_det

    def default_params(self, rng=None):
        return np.zeros(self.dimension + 2)
