"""Fully amortized pdf: one outer MLP predicts every parameter of an inner
pdf.

PyTorch counterpart of ``jammy_flows_tpu/models/fully_amortized.py``.  The
inner pdf is built with ``amortize_everything=True``, so all its parameters
- its own amortization MLPs' weights included - arrive as one (B, n) slab
per call, which the outer AmortizableMLP predicts from the conditional
input.  ``inner_mlp_*`` keywords configure the inner pdf's autoregressive
MLPs, ``amortization_mlp_*`` the outer one (defaults: inner highway mode 1,
outer rank 5 in custom mode).  Its parameter dict is {"outer_mlp": (n,)};
with ``predict_log_normalization`` the outer MLP's last output is the
Poisson head's log-mean.
"""
from __future__ import annotations

import numpy as np
import torch

from .amortizable_mlp import AmortizableMLP, list_from_str
from .pdf import PDF


class FullyAmortizedPDF:

    def __init__(self, pdf_defs, flow_defs, options_overwrite=None,
                 conditional_input_dim=None, inner_mlp_dims_sub_pdfs="128",
                 inner_mlp_ranks=0, inner_mlp_highway_mode=1,
                 amortization_mlp_dims="128",
                 amortization_mlp_use_custom_mode=True,
                 amortization_mlp_ranks=5, amortization_mlp_highway_mode=0,
                 predict_log_normalization=False, device=None):
        if not isinstance(conditional_input_dim, int):
            raise ValueError("a fully amortized pdf needs one integer "
                             "conditional_input_dim")
        self.conditional_input_dim = conditional_input_dim
        self.predict_log_normalization = predict_log_normalization
        self.inner_pdf = PDF(pdf_defs, flow_defs,
                             options_overwrite=options_overwrite or {},
                             conditional_input_dim=None,
                             amortization_mlp_dims=inner_mlp_dims_sub_pdfs,
                             amortization_mlp_use_custom_mode=True,
                             amortization_mlp_ranks=inner_mlp_ranks,
                             amortization_mlp_highway_mode=inner_mlp_highway_mode,
                             amortize_everything=True, device=device)
        self.device = self.inner_pdf.device
        self.num_inner_params = self.inner_pdf.total_number_amortizable_params
        # the reference's non-custom mode is a plain Linear chain: a
        # full-rank highway-0 MLP, with the same packing
        if not amortization_mlp_use_custom_mode:
            amortization_mlp_ranks = 0
            amortization_mlp_highway_mode = 0
        self.outer_mlp = AmortizableMLP(
            conditional_input_dim, list_from_str(amortization_mlp_dims),
            self.num_inner_params + int(bool(predict_log_normalization)),
            highway_mode=amortization_mlp_highway_mode,
            low_rank_approximations=amortization_mlp_ranks)

    def init_params(self, seed=0, dtype=torch.float32, data=None):
        """The outer MLP's init, its final bias pinned to the inner pdf's
        slab init (its data-driven init with ``data``; 0 for the Poisson
        output) and everything upstream damped by 1000; the same numpy
        draws as the JAX package."""
        rng = np.random.default_rng(seed)
        fix_bias = self.inner_pdf.default_amortization_params(rng, data=data)
        if self.predict_log_normalization:
            fix_bias = np.concatenate([fix_bias, np.zeros(1)])
        init = self.outer_mlp.default_init(rng, fix_final_bias=fix_bias,
                                           prev_damping_factor=1000.0)
        return {"outer_mlp": torch.as_tensor(init, dtype=dtype,
                                             device=self.device)}

    def _outer(self, params, conditional_input):
        ci = self.inner_pdf._input(conditional_input, "conditional_input")
        return self.outer_mlp.apply(params["outer_mlp"], ci)

    def _inner_amortization(self, params, conditional_input):
        out = self._outer(params, conditional_input)
        return out[:, :self.num_inner_params]

    def log_prob(self, params, x, conditional_input=None):
        """(log_pdf, log_pdf_base, base_pos) of x given the conditional
        input."""
        return self.inner_pdf.log_prob(
            {}, x, amortization_parameters=self._inner_amortization(
                params, conditional_input))

    def sample(self, params, conditional_input=None, generator=None):
        """One draw per conditional input row: (x, base_pos, log_pdf,
        log_pdf_base); base draws from ``generator``."""
        amort = self._inner_amortization(params, conditional_input)
        return self.inner_pdf.sample({}, samplesize=amort.shape[0],
                                     generator=generator,
                                     amortization_parameters=amort)

    def all_layer_forward(self, params, z, log_det, conditional_input=None):
        """Base -> target through the amortized inner pdf."""
        return self.inner_pdf.all_layer_forward(
            {}, z, log_det, amortization_parameters=self._inner_amortization(
                params, conditional_input))

    def all_layer_inverse(self, params, x, log_det, conditional_input=None):
        """Target -> base through the amortized inner pdf."""
        return self.inner_pdf.all_layer_inverse(
            {}, x, log_det, amortization_parameters=self._inner_amortization(
                params, conditional_input))

    def log_mean_poisson(self, params, conditional_input=None):
        """(B, 1): the outer MLP's last output."""
        if not self.predict_log_normalization:
            raise ValueError("the pdf has no Poisson head "
                             "(predict_log_normalization=False)")
        return self._outer(params, conditional_input)[:, -1:]

    def count_parameters(self):
        return self.outer_mlp.num_params


fully_amortized_pdf = FullyAmortizedPDF
