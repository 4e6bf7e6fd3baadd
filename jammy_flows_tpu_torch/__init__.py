"""PyTorch/CUDA port of jammy_flows_tpu: normalizing flows over products of
manifolds, with the Gaussianization-flow kernels hand-written in CUDA for
Hopper (csrc/).

Main entry points:
    pdf                 - joint autoregressive manifold pdf (two-string DSL),
                          with its diagnostics (entropy, coverage, pdf scans,
                          marginal moments)
    fully_amortized_pdf - one outer MLP predicts every parameter of an inner
                          pdf
    train.fit           - maximum-likelihood fitting with checkpoints
    python -m jammy_flows_tpu_torch fit | sample | eval | moments

The JAX package's samplers (inference/, parallel/) are not ported yet."""
from .models.pdf import PDF, pdf
from .models.fully_amortized import FullyAmortizedPDF, fully_amortized_pdf

__all__ = ["PDF", "pdf", "FullyAmortizedPDF", "fully_amortized_pdf"]
