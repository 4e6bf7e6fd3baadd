"""PyTorch/CUDA port of jammy_flows_tpu: normalizing flows over products of
manifolds, with the whole-block Gaussianization-flow kernel hand-written in
CUDA for Hopper (csrc/).  The serving path (``log_prob``, ``sample``) of the
`e4+s2+e4 / gggg+f+gggg` model is ported; see ROADMAP.md for the rest."""
from .models.pdf import PDF, pdf

__all__ = ["PDF", "pdf"]
