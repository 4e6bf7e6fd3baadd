"""The joint autoregressive manifold PDF orchestrator.

PyTorch counterpart of ``jammy_flows_tpu/models/pdf.py`` for the serving and
training paths: the two-string DSL, ``log_prob``, ancestral ``sample`` (both
differentiable in the parameters) and the training objective
``nll_value_and_grad``; the diagnostics (entropy, coverage, pdf scans,
marginal moments) come from models/diagnostics.DiagnosticsMixin.  The
object holds static configuration only; numbers live in a parameter dict
with the JAX package's keys and packing, so a JAX dict loads 1:1
(utils/convert.params_from_jax):

    "flow_0"  : (P0,)  permanent parameters of sub-pdf 0 (unconditional pdfs)
    "mlp_<k>" : (Pk,)  packed AmortizableMLP predicting sub-pdf k

With ``amortize_everything`` the dict is empty: every parameter (sub-pdf
0's layers, then each later MLP's flat weights) arrives per call as the
(Bp, total_number_amortizable_params) slab ``amortization_parameters``
(Bp in {1, B}), sliced by a running counter as in the JAX package
(``pdf.py:418-474``); the simplex layer `w` and the fully amortized model
(models/fully_amortized.py) run such inner pdfs, the `w` layer's as a
passthrough (no projection from the base space on a first layer).

Routing per sub-manifold, as in the JAX package (``pdf.py:488-524``): a
float32 stack of `g` layers that ops/gf_block.block_meta accepts runs as one
whole-block op (the CUDA kernel on the card, its plain version on the CPU)
with permanent parameters ("perm"), the fused one-hidden-layer tanh MLP
("lazy2", when the summary is at most 128 wide) or the precomputed hidden
activations of any other MLP that splits at its final matrix ("lazy"); an
amortizing MLP whose final hidden width exceeds gf_block.MAX_KERNEL_H (1024)
sends its block layer by layer, with materialized rows.  An s2 stack runs on
the (z, phi) column path when every layer has that form (not the `f`
layer's correlated flow or in-between rotation, nor a layer in embedding
space); other stacks run layer by layer on rows (float32
`g` layers through the per-layer kernels of ops/gf_layer.py, with the
amortization MLP's final product in the kernel when its rows stay factored
as LazyParams; circle, interval and simplex layers in plain PyTorch, their
amortized parameters materialized).

Entry points run on the card unless the caller passes ``device="cpu"``; with
no device given and no CUDA, the constructor raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import registry
from ..ops import gf_block, manifold
from ..ops.lazy_params import LazyParams, for_layer, materialize_if_lazy
from ..ops.special import LOG_SQRT_2PI, std_normal_log_prob
from .amortizable_mlp import AmortizableMLP, list_from_str
from .diagnostics import DiagnosticsMixin
from .init import find_init_pars_of_chained_blocks

def resolve_device(device=None):
    """torch.device for the port's entry points: the current CUDA device
    unless the caller names one; raises when no CUDA device exists."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "port's plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _parse_subspace(token):
    """'e4' -> ('e', 4, None); 'i1_-1.0_1.0' -> ('i', 1, (-1.0, 1.0)), an
    interval without bounds (0, 1)."""
    parts = token.split("_")
    mtype, dim = parts[0][0], int(parts[0][1:])
    if mtype != "i":
        return mtype, dim, None
    if len(parts) >= 3:
        return mtype, dim, (float(parts[1]), float(parts[2]))
    return mtype, dim, (0.0, 1.0)


def _resolve_flow_options(flow_defs_list, options_overwrite):
    """3-level option override precedence: (manifold, layer) tuple >
    manifold int > flow symbol.  An int key, or a tuple key's first index,
    must name a sub-pdf (``ValueError`` otherwise, where the JAX package
    asserts); a tuple key's layer index is not checked, as there."""
    n_sub = len(flow_defs_list)
    for k in options_overwrite:
        ind = k[0] if isinstance(k, tuple) else k
        if isinstance(ind, int) and not isinstance(ind, bool) \
                and not 0 <= ind < n_sub:
            raise ValueError(f"options_overwrite key {k!r}: the model has "
                             f"sub-pdfs 0..{n_sub - 1}")
    flow_opts = {}
    for ind, cur_flow_defs in enumerate(flow_defs_list):
        flow_opts[ind] = []
        for cur_flow_index, abbrv in enumerate(cur_flow_defs):
            opts = registry.obtain_default_options(abbrv)
            found_specific = False
            for k, v in options_overwrite.items():
                if isinstance(k, tuple) and k == (ind, cur_flow_index):
                    found_specific = True
                    for detail_abbrv, detail_opts in v.items():
                        if detail_abbrv != abbrv:
                            raise ValueError(f"override for {k} names "
                                             f"{detail_abbrv}, layer is {abbrv}")
                        for o, ov in detail_opts.items():
                            registry.check_flow_option(abbrv, o, ov)
                            opts[o] = ov
            if not found_specific:
                for k, v in options_overwrite.items():
                    if isinstance(k, int) and not isinstance(k, bool) \
                            and k == ind and abbrv in v:
                        found_specific = True
                        for o, ov in v[abbrv].items():
                            registry.check_flow_option(abbrv, o, ov)
                            opts[o] = ov
            if not found_specific and abbrv in options_overwrite:
                for o, ov in options_overwrite[abbrv].items():
                    registry.check_flow_option(abbrv, o, ov)
                    opts[o] = ov
            flow_opts[ind].append(opts)
    return flow_opts


class PDF(DiagnosticsMixin):
    """Joint autoregressive (conditional) normalizing-flow PDF over products
    of manifolds, defined by a two-string DSL - e.g.
    ``PDF("e4+s2+e4", "gggg+f+gggg")``."""

    def __init__(self, pdf_defs, flow_defs, options_overwrite=None,
                 conditional_input_dim=None, amortization_mlp_dims="128",
                 predict_log_normalization=False,
                 join_poisson_and_pdf_description=False,
                 hidden_mlp_dims_poisson="128",
                 rank_of_mlp_mappings_poisson=0,
                 amortization_mlp_use_custom_mode=False,
                 amortization_mlp_ranks=0, amortization_mlp_highway_mode=0,
                 amortize_everything=False,
                 use_as_passthrough_instead_of_pdf=False,
                 skip_mlp_initialization=False, verbose=False, device=None):
        self.device = resolve_device(device)
        self.pdf_defs_list = pdf_defs.split("+")
        self.flow_defs_list = flow_defs.split("+")
        n_sub = len(self.pdf_defs_list)
        if len(self.flow_defs_list) != n_sub:
            raise ValueError((self.pdf_defs_list, self.flow_defs_list))
        # an int, or a list: one conditional input per sub-pdf
        if isinstance(conditional_input_dim, (list, tuple)):
            conditional_input_dim = list(conditional_input_dim)
            if len(conditional_input_dim) != n_sub:
                raise ValueError(f"{len(conditional_input_dim)} conditional "
                                 f"input widths for {n_sub} sub-pdfs")
        self.conditional_input_dim = conditional_input_dim
        self.encoding_type = "multi" if isinstance(conditional_input_dim,
                                                   list) else "single"
        self.predict_log_normalization = predict_log_normalization
        self.join_poisson_and_pdf_description = \
            join_poisson_and_pdf_description
        if amortize_everything and predict_log_normalization:
            raise ValueError("a Poisson head with amortize_everything exists "
                             "only in the fully amortized pdf")
        if join_poisson_and_pdf_description and (
                n_sub != 1 or conditional_input_dim is None):
            raise ValueError("join_poisson_and_pdf_description needs one "
                             "conditional sub-pdf")
        # stored with no effect, as in the JAX package (``verbose`` only
        # reaches its option resolution, which ignores it)
        self.skip_mlp_initialization = skip_mlp_initialization
        self.force_permanent_parameters_in_first_subpdf = (
            conditional_input_dim is None and not amortize_everything)
        self.amortization_mlp_highway_mode = amortization_mlp_highway_mode
        # accepted with no effect, as in the JAX PDF: only the fully
        # amortized model reads it
        self.amortization_mlp_use_custom_mode = amortization_mlp_use_custom_mode
        self.amortize_everything = amortize_everything
        self.use_as_passthrough_instead_of_pdf = \
            use_as_passthrough_instead_of_pdf
        self.amortization_mlp_dims = [amortization_mlp_dims] * n_sub \
            if isinstance(amortization_mlp_dims, str) \
            else list(amortization_mlp_dims)
        self.amortization_mlp_ranks = [amortization_mlp_ranks] * n_sub \
            if isinstance(amortization_mlp_ranks, (int, str)) \
            else list(amortization_mlp_ranks)
        self.flow_opts = _resolve_flow_options(self.flow_defs_list,
                                               options_overwrite or {})
        self._build_layers()
        self._update_embedding_structure()
        self._build_mlps(hidden_mlp_dims_poisson, rank_of_mlp_mappings_poisson)
        self._block_meta = [gf_block.block_meta(layers)
                            for layers in self.layer_list]

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def _build_layers(self):
        """Instantiate the layers with the auto-injected options: the last
        Euclidean layer gets an offset, the first `g` layer of a stack swaps
        isigmoid for inormal_partly_precise, the first spherical layer
        projects from the plane, the first interval layer from the real line
        and the first simplex layer from the Gaussian (none of the three
        in a passthrough pdf), every interval layer taking the
        sub-manifold's bounds."""
        first = int(not self.use_as_passthrough_instead_of_pdf)
        self.layer_list = []
        self.num_parameter_list = []
        for sub_idx, sub_def in enumerate(self.pdf_defs_list):
            mtype, dim, bounds = _parse_subspace(sub_def)
            flow_str = self.flow_defs_list[sub_idx]
            layers = []
            for layer_ind, sym in enumerate(flow_str):
                if registry.manifold_type(sym) != mtype:
                    raise ValueError(f"layer {sym} incompatible with manifold "
                                     f"{sub_def}")
                kwargs = dict(self.flow_opts[sub_idx][layer_ind])
                if mtype == "s":
                    kwargs["euclidean_to_sphere_as_first"] = int(
                        layer_ind == 0) * first
                    if sym == "f":    # its nested pdfs run on this device
                        kwargs["device"] = self.device
                elif mtype == "i":
                    kwargs["low_boundary"], kwargs["high_boundary"] = bounds
                    kwargs["euclidean_to_interval_as_first"] = int(
                        layer_ind == 0) * first
                elif mtype == "a":
                    kwargs["project_from_gauss_to_simplex"] = int(
                        layer_ind == 0) * first
                    if sym == "w":    # its inner pdf runs on this pdf's device
                        kwargs["device"] = self.device
                elif mtype == "e" and sym != "x":
                    if layer_ind == len(flow_str) - 1 and \
                            kwargs.get("skip_model_offset", 0) == 0:
                        kwargs["model_offset"] = 1
                    elif layer_ind == 0 and sym in ("g", "h") and \
                            kwargs.get("replace_first_sigmoid_with_icdf", 0) > 0 \
                            and kwargs.get("inverse_function_type") == "isigmoid":
                        kwargs["inverse_function_type"] = "inormal_partly_precise"
                kwargs.pop("skip_model_offset", None)
                kwargs.pop("replace_first_sigmoid_with_icdf", None)
                layers.append(registry.get_layer_class(sym)(dim, **kwargs))
            self.layer_list.append(layers)
            self.num_parameter_list.append([l.num_params for l in layers])

    def _update_embedding_structure(self):
        """Each sub-pdf's target columns in its default, intrinsic and
        embedding coordinates, and its base columns: a sub-pdf whose layers
        parametrize in embedding space takes embedded target coordinates by
        default (``pdf.py:223-250`` of the JAX package)."""
        self.target_dim_indices = []
        self.target_dim_indices_intrinsic = []
        self.target_dim_indices_embedded = []
        self.base_dim_indices = []
        td = ti = te = tb = 0
        for layers in self.layer_list:
            use_emb = any(l.always_parametrize_in_embedding_space
                          for l in layers)
            d_int = layers[-1].intrinsic_dim
            d_emb = layers[-1].embedded_dim
            d_tgt = d_emb if use_emb else d_int
            d_base = layers[0].base_dim
            self.target_dim_indices.append((td, td + d_tgt))
            self.target_dim_indices_intrinsic.append((ti, ti + d_int))
            self.target_dim_indices_embedded.append((te, te + d_emb))
            self.base_dim_indices.append((tb, tb + d_base))
            td += d_tgt
            ti += d_int
            te += d_emb
            tb += d_base
        self.total_target_dim = td
        self.total_target_dim_intrinsic = ti
        self.total_target_dim_embedded = te
        self.total_base_dim = tb

    def _build_mlps(self, hidden_mlp_dims_poisson="128",
                    rank_of_mlp_mappings_poisson=0):
        """Per-sub-pdf amortization MLPs: sub-pdf k reads [its conditional
        input (the k-th of a list), embeddings of sub-pdfs < k].  With
        ``amortize_everything``, total_number_amortizable_params counts the
        slab: sub-pdf 0's layer parameters when it has no MLP, then every
        MLP's flat weights.  A Poisson log-mean head is one more output of
        sub-pdf 0's MLP (``join_poisson_and_pdf_description``) or an MLP of
        its own on the (first) conditional input
        (``pdf.py:271-315`` of the JAX package)."""
        self.mlp_predictors = []
        self.total_number_amortizable_params = \
            0 if self.amortize_everything else None
        prev_extra_input_num = 0
        for k in range(len(self.pdf_defs_list)):
            tot_pars = sum(self.num_parameter_list[k])
            emb_dim_k = self.layer_list[k][-1].embedded_dim
            if (k == 0 and self.conditional_input_dim is None) or tot_pars == 0:
                self.mlp_predictors.append(None)
                prev_extra_input_num += emb_dim_k
                if k == 0 and self.amortize_everything:
                    self.total_number_amortizable_params += tot_pars
                continue
            cd = self.conditional_input_dim
            summary_dim = prev_extra_input_num + (
                cd[k] if isinstance(cd, list) else cd or 0)
            self.mlp_predictors.append(AmortizableMLP(
                summary_dim, list_from_str(self.amortization_mlp_dims[k]),
                tot_pars + int(k == 0 and self._joined_poisson()),
                low_rank_approximations=self.amortization_mlp_ranks[k],
                highway_mode=self.amortization_mlp_highway_mode))
            if self.amortize_everything:
                self.total_number_amortizable_params += \
                    self.mlp_predictors[k].num_params
            prev_extra_input_num += emb_dim_k
        self.log_normalization_mlp = None
        if self.predict_log_normalization and \
                self.conditional_input_dim is not None and \
                not self.join_poisson_and_pdf_description:
            cd = self.conditional_input_dim
            self.log_normalization_mlp = AmortizableMLP(
                cd[0] if isinstance(cd, list) else cd,
                list_from_str(hidden_mlp_dims_poisson), 1,
                low_rank_approximations=rank_of_mlp_mappings_poisson,
                highway_mode=self.amortization_mlp_highway_mode)

    def _joined_poisson(self):
        return self.predict_log_normalization and \
            self.join_poisson_and_pdf_description

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def _data_init(self, layers, data, rng):
        """The data-driven init vector of a Euclidean first sub-pdf's chain
        (models/init.py)."""
        if self.pdf_defs_list[0][0] != "e":
            raise ValueError("data-driven init needs a Euclidean first "
                             "sub-pdf")
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        return find_init_pars_of_chained_blocks(layers, np.asarray(data), rng)

    def init_params(self, seed=0, dtype=torch.float32, data=None):
        """Parameter dict: layer init vectors for permanent parameters; each
        MLP gets kaiming init, its final bias pinned to the layers' init
        vector (and 0 for a joined Poisson output) and everything upstream
        damped by 1000; a standalone Poisson MLP's final bias is -1, an
        unconditional Poisson head's ``log_lambda`` 0.  With ``data`` (N, D)
        sub-pdf 0's chain starts from its data-driven init
        (models/init.py).  Same numpy RNG sequence as the JAX package, so
        the values are equal.  Empty with ``amortize_everything`` (see
        default_amortization_params)."""
        rng = np.random.default_rng(seed)
        desired = [np.concatenate([l.default_params(rng) for l in layers])
                   if sum(self.num_parameter_list[k]) > 0 else np.zeros(0)
                   for k, layers in enumerate(self.layer_list)]
        if data is not None:
            desired[0] = self._data_init(self.layer_list[0], data, rng)
        params = {}
        if self.amortize_everything:
            return params
        for k in range(len(self.layer_list)):
            if self.mlp_predictors[k] is not None:
                fix = desired[k]
                if k == 0 and self._joined_poisson():
                    fix = np.concatenate([fix, np.zeros(1)])
                params[f"mlp_{k}"] = self.mlp_predictors[k].default_init(
                    rng, fix_final_bias=fix, prev_damping_factor=1000.0)
            elif k == 0 and self.force_permanent_parameters_in_first_subpdf \
                    and desired[0].size:
                params["flow_0"] = desired[0]
        if self.predict_log_normalization and \
                not self.join_poisson_and_pdf_description:
            if self.log_normalization_mlp is not None:
                params["poisson_mlp"] = self.log_normalization_mlp.default_init(
                    rng, fix_final_bias=np.array([-1.0]),
                    prev_damping_factor=1000.0)
            else:
                params["log_lambda"] = np.zeros(1)
        return {key: torch.as_tensor(v, dtype=dtype, device=self.device)
                for key, v in params.items()}

    def default_amortization_params(self, rng=None, data=None):
        """The init vector (numpy float64) of an ``amortize_everything``
        pdf's whole slab: sub-pdf 0's layer init vector when it has no MLP
        (its data-driven init with ``data``), each MLP's init with its final
        bias pinned to its layers' vector and everything upstream damped by
        1000 (``pdf.py:370-399`` of the JAX package)."""
        if not self.amortize_everything:
            raise ValueError("default_amortization_params needs "
                             "amortize_everything=True")
        rng = rng or np.random.default_rng(0)
        parts = []
        for k, layers in enumerate(self.layer_list):
            if k == 0 and data is not None:
                parts.append(self._data_init(layers, data, rng))
                continue
            desired = [l.default_params(rng) for l in layers]
            desired = np.concatenate(desired) if desired else np.zeros(0)
            mlp = self.mlp_predictors[k]
            parts.append(desired if mlp is None else mlp.default_init(
                rng, fix_final_bias=desired, prev_damping_factor=1000.0))
        vec = np.concatenate(parts) if parts else np.zeros(0)
        if len(vec) != self.total_number_amortizable_params:
            raise ValueError((len(vec), self.total_number_amortizable_params))
        return vec

    def count_parameters(self, params=None):
        """The number of trainable parameters: every MLP's, sub-pdf 0's
        permanent ones and the Poisson head's."""
        total = 0
        for k, mlp in enumerate(self.mlp_predictors):
            if mlp is not None:
                total += mlp.num_params
            elif k == 0 and self.force_permanent_parameters_in_first_subpdf:
                total += sum(self.num_parameter_list[0])
        if self.predict_log_normalization and \
                not self.join_poisson_and_pdf_description:
            total += self.log_normalization_mlp.num_params \
                if self.log_normalization_mlp is not None else 1
        return total

    # ------------------------------------------------------------------
    # conditioning / parameter prediction
    # ------------------------------------------------------------------
    def _amortization_parts(self, amortization_parameters):
        """Each sub-pdf's columns of the amortization slab (Bp, >= the
        widths), or None: an MLP's flat weights, or sub-pdf 0's layer
        parameters in an ``amortize_everything`` pdf; one ``torch.split``,
        whose backward is one concatenation (a slice each would make a
        slab-sized gradient each)."""
        n_sub = len(self.layer_list)
        if amortization_parameters is None:
            if self.amortize_everything:
                raise ValueError("an amortize_everything pdf takes its "
                                 "parameters as amortization_parameters")
            return [None] * n_sub
        slab = self._input(amortization_parameters, "amortization_parameters")
        widths = [mlp.num_params if mlp is not None
                  else sum(self.num_parameter_list[0])
                  if k == 0 and self.amortize_everything else 0
                  for k, mlp in enumerate(self.mlp_predictors)]
        if slab.ndim != 2 or slab.shape[1] < sum(widths):
            raise ValueError(f"amortization slab of shape {tuple(slab.shape)}"
                             f", the pdf reads {sum(widths)} columns")
        parts = torch.split(slab, widths + [slab.shape[1] - sum(widths)],
                            dim=1)
        return [p if w else None for p, w in zip(parts, widths)]

    def _predict_extra_params(self, params, k, data_summary_parts,
                              conditional_input, amort=None):
        """Sub-pdf k's parameters: its columns ``amort`` of the amortization
        slab (a sub-pdf without an MLP), or its MLP applied to them; a (1,
        P) permanent slab; in float32,
        LazyParams when the MLP splits at its final matrix: the fused MLP's
        summary and first layer for a block the fused mode takes (a
        one-hidden-layer tanh MLP, a summary at most 128 wide, H at most
        MAX_KERNEL_H: ``pdf.py:499-503`` of the JAX package), else the
        hidden activations, made once here for the block's lazy mode or the
        per-layer kernels; a materialized (B, P) slab otherwise; or None
        (``pdf.py:446-455``).  A joined Poisson head's output, the MLP's
        last, is left out."""
        mlp = self.mlp_predictors[k]
        if mlp is None:
            if sum(self.num_parameter_list[k]) == 0:
                return None
            return amort if amort is not None else params["flow_0"][None, :]
        if isinstance(conditional_input, list):
            conditional_input = conditional_input[k]
        parts = ([conditional_input] if conditional_input is not None
                 else []) + list(data_summary_parts)
        if not parts:
            raise ValueError("autoregressive conditioning input required")
        summary = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        extra = self._mlp_params(params, k, mlp, summary, amort)
        if k == 0 and self._joined_poisson():
            n = sum(self.num_parameter_list[0])
            extra = extra.rows(0, n) if isinstance(extra, LazyParams) \
                else extra[:, :n]
        return extra

    def _mlp_params(self, params, k, mlp, summary, amort):
        if amort is not None:
            return mlp.apply(amort, summary)
        flat = params[f"mlp_{k}"]
        if summary.dtype == torch.float32 and mlp.supports_penultimate():
            w, b = mlp.final_layer_weights(flat)
            if (mlp.supports_full_fusion() and self._block_meta[k] is not None
                    and summary.shape[1] <= gf_block.MAX_FUSED_SUMMARY
                    and w.shape[1] <= gf_block.MAX_KERNEL_H):
                w1, b1 = mlp.first_layer_weights(flat)
                return LazyParams(w, b, summary=summary.contiguous(), w1=w1,
                                  b1=b1)
            return LazyParams(w, b, hidden=mlp.apply_penultimate(flat,
                                                                 summary))
        return mlp.apply(flat, summary)

    # ------------------------------------------------------------------
    # core mappings
    # ------------------------------------------------------------------
    def _try_block(self, k, extra, target, direction):
        """Sub-manifold k's whole gggg stack as one block op, or None
        (``pdf.py:488-524`` of the JAX package).  Returns (out, ld summed
        over dims)."""
        info = self._block_meta[k]
        if target.dtype != torch.float32 or info is None or extra is None:
            return None
        prep, meta = info
        target = target.contiguous()
        if isinstance(extra, LazyParams):
            if extra.w.shape[1] > gf_block.MAX_KERNEL_H:
                return None
            if extra.summary is not None:
                fn = (gf_block.gf_block_density_lazy2 if direction == "density"
                      else gf_block.gf_block_sample_lazy2)
                out, ld = fn(target, extra.summary, extra.w1, extra.b1,
                             extra.w, extra.b, prep, meta)
            else:
                fn = (gf_block.gf_block_density_lazy if direction == "density"
                      else gf_block.gf_block_sample_lazy)
                out, ld = fn(target, extra.hidden.contiguous(), extra.w,
                             extra.b, prep, meta)
        elif extra.shape[0] == 1:
            fn = gf_block.gf_block_density_perm if direction == "density" \
                else gf_block.gf_block_sample_perm
            out, ld = fn(target, extra[0], prep, meta)
        else:
            return None
        return out, ld.sum(dim=-1)

    def _zphi_columns(self, k, extra, target, log_det, direction):
        """Run s2 sub-manifold k's stack on flat (z = cos(theta), phi)
        columns.  The sub-manifold's boundary coordinates are (theta, phi);
        its first layer projects from or to the plane, or, in a passthrough
        pdf, the stack starts from (theta, phi) too.  Slicing mirrors the
        row loops: front for forward, back-reversed for inverse."""
        layers = self.layer_list[k]
        if extra is None:
            slab = torch.zeros((0, 1), dtype=target.dtype, device=target.device)
        elif isinstance(extra, LazyParams):
            slab = extra.materialize_T()
        else:
            slab = extra.T
        cols = (target[:, 0], target[:, 1])
        cnt = 0
        if direction == "density":
            theta = manifold.safe_angle_within_pi(cols[0])
            log_det = log_det + torch.log(torch.sin(theta))
            cols = (torch.cos(theta), cols[1])
            total = slab.shape[0]
            for layer in reversed(layers):
                p = layer.num_params
                hi = total - cnt
                cols, log_det = layer.inverse_cols_z(slab[hi - p:hi], cols,
                                                     log_det)
                cnt += p
            if not layers[0].euclidean_to_sphere_as_first:
                cols, log_det = self._z_to_theta(cols, log_det)
        else:
            if not layers[0].euclidean_to_sphere_as_first:
                theta = manifold.safe_angle_within_pi(cols[0])
                log_det = log_det + torch.log(torch.sin(theta))
                cols = (torch.cos(theta), cols[1])
            for layer in layers:
                p = layer.num_params
                cols, log_det = layer.forward_cols_z(slab[cnt:cnt + p], cols,
                                                     log_det)
                cnt += p
            cols, log_det = self._z_to_theta(cols, log_det)
        return torch.stack(cols, dim=1), log_det

    @staticmethod
    def _z_to_theta(cols, log_det):
        theta = torch.arccos(manifold.safe_costheta(cols[0]))
        log_det = log_det - torch.log(torch.sin(
            manifold.safe_angle_within_pi(theta)))
        return (theta, cols[1]), log_det

    @staticmethod
    def _layer_slab(extra, lo, hi, target, layer):
        """Layer columns lo:hi: LazyParams rows for a layer that takes them
        (``pdf.py:636-648`` of the JAX package), else a tensor."""
        if extra is None or hi == lo:
            return torch.zeros((target.shape[0], 0), dtype=target.dtype,
                               device=target.device)
        if isinstance(extra, LazyParams):
            return for_layer(extra.rows(lo, hi), layer)
        return extra[:, lo:hi]

    def _apply_stack(self, k, extra, target, log_det, direction):
        """Sub-manifold k's layer stack in one direction: whole-block op,
        (z, phi) column path (an s2 stack whose every layer has that form),
        or the per-layer row loop (``pdf.py:534-650`` of the JAX package,
        without its (theta, phi) columns)."""
        fused = self._try_block(k, extra, target, direction)
        if fused is not None:
            out, ld_sum = fused
            return out, (log_det + ld_sum if direction == "density"
                         else log_det - ld_sum)
        if self.pdf_defs_list[k] == "s2" and all(
                l.supports_zphi() for l in self.layer_list[k]):
            return self._zphi_columns(k, extra, target, log_det, direction)
        layers = self.layer_list[k]
        total = sum(self.num_parameter_list[k])
        cnt = 0
        if direction == "density":
            for layer in reversed(layers):
                p = layer.num_params
                sl = self._layer_slab(extra, total - cnt - p, total - cnt,
                                      target, layer)
                target, log_det = layer.inverse(sl, target, log_det)
                cnt += p
        else:
            for layer in layers:
                p = layer.num_params
                sl = self._layer_slab(extra, cnt, cnt + p, target, layer)
                target, log_det = layer.forward(sl, target, log_det)
                cnt += p
        return target, log_det

    def _input(self, t, name):
        if not isinstance(t, torch.Tensor):
            return torch.as_tensor(t, device=self.device)
        if t.device != self.device:
            raise ValueError(f"{name} is on {t.device}, the pdf runs on "
                             f"{self.device}")
        return t

    def _conditional(self, conditional_input):
        """None, a tensor, or (a list-valued conditional_input_dim) a list
        of one tensor per sub-pdf, each on the pdf's device."""
        if conditional_input is None:
            return None
        if isinstance(conditional_input, (list, tuple)):
            return [self._input(c, "conditional_input")
                    for c in conditional_input]
        return self._input(conditional_input, "conditional_input")

    def all_layer_inverse(self, params, x, log_det, conditional_input=None,
                          amortization_parameters=None,
                          force_embedding_coordinates=False,
                          force_intrinsic_coordinates=False):
        """Autoregressive target -> base mapping; x in the default
        coordinates, or the embedding / intrinsic ones when forced."""
        x = self._input(x, "x")
        coords = "embedding" if force_embedding_coordinates else \
            "intrinsic" if force_intrinsic_coordinates else None
        width = {None: self.total_target_dim,
                 "embedding": self.total_target_dim_embedded,
                 "intrinsic": self.total_target_dim_intrinsic}[coords]
        if x.shape[1] != width:
            raise ValueError((x.shape[1], width))
        if coords is not None:
            x, log_det = self.transform_target_space(
                x, log_det, transform_from=coords, transform_to="default")
        conditional_input = self._conditional(conditional_input)
        amort = self._amortization_parts(amortization_parameters)
        summaries = []
        base_targets = []
        for k, layers in enumerate(self.layer_list):
            extra = self._predict_extra_params(params, k, summaries,
                                               conditional_input, amort[k])
            lo, hi = self.target_dim_indices[k]
            out, log_det = self._apply_stack(k, extra, x[:, lo:hi], log_det,
                                             "density")
            base_targets.append(out)
            summaries.append(layers[-1].embedding_conditional_return(
                x[:, lo:hi]))
        return torch.cat(base_targets, dim=1), log_det

    def all_layer_forward(self, params, z, log_det, conditional_input=None,
                          amortization_parameters=None,
                          force_embedding_coordinates=False,
                          force_intrinsic_coordinates=False):
        """Autoregressive base -> target mapping; the targets in the default
        coordinates, or the embedding / intrinsic ones when forced."""
        z = self._input(z, "z")
        conditional_input = self._conditional(conditional_input)
        amort = self._amortization_parts(amortization_parameters)
        summaries = []
        new_targets = []
        for k, layers in enumerate(self.layer_list):
            extra = self._predict_extra_params(params, k, summaries,
                                               conditional_input, amort[k])
            lo, hi = self.base_dim_indices[k]
            out, log_det = self._apply_stack(k, extra, z[:, lo:hi], log_det,
                                             "sample")
            new_targets.append(out)
            summaries.append(layers[-1].embedding_conditional_return(out))
        x = torch.cat(new_targets, dim=1)
        if force_embedding_coordinates or force_intrinsic_coordinates:
            x, log_det = self.transform_target_space(
                x, log_det, transform_from="default",
                transform_to="embedding" if force_embedding_coordinates
                else "intrinsic")
        return x, log_det

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def log_prob(self, params, x, conditional_input=None,
                 amortization_parameters=None,
                 force_embedding_coordinates=False,
                 force_intrinsic_coordinates=False):
        """log p(x [| c]).  Returns (log_pdf, log_pdf_base, base_pos).  A
        passthrough pdf has no density of its own (ValueError)."""
        if self.use_as_passthrough_instead_of_pdf:
            raise ValueError("a passthrough pdf (use_as_passthrough_instead_"
                             "of_pdf) has no log_prob: call all_layer_inverse")
        x = self._input(x, "x")
        log_det = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        base_pos, log_det = self.all_layer_inverse(
            params, x, log_det, conditional_input,
            amortization_parameters=amortization_parameters,
            force_embedding_coordinates=force_embedding_coordinates,
            force_intrinsic_coordinates=force_intrinsic_coordinates)
        log_base = std_normal_log_prob(base_pos)
        return log_base + log_det, log_base, base_pos

    @staticmethod
    def _value_and_grad(fn, params):
        """(fn(params), d fn / d params) by autograd, on detached leaves."""
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            value = fn(leaves)
            got = torch.autograd.grad(value, list(leaves.values()),
                                      allow_unused=True) if leaves else ()
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), got)}
        return value.detach(), grads

    def nll_value_and_grad(self, params, x, conditional_input=None):
        """(mean NLL, gradient dict): the training objective
        ``-log_prob(params, x, conditional_input)[0].mean()`` and its
        gradient, with the routing of the JAX package (``pdf.py:802-902``).

        In the density direction the autoregressive conditioning reads the
        data, never a computed output, so each sub-pdf's NLL term decouples
        and the cotangents of a block's outputs are known before the loss:
        1/B times its base position and -1/B for its log-det.  Each float32
        sub-manifold that runs as one perm or lazy2 block op therefore takes
        one fused call (``gf_block_nll_perm`` / ``gf_block_nll_lazy2``:
        forward and backward together); any other sub-pdf (a block in the
        lazy mode: the block forward and backward kernels; the s2 `f` layer)
        takes autograd of its own NLL term; float64, and a pdf with a Poisson
        head, take autograd of the whole objective (``pdf.py:828-831`` of the
        JAX package).  A passthrough or ``amortize_everything`` pdf has
        no objective of its own here (ValueError; the JAX package's fails
        its assertion)."""
        if self.use_as_passthrough_instead_of_pdf or self.amortize_everything:
            raise ValueError("nll_value_and_grad needs a pdf with its own "
                             "parameters (not a passthrough or "
                             "amortize_everything pdf)")
        x = self._input(x, "x")
        conditional_input = self._conditional(conditional_input)
        if x.dtype != torch.float32 or self.predict_log_normalization:
            return self._value_and_grad(
                lambda pp: -self.log_prob(pp, x, conditional_input)[0].mean(),
                params)
        n = x.shape[0]
        wv, wl = 1.0 / n, -1.0 / n
        summaries = []
        for k, layers in enumerate(self.layer_list):
            lo, hi = self.target_dim_indices[k]
            summaries.append(layers[-1].embedding_conditional_return(
                x[:, lo:hi]))
        fixed = {k: v.detach() for k, v in params.items()}
        loss = torch.zeros((), dtype=x.dtype, device=x.device)
        grads = {k: torch.zeros_like(v) for k, v in fixed.items()}
        for k in range(len(self.layer_list)):
            lo, hi = self.target_dim_indices[k]
            target = x[:, lo:hi].contiguous()
            parts = summaries[:k]
            extra = self._predict_extra_params(fixed, k, parts,
                                               conditional_input)
            info = self._block_meta[k]
            fused = None
            if info is not None and extra is not None:
                prep, meta = info
                if isinstance(extra, LazyParams):
                    if extra.summary is not None:
                        val, ld, _, (_, gw1, gb1, gw, gb) = \
                            gf_block.gf_block_nll_lazy2(
                                target, extra.summary, extra.w1, extra.b1,
                                extra.w, extra.b, prep, meta, wv, wl)
                        fused = (f"mlp_{k}", self.mlp_predictors[k]
                                 .fused_grads_to_flat(gw1, gb1, gw, gb))
                elif extra.shape[0] == 1:
                    val, ld, _, (gpvec,) = gf_block.gf_block_nll_perm(
                        target, extra[0], prep, meta, wv, wl)
                    fused = ("flow_0", gpvec)
            if fused is not None:
                grads[fused[0]] = grads[fused[0]] + fused[1]
                loss = loss + (0.5 * val * val + LOG_SQRT_2PI).sum(
                    dim=-1).mean() - ld.sum(dim=-1).mean()
                continue

            def sub_nll(pp, k=k, parts=parts, target=target):
                ep = self._predict_extra_params(pp, k, parts,
                                                conditional_input)
                log_det = torch.zeros(n, dtype=x.dtype, device=x.device)
                out, log_det = self._apply_stack(k, ep, target, log_det,
                                                 "density")
                return -(std_normal_log_prob(out) + log_det).mean()

            lk, gk = self._value_and_grad(sub_nll, fixed)
            loss = loss + lk
            grads = {key: grads[key] + gk[key] for key in grads}
        return loss, grads

    def sample(self, params, samplesize=1, conditional_input=None,
               generator=None, dtype=None, amortization_parameters=None,
               force_embedding_coordinates=False,
               force_intrinsic_coordinates=False,
               failsafe_crosscheck_tolerance=None, failsafe_rounds=3):
        """Ancestral sampling.  Returns (x, base_pos, log_pdf, log_pdf_base).
        Base draws come from ``generator`` (a torch.Generator on the pdf's
        device); with a conditional input the batch size is its row count
        (its first tensor's, for a list).  The dtype is the conditional
        input's, else ``dtype``, else the parameters' (or the amortization
        slab's).

        ``failsafe_crosscheck_tolerance``: each of ``failsafe_rounds`` rounds
        evaluates log_prob of the samples and redraws the rows whose two
        log-densities differ by more than the tolerance, merged in with
        ``torch.where`` (``pdf.py:947-958`` of the JAX package); a row still
        off after the last round keeps its last draw.  The forced
        coordinates apply to the returned samples and their density."""
        conditional_input = self._conditional(conditional_input)
        if conditional_input is not None:
            first = conditional_input[0] \
                if isinstance(conditional_input, list) else conditional_input
            n = first.shape[0]
            dtype = first.dtype
        else:
            n = samplesize
            if dtype is None:
                dtype = next(iter(params.values()),
                             amortization_parameters).dtype

        def draw():
            z = torch.randn((n, self.total_base_dim), generator=generator,
                            dtype=dtype, device=self.device)
            log_base = std_normal_log_prob(z)
            log_det = torch.zeros(n, dtype=dtype, device=self.device)
            x, log_det = self.all_layer_forward(
                params, z, log_det, conditional_input,
                amortization_parameters=amortization_parameters)
            return x, z, log_base - log_det, log_base

        x, z, log_pdf, log_base = draw()
        if failsafe_crosscheck_tolerance is not None:
            for _ in range(failsafe_rounds):
                lp_eval = self.log_prob(
                    params, x, conditional_input=conditional_input,
                    amortization_parameters=amortization_parameters)[0]
                bad = (lp_eval - log_pdf).abs() > failsafe_crosscheck_tolerance
                x2, z2, lp2, lb2 = draw()
                x = torch.where(bad[:, None], x2, x)
                z = torch.where(bad[:, None], z2, z)
                log_pdf = torch.where(bad, lp2, log_pdf)
                log_base = torch.where(bad, lb2, log_base)
        if force_embedding_coordinates or force_intrinsic_coordinates:
            x, neg_ld = self.transform_target_space(
                x, torch.zeros(n, dtype=dtype, device=self.device),
                transform_from="default",
                transform_to="embedding" if force_embedding_coordinates
                else "intrinsic")
            log_pdf = log_pdf - neg_ld
        return x, z, log_pdf, log_base

    def log_mean_poisson(self, params, conditional_input=None,
                         amortization_parameters=None):
        """The Poisson head's log-mean: ``log_lambda`` (1, 1) without a
        conditional input, else (B, 1) from sub-pdf 0's MLP's last output
        (joined) or the standalone Poisson MLP on the (first) conditional
        input."""
        if not self.predict_log_normalization:
            raise ValueError("the pdf has no Poisson head "
                             "(predict_log_normalization=False)")
        if conditional_input is None:
            return params["log_lambda"][None, :]
        ci = self._conditional(conditional_input)
        if isinstance(ci, list):
            ci = ci[0]
        if self.join_poisson_and_pdf_description:
            mlp = self.mlp_predictors[0]
            flat = params["mlp_0"] if amortization_parameters is None else \
                self._input(amortization_parameters,
                            "amortization_parameters")[:, :mlp.num_params]
            return mlp.apply(flat, ci)[:, -1:]
        return self.log_normalization_mlp.apply(params["poisson_mlp"], ci)

    # ------------------------------------------------------------------
    # coordinates and parameter structure
    # ------------------------------------------------------------------
    def get_embedding_flags(self):
        """Each sub-pdf's embedding flag (its layers must agree)."""
        flags = []
        for layers in self.layer_list:
            flag = layers[0].always_parametrize_in_embedding_space
            if any(l.always_parametrize_in_embedding_space != flag
                   for l in layers):
                raise ValueError("a sub-pdf's layers disagree on the "
                                 "embedding flag")
            flags.append(flag)
        return flags

    def set_embedding_flags(self, usement_flag, sub_pdf_index=None):
        """Parametrize every sub-pdf (or the one at ``sub_pdf_index``) in
        embedding space (True) or intrinsic coordinates (False)."""
        if usement_flag not in (True, False):
            raise ValueError(f"embedding flag {usement_flag!r}")
        for ind, layers in enumerate(self.layer_list):
            if sub_pdf_index is None or ind == sub_pdf_index:
                for layer in layers:
                    layer.always_parametrize_in_embedding_space = \
                        bool(usement_flag)
        self._update_embedding_structure()

    def get_total_embedding_dim(self):
        """The joint target's width in embedding coordinates."""
        return sum(layers[-1].embedded_dim for layers in self.layer_list)

    def transform_target_into_returnable_params(self, target):
        """A target from the default into embedding coordinates."""
        return self.transform_target_space(target)[0]

    def transform_target_space(self, x, log_det=0.0, transform_from="default",
                               transform_to="embedding"):
        """The joint target from one coordinate system ("default",
        "intrinsic", "embedding") to another, sub-pdf by sub-pdf, with the
        log-det of the conversion.  Returns (x', log_det')."""
        if not isinstance(log_det, torch.Tensor):
            log_det = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        src = {"default": self.target_dim_indices,
               "intrinsic": self.target_dim_indices_intrinsic,
               "embedding": self.target_dim_indices_embedded}[transform_from]
        outs = []
        for k, layers in enumerate(self.layer_list):
            lo, hi = src[k]
            part, log_det = layers[-1].transform_target_space(
                x[:, lo:hi], log_det, transform_from=transform_from,
                transform_to=transform_to)
            outs.append(part)
        return torch.cat(outs, dim=1), log_det

    def obtain_flow_param_structure(self, params, conditional_input=None,
                                    predefined_target_input=None,
                                    generator=None,
                                    amortization_parameters=None, dtype=None):
        """Each layer's parameters along the sampling path, keyed
        "<k>_<flows>.<j>": the (B, P) slab ("params"), its named split
        ("named", by the layer's param_structure), the layer's class and
        width.  The base rows are ``predefined_target_input``, else one
        draw per conditional input row (one row without one) from
        ``generator``."""
        conditional_input = self._conditional(conditional_input)
        if predefined_target_input is not None:
            z = self._input(predefined_target_input, "predefined_target_input")
        else:
            first = conditional_input[0] if isinstance(conditional_input,
                                                       list) \
                else conditional_input
            n = 1 if first is None else first.shape[0]
            if dtype is None:
                dtype = next(iter(params.values()),
                             amortization_parameters).dtype
            z = torch.randn((n, self.total_base_dim), generator=generator,
                            dtype=dtype, device=self.device)
        amort = self._amortization_parts(amortization_parameters)
        structure = {}
        summaries = []
        log_det = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        for k, layers in enumerate(self.layer_list):
            extra = self._predict_extra_params(params, k, summaries,
                                               conditional_input, amort[k])
            lo, hi = self.base_dim_indices[k]
            target = z[:, lo:hi]
            cnt = 0
            for j, layer in enumerate(layers):
                p = layer.num_params
                sl = materialize_if_lazy(self._layer_slab(
                    extra, cnt, cnt + p, target, layer))
                named, off = {}, 0
                for pname, size in layer.param_structure():
                    named[pname] = sl[:, off:off + size]
                    off += size
                structure[f"{k:03d}_{self.flow_defs_list[k]}.{j:03d}"] = {
                    "params": sl, "named": named,
                    "layer_type": type(layer).__name__, "num_params": p}
                target, log_det = layer.forward(sl, target, log_det)
                cnt += p
            summaries.append(layers[-1].embedding_conditional_return(target))
        return structure


# user-facing alias matching `jammy_flows.pdf`
pdf = PDF
