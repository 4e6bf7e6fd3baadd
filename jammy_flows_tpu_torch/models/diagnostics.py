"""Diagnostics mixin for the PDF orchestrator: per-sub-manifold log-dets,
entropy (joint + marginals), chi^2 base-space coverage, pdf scans, and
marginal moments (Gaussian / vMF approximations, the zlp-Kent fit).

PyTorch counterpart of ``jammy_flows_tpu/models/diagnostics.py`` (the
reference's main/default.py:1954-3968 and helper_fns/coverage.py).  Each
sub-manifold runs through the pdf's own routing (``_apply_stack``: the
whole-block kernels on the card, the (z, phi) columns of an s2 stack), so
the diagnostics drive the same kernels as ``sample`` and ``log_prob``.
Random draws come from a ``torch.Generator`` where the JAX API takes a key.
The host-side methods go to numpy / scipy where the JAX package does; the
``*_device`` twins stay in torch from the draw to the result.  S2 scans use
an equal-area Fibonacci lattice (healpy-free, static shapes).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.special import LOG_SQRT_2PI, std_normal_log_prob


def _rows_of(ci):
    """The row count of a conditional input (its first tensor's, for a
    list)."""
    return (ci[0] if isinstance(ci, list) else ci).shape[0]


def _repeat(ci, reps):
    """Each row of a conditional input (of each tensor, for a list) repeated
    ``reps`` times in place, as ``jnp.repeat(ci, reps, axis=0)``."""
    if ci is None:
        return None
    if isinstance(ci, list):
        return [c.repeat_interleave(reps, dim=0) for c in ci]
    return ci.repeat_interleave(reps, dim=0)


def _host(t):
    return t.detach().cpu().numpy()


def _fibonacci_lattice(n_pts):
    """(theta, phi) of the equal-area Fibonacci lattice of n_pts points on
    S2 (numpy), and each point's area 4 pi / n_pts."""
    i = np.arange(n_pts)
    golden = (1.0 + 5**0.5) / 2.0
    z = 1.0 - (2.0 * i + 1.0) / n_pts
    theta = np.arccos(np.clip(z, -1, 1))
    phi = np.mod(2.0 * np.pi * i / golden, 2.0 * np.pi)
    return np.stack([theta, phi], axis=1), 4.0 * np.pi / n_pts


class DiagnosticsMixin:
    """Mixed into models.pdf.PDF; uses its layer_list / index bookkeeping."""

    def _draw_dtype(self, params, conditional_input, dtype):
        """The dtype of a draw: the conditional input's (its first
        tensor's), else ``dtype``, else the parameters' (float32 for an
        empty dict), as ``sample`` chooses."""
        if conditional_input is not None:
            return (conditional_input[0] if isinstance(conditional_input, list)
                    else conditional_input).dtype
        if dtype is not None:
            return dtype
        return next((v.dtype for v in params.values()), torch.float32)

    def _generator(self, generator):
        """``generator``, or a generator on the pdf's device seeded with 0
        (the JAX package's ``PRNGKey(0)`` default)."""
        if generator is not None:
            return generator
        return torch.Generator(device=self.device).manual_seed(0)

    # ------------------------------------------------------------------
    # per-sub-manifold mappings (default.py:2713-3288)
    # ------------------------------------------------------------------
    def all_layer_forward_subdims(self, params, z, conditional_input=None,
                                  amortization_parameters=None,
                                  force_embedding_coordinates=False,
                                  force_intrinsic_coordinates=False):
        """Base -> target keeping a separate log-det per sub-manifold.

        Returns (x, log_det_dict) with integer keys per sub-manifold plus
        "total" (default.py:2979-3214).  Each sub-manifold starts from a
        zero log-det and runs its stack as ``all_layer_forward`` does; the
        forced coordinates apply per sub-manifold with its log-det.
        """
        z = self._input(z, "z")
        conditional_input = self._conditional(conditional_input)
        amort = self._amortization_parts(amortization_parameters)
        coords = "embedding" if force_embedding_coordinates else \
            "intrinsic" if force_intrinsic_coordinates else None
        summaries, new_targets, log_det_dict = [], [], {}
        for k, layers in enumerate(self.layer_list):
            extra = self._predict_extra_params(params, k, summaries,
                                               conditional_input, amort[k])
            lo, hi = self.base_dim_indices[k]
            zero = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
            target, ld_k = self._apply_stack(k, extra, z[:, lo:hi], zero,
                                             "sample")
            summaries.append(layers[-1].embedding_conditional_return(target))
            if coords is not None:
                target, ld_k = layers[-1].transform_target_space(
                    target, ld_k, transform_from="default",
                    transform_to=coords)
            new_targets.append(target)
            log_det_dict[k] = ld_k
        log_det_dict["total"] = sum(log_det_dict[k]
                                    for k in range(len(self.layer_list)))
        return torch.cat(new_targets, dim=1), log_det_dict

    def all_layer_inverse_subdims(self, params, x, conditional_input=None,
                                  amortization_parameters=None,
                                  force_embedding_coordinates=False,
                                  force_intrinsic_coordinates=False):
        """Target -> base with per-sub-manifold log-dets
        (default.py:2713-2901)."""
        x = self._input(x, "x")
        conditional_input = self._conditional(conditional_input)
        amort = self._amortization_parts(amortization_parameters)
        if force_embedding_coordinates:
            coords, index_map = "embedding", self.target_dim_indices_embedded
        elif force_intrinsic_coordinates:
            coords, index_map = "intrinsic", self.target_dim_indices_intrinsic
        else:
            coords, index_map = None, self.target_dim_indices
        summaries, base_targets, log_det_dict = [], [], {}
        for k, layers in enumerate(self.layer_list):
            extra = self._predict_extra_params(params, k, summaries,
                                               conditional_input, amort[k])
            lo, hi = index_map[k]
            target = x[:, lo:hi]
            ld_k = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
            if coords is not None:
                target, ld_k = layers[-1].transform_target_space(
                    target, ld_k, transform_from=coords,
                    transform_to="default")
            summaries.append(layers[-1].embedding_conditional_return(target))
            base, ld_k = self._apply_stack(k, extra, target, ld_k, "density")
            base_targets.append(base)
            log_det_dict[k] = ld_k
        log_det_dict["total"] = sum(log_det_dict[k]
                                    for k in range(len(self.layer_list)))
        return torch.cat(base_targets, dim=1), log_det_dict

    def _subdim_logprobs(self, params, z, conditional_input,
                         force_embedding_coordinates,
                         force_intrinsic_coordinates):
        """Targets of the base draws z and their log-pdfs per sub-manifold
        and in total."""
        x, ld_dict = self.all_layer_forward_subdims(
            params, z, conditional_input,
            force_embedding_coordinates=force_embedding_coordinates,
            force_intrinsic_coordinates=force_intrinsic_coordinates)
        log_pdf_dict = {}
        for k in range(len(self.layer_list)):
            lo, hi = self.base_dim_indices[k]
            log_pdf_dict[k] = std_normal_log_prob(z[:, lo:hi]) - ld_dict[k]
        log_pdf_dict["total"] = std_normal_log_prob(z) - ld_dict["total"]
        return x, log_pdf_dict

    def sample_with_subdim_logprobs(self, params, generator=None,
                                    samplesize=1, conditional_input=None,
                                    force_embedding_coordinates=True,
                                    force_intrinsic_coordinates=False,
                                    failsafe_crosscheck_tolerance=None,
                                    failsafe_rounds=3, dtype=None):
        """Sample + per-sub-manifold log-probabilities
        (default.py:2903-2977).  Returns (x, z, log_pdf_dict).  Base draws
        come from ``generator``; with a conditional input the batch size is
        its row count.

        failsafe_crosscheck_tolerance: roundtrip each sample through
        log_prob and re-draw batch items whose forward/backward total
        log-pdfs disagree beyond the tolerance (fixed-round where-merge,
        default.py:2954-2974)."""
        conditional_input = self._conditional(conditional_input)
        dtype = self._draw_dtype(params, conditional_input, dtype)
        n = samplesize if conditional_input is None \
            else _rows_of(conditional_input)

        def draw():
            z = torch.randn((n, self.total_base_dim), generator=generator,
                            dtype=dtype, device=self.device)
            x, log_pdf_dict = self._subdim_logprobs(
                params, z, conditional_input, force_embedding_coordinates,
                force_intrinsic_coordinates)
            return x, z, log_pdf_dict

        x, z, log_pdf_dict = draw()
        if failsafe_crosscheck_tolerance is not None:
            for _ in range(failsafe_rounds):
                lp_eval = self.log_prob(
                    params, x, conditional_input=conditional_input,
                    force_embedding_coordinates=force_embedding_coordinates,
                    force_intrinsic_coordinates=force_intrinsic_coordinates)[0]
                bad = (lp_eval - log_pdf_dict["total"]).abs() \
                    > failsafe_crosscheck_tolerance
                x2, z2, lpd2 = draw()
                x = torch.where(bad[:, None], x2, x)
                z = torch.where(bad[:, None], z2, z)
                log_pdf_dict = {kk: torch.where(bad, lpd2[kk], vv)
                                for kk, vv in log_pdf_dict.items()}
        return x, z, log_pdf_dict

    # ------------------------------------------------------------------
    # entropy (default.py:2263-2712)
    # ------------------------------------------------------------------
    def _entropy_draw(self, params, generator, conditional_input, samplesize,
                      force_emb, force_intr, failsafe_crosscheck_tolerance):
        """(batch size, the conditional input repeated per sample, targets,
        log-pdf dict) of samplesize draws per conditional input row."""
        conditional_input = self._conditional(conditional_input)
        batch_size, data_summary = 1, None
        if conditional_input is not None:
            batch_size = _rows_of(conditional_input)
            data_summary = _repeat(conditional_input, samplesize)
        targets, _, log_pdf_dict = self.sample_with_subdim_logprobs(
            params, generator, samplesize * batch_size, data_summary,
            force_embedding_coordinates=force_emb,
            force_intrinsic_coordinates=force_intr,
            failsafe_crosscheck_tolerance=failsafe_crosscheck_tolerance)
        return batch_size, data_summary, targets, log_pdf_dict

    def entropy(self, params, generator=None, sub_manifolds=(-1,),
                conditional_input=None, samplesize=100,
                force_embedding_coordinates=True,
                force_intrinsic_coordinates=False,
                failsafe_crosscheck_tolerance=None):
        """Monte-Carlo entropy of the joint and/or marginal sub-manifold PDFs.

        Returns dict: {"total": (B,), k: (B,)} per requested index.  Marginal
        entropies for k>0 use the S x S conditioning-pair logsumexp trick
        (default.py:2391-2451).  Differentiable in the parameters.
        """
        batch_size, data_summary, targets, log_pdf_dict = self._entropy_draw(
            params, generator, conditional_input, samplesize,
            force_embedding_coordinates, force_intrinsic_coordinates,
            failsafe_crosscheck_tolerance)
        entropy_dict = {}
        for sub_mf in sub_manifolds:
            if sub_mf == -1:
                entropy_dict["total"] = -log_pdf_dict["total"].reshape(
                    -1, samplesize).mean(dim=1)
            elif sub_mf == 0:
                entropy_dict[0] = -log_pdf_dict[0].reshape(
                    -1, samplesize).mean(dim=1)
            else:
                entropy_dict[sub_mf] = self._marginal_entropy(
                    params, targets, data_summary, sub_mf, samplesize,
                    batch_size, force_embedding_coordinates,
                    force_intrinsic_coordinates, iterative_samplesize=samplesize)
        return entropy_dict

    def _marginal_entropy(self, params, targets, data_summary, sub_mf,
                          samplesize, batch_size, force_emb, force_intr,
                          iterative_samplesize):
        """Marginal entropy of sub-manifold k>0: for each of its samples,
        average the conditional density over the S conditioning samples.
        The later sub-manifolds' columns are filled with ones; only sub_mf's
        log-det is read."""
        if force_emb:
            index_map = self.target_dim_indices_embedded
        elif force_intr:
            index_map = self.target_dim_indices_intrinsic
        else:
            index_map = self.target_dim_indices
        lo, hi = index_map[sub_mf]
        first_len = lo          # the widths of the sub-manifolds before
        d_mf = hi - lo
        total_len = targets.shape[1]

        num_steps = samplesize // iterative_samplesize
        chunks = []
        for step in range(num_steps):
            # conditioning block: tile all S first-part samples
            first = targets[:, :first_len].reshape(-1, samplesize, first_len)
            first = first.repeat(1, iterative_samplesize, 1).reshape(
                -1, first_len)
            # marginal block: each selected sample against all S conditioners
            final = targets[:, lo:hi].reshape(-1, samplesize, d_mf)
            final = final[:, step * iterative_samplesize:
                          (step + 1) * iterative_samplesize, :]
            final = final.repeat_interleave(samplesize, dim=1).reshape(
                -1, d_mf)

            joint = torch.cat([first, final], dim=1)
            fill = total_len - joint.shape[1]
            filled = torch.cat([joint, torch.ones(
                (joint.shape[0], fill), dtype=joint.dtype,
                device=joint.device)], dim=1)

            ds = _repeat(data_summary, iterative_samplesize)
            base_vals, ld_dict = self.all_layer_inverse_subdims(
                params, filled, ds,
                force_embedding_coordinates=force_emb,
                force_intrinsic_coordinates=force_intr)
            blo, bhi = self.base_dim_indices[sub_mf]
            log_g = std_normal_log_prob(base_vals[:, blo:bhi])
            lp = (log_g + ld_dict[sub_mf]).reshape(-1, iterative_samplesize,
                                                   samplesize)
            lp = torch.logsumexp(lp, dim=-1) - math.log(samplesize)
            chunks.append(lp)
        log_probs = torch.cat(chunks, dim=1)
        return -log_probs.mean(dim=1)

    def entropy_iterative(self, params, generator=None, sub_manifolds=(-1,),
                          conditional_input=None, samplesize=100,
                          iterative_samplesize=10, max_iterative_batchsize=20,
                          force_embedding_coordinates=True,
                          force_intrinsic_coordinates=False,
                          failsafe_crosscheck_tolerance=None,
                          return_samples=False):
        """Memory-bounded entropy: chunks the marginal S x S evaluation over
        target samples and batch items (default.py:2456-2712)."""
        if samplesize % iterative_samplesize:
            raise ValueError(f"samplesize {samplesize} is not a multiple of "
                             f"iterative_samplesize {iterative_samplesize}")
        batch_size, data_summary, targets, log_pdf_dict = self._entropy_draw(
            params, generator, conditional_input, samplesize,
            force_embedding_coordinates, force_intrinsic_coordinates,
            failsafe_crosscheck_tolerance)
        entropy_dict = {}
        for sub_mf in sub_manifolds:
            if sub_mf == -1:
                entropy_dict["total"] = -log_pdf_dict["total"].reshape(
                    -1, samplesize).mean(dim=1)
            elif sub_mf == 0:
                entropy_dict[0] = -log_pdf_dict[0].reshape(
                    -1, samplesize).mean(dim=1)
            else:
                # batch chunking
                rows = max_iterative_batchsize * samplesize
                n_batch_steps = max(1, math.ceil(batch_size
                                                 / max_iterative_batchsize))
                parts = []
                for bstep in range(n_batch_steps):
                    sl = slice(bstep * rows, (bstep + 1) * rows)
                    t_slice = targets[sl]
                    ds = None if data_summary is None else \
                        [d[sl] for d in data_summary] \
                        if isinstance(data_summary, list) else data_summary[sl]
                    parts.append(self._marginal_entropy(
                        params, t_slice, ds, sub_mf, samplesize,
                        t_slice.shape[0] // samplesize,
                        force_embedding_coordinates,
                        force_intrinsic_coordinates, iterative_samplesize))
                entropy_dict[sub_mf] = torch.cat(parts, dim=0)
        if return_samples:
            return entropy_dict, targets, log_pdf_dict
        return entropy_dict

    # ------------------------------------------------------------------
    # coverage (default.py:1954-2257, helper_fns/coverage.py)
    # ------------------------------------------------------------------
    def approximate_coverage(self, params, target_x, conditional_input=None,
                             amortization_parameters=None,
                             force_embedding_coordinates=False,
                             force_intrinsic_coordinates=False,
                             num_percentile_points=100, sub_manifolds=(-1,)):
        """chi^2 base-space coverage: 2*(logp(0) - logp(z_base)) should be
        chi^2(dim)-distributed for calibrated posteriors (scipy on the
        host)."""
        from scipy.stats import chi2

        return_dict = {"true": {}, "logprob_diffs": {}, "chi2_cdf_evals": {}}
        expected = np.linspace(0, 1.0, num_percentile_points)
        return_dict["expected"] = expected

        with torch.no_grad():
            _, logp_base, base_points = self.log_prob(
                params, target_x, conditional_input=conditional_input,
                amortization_parameters=amortization_parameters,
                force_embedding_coordinates=force_embedding_coordinates,
                force_intrinsic_coordinates=force_intrinsic_coordinates)

        def coverage(logp_base_t, ndim):
            diffs = 2.0 * (0.0 - (_host(logp_base_t) + ndim * LOG_SQRT_2PI))
            diffs = np.maximum(diffs, 0.0)
            chi2_evals = chi2.cdf(diffs, df=ndim)
            actual = np.asarray(
                [np.mean(chi2_evals <= e) for e in expected])
            return actual, diffs, chi2_evals

        if -1 in sub_manifolds:
            tc, ld, ce = coverage(logp_base, self.total_base_dim)
            return_dict["true"]["total"] = tc
            return_dict["logprob_diffs"]["total"] = ld
            return_dict["chi2_cdf_evals"]["total"] = ce

        for sm in sub_manifolds:
            if sm == -1:
                continue
            lo, hi = self.base_dim_indices[sm]
            sub_lp = std_normal_log_prob(base_points[:, lo:hi])
            tc, ld, ce = coverage(sub_lp, hi - lo)
            return_dict["true"][int(sm)] = tc
            return_dict["logprob_diffs"][int(sm)] = ld
            return_dict["chi2_cdf_evals"][int(sm)] = ce
        return return_dict

    def _scan_kind(self):
        mtypes = {d[0] for d in self.pdf_defs_list}
        if mtypes == {"e"}:
            return "e"
        if mtypes == {"s"}:
            if self.pdf_defs_list != ["s2"]:
                raise ValueError("only s2 scans supported")
            return "s"
        raise NotImplementedError(
            "pdf scans support pure-Euclidean or pure-s2 PDFs")

    def _to_embedding(self, x):
        return self.transform_target_space(x, transform_from="intrinsic",
                                           transform_to="embedding")[0]

    def coverage_and_or_pdf_scan(self, params, labels=None,
                                 conditional_input=None,
                                 amortization_parameters=None,
                                 coverage_num_percentile_points=100,
                                 exact_coverage_calculation=False,
                                 save_pdf_scan=False, calculate_MAP=False,
                                 samples_per_event=10000, generator=None):
        """Grid/lattice pdf scans: HPD coverage and MAP extraction
        (default.py:2024-2257).  S2 scans use an equal-area Fibonacci lattice
        instead of healpix.  The draws of a Euclidean scan come from
        ``generator`` (by default one seeded with 0); its per-event grids
        and the HPD sums are made on the host."""
        conditional_input = self._conditional(conditional_input)
        return_dict = {}
        batch_size = 1 if conditional_input is None \
            else _rows_of(conditional_input)

        embedded_labels = None
        if labels is not None:
            embedded_labels = self._input(labels, "labels")
            if embedded_labels.shape[1] == self.total_target_dim_intrinsic:
                embedded_labels = self._to_embedding(embedded_labels)
            cov = self.approximate_coverage(
                params, embedded_labels, conditional_input=conditional_input,
                amortization_parameters=amortization_parameters,
                force_embedding_coordinates=True,
                num_percentile_points=coverage_num_percentile_points)
            return_dict["approx_cov_values"] = cov["chi2_cdf_evals"]["total"]
            return_dict["logprob_diffs_base"] = cov["logprob_diffs"]["total"]
            with torch.no_grad():
                lp_t, lp_b, _ = self.log_prob(
                    params, embedded_labels,
                    conditional_input=conditional_input,
                    force_embedding_coordinates=True)
            return_dict["log_pdf_labels"] = _host(lp_t)
            return_dict["log_pdf_base_labels"] = _host(lp_b)
            embedded_labels = _host(embedded_labels)

        if not (exact_coverage_calculation or save_pdf_scan or calculate_MAP):
            return return_dict

        kind = self._scan_kind()
        max_positions, real_cov_values = [], []
        scan_positions, scan_log_evals, scan_volumes = [], [], []
        dtype = self._draw_dtype(params, conditional_input, None)

        if kind == "e":
            from ..utils import grid as grid_utils
            # dispatch 1: B*S samples in one call
            with torch.no_grad():
                samples, _, lp_s, _ = self.sample(
                    params, samplesize=samples_per_event * batch_size,
                    conditional_input=_repeat(conditional_input,
                                              samples_per_event),
                    generator=self._generator(generator), dtype=dtype)
            samples = _host(samples).reshape(batch_size, samples_per_event, -1)
            lp_s = _host(lp_s).reshape(batch_size, samples_per_event)
            mi = np.argmax(lp_s, axis=1)
            max_positions = [samples[b, mi[b]:mi[b] + 1]
                             for b in range(batch_size)]

            # host-side: per-event grids from per-event percentile bounds
            npts = int(samples_per_event ** (1.0 / self.total_target_dim))
            grids, volumes = [], []
            for b in range(batch_size):
                bounds = grid_utils.percentile_bounds(samples[b], [0.5, 99.5])
                pos, vol = grid_utils.make_grid(bounds, npts)
                grids.append(pos)
                volumes.append(vol)
            g = grids[0].shape[0]
            all_pos = torch.as_tensor(np.concatenate(grids, axis=0),
                                      dtype=dtype, device=self.device)

            # dispatch 2: all grids in one call
            with torch.no_grad():
                lp_all = self.log_prob(params, all_pos,
                                       conditional_input=_repeat(
                                           conditional_input, g))[0]
            lp_all = _host(lp_all).reshape(batch_size, g)

            for b in range(batch_size):
                positions, log_evals = grids[b], lp_all[b]
                bin_volume = volumes[b]
                if save_pdf_scan:
                    scan_positions.append(positions)
                    scan_log_evals.append(log_evals)
                    scan_volumes.append(bin_volume)
                if exact_coverage_calculation and labels is not None:
                    p = np.exp(log_evals)
                    order = np.argsort(p)[::-1]
                    idx = np.argmin(np.linalg.norm(
                        positions[order] - embedded_labels[b], axis=1))
                    real_cov_values.append(
                        float(np.cumsum(p[order] * bin_volume)[idx]))
        else:
            n_pts = samples_per_event
            angles, area = _fibonacci_lattice(n_pts)
            angles_t = torch.as_tensor(angles, dtype=dtype, device=self.device)

            # ONE dispatch: every batch item scans the same lattice
            with torch.no_grad():
                lp_all = self.log_prob(
                    params, angles_t.repeat(batch_size, 1),
                    conditional_input=_repeat(conditional_input, n_pts),
                    force_intrinsic_coordinates=True)[0]
            lp_all = _host(lp_all).reshape(batch_size, n_pts)
            xyz = _host(self._to_embedding(angles_t))

            max_positions_angles = []
            for b in range(batch_size):
                lp = lp_all[b]
                if save_pdf_scan:
                    scan_positions.append(angles)
                    scan_log_evals.append(lp)
                    scan_volumes.append(np.full(n_pts, area))
                mi = int(np.argmax(lp))
                max_positions_angles.append(angles[mi:mi + 1])
                max_positions.append(xyz[mi:mi + 1])
                if exact_coverage_calculation and labels is not None:
                    order = np.argsort(lp)[::-1]
                    idx = np.argmin(np.linalg.norm(
                        xyz[order] - embedded_labels[b], axis=1))
                    real_cov_values.append(
                        float(np.cumsum(area * np.exp(lp[order]))[idx]))
            if calculate_MAP:
                return_dict["map_positions_angles"] = np.concatenate(
                    max_positions_angles)

        if calculate_MAP:
            return_dict["map_positions"] = np.concatenate(max_positions)
        if exact_coverage_calculation and labels is not None:
            return_dict["real_cov_values"] = np.array(real_cov_values)
        if save_pdf_scan:
            return_dict["pdf_scan_positions"] = scan_positions
            return_dict["pdf_scan_log_evals"] = scan_log_evals
            return_dict["pdf_scan_volume_sizes"] = scan_volumes
        return return_dict

    # ------------------------------------------------------------------
    # the device twins: torch from the draw to the result
    # ------------------------------------------------------------------
    def marginal_moments_device(self, params, generator=None,
                                conditional_input=None, samplesize=500):
        """Marginal moments in torch, with no host transfer between the draw
        and the result.

        Returns a dict of tensors on the pdf's device: per sub-manifold
        ``mean_k`` and ``varlike_k`` (Euclidean covariance / spherical vMF
        kappa), plus ``entropy_gauss_approx_k`` / ``entropy_vmf_approx_k``.
        """
        conditional_input = self._conditional(conditional_input)
        batch_size = 1 if conditional_input is None \
            else _rows_of(conditional_input)
        targets, _, _ = self.sample_with_subdim_logprobs(
            params, generator, samplesize * batch_size,
            _repeat(conditional_input, samplesize),
            force_embedding_coordinates=True)

        out = {}
        for k, sub_def in enumerate(self.pdf_defs_list):
            lo, hi = self.target_dim_indices_embedded[k]
            d = hi - lo
            sub = targets[:, lo:hi].reshape(batch_size, samplesize, d)
            mean = sub.mean(dim=1)
            if sub_def[0] == "e":
                c = sub - mean[:, None, :]
                cov = torch.einsum("bsi,bsj->bij", c, c) / (samplesize - 1)
                out[f"mean_{k}"] = mean
                out[f"varlike_{k}"] = cov
                logdet = torch.linalg.slogdet(cov)[1]
                out[f"entropy_gauss_approx_{k}"] = 0.5 * (
                    d * (1.0 + math.log(2.0 * math.pi)) + logdet)
            elif sub_def in ("s1", "s2"):
                rbar = torch.linalg.norm(mean, dim=-1)
                mean_dir = mean / torch.clamp(rbar[:, None], min=1e-12)
                kappa = _banerjee_kappa_torch(rbar, p=d)
                out[f"mean_{k}"] = mean_dir
                out[f"varlike_{k}"] = kappa
                if sub_def == "s2":
                    out[f"entropy_vmf_approx_{k}"] = _vmf_entropy_torch(kappa)
            else:
                out[f"mean_{k}"] = mean
                out[f"varlike_{k}"] = sub.var(dim=1, correction=0)
        return out

    def entropy_device(self, params, generator=None, sub_manifolds=(-1,),
                       conditional_input=None, samplesize=100,
                       force_embedding_coordinates=True,
                       force_intrinsic_coordinates=False):
        """:meth:`entropy` with string keys and no failsafe: the S x S
        marginal block is evaluated in one shot (memory B*S^2*D), every
        reduction batch-local, no host transfer."""
        ent = self.entropy(
            params, generator, sub_manifolds=tuple(sub_manifolds),
            conditional_input=conditional_input, samplesize=samplesize,
            force_embedding_coordinates=force_embedding_coordinates,
            force_intrinsic_coordinates=force_intrinsic_coordinates,
            failsafe_crosscheck_tolerance=None)
        return {str(k): v for k, v in ent.items()}

    def coverage_scan_device(self, params, labels, conditional_input=None,
                             samples_per_event=4096, generator=None,
                             return_scan=False):
        """Exact HPD coverage + MAP from a pdf scan in torch: per-event
        percentile bounds (``torch.quantile``, linear interpolation as
        ``jnp.percentile``) for Euclidean PDFs, a shared equal-area Fibonacci
        lattice for s2, density evaluation, the HPD ordering (a batched
        stable argsort), the cumulative mass and the label's cell by
        gather, with no host transfer (the host-orchestrated counterpart is
        :meth:`coverage_and_or_pdf_scan`, which draws the same samples from
        a generator in the same state).

        labels: (B, intrinsic-dim) event positions.  Returns a dict of
        tensors: ``real_cov_values`` (B,), ``map_positions`` (B, D); with
        return_scan also ``scan_positions``/``scan_log_evals``/
        ``scan_volumes``.
        """
        conditional_input = self._conditional(conditional_input)
        labels = self._input(labels, "labels")
        kind = self._scan_kind()
        batch_size = labels.shape[0]
        dtype = labels.dtype

        if kind == "e":
            D = self.total_target_dim
            S = samples_per_event
            samples, _, lp_s, _ = self.sample(
                params, samplesize=S * batch_size,
                conditional_input=_repeat(conditional_input, S),
                generator=self._generator(generator), dtype=dtype)
            samples = samples.reshape(batch_size, S, D)
            lp_s = lp_s.reshape(batch_size, S)
            mi = torch.argmax(lp_s, dim=1)
            map_positions = torch.gather(
                samples, 1, mi[:, None, None].expand(-1, 1, D))[:, 0]

            # per-event rectangular grids from percentile bounds (mirrors
            # utils/grid.py percentile_bounds + make_grid, batched)
            npts = int(S ** (1.0 / D))
            lows = torch.quantile(samples, 0.005, dim=1)     # (B, D)
            highs = torch.quantile(samples, 0.995, dim=1)
            margin = (highs - lows) * 0.1
            lows, highs = lows - margin, highs + margin
            axes = np.meshgrid(*([np.linspace(0.0, 1.0, npts)] * D),
                               indexing="ij")
            unit = torch.as_tensor(np.stack([m.ravel() for m in axes], axis=1),
                                   dtype=dtype, device=self.device)  # (g, D)
            g = unit.shape[0]
            positions = lows[:, None, :] + unit[None] \
                * (highs - lows)[:, None, :]               # (B, g, D)
            volumes = torch.prod((highs - lows) / (npts - 1), dim=1)  # (B,)

            lp_all = self.log_prob(
                params, positions.reshape(batch_size * g, D),
                conditional_input=_repeat(conditional_input, g))[0]
            lp_all = lp_all.reshape(batch_size, g)
            scan_positions = positions
            scan_volumes = volumes[:, None].expand(batch_size, g)
            emb_labels = labels
        else:
            angles_np, area = _fibonacci_lattice(samples_per_event)
            g = samples_per_event
            angles = torch.as_tensor(angles_np, dtype=dtype,
                                     device=self.device)
            lp_all = self.log_prob(
                params, angles.repeat(batch_size, 1),
                conditional_input=_repeat(conditional_input, g),
                force_intrinsic_coordinates=True)[0].reshape(batch_size, g)
            xyz = self._to_embedding(angles)                 # (g, 3)
            map_positions = xyz[torch.argmax(lp_all, dim=1)]
            positions = xyz[None].expand(batch_size, g, 3)
            scan_positions = angles[None].expand(batch_size, g, 2)
            scan_volumes = torch.full((batch_size, g), area, dtype=dtype,
                                      device=self.device)
            emb_labels = self._to_embedding(labels) if labels.shape[1] == 2 \
                else labels
            volumes = torch.full((batch_size,), area, dtype=dtype,
                                 device=self.device)

        # per event: the cells in descending density, their cumulative mass,
        # and the mass up to the cell nearest the label
        order = torch.argsort(-lp_all, dim=1, stable=True)
        csum = torch.cumsum(torch.exp(torch.gather(lp_all, 1, order))
                            * volumes[:, None], dim=1)
        pos_sorted = torch.gather(positions, 1, order[:, :, None].expand(
            -1, -1, positions.shape[2]))
        cell = torch.argmin(torch.linalg.norm(
            pos_sorted - emb_labels[:, None, :], dim=2), dim=1)
        real_cov = torch.gather(csum, 1, cell[:, None])[:, 0]
        out = {"real_cov_values": real_cov, "map_positions": map_positions}
        if return_scan:
            out["scan_positions"] = scan_positions
            out["scan_log_evals"] = lp_all
            out["scan_volumes"] = scan_volumes
        return out

    # ------------------------------------------------------------------
    # marginal moments (default.py:3290-3968)
    # ------------------------------------------------------------------
    def _s2_scan_entropy(self, params, conditional_input, batch_size,
                         nside=32):
        """Scan-based entropy of a pure-s2 PDF: adaptive multiresolution
        scan (utils/grid.py:multires_s2_scan, the healpy-free equivalent of
        the reference's healpix entropy scan default.py:3521-3698), then
        H = -sum_i p_i a_i log p_i over the cells."""
        from ..utils.grid import multires_s2_scan
        if self.pdf_defs_list != ["s2"]:
            raise ValueError("s2_entropy_scanning requires a pure-s2 PDF "
                             "(default.py:3524)")
        conditional_input = self._conditional(conditional_input)
        n_base = 12 * nside * nside
        ents = []
        for b in range(batch_size):
            ci_b = None
            if conditional_input is not None:
                ci_b = conditional_input[0][b:b + 1] \
                    if isinstance(conditional_input, list) \
                    else conditional_input[b:b + 1]
            _, lp, areas = multires_s2_scan(self, params,
                                            conditional_input=ci_b,
                                            n_base=min(n_base, 49152),
                                            rounds=3)
            prob = np.exp(lp) * areas
            tot = prob.sum()
            if not abs(tot - 1.0) < 0.05:
                raise ValueError(f"s2 entropy scan captured only {tot:.3f} "
                                 "probability mass; increase "
                                 "s2_entropy_scan_nside")
            prob = prob / tot
            ents.append(-float(np.sum(prob * lp)))
        return np.asarray(ents)

    def marginal_moments(self, params, generator=None, conditional_input=None,
                         samplesize=500, calc_kl_diff_and_entropic_quantities=False,
                         iterative_samplesize=10, max_iterative_batchsize=20,
                         mises_abs_precision=1e-7,
                         failsafe_crosscheck_tolerance=None,
                         s2_entropy_scanning=False, s2_entropy_scan_nside=32,
                         calc_zlp_kent_fit=False, return_samples=False):
        """Per-sub-manifold moments: Euclidean mean/cov (+ Gaussian-approx
        entropy), spherical mean direction + vMF kappa (Banerjee + Newton to
        ``mises_abs_precision`` on A_p(kappa)=rbar, default.py:3446-3469) and
        vMF entropy; optional exact-marginal entropies and KL(exact||approx)
        (option surface of default.py:3290-3303).

        s2_entropy_scanning: compute the exact entropy of a pure-s2 PDF from
        an adaptive multiresolution scan instead of Monte-Carlo sampling
        (reference healpix scan, default.py:3521-3698); moments still come
        from MC samples.  return_samples: adds ``samples_<k>`` (B, S, d_emb)
        and ``samples_<k>_angles`` for spheres.  failsafe_crosscheck_tolerance
        is passed to the sampling path (v-flow safety net).

        With ``calc_zlp_kent_fit=True``, every S2 sub-manifold additionally
        gets a batched maximum-likelihood zlp-Kent fit on the pdf's device
        (utils/vmf_kent.py; the reference calls the analogous fit from
        marginal_moments at default.py:3859-3866): keys
        ``zlp_kent_pars_<k>`` (gamma1/2/3, kappa, u, loglike, grad_norm) and,
        when the exact marginal entropy is computed, ``kl_diff_exact_kent_<k>``
        = E_flow[log p_flow - log p_kent].  The Kent fit uses the first half
        of the samples; its cross-entropy is evaluated on the held-out second
        half.  The reduction is :meth:`_moments_of_samples`.
        """
        conditional_input = self._conditional(conditional_input)
        batch_size = 1 if conditional_input is None \
            else _rows_of(conditional_input)

        sub_indices = list(range(len(self.pdf_defs_list)))
        entropy_dict = None
        with torch.no_grad():
            if calc_kl_diff_and_entropic_quantities and s2_entropy_scanning:
                scan_ent = self._s2_scan_entropy(params, conditional_input,
                                                 batch_size,
                                                 nside=s2_entropy_scan_nside)
                entropy_dict = {"total": scan_ent, 0: scan_ent}
            if calc_kl_diff_and_entropic_quantities and entropy_dict is None:
                entropy_dict, targets, _ = self.entropy_iterative(
                    params, generator, sub_manifolds=[-1] + sub_indices,
                    conditional_input=conditional_input,
                    samplesize=samplesize,
                    iterative_samplesize=iterative_samplesize,
                    max_iterative_batchsize=max_iterative_batchsize,
                    failsafe_crosscheck_tolerance=failsafe_crosscheck_tolerance,
                    return_samples=True)
            else:
                targets, _, _ = self.sample_with_subdim_logprobs(
                    params, generator, samplesize * batch_size,
                    _repeat(conditional_input, samplesize),
                    force_embedding_coordinates=True,
                    failsafe_crosscheck_tolerance=failsafe_crosscheck_tolerance)
        if entropy_dict is not None:
            entropy_dict = {k: v if isinstance(v, np.ndarray) else _host(v)
                            for k, v in entropy_dict.items()}
        return self._moments_of_samples(
            _host(targets), batch_size, samplesize, entropy_dict=entropy_dict,
            mises_abs_precision=mises_abs_precision,
            calc_zlp_kent_fit=calc_zlp_kent_fit, return_samples=return_samples)

    def _moments_of_samples(self, targets, batch_size, samplesize,
                            entropy_dict=None, mises_abs_precision=1e-7,
                            calc_zlp_kent_fit=False, return_samples=False):
        """The reduction of :meth:`marginal_moments`: targets (B*S, total
        embedded dim) numpy in embedding coordinates, batch item by batch
        item; entropy_dict the exact entropies (numpy), or None."""
        out = {}
        if entropy_dict is not None:
            for k, v in entropy_dict.items():
                out[f"entropy_{k}"] = np.asarray(v)

        for k, sub_def in enumerate(self.pdf_defs_list):
            lo, hi = self.target_dim_indices_embedded[k]
            sub = np.asarray(targets[:, lo:hi]).reshape(
                batch_size, samplesize, hi - lo)
            if return_samples:
                out[f"samples_{k}"] = sub
            if sub_def[0] == "e":
                mean = sub.mean(axis=1)
                c = sub - mean[:, None, :]
                cov = np.einsum("bsi,bsj->bij", c, c) / (samplesize - 1)
                out[f"mean_{k}"] = mean
                out[f"varlike_{k}"] = cov
                # Gaussian-approximation entropy 0.5 log det(2 pi e Sigma)
                d = hi - lo
                _, logdet = np.linalg.slogdet(cov)
                out[f"entropy_gauss_approx_{k}"] = 0.5 * (
                    d * (1.0 + math.log(2.0 * math.pi)) + logdet)
            elif sub_def == "s2":
                resultant = sub.mean(axis=1)
                rbar = np.linalg.norm(resultant, axis=-1)
                mean_dir = resultant / np.maximum(rbar[:, None], 1e-12)
                kappa = _banerjee_kappa(rbar, p=3,
                                        abs_precision=mises_abs_precision)
                out[f"mean_{k}"] = mean_dir
                theta = np.arccos(np.clip(mean_dir[:, 2], -1, 1))
                phi = np.mod(np.arctan2(mean_dir[:, 1], mean_dir[:, 0]),
                             2 * np.pi)
                out[f"mean_{k}_angles"] = np.stack([theta, phi], axis=1)
                out[f"varlike_{k}"] = kappa
                out[f"entropy_vmf_approx_{k}"] = _vmf_entropy(kappa)
                if return_samples:
                    th = np.arccos(np.clip(sub[:, :, 2], -1, 1))
                    ph = np.mod(np.arctan2(sub[:, :, 1], sub[:, :, 0]),
                                2 * np.pi)
                    out[f"samples_{k}_angles"] = np.stack([th, ph], axis=-1)
                if calc_zlp_kent_fit:
                    from ..utils.vmf_kent import (fit_zlpkent_batch_quat,
                                                  zlpkent_logpdf_s2_batch)
                    half = samplesize // 2
                    fit = fit_zlpkent_batch_quat(
                        torch.as_tensor(sub[:, :half], device=self.device),
                        num_steps=150, newton_steps=8,
                        grad_tol=mises_abs_precision)
                    out[f"zlp_kent_pars_{k}"] = fit
                    # held-out MC cross-entropy of the flow marginal vs its
                    # Kent fit (in-sample evaluation is optimistically biased)
                    held = sub[:, half:]
                    lps = zlpkent_logpdf_s2_batch(
                        held, fit["gamma1"], fit["gamma2"], fit["gamma3"],
                        fit["kappa"], fit["u"])
                    kent_ce = -lps.mean(axis=1)
                    out[f"entropy_kent_crossent_{k}"] = kent_ce
                    if entropy_dict is not None:
                        out[f"kl_diff_exact_kent_{k}"] = (
                            kent_ce - np.asarray(entropy_dict[k]))
            elif sub_def == "s1":
                resultant = sub.mean(axis=1)
                rbar = np.linalg.norm(resultant, axis=-1)
                mean_dir = resultant / np.maximum(rbar[:, None], 1e-12)
                kappa = _banerjee_kappa(rbar, p=2,
                                        abs_precision=mises_abs_precision)
                out[f"mean_{k}"] = mean_dir
                out[f"mean_{k}_angles"] = np.mod(
                    np.arctan2(mean_dir[:, 1], mean_dir[:, 0]), 2 * np.pi)
                out[f"varlike_{k}"] = kappa
                if return_samples:
                    out[f"samples_{k}_angles"] = np.mod(
                        np.arctan2(sub[:, :, 1], sub[:, :, 0]), 2 * np.pi)
            else:
                mean = sub.mean(axis=1)
                out[f"mean_{k}"] = mean
                out[f"varlike_{k}"] = sub.var(axis=1)

            if entropy_dict is not None and sub_def[0] == "e" \
                    and k in entropy_dict:
                out[f"kl_diff_exact_approximate_{k}"] = (
                    out[f"entropy_gauss_approx_{k}"] - np.asarray(
                        entropy_dict[k]))
            if entropy_dict is not None and sub_def == "s2" \
                    and k in entropy_dict:
                out[f"kl_diff_exact_approximate_{k}"] = (
                    out[f"entropy_vmf_approx_{k}"] - np.asarray(
                        entropy_dict[k]))
        return out


def _banerjee_kappa_torch(rbar, p=3, newton_iters=8):
    """torch twin of _banerjee_kappa (p=2 uses the exponentially-scaled
    Bessel ratio i1e/i0e, which is the plain ratio).  8 fixed Newton
    iterations converge A_p(kappa)=rbar in f64 from the Banerjee init."""
    rbar = torch.clamp(rbar, 1e-9, 1.0 - 1e-9)
    kappa = rbar * (p - rbar**2) / (1.0 - rbar**2)
    for _ in range(newton_iters):
        if p == 3:
            a = 1.0 / torch.tanh(kappa) - 1.0 / kappa
            da = 1.0 / kappa**2 - 1.0 / torch.sinh(kappa)**2
        else:
            a = torch.special.i1e(kappa) / torch.special.i0e(kappa)
            da = 1.0 - a**2 - a / kappa
        kappa = kappa - (a - rbar) / torch.clamp(da, min=1e-12)
        kappa = torch.clamp(kappa, min=1e-9)
    return kappa


def _vmf_entropy_torch(kappa):
    """torch twin of _vmf_entropy (stable log-sinh for large kappa)."""
    kappa = torch.clamp(kappa, min=1e-9)
    ks = torch.clamp(kappa, max=20.0)
    log_c_small = torch.log(kappa) - math.log(4.0 * math.pi) \
        - torch.log(torch.sinh(ks))
    log_c_large = torch.log(kappa) - math.log(4.0 * math.pi) \
        - (kappa - math.log(2.0))
    log_c = torch.where(kappa > 20, log_c_large, log_c_small)
    a3 = 1.0 / torch.tanh(kappa) - 1.0 / kappa
    return -log_c - kappa * a3


def _banerjee_kappa(rbar, p=3, newton_iters=3, abs_precision=None,
                    max_iters=100):
    """Banerjee et al. vMF concentration estimate + Newton refinement on
    A_p(kappa) = rbar (default.py:3446-3469).

    With ``abs_precision`` set, iterates until max |A_p(kappa) - rbar| <
    abs_precision (the reference's mises_abs_precision loop) instead of a
    fixed count, bounded by ``max_iters``."""
    rbar = np.clip(rbar, 1e-9, 1.0 - 1e-9)
    kappa = rbar * (p - rbar**2) / (1.0 - rbar**2)
    n_iters = max_iters if abs_precision is not None else newton_iters
    for _ in range(n_iters):
        if p == 3:
            a = 1.0 / np.tanh(kappa) - 1.0 / kappa
            da = 1.0 / kappa**2 - 1.0 / np.sinh(kappa)**2
        else:  # p == 2: A_2 = I1/I0
            from scipy.special import i0, i1
            a = i1(kappa) / i0(kappa)
            da = 1.0 - a**2 - a / kappa
        if abs_precision is not None and \
                np.max(np.abs(a - rbar)) < abs_precision:
            break
        kappa = kappa - (a - rbar) / np.maximum(da, 1e-12)
        kappa = np.maximum(kappa, 1e-9)
    return kappa


def _vmf_entropy(kappa):
    """Entropy of a vMF on S2: -log C_3(kappa) - kappa * A_3(kappa)."""
    kappa = np.maximum(kappa, 1e-9)
    log_c = np.log(kappa) - np.log(4.0 * np.pi) - np.log(np.sinh(kappa))
    # use stable log sinh for large kappa
    large = kappa > 20
    log_c = np.where(large,
                     np.log(kappa) - np.log(4.0 * np.pi)
                     - (kappa - math.log(2.0)), log_c)
    a3 = 1.0 / np.tanh(kappa) - 1.0 / kappa
    return -log_c - kappa * a3
