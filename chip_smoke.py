"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from jammy_flows_tpu_torch/csrc (the
block and the per-layer sources, forward and backward, all nvcc processes
in parallel), then drives the flagship ``pdf("e4+s2+e4", "gggg+f+gggg")``:

* serving, twice, unconditional (1,048,576 rows) and conditional_input_dim=3
  (262,144 rows): ``sample``, then ``log_prob`` of the samples;
* training, for both configurations at 262,144 rows sampled from the model:
  the fused ``nll_value_and_grad`` (T3 per block), autograd of
  ``-log_prob(...).mean()`` (T1 + T2) and of a sample objective (T1 + the
  T2 sample body), then ``train.fit`` for 20 full-batch Adam steps;
* the per-layer route (T4-T7), on the flagship with
  ``{"g": {"add_skewness": 1}}`` (raw and lazy interfaces) and with
  ``{"g": {"center_mean": 1}}`` (prepared interface), each unconditional and
  conditional: serving at the same row counts (the skewed models' sample
  and log_prob timed, 1,048,576 / 262,144 rows), the skewed models'
  training paths as above (T4 / T5 and both T7 bodies per layer), and the
  centred models' gradients at the cross-check size;
* the remaining Euclidean options, each on the flagship at full width:
  the angles rotation (unconditional, served and trained like the skewed
  model, and conditional: the plain-mixture instances of T4 / T5 raw and
  lazy and of T7), high_precision_tail_newton (unconditional and
  conditional: T6 / T4 prepared at the roots refined in float64 on the
  card; skewed, unconditional: T4 raw at the refined roots, the skew kept),
  the rq_splines stretch (unconditional) and ``"t+f+t"`` with a full
  covariance (conditional), both plain PyTorch: serving at the same row
  counts, exact launch counts, every kernel call against its plain
  version, log_prob against the port's f64 CPU path, sample and log_prob
  timed;
* the circle and interval layers, on the repo's examples at full width
  (``"s1+s2+e2", "m+f+gg"`` with conditional_input_dim=2, ``"e2+s1",
  "gg+o"`` and ``"i1_-5.5_10.0", "r"`` with conditional_input_dim=2): their
  gg blocks through T1 lazy2 / perm, the circle and interval layers plain
  PyTorch; serving at 262,144 / 1,048,576 / 262,144 rows with exact launch
  counts, every block call against its plain version, log_prob against
  the port's f64 CPU path, sample and log_prob timed and censused by
  torch.profiler; the first model trained as the conditional flagship
  (T3 / T2 lazy2, its Moebius solve's implicit gradient in the sample
  objective's);
* the simplex layers and the amortization machinery under them, at full
  width: ``"a2", "w"`` with conditional_input_dim=2 (the outer MLP predicts
  the `w` layer's 8,316 parameters per row: its inner pdf's MLP runs
  per-row weights; 262,144 rows, trained), ``"a3", "w"`` and ``"a2", "u"``
  (1,048,576 rows), all plain PyTorch, and ``fully_amortized_pdf("e2+s1",
  "gg+o", conditional_input_dim=3)`` at its defaults (262,144 rows; its gg
  block's parameters arrive per row: T4 / T5 raw per row, the T7 density
  body in its log_prob gradient): serving with exact launch counts, every
  per-layer call against its plain version, log_prob (and the gradients)
  against the port's f64 CPU path, sample and log_prob timed and censused,
  each model's peak device memory;
* the s2 options of `f` and the exponential map `v`, at full width: the
  production S2 recipe ``pdf("s2", "f" * 15)`` with nested smooth vertical
  and circular splines (PRODUCTION_F, unconditional), the conditional
  flagship with that `f` (its gggg blocks through T1 / T2 / T3 lazy2), and
  the `v` fixtures' models (exponential and splines potentials with
  conditional_input_dim=2, the exponential one solved in the density
  direction unconditionally): serving at 262,144 rows with exact launch
  counts, every block call against its plain version, log_prob against
  the port's f64 CPU path, sample and log_prob timed and censused, peak
  device memory, each sphere-Newton solve's iterations and unconverged
  rows; the production models and the conditional exponential `v` model
  trained as the flagship;
* the manifold CNF `c` at its registry defaults (hidden 32, 4 charts,
  dopri5 at rtol = atol = 1e-7): ``pdf("s2", "c")``, its rk4 form (the
  s2_c fixture's model) and the conditional flagship with `c` between its
  gggg blocks (``"e4+s2+e4", "gggg+c+gggg"``, the field's 259 weights
  predicted per row; T1-T3 lazy2 for the blocks): serving at 262,144 rows
  with exact launch counts, every block call against its plain version,
  log_prob against the port's f64 CPU path, sample and log_prob timed and
  censused, peak device memory; training through the continuous adjoint
  (dopri5) or rk4's checkpointed steps: the fused NLL, autograd of
  log_prob and of a sample objective, gradients against the CPU path,
  ``train.fit`` (rk4 and dopri5 as many steps as FIT_BUDGET_S allows,
  the flagship with `c` none); each ODE integration's steps per chart, forward
  and adjoint apart;
* the PDF-level options on the conditional flagship with one conditional
  input per sub-pdf (3, 2 and 2 wide) and a standalone Poisson head:
  ``init_params(data=...)`` from the training rows, failsafe sampling in
  embedding coordinates and log_prob with forced embedding coordinates
  (exact launch counts, every block call against its plain version, the
  roundtrip), log_mean_poisson and log_prob against the port's f64 CPU
  path, and training from the data-driven init (its NLL through autograd:
  T1 / T2 lazy2, a Poisson head);
* the diagnostics on the conditional flagship, each path with its own
  exact launch counts and every block call against its plain version:
  ``entropy`` of one conditional row from 512 draws (each marginal's
  512 x 512 = 262,144 conditioning pairs through T1 density lazy2),
  ``entropy_iterative`` and ``entropy_device`` equal to it on the same
  generator state, the entropy's gradient (T1 / T2 lazy2 through
  autograd), ``marginal_moments`` of 512 items x 512 samples with the
  zlp-Kent fit of the s2 marginal against ``marginal_moments_device`` on
  the same draws, the chi^2 coverage of 262,144 of the model's own
  samples, the sub-manifold mappings and marginal entropies against the
  port's f64 CPU path; then the grid scan of a conditional ``"e4", "gggg"``
  and the lattice scan of a conditional ``"s2", "f"`` (64 events x 4,096
  points; host and device scans on one generator state), the s2 entropy
  scan against Monte Carlo;
* the CLI (``python -m jammy_flows_tpu_torch``, in-process): fit of the
  unconditional flagship, then sample, eval and moments of the saved
  model; a fit checkpointed every 10 steps against the unchunked one, a
  checkpoint roundtrip on the card, the profiling helpers;
* the block's lazy mode (precomputed hidden activations, T1 / T2), on the
  flagship with two-hidden-layer ``amortization_mlp_dims="64-64"`` MLPs,
  unconditional and conditional, serving and training as the flagship;
  then the routing by MLP shape: ``conditional_input_dim=200`` (a summary
  wider than 128 takes the lazy mode; serving at 262,144 rows) and
  ``amortization_mlp_dims="1024"`` (the widest hidden layer the kernels
  take; ``nll_value_and_grad`` and a sample-objective gradient at 4,096
  rows);
* the chain-rate probe (T8): the measured per-step rate of exp, log,
  softplus, sin, arccos and a multiply-add on 1,048,576 elements, beside
  the data-sheet FP32 rate the bounds assume;
* checks beside the paths: a NaN made on the card (0/0) in the lazy2
  block's summary or weights reaches T1 lazy2's and T3 lazy2's outputs
  exactly where it reaches the plain versions', and one in the skewed
  layer's hidden activations or w reaches T4 / T5 lazy's and T7 lazy's
  (density body) outputs so too; the perm backward kernels and T7 lazy
  (both bodies) give the same bits on two launches; the per-layer lazy
  kernels (3xTF32 tile products) match their plain versions at hidden
  widths 12, 200 and 1024 on a row count that is not a multiple of any
  tile, and the block's lazy mode (T1 / T2 lazy, on the same tile stage)
  at 12, 64, 200 and 1024, T2 lazy with the same bits on two launches.

Each path has its own launch counts, which must be exactly the kernels that
path runs.  Every kernel call of every path is recorded and held against the
plain PyTorch version on the same inputs; the fused NLL against autograd;
the card's float32 log-prob and gradients against the port's float64 CPU
path; then each kernel, its plain version, the whole ``sample`` /
``log_prob`` and the training step are timed.  Every failure raises
(non-zero exit).  The last line of standard output is the device JSON; the
line before it the per-kernel JSON.  Needs one CUDA device; imports nothing
of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

FLAGSHIP = ("e4+s2+e4", "gggg+f+gggg")
N_SAMPLE_UNCOND = 1_048_576      # bench.py's sampling batch
N_COND = 262_144
N_CROSS = 4096
# kernel vs plain limits, as the JAX package holds its TPU kernels against
# their XLA formulation (tests/test_pallas_interpret.py): density values
# 3e-4; the sample direction's Newton solve 3e-3
TOL_DENSITY = 3e-4
TOL_SAMPLE = 3e-3
TOL_ROUNDTRIP_Q999 = 1e-3        # tests/test_tpu_kernels.py
TOL_CROSS = 1e-3
TIMING_REPS = 20
PLAIN_REPS = 5                   # the plain versions of the per-layer kernels
# the block entry points, as gf_block.gf_block_<name>; the lazy mode's
# counters are density_lazyh / sample_lazyh (gf_block._COUNTER)
ENTRY_POINTS = ("density_perm", "sample_perm", "density_lazy2",
                "sample_lazy2", "density_lazy", "sample_lazy")
BWD_KERNELS = ("density_bwd_perm", "density_bwd_lazy2", "sample_bwd_perm",
               "sample_bwd_lazy2", "nll_perm", "nll_lazy2")
LAZYH_BWD = ("density_bwd_lazyh", "sample_bwd_lazyh")
# launches of one sample + log_prob: the unconditional flagship's block 0
# has permanent parameters (perm) and block 2 a fused MLP (lazy2); the
# conditional one amortizes both blocks (lazy2, 3- and 10-wide summaries)
EXPECTED_LAUNCHES = {
    "unconditional": {"density_perm": 1, "sample_perm": 1,
                      "density_lazy2": 1, "sample_lazy2": 1},
    "conditional": {"density_lazy2": 2, "sample_lazy2": 2},
}
# training: rows per step (the JAX package's training step,
# pallas_gf_block.py:4-7), a ragged batch, the f64 cross-check size, steps
N_TRAIN = 262_144
N_RAGGED = N_TRAIN - 1
TRAIN_STEPS = 20
TRAIN_LR = 1e-3
# backward vs plain, relative (per-row gradients: max|diff| over max|ref|;
# broadcast gradients: relative norm), and fused NLL vs autograd: the JAX
# package's kernel-vs-XLA gradient limits (tests/test_tpu_kernels.py:136,
# 147, 178-182); T3's val / ld vs T1's: the same expressions on the same
# values, so the same bits
TOL_GRAD = {"density": 1e-4, "nll": 1e-4, "sample": 3e-4}
TOL_NLL_LOSS = 1e-4
TOL_T3_VS_T1 = 0.0
TOL_CROSS_GRAD = 1e-3
# launches of each training path, per configuration: the fused NLL runs
# one T3 launch per block and nothing else; autograd of log_prob the T1
# density and T2 density kernels of each block; autograd of sample the T1
# sample and T2 sample kernels of each block
EXPECTED_TRAIN_LAUNCHES = {
    "unconditional": {
        "nll": {"nll_perm": 1, "nll_lazy2": 1},
        "log_prob_grad": {"density_perm": 1, "density_lazy2": 1,
                          "density_bwd_perm": 1, "density_bwd_lazy2": 1},
        "sample_grad": {"sample_perm": 1, "sample_lazy2": 1,
                        "sample_bwd_perm": 1, "sample_bwd_lazy2": 1},
        "fit": {"nll_perm": TRAIN_STEPS, "nll_lazy2": TRAIN_STEPS}},
    "conditional": {
        "nll": {"nll_lazy2": 2},
        "log_prob_grad": {"density_lazy2": 2, "density_bwd_lazy2": 2},
        "sample_grad": {"sample_lazy2": 2, "sample_bwd_lazy2": 2},
        "fit": {"nll_lazy2": 2 * TRAIN_STEPS}},
}
# the per-layer route: the flagship with one GF option, per configuration
SKEW = {"g": {"add_skewness": 1}}
CENTRE = {"g": {"center_mean": 1}}
LAYER_MODELS = (("skewed unconditional", SKEW, None),
                ("skewed conditional", SKEW, 3),
                ("centred unconditional", CENTRE, None),
                ("centred conditional", CENTRE, 3))
LAYER_ENTRY = ("forward_prepared", "inverse_prepared", "forward_raw",
               "sample_raw", "forward_lazy", "sample_lazy")
LAYER_BWD = ("forward_bwd_raw", "sample_bwd_raw", "forward_bwd_lazy",
             "sample_bwd_lazy")
# the centred models' g-layer means are scaled by this before serving: at
# init_params(seed=0) the centring mean (minus the weighted sum of the nine
# others) lies ~10 widths off the bulk, where the 4-step Newton solve of the
# JAX package does not converge (its own f32 sample -> log_prob roundtrip
# there: q999 11.7 on 8,192 rows, interpret mode on the CPU), so the
# roundtrip would measure the reference's solve, not the port
CENTRE_MEAN_SCALE = 1.0 / 3.0
# launches of one sample + log_prob: 4 g layers per block; the skewed
# unconditional block 0 takes raw broadcast parameters, every amortized
# block lazy rows; the centred blocks the prepared interface (solve, then
# the density pass at the root, then log_prob's density pass)
SKEW_U = {"sample_raw": 4, "sample_lazy": 4, "forward_raw": 4,
          "forward_lazy": 4}
CENTRED = {"inverse_prepared": 8, "forward_prepared": 16}
EXPECTED_LAUNCHES.update({
    "skewed unconditional": SKEW_U,
    "skewed conditional": {"sample_lazy": 8, "forward_lazy": 8},
    "centred unconditional": CENTRED, "centred conditional": CENTRED})
# training: nll_value_and_grad takes autograd per sub-pdf when no block is
# eligible, so it launches what autograd of log_prob launches
_LP_U = {"forward_raw": 4, "forward_lazy": 4, "forward_bwd_raw": 4,
         "forward_bwd_lazy": 4}
_LP_C = {"forward_lazy": 8, "forward_bwd_lazy": 8}
EXPECTED_TRAIN_LAUNCHES.update({
    "skewed unconditional": {
        "nll": _LP_U, "log_prob_grad": _LP_U,
        "sample_grad": {"sample_raw": 4, "sample_lazy": 4,
                        "sample_bwd_raw": 4, "sample_bwd_lazy": 4},
        "fit": {k: v * TRAIN_STEPS for k, v in _LP_U.items()}},
    "skewed conditional": {
        "nll": _LP_C, "log_prob_grad": _LP_C,
        "sample_grad": {"sample_lazy": 8, "sample_bwd_lazy": 8},
        "fit": {k: v * TRAIN_STEPS for k, v in _LP_C.items()}}})
# the centred models' gradients (prepared interface: no backward kernel, the
# plain VJP; the sample direction's solve by make_inverse_fn's implicit rule)
EXPECTED_CENTRED_GRAD = {"log_prob_grad": {"forward_prepared": 8},
                         "sample_grad": {"inverse_prepared": 8,
                                         "forward_prepared": 8}}
# the remaining Euclidean options, each on the flagship at full width (the
# affine model puts `t` where the flagship has its g blocks): (label,
# definitions, options, conditional input dim, trained).  The angles and
# tail-Newton models run the per-layer kernels on the plain (unskewed)
# mixture, the skewed tail-Newton model T4 raw at the refined roots;
# rq_splines and `t` have no kernel in either package
ANGLES = {"g": {"rotation_mode": "angles"}}
TAIL = {"g": {"high_precision_tail_newton": 2}}    # tests/test_tail_precision.py:63
SKEW_TAIL = {"g": {"add_skewness": 1, "high_precision_tail_newton": 2}}
SPLINES = {"g": {"nonlinear_stretch_type": "rq_splines"}}
AFFINE = ("e4+s2+e4", "t+f+t")
EUCLID_MODELS = (
    ("rotated unconditional", FLAGSHIP, ANGLES, None, True),
    ("rotated conditional", FLAGSHIP, ANGLES, 3, False),
    ("tail-Newton unconditional", FLAGSHIP, TAIL, None, False),
    ("tail-Newton conditional", FLAGSHIP, TAIL, 3, False),
    ("skewed tail-Newton unconditional", FLAGSHIP, SKEW_TAIL, None, False),
    ("splines unconditional", FLAGSHIP, SPLINES, None, False),
    ("affine conditional", AFFINE, {"t": {"cov_type": "full"}}, 3, False))
# launches of one sample + log_prob: the angles rotation keeps the skewed
# models' interfaces (raw broadcast block 0, lazy rows elsewhere); tail
# Newton solves with T6 prepared and takes T4 prepared at the refined root
# (its amortized rows materialized: per row), log_prob T4 raw; with skew the
# solve is the plain one and both density passes T4 raw (skewed); rq_splines
# and `t` launch nothing
_TAIL = {"inverse_prepared": 8, "forward_prepared": 8, "forward_raw": 8}
EXPECTED_LAUNCHES.update({
    "rotated unconditional": SKEW_U,
    "rotated conditional": {"sample_lazy": 8, "forward_lazy": 8},
    "tail-Newton unconditional": _TAIL, "tail-Newton conditional": _TAIL,
    "skewed tail-Newton unconditional": {"forward_raw": 16},
    "splines unconditional": {}, "affine conditional": {}})
EXPECTED_TRAIN_LAUNCHES["rotated unconditional"] = \
    EXPECTED_TRAIN_LAUNCHES["skewed unconditional"]
# the circle and interval layers on the repo's examples
# (examples/examples.ipynb): (label, definitions, flows, conditional input
# dim, trained), each at its layers' default options and the default
# 128-wide MLP; the `m` layer's sampling direction is a bisection + Newton
# solve in plain PyTorch, as the circle and interval layers are (no kernel
# in either package)
CIRCLE_MODELS = (
    ("s1+s2+e2 conditional", "s1+s2+e2", "m+f+gg", 2, True),
    ("e2+s1 unconditional", "e2+s1", "gg+o", None, False),
    ("interval conditional", "i1_-5.5_10.0", "r", 2, False))
# launches of one sample + log_prob: the gg block runs lazy2 on a 7-wide
# summary (conditional input 2, the circle's embedding 2, the sphere's 3)
# or perm; the interval model launches nothing.  Training takes the
# conditional flagship's table with one lazy2 block
EXPECTED_LAUNCHES.update({
    "s1+s2+e2 conditional": {"density_lazy2": 1, "sample_lazy2": 1},
    "e2+s1 unconditional": {"density_perm": 1, "sample_perm": 1},
    "interval conditional": {}})
EXPECTED_TRAIN_LAUNCHES["s1+s2+e2 conditional"] = {
    "nll": {"nll_lazy2": 1},
    "log_prob_grad": {"density_lazy2": 1, "density_bwd_lazy2": 1},
    "sample_grad": {"sample_lazy2": 1, "sample_bwd_lazy2": 1},
    "fit": {"nll_lazy2": TRAIN_STEPS}}
# the simplex layers and the fully amortized model: (label, constructor,
# definitions, flows, conditional input dim, rows, training), each at the
# default 128-wide MLPs; "fit" trains as the flagship, "grad" takes
# autograd of -log_prob().mean()
SIMPLEX_MODELS = (
    ("a2 w conditional", "pdf", "a2", "w", 2, N_COND, "fit"),
    ("a3 w unconditional", "pdf", "a3", "w", None, N_SAMPLE_UNCOND, None),
    ("a2 u unconditional", "pdf", "a2", "u", None, N_SAMPLE_UNCOND, None),
    ("fully amortized e2+s1", "fully_amortized_pdf", "e2+s1", "gg+o", 3,
     N_COND, "grad"))
# the simplex layers launch nothing (no kernel in either package).  The
# fully amortized model's gg block gets its parameters as per-row slabs,
# which the block op does not take (models/pdf.py _try_block), so each of
# its two g layers runs on its own (layers/euclidean.py): one T4
# gf_forward_raw in log_prob, one T5 gf_sample_raw in sample, and in the
# gradient of log_prob T4 again and one T7 density body
EXPECTED_LAUNCHES.update({
    "a2 w conditional": {}, "a3 w unconditional": {},
    "a2 u unconditional": {},
    "fully amortized e2+s1": {"forward_raw": 2, "sample_raw": 2}})
EXPECTED_TRAIN_LAUNCHES.update({
    "a2 w conditional": {"nll": {}, "log_prob_grad": {}, "sample_grad": {},
                         "fit": {}},
    "fully amortized e2+s1": {"log_prob_grad": {"forward_raw": 2,
                                                "forward_bwd_raw": 2}}})
# the `u` layer's float32 sample is its d intrinsic coordinates: near a
# vertex the remainder 1 - sum(x) falls below their resolution and log_prob
# of the sample is ill-conditioned, in the JAX package's float32 path as in
# the port's (at this run's weights, temperature 0.69: a roundtrip q999 of
# ~1.8e-2 and 1.9e-3 from float64 on 4,096 samples in both packages on the
# CPU; PERF.md). Its roundtrip and log_prob are held against the port's
# float32 CPU path on the same inputs, the float64 distance printed
F32_HELD = ("a2 u unconditional",)
# the sphere phase (the s2 options of `f` and the exponential map `v`):
# the production S2 recipe (docs/suggested_settings.md, tools/
# bench_production.py PRODUCTION_F), the conditional flagship with it, and
# the `v` fixtures' models at their default 10 components: (label,
# definitions, flows, options, conditional input dim, trained), each at the
# default 128-wide MLPs, served at N_COND rows
PRODUCTION_F = {"f": {
    "add_vertical_rq_spline_flow": 1,
    "add_circular_rq_spline_flow": 1,
    "spline_num_basis_functions": -1,
    "vertical_smooth": 1,
    "vertical_flow_defs": "rr",
    "circular_flow_defs": "oo",
    "vertical_fix_boundary_derivative": 1,
    "vertical_fix_first_width_n_height_to_zero": 1,
    "vertical_also_fix_second_width_to_zero": 1,
    "vertical_independent_width_height_parametrization": 1,
    "circular_add_rotation": 0,
    "kappa_prediction": "direct_log_real_bounded",
    "rotation_mode": "householder",
}}
SPHERE_MODELS = (
    ("production s2", "s2", "f" * 15, PRODUCTION_F, None, True),
    ("flagship production f", *FLAGSHIP, PRODUCTION_F, 3, True),
    ("v exponential conditional", "s2", "v",
     {"v": {"exp_map_type": "exponential"}}, 2, True),
    ("v splines conditional", "s2", "v", {"v": {"exp_map_type": "splines"}},
     2, False),
    ("v exponential sample-natural", "s2", "v",
     {"v": {"exp_map_type": "exponential", "natural_direction": 1}}, None,
     False))
# the `f` and `v` layers launch nothing (no kernel in either package); the
# flagship with the production `f` launches what the conditional flagship
# does (its two gggg blocks in lazy2)
EXPECTED_LAUNCHES.update({label: {} for label, *_ in SPHERE_MODELS})
EXPECTED_LAUNCHES["flagship production f"] = EXPECTED_LAUNCHES["conditional"]
EXPECTED_TRAIN_LAUNCHES.update({
    "production s2": {"nll": {}, "log_prob_grad": {}, "sample_grad": {},
                      "fit": {}},
    "flagship production f": EXPECTED_TRAIN_LAUNCHES["conditional"],
    "v exponential conditional": {"nll": {}, "log_prob_grad": {},
                                  "sample_grad": {}, "fit": {}}})
# the manifold CNF `c` at the registry's defaults (hidden 32, 4 charts,
# dopri5 at rtol = atol = 1e-7, highway 0): unconditional, its rk4 form (the
# s2_c fixture's model), and between the conditional flagship's gggg
# blocks, where the field's 259 weights are predicted per row; "fit": 20
# train.fit steps, None: as many as FIT_BUDGET_S allows, 0: none
CNF_MODELS = (
    ("c dopri5", "s2", "c", None, None, None),
    ("c rk4", "s2", "c", {"c": {"solver": "rk4"}}, None, None),
    ("flagship c", "e4+s2+e4", "gggg+c+gggg", None, 3, 0))
# the c models' calls take seconds (host-bound, ~20 us per launch, one
# sync per attempted ODE step): sample / log_prob are timed over CNF_REPS
# calls, a training step over one; their gradients are held against the
# CPU path on N_CROSS_CNF rows; their fits take as many steps as
# FIT_BUDGET_S allows (at least 2), which keeps the script inside its
# time limit on a host where a step takes 2-4 s
FIT_BUDGET_S = 10.0
CNF_REPS = 3
N_CROSS_CNF = 1024
EXPECTED_LAUNCHES.update({"c dopri5": {}, "c rk4": {},
                          "flagship c": EXPECTED_LAUNCHES["conditional"]})
EXPECTED_TRAIN_LAUNCHES.update({
    "c dopri5": {"nll": {}, "log_prob_grad": {}, "sample_grad": {},
                 "fit": {}},
    "c rk4": {"nll": {}, "log_prob_grad": {}, "sample_grad": {}, "fit": {}},
    "flagship c": {k: v for k, v in EXPECTED_TRAIN_LAUNCHES[
        "conditional"].items() if k != "fit"}})
# the PDF-level options: the conditional flagship with one conditional
# input per sub-pdf (3, 2 and 2 wide) and a standalone Poisson head,
# initialized from data, served with failsafe sampling in embedding
# coordinates; its NLL takes the plain autograd route (a Poisson head), so
# T1 density and T2 density lazy2 per block and step
OPTIONS_MODEL = ("e4+s2+e4", "gggg+f+gggg", [3, 2, 2])
FAILSAFE_TOL = 1e-3
FAILSAFE_ROUNDS = 3
_LAZY2_AUTOGRAD = {"density_lazy2": 2, "density_bwd_lazy2": 2}
EXPECTED_LAUNCHES["options"] = {"sample_lazy2": 2 * (1 + FAILSAFE_ROUNDS),
                                "density_lazy2": 2 * (FAILSAFE_ROUNDS + 1)}
EXPECTED_TRAIN_LAUNCHES["options"] = {
    "nll": _LAZY2_AUTOGRAD, "log_prob_grad": _LAZY2_AUTOGRAD,
    "sample_grad": {"sample_lazy2": 2, "sample_bwd_lazy2": 2},
    "fit": {k: v * TRAIN_STEPS for k, v in _LAZY2_AUTOGRAD.items()}}
# the diagnostics (models/diagnostics.py) on the conditional flagship:
# entropy of one conditional row from DIAG_S draws (each marginal's S x S
# conditioning pairs are 262,144 rows through all_layer_inverse_subdims),
# entropy_iterative in chunks of DIAG_ITER marginal samples, marginal
# moments of DIAG_ITEMS items x DIAG_S samples (262,144 rows) with the
# zlp-Kent fit of the s2 marginal, the chi^2 coverage of N_COND of the
# model's own samples; then the pdf scans of a conditional "e4", "gggg"
# (an 8^4 grid per event) and "s2", "f" (a 4,096-point lattice) over
# N_SCAN_EVENTS events (262,144 rows), and the s2 entropy scan
DIAG_S = 512
DIAG_ITER = 64
DIAG_ITEMS = 512
N_SCAN_EVENTS = 64
N_SCAN = 4096
SCAN_E = ("e4", "gggg")
SCAN_S = ("s2", "f")
N_S2_MC = 65_536                  # the s2 Monte-Carlo entropy's draws
TOL_ENTROPY = 1e-5                # entropy_iterative / entropy_device vs
                                  # entropy on one generator state
TOL_MOMENTS = 1e-4                # device vs host moments, relative
TOL_COVERAGE = 0.01               # max |expected - actual| chi^2 coverage
TOL_SCAN = 1e-4                   # device vs host scans: coverage values
TOL_LATTICE_MASS = 1e-2           # each event's s2 lattice mass vs 1
TOL_S2_SCAN_ENTROPY = 0.05        # scan vs MC entropy (tests/test_diagnostics.py:263)
N_CROSS_DIAG = 1024               # card vs the port's f64 CPU path
CROSS_S = 32                      # a 32 x 32 marginal block: 1,024 rows
# the CLI (python -m jammy_flows_tpu_torch, run in-process by main()): the
# unconditional flagship fitted for TRAIN_STEPS steps on N_CLI rows, then
# sample / eval / moments on the saved model; train.fit with checkpoints
# every CLI_CHECKPOINT_EVERY steps against the unchunked fit
N_CLI = 4096
CLI_MOMENTS_N = 2000
CLI_CHECKPOINT_EVERY = 10
_DIAG_ENTROPY = {"sample_lazy2": 2, "density_lazy2": 4}
EXPECTED_DIAG_LAUNCHES = {
    "diagnostics": {
        # sampling DIAG_S rows, then each marginal's S x S block through
        # both blocks (the later sub-manifold's columns are filled with ones)
        "entropy": _DIAG_ENTROPY,
        "entropy_iterative": {"sample_lazy2": 2,
                              "density_lazy2": 4 * DIAG_S // DIAG_ITER},
        "entropy_device": _DIAG_ENTROPY,
        # the joint and the s2 marginal: the marginal's block calls get
        # their (zero) cotangents through the concatenated base positions
        "entropy_grad": {"sample_lazy2": 2, "density_lazy2": 2,
                         "sample_bwd_lazy2": 2, "density_bwd_lazy2": 2},
        "moments": {"sample_lazy2": 2},
        "moments_device": {"sample_lazy2": 2},
        "coverage": {"sample_lazy2": 2, "density_lazy2": 2},
        # forward / inverse mappings, a CROSS_S draw, two marginals
        "cross": {"sample_lazy2": 4, "density_lazy2": 6}},
    # labels, their approximate coverage and log_prob, the draws, the grids
    "scan e4": {"host scan": {"sample_lazy2": 2, "density_lazy2": 3},
                "device scan": {"sample_lazy2": 1, "density_lazy2": 1}},
    # the `f` layer has no kernel
    "scan s2": {"host scan": {}, "device scan": {}},
}
_CLI_FIT = {"nll_perm": TRAIN_STEPS, "nll_lazy2": TRAIN_STEPS}
EXPECTED_CLI_LAUNCHES = {
    "fit": _CLI_FIT,
    "sample": {"sample_perm": 1, "sample_lazy2": 1},
    "eval": {"density_perm": 1, "density_lazy2": 1},
    "moments": {"sample_perm": 1, "sample_lazy2": 1},
    # throughput's warm-up and 5 reps, one call under the profiler
    "profiling": {"density_perm": 7, "density_lazy2": 7}}
# the per-row raw instances it runs, timed on its first recorded calls
PER_ROW_RAW = ("forward_raw", "sample_raw", "forward_bwd_raw")
# the per-layer entry points and T7 bodies that run on the plain mixture
# in the rotated and tail-Newton models, timed on the rotated unconditional
# flagship's first calls (rows "..._unskewed")
UNSKEWED = ("forward_raw", "sample_raw", "forward_lazy", "sample_lazy") \
    + LAYER_BWD
# the block's lazy mode: the flagship with two-hidden-layer MLPs (the JAX
# package's own test of the mode, tests/test_tpu_kernels.py:90-91); the
# unconditional block 0 stays perm, every amortized block takes "lazy"
DIMS_LAZY = "64-64"
LAZY_MODELS = (("64-64 unconditional", None), ("64-64 conditional", 3))
EXPECTED_LAUNCHES.update({
    "64-64 unconditional": {"density_perm": 1, "sample_perm": 1,
                            "density_lazyh": 1, "sample_lazyh": 1},
    "64-64 conditional": {"density_lazyh": 2, "sample_lazyh": 2},
    # routing: a 200-wide summary takes the lazy mode (pdf.py:502-503)
    "wide summary": {"density_lazyh": 2, "sample_lazyh": 2}})
# no fused NLL for a lazy-mode block (as in the JAX package): autograd of
# its term runs the T1 density and T2 density kernels
EXPECTED_TRAIN_LAUNCHES.update({
    "64-64 unconditional": {
        "nll": {"nll_perm": 1, "density_lazyh": 1, "density_bwd_lazyh": 1},
        "log_prob_grad": {"density_perm": 1, "density_lazyh": 1,
                          "density_bwd_perm": 1, "density_bwd_lazyh": 1},
        "sample_grad": {"sample_perm": 1, "sample_lazyh": 1,
                        "sample_bwd_perm": 1, "sample_bwd_lazyh": 1},
        "fit": {"nll_perm": TRAIN_STEPS, "density_lazyh": TRAIN_STEPS,
                "density_bwd_lazyh": TRAIN_STEPS}},
    "64-64 conditional": {
        "nll": {"density_lazyh": 2, "density_bwd_lazyh": 2},
        "log_prob_grad": {"density_lazyh": 2, "density_bwd_lazyh": 2},
        "sample_grad": {"sample_lazyh": 2, "sample_bwd_lazyh": 2},
        "fit": {"density_lazyh": 2 * TRAIN_STEPS,
                "density_bwd_lazyh": 2 * TRAIN_STEPS}},
    # the widest hidden layer the kernels take (gf_block.MAX_KERNEL_H):
    # the lazy2 backward kernels keep dh in a global scratch there
    "H=1024": {"nll": {"nll_lazy2": 2},
               "sample_grad": {"sample_lazy2": 2, "sample_bwd_lazy2": 2}}})
WIDE_SUMMARY = 200
# the chain-rate probe (T8): FP32 operations of one step of each chain, as
# work() counts (an FMA as 2; exp, log, log1p, sin, acos as 1 each)
CHAIN_OPS = {"exp": 2, "log": 3, "softplus": 7, "sin": 2, "arccos": 3,
             "fma": 2}
CHAIN_CHECK_STEPS = 16
TOL_CHAIN = 1e-5                 # f32 library differences over 16 steps
# H100 SXM peaks (NVIDIA data sheet): FP32 on the CUDA cores, HBM3, and
# dense TF32 on the tensor cores, of which a 3xTF32 product takes three
# passes
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_3XTF32_FLOPS = 495e12 / 3
# the kernels whose parameter rows are 3xTF32 tile products
# (csrc/gf_block_src.cuh TileSrc): lazy2 and lazy, forward and backward
TILE_KERNELS = ("density_lazy2", "sample_lazy2", "density_bwd_lazy2",
                "sample_bwd_lazy2", "nll_lazy2", "density_lazyh",
                "sample_lazyh", "density_bwd_lazyh", "sample_bwd_lazyh")
# the block's lazy mode against its plain versions beyond the "64-64"
# flagship's H = 64, on the flagship with "64-<H>" MLPs (block 2): 12 (not
# a multiple of the 8-wide k step), 64 (dh in shared memory), 200 (dh in
# the global scratch), 1024 (32-row tiles), on N_WIDTH rows
LAZY_WIDTHS = (12, 64, 200, 1024)
# the per-layer lazy kernels whose parameter rows (and T7's dh / gw) are
# 3xTF32 tile products (csrc/tile_rows.cuh, csrc/gf_layer_src.cuh
# LayerTileSrc)
LAYER_TILE_KERNELS = ("forward_lazy", "sample_lazy", "forward_bwd_lazy",
                      "sample_bwd_lazy")
# the lazy instances against their plain versions beyond the flagship's
# H = 128, on the skewed flagship with amortization_mlp_dims = H: the widths
# (12: not a multiple of the 8-wide k step; 1024: the routing limit, the
# backward's 32-row tiles, dh in the global scratch) and a row count that is
# not a multiple of any tile
LAYER_WIDTHS = (12, 200, 1024)
N_WIDTH = 4099
# the perm backward kernels: a grid of (blocks per SM) x SMs, warp-private
# partials summed in a fixed order
PERM_BWD = ("density_bwd_perm", "sample_bwd_perm", "nll_perm")
# the perm forward kernels: persistent blocks walking tiles of rows
PERM_FWD = ("density_perm", "sample_perm")
# rows of the NaN check (the flagship's lazy2 block)
N_NAN = 4096


def log(msg):
    print(msg, flush=True)


def counts():
    """Every kernel's launch count: the block (gf_block), the per-layer
    (gf_layer) and the chain-probe wrappers' counters, whose names do not
    overlap."""
    from jammy_flows_tpu_torch.ops import gf_block as gb, gf_layer as gl
    from jammy_flows_tpu_torch.tools import transcendental_peak as tp
    return {**gb.LAUNCHES, **gl.LAUNCHES, **tp.LAUNCHES}


def reset_counts():
    from jammy_flows_tpu_torch.ops import gf_block as gb, gf_layer as gl
    from jammy_flows_tpu_torch.tools import transcendental_peak as tp
    gb.reset_launch_counts()
    gl.reset_launch_counts()
    tp.reset_launch_counts()


def all_counts(expected):
    """An expected launch dict with every other kernel at 0."""
    return {k: expected.get(k, 0) for k in counts()}


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def ptxas_summary(report):
    """One line per compiled kernel: registers, stack and spills, from
    nvcc's -Xptxas -v report."""
    lines = []
    for name, body in re.findall(r"Function properties for (\S+)\n(.*?)"
                                 r"(?=ptxas info\s+: Compil|\Z)", report, re.S):
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", body)
        if regs and spill:
            lines.append(f"ptxas {name}: {regs.group(1)} registers, stack "
                         f"{spill.group(1)} B, spill stores {spill.group(2)} B, "
                         f"spill loads {spill.group(3)} B")
    return lines


def cuda_ms(fn, reps, warm=True):
    """Median over ``reps`` single-launch CUDA-event timings, after one
    warm-up call (none without ``warm``)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# the entry points' calls on the serving path, held against the plain version
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recording(calls):
    """Wrap the block entry points so that every call the serving path
    makes appends (name, inputs, out, ld) to ``calls``, as copies.  The
    wrapped entry point still launches, and counts, its kernel once."""
    from jammy_flows_tpu_torch.ops import gf_block as gb
    originals = {name: getattr(gb, f"gf_block_{name}") for name in ENTRY_POINTS}

    def recorder(name, fn):
        def call(*args):
            kept = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                         for a in args)
            out, ld = fn(*args)
            calls.append((name, kept, out.clone(), ld.clone()))
            return out, ld
        return call

    for name, fn in originals.items():
        setattr(gb, f"gf_block_{name}", recorder(name, fn))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(gb, f"gf_block_{name}", fn)


def split_args(name, args):
    """(direction, mode, x, params, prep, meta) of an entry point's args."""
    direction, mode = name.split("_")
    *tensors, prep, meta = args
    return direction, mode, tensors[0], tuple(tensors[1:]), prep, meta


def counter(name):
    """The launch counter of entry point ``name`` (density_lazy ->
    density_lazyh)."""
    from jammy_flows_tpu_torch.ops import gf_block as gb
    direction, mode = name.split("_")
    return f"{direction}_{gb._COUNTER[mode]}"


def check_calls(label, calls):
    """Each recorded kernel result against the plain version on the same
    inputs; returns the largest |diff| per entry point."""
    from jammy_flows_tpu_torch.ops import gf_block as gb
    errs = {}
    for name, args, out_k, ld_k in calls:
        direction, mode, x, params, prep, meta = split_args(name, args)
        out_p, ld_p = gb.block_plain(direction, x, params, prep, meta, mode)
        torch.cuda.synchronize()
        e_out = (out_k - out_p).abs().max().item()
        e_ld = (ld_k - ld_p).abs().max().item()
        tol = TOL_DENSITY if direction == "density" else TOL_SAMPLE
        what = f"{label} {name} ({x.shape[0]} rows" + (
            ")" if mode == "perm" else f", {params[0].shape[1]}-wide "
            f"{'summary' if mode == 'lazy2' else 'hidden'})")
        log(f"kernel vs plain {what}: max|diff| out {e_out:.3e} ld "
            f"{e_ld:.3e} (limit {tol:g})")
        if not (max(e_out, e_ld) < tol and torch.isfinite(out_k).all()
                and torch.isfinite(ld_k).all()):
            raise AssertionError(f"{what}: kernel disagrees with its plain "
                                 f"version ({max(e_out, e_ld):.3e} >= {tol:g})")
        errs[name] = max(errs.get(name, 0.0), e_out, e_ld)
    return errs


# ---------------------------------------------------------------------------
# operation and byte counts for the bound
# ---------------------------------------------------------------------------

# FP32 operations counted from the kernels' expressions (csrc/gf_common.cuh,
# gf_block_src.cuh, gf_block_bwd.cu): an FMA as 2, every other operation
# (add, multiply, divide, compare, select, min/max, transcendental) as 1.
# Each function's minimum is counted once: a backward reuses every value its
# forward made (the mixture's terms, the parameter rows, the rotated inputs)
# and recomputes none, and parameter-only terms count per row where the
# parameters differ per row (lazy2), else once per call.  Data-dependent
# branches count the branch of a row inside the mixture (no far-tail
# fallback lane; the erfinv centre of the normal iCDF).
# Each constant is also split (ops(): its plain operations and its calls of
# the library's expf and of logf / log1pf, counted from the same
# expressions; a regulator is the flagship's bounded one, whose value takes
# two exp and two log calls and whose derivative four and two) for the
# per-layer kernels' slot bound (layer_work's slots).


def ops(plain, exp=0, log=0):
    """An operation count: plain FP32 operations and library exp and log
    (logf, log1pf) calls."""
    return {"plain": plain, "exp": exp, "log": log}


def cost(c, slots=None):
    """The FP32 operations of count c with each library call at slots[kind]
    operations (two a multiply-add slot), or at 1 (work()'s count)."""
    slots = slots or {}
    return c["plain"] + sum(slots.get(kind, 1) * c[kind]
                            for kind in ("exp", "log"))


MIX = ops(26, exp=1)    # per component: c, exp, sigmoid, F, SF, P, fallback
                        # maxima
MIX_DIM = ops(9, log=3)     # per dimension: log_cdf, log_sf, log_pdf
# pass + log-deriv: isigmoid's logaddexp; the erfinv centre's two exp and
# its log
ICDF = {"isigmoid": ops(10, exp=1, log=1),
        "inormal_partly_precise": ops(38, exp=2, log=1)}
PREP = ops(38, exp=7, log=5)    # per component: both regulators, exp(-lw),
                                # log-softmax, nw * iw, lnw + log iw
PREP_DIM = ops(1, log=1)    # per dimension: the log-softmax's log-sum
ADJ = ops(30)       # per component: the transposed tangent rule -> dx, dm,
                    # dlw, dln
ADJ_DIM = ops(7)    # per dimension: 1/F, 1/SF, 1/P and their cotangents
ICDF_ADJ = {"isigmoid": ops(6, exp=2), "inormal_partly_precise": ops(28)}
PREP_ADJ = ops(2, exp=8, log=4)     # per component: the two regulators'
                                    # derivatives
JVP = ops(6)        # sample body, per component: the tangent along ds
JVP_DIM = ops(7)    # sample body, per dimension: c = (gs + gld lx) / fp
ICDF_JVP = {"isigmoid": ops(5), "inormal_partly_precise": ops(11)}
MIX_OPS, MIX_DIM_OPS, PREP_OPS, PREP_DIM_OPS = (
    cost(c) for c in (MIX, MIX_DIM, PREP, PREP_DIM))
ADJ_OPS, ADJ_DIM_OPS, PREP_ADJ_OPS, JVP_OPS, JVP_DIM_OPS = (
    cost(c) for c in (ADJ, ADJ_DIM, PREP_ADJ, JVP, JVP_DIM))
ICDF_OPS, ICDF_ADJ_OPS, ICDF_JVP_OPS = (
    {k: cost(v) for k, v in c.items()} for c in (ICDF, ICDF_ADJ, ICDF_JVP))


def work(name, n, meta, n_in=0, hid=0):
    """(flops, bytes) of one kernel call on n rows, name as in LAUNCHES.
    Per layer and row: the offset, the householder reflections (4d - 1 each,
    their unit vectors and 2v 4d + 1 per parameter set; backward 13d - 2)
    and per dimension the mixture (MIX_OPS ...); the forward sample
    direction's solve per dimension: the bracket 4 per component, its start
    (isigmoid a weighted quantile, 3 per component, else two value passes of
    12 per component + 15), four Newton steps and the log-derivative (16 per
    component + 30 each).  lazy2 adds the MLP: 2 H In + 2 H for the hidden
    layer, 2 P H + P for the parameter rows; its backward dh = w^T dp and gw
    = sum_rows dp x hidden (2 P H each), gb (P) and the hidden layer's
    backward (4 H In + 4 H); perm's backward sums dp over rows (P).  The
    lazy mode (lazyh) reads the hidden row (H floats) instead of the
    summary and adds only the parameter rows (no hidden-layer flops); its
    backward adds dh and gw (2 P H each) and gb, and writes ghidden.  The
    loops have fixed trip counts, so this is what every run needs.  Bytes:
    each input read once, each output written once."""
    from jammy_flows_tpu_torch.ops.gf_block import block_rows
    k, d, layers = meta
    parts = name.split("_")
    kind, mode = parts[0], parts[-1]
    lazy = mode in ("lazy2", "lazyh")
    if mode == "lazyh":            # the per-row input is the hidden row
        n_in = hid
    bwd = kind == "nll" or parts[1] == "bwd"
    p = block_rows(k, d, layers)
    row = prep = 0
    for has_off, rot_it, _, ift in layers:
        prep += d * (k * PREP_OPS + PREP_DIM_OPS) + rot_it * (4 * d + 1)
        row += d * has_off + rot_it * (4 * d - 1)
        if kind == "sample" and not bwd:
            start = 3 * k if ift == "isigmoid" else 2 * (12 * k + 15)
            row += d * (4 * k + start + 5 * (16 * k + 30))
        else:
            row += d * (k * MIX_OPS + MIX_DIM_OPS + ICDF_OPS[ift])
        if bwd:
            prep += d * k * PREP_ADJ_OPS
            row += rot_it * (13 * d - 2) + d * (
                k * ADJ_OPS + ADJ_DIM_OPS + ICDF_ADJ_OPS[ift])
            if kind == "sample":
                row += d * (k * JVP_OPS + JVP_DIM_OPS + ICDF_JVP_OPS[ift])
            else:                  # the offset's cotangent -g
                row += d * has_off
    if kind == "nll":              # the cotangent wv * val
        row += d
    n_io = 4 if bwd else 3         # x, out, ld (+ the cotangents, gx)
    byts = n_io * n * d * 4
    if lazy:
        mlp = mode == "lazy2"      # the hidden layer runs in the kernel
        row += prep + 2 * p * hid + p + mlp * (2 * hid * n_in + 2 * hid)
        weights = p * hid + p + mlp * (hid * n_in + hid)
        byts += 4 * (n * n_in + weights)
        if bwd:
            row += 4 * p * hid + p + mlp * (4 * hid * n_in + 4 * hid)
            byts += 4 * (n * n_in + weights)   # gsummary / ghidden, grads
        return row * n, byts
    row += p if bwd else 0
    byts += 4 * p * (2 if bwd else 1)
    return row * n + prep, byts


def bound_ms(flops, byts):
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = byts / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def product_flops(name, n, p_rows, hid):
    """The P x H parameter-row products inside a lazy kernel call's work()
    / layer_work() count on n rows: the rows w . hidden (2 P H per row) and,
    in a backward, dh = w^T dp and gw = sum_rows dp x hidden (4 P H more).
    The part of the work the tensor cores can take."""
    bwd = name.startswith("nll") or "_bwd_" in name
    return (2 + 4 * bwd) * p_rows * hid * n


def tc_bound_ms(flops, byts, products):
    """The bound with the P x H products on the tensor cores in 3xTF32
    (495 / 3 TFLOP/s) and the rest of the operations at the FP32 rate: the
    least the card could take for the same work now that the products can
    run there."""
    t_ops = ((flops - products) / PEAK_F32_FLOPS
             + products / PEAK_3XTF32_FLOPS) * 1e3
    return max(t_ops, byts / PEAK_BYTES * 1e3)


def products_matmul_ms(name, n, p_rows, hid, dev):
    """A yardstick the port never calls: the P x H products of a lazy2 call
    alone, as torch.matmul in float32 at "highest" precision (no TF32) at
    the kernel's shapes: the rows (n, H) @ (H, P) and, in a backward,
    dh = (n, P) @ (P, H) and gw = (P, n) @ (n, H).  Median of 5."""
    torch.set_float32_matmul_precision("highest")
    g = torch.Generator(device=dev).manual_seed(90)
    hidden = torch.randn((n, hid), generator=g, device=dev)
    w = torch.randn((p_rows, hid), generator=g, device=dev)
    dp = torch.randn((n, p_rows), generator=g, device=dev)
    bwd = name.startswith("nll") or "_bwd_" in name

    def run():
        torch.matmul(hidden, w.T)
        if bwd:
            torch.matmul(dp, w)
            torch.matmul(dp.T, hidden)

    ms = cuda_ms(run, 5)
    del hidden, w, dp
    torch.cuda.empty_cache()
    return ms


def cuobjdump_path():
    from jammy_flows_tpu_torch.ops import cuda_build
    import pathlib
    return str(pathlib.Path(cuda_build.nvcc_path()).parent / "cuobjdump")


def tile_kernel_report(built, card):
    """After the build: each lazy2 kernel's TF32 HMMA instructions in the
    SASS of its built library (cuobjdump -sass), and its blocks per SM at
    the flagship's H = 128 (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    and the perm kernels' blocks per SM at block 0 (their grid).  Fails
    when a lazy2 kernel has no TF32 HMMA."""
    from jammy_flows_tpu_torch import pdf
    from jammy_flows_tpu_torch.ops import gf_block as gb
    # gf_block_density_kernel<MODE, KT, DT>, gf_block_bwd_kernel<KIND,
    # MODE, DHG, KT, DT>: MODE 1 is lazy2, 2 lazy (whose backward has an
    # instance with dh in shared memory and one with dh in the scratch)
    suffix = {"1": "lazy2", "2": "lazyh"}
    pats = {"gf_block": (r"gf_block_(density|sample)_kernelILi([12])ELi(\d+)ELi",
                         lambda m: f"{m.group(1)}_{suffix[m.group(2)]}"),
            "gf_block_bwd": (r"gf_block_bwd_kernelILi(\d)ELi([12])ELb\dELi(\d+)ELi",
                             lambda m: ("density_bwd", "sample_bwd",
                                        "nll")[int(m.group(1))] + "_" +
                             suffix[m.group(2)])}
    found = {}
    for lib_name, (pat, kernel) in pats.items():
        sass = subprocess.run([cuobjdump_path(), "-sass",
                               str(built[lib_name][0])], capture_output=True,
                              text=True, check=True, timeout=600).stdout
        for fn, body in re.findall(r"Function : (\S+)\n(.*?)(?=Function : |\Z)",
                                   sass, re.S):
            m = re.search(pat, fn)
            if m:
                n = len(re.findall(r"HMMA\.\S*TF32", body))
                shape = "K=10, d=4" if m.group(3) == "10" else "generic"
                scratch = (", dh in the scratch"
                           if re.search(r"ELi2ELb1E", fn) else "")
                log(f"SASS {kernel(m)} ({shape}{scratch}): {n} TF32 HMMA "
                    f"instructions")
                found[(kernel(m), shape)] = min(
                    n, found.get((kernel(m), shape), n))
    # gf_layer_kernel<LAZY = 1, SKEW, MODE, KT>, gf_layer_bwd_kernel<LAZY =
    # 1, SKEW, SAMPLE, KT>: the per-layer lazy kernels
    layer_pats = {
        "gf_layer": (r"gf_layer_kernelILb1ELb(\d)ELi(\d)ELi(\d+)E",
                     ("forward_lazy", "sample_lazy")),
        "gf_layer_bwd": (r"gf_layer_bwd_kernelILb1ELb(\d)ELb(\d)ELi(\d+)E",
                         ("forward_bwd_lazy", "sample_bwd_lazy"))}
    for lib_name, (pat, names) in layer_pats.items():
        sass = subprocess.run([cuobjdump_path(), "-sass",
                               str(built[lib_name][0])], capture_output=True,
                              text=True, check=True, timeout=600).stdout
        for fn, body in re.findall(r"Function : (\S+)\n(.*?)(?=Function : |\Z)",
                                   sass, re.S):
            m = re.search(pat, fn)
            if m:
                n = len(re.findall(r"HMMA\.\S*TF32", body))
                shape = ("K=10" if m.group(3) == "10" else "generic") + (
                    ", skewed" if m.group(1) == "1" else "")
                name = names[int(m.group(2))]
                log(f"SASS {name} ({shape}): {n} TF32 HMMA instructions")
                found[(name, shape)] = n
    missing = [k for k in TILE_KERNELS for shape in ("K=10, d=4", "generic")
               if not found.get((k, shape))]
    missing += [k for k in LAYER_TILE_KERNELS
                for shape in ("K=10", "generic", "K=10, skewed",
                              "generic, skewed")
                if not found.get((k, shape))]
    if missing:
        raise AssertionError(f"no TF32 HMMA in the SASS of {missing}")
    p = pdf(*FLAGSHIP, device="cpu")
    p_lazy = pdf(*FLAGSHIP, amortization_mlp_dims=DIMS_LAZY, device="cpu")
    lazy2 = tuple(n for n in TILE_KERNELS if n.endswith("lazy2"))
    lazyh = tuple(n for n in TILE_KERNELS if n.endswith("lazyh"))
    for pp, k, names, hid in ((p, 2, lazy2, 128),
                              (p, 0, PERM_BWD + PERM_FWD, 0),
                              (p_lazy, 2, lazyh, 64)):
        prep, meta = pp._block_meta[k]
        for name in names:
            blocks, threads, smem = gb.kernel_occupancy(name, prep, meta, hid)
            log(f"occupancy {name} (block {k}{f', H = {hid}' if hid else ''}"
                f") on {card}: {blocks} blocks of {threads} threads = "
                f"{blocks * threads // 32} warps per SM, {smem} B of shared "
                f"memory a block")
    for name in LAYER_TILE_KERNELS:
        blocks, threads, smem = layer_occupancy(name)
        log(f"occupancy {name} (the skewed flagship layer, H = 128) on "
            f"{card}: {blocks} blocks of {threads} threads = "
            f"{blocks * threads // 32} warps per SM, {smem} B of shared "
            f"memory a block")


def layer_occupancy(name, hid=128, n_groups=4, skew=True):
    """(blocks per SM, threads, shared memory bytes) of a per-layer lazy
    kernel, or of T4-T7 with broadcast slabs (hid 0), at the skewed
    flagship's layer (K = 10, d = 4, four groups), or with ``n_groups``
    and ``skew`` given, a layer of the plain mixture."""
    from jammy_flows_tpu_torch.ops import gf_layer as gl
    return gl.kernel_occupancy(name, 10, 4, hid, n_groups, skew=skew)


def entry_row(name, args, by_path, err, card, ptxas=None):
    """Time block entry point ``name`` (T1) on one recorded call's own
    inputs: kernel, plain version, bound; returns its JSON row.  The perm
    rows also carry their registers, stack and spills (``ptxas``: the
    -Xptxas -v lines of the built library, tools/tile_breakdown.perm_ptxas)
    and blocks per SM, and the grid of this call."""
    from jammy_flows_tpu_torch.ops import gf_block as gb
    fn = getattr(gb, f"gf_block_{name}")
    direction, mode, x, params, prep, meta = split_args(name, args)
    ms = cuda_ms(lambda: fn(*args), TIMING_REPS)
    plain_ms = cuda_ms(lambda: gb.block_plain(direction, x, params, prep,
                                              meta, mode), TIMING_REPS)
    n_in, hid = mlp_widths(mode, params)
    flops, byts = work(counter(name), x.shape[0], meta, n_in, hid)
    b_ms, b_by = bound_ms(flops, byts)
    p_rows = gb.block_rows(*meta)
    tc_ms = tc_bound_ms(flops, byts, product_flops(name, x.shape[0], p_rows,
                                                   hid))
    log(f"{name} at {x.shape[0]} rows on {card}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{flops:.4g} flop, {byts:.4g} B), tensor-core bound {tc_ms:.4f} ms")
    row = {"name": f"gf_block_{name}", "route": "cuda",
           "source": "jammy_flows_tpu_torch/csrc/gf_block.cu",
           "replaces": "jammy_flows_tpu/ops/pallas_gf_block.py:489",
           "launches": sum(by_path.values()), "launches_by_path": by_path,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "tc_bound_ms": tc_ms,
           "library_ms": None}
    if name in PERM_FWD:
        shape = "K=10, d=4" if meta[:2] == (10, 4) else "generic"
        row["ptxas"] = (ptxas or {}).get(f"{name} ({shape})")
        row["blocks_per_sm"] = gb.kernel_occupancy(name, prep, meta)[0]
        row["grid"] = gb.perm_grid(direction, x.shape[0], prep, meta)
        log(f"{name} ({shape}): {row['ptxas']}, {row['blocks_per_sm']} "
            f"blocks per SM; grid {row['grid'][0]} persistent blocks, "
            f"tiles of {row['grid'][1]} rows")
    if counter(name) in TILE_KERNELS:
        row["products_matmul_ms"] = products_matmul_ms(name, x.shape[0],
                                                       p_rows, hid, x.device)
        log(f"{name}: its P x H products alone as torch.matmul (f32, "
            f"highest) {row['products_matmul_ms']:.4f} ms (a yardstick)")
    return row


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def jittered_params(p, seed, flow_scale=0.0):
    """init_params(seed=0) with every MLP's weights moved by 0.02 * N(0, 1)
    (and the permanent flow_0 by flow_scale * N(0, 1)): the initial MLP's
    output hardly depends on its input (its weights are damped by 1000), so
    this gives the lazy2 kernel parameters that differ from row to row, as a
    trained model's do."""
    params = p.init_params(seed=0)
    g = torch.Generator(device=p.device).manual_seed(seed)
    scale = {k: 0.02 if k.startswith("mlp_") else flow_scale for k in params}
    return {k: v + scale[k] * torch.randn(v.shape, generator=g, device=v.device)
            if scale[k] else v for k, v in params.items()}


def sample_rows(p, params, n, ci, g):
    """p.sample of n rows (a fully amortized pdf draws one row for each
    conditional input row)."""
    if hasattr(p, "inner_pdf"):
        return p.sample(params, conditional_input=ci, generator=g)
    return p.sample(params, samplesize=n, conditional_input=ci, generator=g)


def cond_input(p, n, g):
    """n rows of p's conditional input from the generator g: None, a
    tensor, or one tensor per sub-pdf (a list-valued
    conditional_input_dim)."""
    cd = p.conditional_input_dim
    if cd is None:
        return None
    if isinstance(cd, list):
        return [torch.randn((n, w), generator=g, device=p.device) for w in cd]
    return torch.randn((n, cd), generator=g, device=p.device)


def ci_map(ci, fn):
    """fn of a conditional input, or of each tensor of a list of them."""
    if ci is None:
        return None
    return [fn(c) for c in ci] if isinstance(ci, list) else fn(ci)


def roundtrip(p, params, n, ci, seed):
    """sample n rows, then log_prob of them; returns (x, base draws,
    |dlogp|)."""
    g = torch.Generator(device=p.device).manual_seed(seed)
    x, z, lp_sample, _ = sample_rows(p, params, n, ci, g)
    lp_eval, _, _ = p.log_prob(params, x, conditional_input=ci)
    torch.cuda.synchronize()
    for name, t in (("x", x), ("log_pdf", lp_sample), ("log_prob", lp_eval)):
        if t.shape[0] != n or not torch.isfinite(t).all():
            raise AssertionError(f"non-finite or misshapen {name}")
    if x.shape[1] != getattr(p, "inner_pdf", p).total_target_dim:
        raise AssertionError(f"samples have width {x.shape[1]}")
    return x, z, (lp_eval - lp_sample).abs()


def serve(label, p, params, n, ci, seed, f32_twin=None):
    """One serving path (sample, then log_prob of the samples) with the
    launch counts set to 0 just before it and read just after; returns
    (samples, launches, recorded block calls, recorded per-layer calls).
    The roundtrip's q999 is held below TOL_ROUNDTRIP_Q999, or, with
    ``f32_twin`` (the model and its parameters on the CPU, float32), within
    TOL_ROUNDTRIP_Q999 of that path's roundtrip on the same base draws."""
    calls, layer_calls = [], []
    reset_counts()
    with recording(calls), recording_layer(layer_calls):
        x, z, d = roundtrip(p, params, n, ci, seed)
    torch.cuda.synchronize()
    launches = counts()
    log(f"{label} ({n} rows): launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if launches != all_counts(EXPECTED_LAUNCHES[label]):
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{EXPECTED_LAUNCHES[label]}")
    if len(calls) + len(layer_calls) != sum(launches.values()):
        raise AssertionError(f"{label}: {len(calls) + len(layer_calls)} "
                             f"entry-point calls for "
                             f"{sum(launches.values())} launches")
    q999 = torch.quantile(d.float(), 0.999).item()
    if f32_twin is None:
        log(f"{label}: sample->log_prob |dlogp| q999 {q999:.3e} max "
            f"{d.max().item():.3e} (limit q999 < {TOL_ROUNDTRIP_Q999:g})")
        if not q999 < TOL_ROUNDTRIP_Q999:
            raise AssertionError(f"{label}: roundtrip q999 {q999:.3e}")
        return x, launches, calls, layer_calls
    from jammy_flows_tpu_torch.ops.special import std_normal_log_prob
    twin, twin_params = f32_twin
    zc = z.cpu()
    xc, ldc = twin.all_layer_forward(twin_params, zc, torch.zeros(n))
    dc = (twin.log_prob(twin_params, xc)[0]
          - (std_normal_log_prob(zc) - ldc)).abs()
    q_cpu = torch.quantile(dc, 0.999).item()
    log(f"{label}: sample->log_prob |dlogp| q999 {q999:.3e} max "
        f"{d.max().item():.3e}; the port's CPU f32 path on the same base "
        f"draws q999 {q_cpu:.3e} max {dc.max().item():.3e} (limit |q999 - "
        f"its| < {TOL_ROUNDTRIP_Q999:g})")
    if not abs(q999 - q_cpu) < TOL_ROUNDTRIP_Q999:
        raise AssertionError(f"{label}: roundtrip q999 {q999:.3e}, the CPU "
                             f"f32 path's {q_cpu:.3e}")
    return x, launches, calls, layer_calls


def cpu_twin(p, opts=None):
    """p's model (its definitions, options, conditional input, MLP widths)
    on the CPU."""
    from jammy_flows_tpu_torch import pdf
    return pdf("+".join(p.pdf_defs_list), "+".join(p.flow_defs_list),
               options_overwrite=opts,
               conditional_input_dim=p.conditional_input_dim,
               amortization_mlp_dims=p.amortization_mlp_dims,
               predict_log_normalization=p.predict_log_normalization,
               device="cpu")


def cross_check(label, p, params, x, ci, opts=None, p_cpu=None,
                f32_held=False):
    """The card's f32 log_prob of N_CROSS samples against the port's f64
    CPU path (``p_cpu``, by default cpu_twin(p, opts)); with ``f32_held``
    against its f32 CPU path, the f64 distance printed."""
    from jammy_flows_tpu_torch.utils.convert import params_from_jax
    xs = x[:N_CROSS]
    cis = ci_map(ci, lambda c: c[:N_CROSS])
    lp_gpu = p.log_prob(params, xs, conditional_input=cis)[0].double().cpu()
    p_cpu = p_cpu or cpu_twin(p, opts)
    par64 = params_from_jax({k: v.cpu().numpy() for k, v in params.items()},
                            dtype=torch.float64)
    ci64 = ci_map(cis, lambda c: c.double().cpu())
    lp_cpu = p_cpu.log_prob(par64, xs.double().cpu(),
                            conditional_input=ci64)[0]
    cross = (lp_gpu - lp_cpu).abs().max().item()
    log(f"{label}: card f32 vs CPU f64 log_prob on {N_CROSS} samples: "
        f"max|diff| {cross:.3e} " + ("(printed)" if f32_held
                                     else f"(limit {TOL_CROSS:g})"))
    if f32_held:
        lp_32 = p_cpu.log_prob({k: v.float() for k, v in par64.items()},
                               xs.cpu(), conditional_input=ci_map(
                                   ci64, lambda c: c.float()))[0].double()
        cross = (lp_gpu - lp_32).abs().max().item()
        log(f"{label}: card f32 vs CPU f32 log_prob on {N_CROSS} samples: "
            f"max|diff| {cross:.3e} (limit {TOL_CROSS:g}); CPU f32 vs f64 "
            f"{(lp_32 - lp_cpu).abs().max().item():.3e} (printed)")
    if not cross < TOL_CROSS:
        raise AssertionError(f"{label}: card vs CPU log_prob differ by "
                             f"{cross:.3e}")


# ---------------------------------------------------------------------------
# training: the backward (T2) and fused NLL (T3) calls, held against the
# plain versions
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recording_bwd(calls):
    """Wrap the block backward and the fused NLL call so that every T2 / T3
    call appends (name, kind, inputs, outputs) to ``calls``, as copies; the
    wrapped call still launches, and counts, its kernel once."""
    from jammy_flows_tpu_torch.ops import gf_block as gb
    run_bwd, run_nll = gb._run_bwd, gb._run_nll

    def bwd(direction, res, params, g_out, g_ld, prep, meta, mode):
        kept = (res.clone(), tuple(p.clone() for p in params),
                g_out.contiguous().clone(), g_ld.contiguous().clone())
        gx, grads = run_bwd(direction, res, params, g_out, g_ld, prep, meta,
                            mode)
        calls.append((f"{direction}_bwd_{gb._COUNTER[mode]}", direction,
                      kept, prep, meta, mode,
                      (gx.clone(), tuple(g.clone() for g in grads))))
        return gx, grads

    def nll(x, params, prep, meta, mode, wv, wl):
        kept = (x.clone(), tuple(p.clone() for p in params), wv, wl)
        val, ld, gx, grads = run_nll(x, params, prep, meta, mode, wv, wl)
        calls.append((f"nll_{gb._COUNTER[mode]}", "nll", kept, prep, meta,
                      mode, (val.clone(), ld.clone(), gx.clone(),
                             tuple(g.clone() for g in grads))))
        return val, ld, gx, grads

    gb._run_bwd, gb._run_nll = bwd, nll
    try:
        yield
    finally:
        gb._run_bwd, gb._run_nll = run_bwd, run_nll


def grad_errors(got, ref, per_row=None):
    """(largest relative error, largest absolute difference, the output with
    the largest relative error) over a call's gradients (gx, then the
    parameters' in the wrapper's order): per-row ones (``per_row``; by
    default gx and a block's gsummary or ghidden) as max|diff| / max|ref|,
    broadcast ones as relative norms."""
    rel, absd, worst = 0.0, 0.0, 0
    for i, (a, b) in enumerate(zip(got, ref)):
        if not torch.isfinite(a).all():
            return float("inf"), float("inf"), i
        d = (a.double() - b.double())
        absd = max(absd, d.abs().max().item() if d.numel() else 0.0)
        if per_row is not None:
            row_wise = per_row[i]
        else:
            row_wise = i == 0 or (i == 1 and len(got) > 2)
        if row_wise:
            scale = b.abs().max().item() if b.numel() else 0.0
            e = d.abs().max().item() / scale if scale > 0 else 0.0
        else:
            n = b.double().norm().item()
            e = d.norm().item() / n if n > 0 else d.norm().item()
        if e > rel:
            rel, worst = e, i
    return rel, absd, worst


def check_bwd_calls(label, calls):
    """Each recorded T2 / T3 call against its plain version on the same
    inputs, and each T3 call's val / ld against the T1 forward's; returns
    the largest |diff| per kernel."""
    from jammy_flows_tpu_torch.ops import gf_block as gb
    errs = {}
    for name, kind, kept, prep, meta, mode, outs in calls:
        if kind == "nll":
            x, params, wv, wl = kept
            val, ld, gx, grads = outs
            ref = gb.block_nll_plain(x, params, prep, meta, mode, wv, wl)
            got, want = (gx, *grads), (ref[2], *ref[3])
            t1_out, t1_ld = gb._run(x, params, prep, meta, mode, "density")
            t13 = max((val - t1_out).abs().max().item(),
                      (ld - t1_ld).abs().max().item())
            log(f"{label} {name}: T3 val/ld vs T1 max|diff| {t13:.3e} "
                f"(limit {TOL_T3_VS_T1:g})")
            if not t13 <= TOL_T3_VS_T1:
                raise AssertionError(f"{label} {name}: T3 val/ld differ from "
                                     f"T1 by {t13:.3e}")
        else:
            res, params, g_out, g_ld = kept
            gx, grads = outs
            ref = gb.block_bwd_plain(kind, res, params, g_out, g_ld, prep,
                                     meta, mode)
            got, want = (gx, *grads), (ref[0], *ref[1])
        torch.cuda.synchronize()
        rel, absd, worst = grad_errors(got, want)
        tol = TOL_GRAD[kind]
        log(f"kernel vs plain {label} {name} ({kept[0].shape[0]} rows): "
            f"largest relative error {rel:.3e} (output {worst}), max|diff| "
            f"{absd:.3e} (limit {tol:g})")
        if not rel < tol:
            raise AssertionError(f"{label} {name}: kernel disagrees with its "
                                 f"plain version ({rel:.3e} >= {tol:g})")
        errs[name] = max(errs.get(name, 0.0), absd)
    return errs


def train_path(label, what, p, fn, record=True):
    """One training path with the launch counts set to 0 just before it and
    read just after; returns (result, launches, recorded T2 / T3 calls,
    recorded per-layer calls; none without ``record``)."""
    calls, layer_calls = [], []
    reset_counts()
    with contextlib.ExitStack() as stack:
        if record:
            stack.enter_context(recording_bwd(calls))
            stack.enter_context(recording_layer(layer_calls))
        out = fn()
    torch.cuda.synchronize()
    launches = counts()
    want = all_counts(EXPECTED_TRAIN_LAUNCHES[label][what])
    log(f"{label} training path {what}: launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if launches != want:
        raise AssertionError(f"{label} {what}: launches {launches}, expected "
                             f"{want}")
    return out, launches, calls, layer_calls


def sample_objective(p, pp, z, ci):
    """(x**2).mean() + 0.1 * log q.mean() through all_layer_forward on base
    draws z (log q = log N(z) - log det; log N(z) does not depend on the
    parameters)."""
    x, ld = p.all_layer_forward(pp, z, torch.zeros(z.shape[0], dtype=z.dtype,
                                                   device=z.device), ci)
    return (x**2).mean() - 0.1 * ld.mean()


def rel_norm(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return (a - b).norm().item() / max(b.norm().item(), 1e-300)


def card_vs_f64_grads(label, p, params, xs, zs, cis, opts, sample_f32=False,
                      f32_reading=False, nll_f32=False):
    """The card's f32 gradients of the NLL and of the sample objective on
    N_CROSS rows against the port's f64 CPU path, as relative norms.  With
    ``sample_f32`` the sample objective's gradient is held against the
    port's f32 CPU path instead, and its distance to f64 only printed (the
    centred models: there the JAX package's own f32 path lies up to 1.0e-3
    from its f64 path, PERF.md); with ``nll_f32`` the NLL gradient likewise
    (the production `f` stack: the JAX package's f32 NLL gradient lies
    4.8e-3 from its f64 one, PERF.md).  With ``f32_reading`` the f64 limit
    holds and the card's and the f32 CPU path's distances to each other and
    to f64 are printed beside it: they tell an f32 algorithm's own distance
    from one the card adds."""
    from jammy_flows_tpu_torch.utils.convert import params_from_jax
    p_cpu = cpu_twin(p, opts)
    par64 = params_from_jax({k: v.cpu().numpy() for k, v in params.items()},
                            dtype=torch.float64)
    cis64 = ci_map(cis, lambda c: c.double().cpu())
    _, gn_card = p.nll_value_and_grad(params, xs, cis)
    _, gn_cpu = p_cpu.nll_value_and_grad(par64, xs.double().cpu(), cis64)
    _, gs_card = p._value_and_grad(
        lambda pp: sample_objective(p, pp, zs, cis), params)
    _, gs_cpu = p_cpu._value_and_grad(
        lambda pp: sample_objective(p_cpu, pp, zs.double().cpu(), cis64),
        par64)
    checks = [("card f32", "NLL", "f64", gn_card, gn_cpu, not nll_f32),
              ("card f32", "sample", "f64", gs_card, gs_cpu, not sample_f32)]
    par32 = {k: v.cpu() for k, v in params.items()}
    if nll_f32:
        _, gn_32 = p_cpu.nll_value_and_grad(par32, xs.cpu(),
                                            ci_map(cis, lambda c: c.cpu()))
        checks.append(("card f32", "NLL", "f32", gn_card, gn_32, True))
        checks.append(("CPU f32", "NLL", "f64", gn_32, gn_cpu, False))
    if sample_f32 or f32_reading:
        _, gs_32 = p_cpu._value_and_grad(
            lambda pp: sample_objective(p_cpu, pp, zs.cpu(),
                                        ci_map(cis, lambda c: c.cpu())), par32)
        checks.append(("card f32", "sample", "f32", gs_card, gs_32,
                       sample_f32))
    if f32_reading:
        checks.append(("CPU f32", "sample", "f64", gs_32, gs_cpu, False))
    for who, what, ref, a, b, held in checks:
        rels = {k: rel_norm(a[k], b[k]) for k in a}
        log(f"{label}: {who} vs CPU {ref} {what} gradient on "
            f"{xs.shape[0]} rows: relative norms "
            f"{', '.join(f'{k} {v:.3e}' for k, v in rels.items())}"
            + (f" (limit {TOL_CROSS_GRAD:g})" if held else " (printed)"))
        if held and not max(rels.values()) < TOL_CROSS_GRAD:
            raise AssertionError(f"{label}: card vs CPU {ref} {what} "
                                 "gradient")


def ragged_layer_check(label, layer_calls):
    """A ragged batch (N_RAGGED rows) through T4 and the T7 density body on
    the inputs of the first recorded forward call of each interface, against
    the plain versions."""
    from jammy_flows_tpu_torch.ops import gf_layer as gl
    errs = {}
    done = set()
    for name, mode, iface, kept, ift, prep, kd, _ in layer_calls:
        if mode != "forward" or iface in done:
            continue
        done.add(iface)
        x, params = kept
        x = x[:N_RAGGED]
        params = (params[0][:N_RAGGED].contiguous(),) + params[1:] \
            if iface == "lazy" else tuple(
                t[..., :N_RAGGED].contiguous() if t.ndim == 3 else t
                for t in params)
        g = torch.Generator(device=x.device).manual_seed(9)
        g1 = torch.randn(x.shape, generator=g, device=x.device)
        g2 = torch.randn(x.shape, generator=g, device=x.device)
        out = gl._run("forward", iface, x, params, ift, prep, kd)
        ref = gl.layer_plain("forward", iface, x, params, ift, prep, kd)
        e_fwd = max((a - b).abs().max().item() for a, b in zip(out, ref))
        gx, gp = gl._launch_bwd("forward", iface, x, params, g1, g2, ift,
                                prep, kd)
        rgx, rgp = gl.layer_bwd_plain("forward", iface, x, params, g1, g2,
                                      ift, prep, kd)
        torch.cuda.synchronize()
        rel, absd, _ = grad_errors((gx, *gp), (rgx, *rgp),
                                   per_row=layer_per_row(iface, params))
        log(f"{label} forward_{iface} ragged ({N_RAGGED} rows): T4 max|diff| "
            f"{e_fwd:.3e} (limit {TOL_DENSITY:g}); T7 largest relative error "
            f"{rel:.3e}, max|diff| {absd:.3e} (limit {TOL_GRAD['density']:g})")
        if not (e_fwd < TOL_DENSITY and rel < TOL_GRAD["density"]):
            raise AssertionError(f"{label} forward_{iface}: ragged batch "
                                 "disagrees")
        errs[err_key(f"forward_{iface}", iface, prep)] = e_fwd
        errs[err_key(f"forward_bwd_{iface}", iface, prep)] = absd
    return errs


def train(label, p, params, seed, opts=None, f32_reading=False,
          f32_held=False, sample_f32=False, init=None, fit_steps=TRAIN_STEPS,
          reps=10, n_cross=N_CROSS, warm_rows=4096, report=None):
    """The training phase of one configuration; returns (launches per path,
    errors per kernel, recorded block calls, recorded per-layer calls, step
    times).  ``f32_reading``: card_vs_f64_grads's; ``f32_held``: both
    gradients held against the port's f32 CPU path (its ``nll_f32`` and
    ``sample_f32``), ``sample_f32`` the sample objective's alone.
    ``train.fit`` takes ``fit_steps`` Adam steps from
    ``init`` (init_params(seed=0) by default; none with 0, as many as
    FIT_BUDGET_S allows at the fused NLL's time with None) on the sampled
    rows, after a one-step fit on ``warm_rows``; the steps are timed over
    ``reps`` calls; the gradients are held against the CPU path on
    ``n_cross`` rows; ``report(what)`` runs after each path."""
    from jammy_flows_tpu_torch import train as ttrain
    report = report or (lambda what: None)
    dev = p.device
    g = torch.Generator(device=dev).manual_seed(seed)
    ci = cond_input(p, N_TRAIN, g)
    # the rows come from another jittered model (flow_0 moved as well): at
    # the model that drew them, a gradient is a sum of cancelling per-row
    # terms and its relative error measures float32 summation order only
    with torch.no_grad():
        x = p.sample(jittered_params(p, seed + 100, flow_scale=0.1),
                     samplesize=N_TRAIN, conditional_input=ci,
                     generator=g)[0]
    z = torch.randn((N_TRAIN, p.total_base_dim), generator=g, device=dev)

    report("sampling the training rows")
    t_nll = time.time()
    (l_f, g_f), l_nll, c_nll, lc_nll = train_path(
        label, "nll", p, lambda: p.nll_value_and_grad(params, x, ci))
    t_nll = time.time() - t_nll
    report("nll_value_and_grad")
    (l_a, g_a), l_lp, c_lp, lc_lp = train_path(
        label, "log_prob_grad", p, lambda: p._value_and_grad(
            lambda pp: -p.log_prob(pp, x, ci)[0].mean(), params))
    report("autograd of -log_prob().mean()")
    (l_s, g_s), l_sg, c_sg, lc_sg = train_path(
        label, "sample_grad", p, lambda: p._value_and_grad(
            lambda pp: sample_objective(p, pp, z, ci), params))
    report("autograd of the sample objective")

    d_loss = abs(l_f.item() - l_a.item())
    rels = {k: rel_norm(g_f[k], g_a[k]) for k in g_f}
    log(f"{label}: nll_value_and_grad {l_f.item():.6f} vs autograd "
        f"{l_a.item():.6f} (|diff| {d_loss:.3e}, limit {TOL_NLL_LOSS:g}); "
        f"gradient relative norms "
        f"{', '.join(f'{k} {v:.3e}' for k, v in rels.items())} "
        f"(limit {TOL_GRAD['nll']:g})")
    if not (d_loss < TOL_NLL_LOSS and max(rels.values()) < TOL_GRAD["nll"]):
        raise AssertionError(f"{label}: nll_value_and_grad disagrees with "
                             "autograd")
    for k, v in list(g_f.items()) + list(g_s.items()):
        if not torch.isfinite(v).all():
            raise AssertionError(f"{label}: non-finite gradient {k}")
    log(f"{label}: sample objective {l_s.item():.6f}, gradient norms "
        f"{', '.join(f'{k} {v.norm().item():.4g}' for k, v in g_s.items())}")

    errs = {}
    for k, v in list(check_bwd_calls(label, c_nll + c_lp + c_sg).items()) + \
            list(check_layer_calls(label, lc_nll + lc_lp + lc_sg).items()):
        errs[k] = max(errs.get(k, 0.0), v)

    # a ragged batch through T3 (blocks) and through T4 / T7 (layers),
    # against the plain versions
    from jammy_flows_tpu_torch.ops import gf_block as gb
    for name, kind, kept, prep, meta, mode, _ in c_nll:
        if kind != "nll":
            continue
        xr, params_r, wv, wl = kept
        xr = xr[:N_RAGGED]
        params_r = (params_r[0][:N_RAGGED].contiguous(),) + params_r[1:] \
            if mode != "perm" else params_r
        out = gb._run_nll(xr, params_r, prep, meta, mode, wv, wl)
        ref = gb.block_nll_plain(xr, params_r, prep, meta, mode, wv, wl)
        rel, absd, _ = grad_errors((out[2], *out[3]), (ref[2], *ref[3]))
        log(f"{label} {name} ragged ({N_RAGGED} rows): largest relative "
            f"error {rel:.3e}, max|diff| {absd:.3e} (limit "
            f"{TOL_GRAD['nll']:g})")
        if not rel < TOL_GRAD["nll"]:
            raise AssertionError(f"{label} {name}: ragged batch disagrees")
        errs[name] = max(errs.get(name, 0.0), absd)
    for k, v in ragged_layer_check(label, lc_lp).items():
        errs[k] = max(errs.get(k, 0.0), v)
    lc_calls = first_calls(lc_nll + lc_lp + lc_sg)
    del lc_nll, lc_lp, lc_sg

    # card f32 against the port's f64 CPU path, n_cross rows
    card_vs_f64_grads(label, p, params, x[:n_cross], z[:n_cross],
                      ci_map(ci, lambda c: c[:n_cross]), opts,
                      f32_reading=f32_reading, nll_f32=f32_held,
                      sample_f32=f32_held or sample_f32)
    report(f"gradients on {n_cross} rows (card, then the CPU f64 path)")
    launches = {"nll": l_nll, "log_prob_grad": l_lp, "sample_grad": l_sg}

    if fit_steps is None:
        fit_steps = max(2, min(TRAIN_STEPS, int(FIT_BUDGET_S / t_nll)))
        log(f"{label}: {fit_steps} train.fit steps: the fused NLL step took "
            f"{t_nll:.1f} s (host clock, with its recording), "
            f"{FIT_BUDGET_S:g} s allowed for the fit, {TRAIN_STEPS} at most")
    if fit_steps:
        # train.fit: fit_steps full-batch Adam steps from init (by default
        # init_params(seed=0)) on the rows sampled from the jittered model
        init = p.init_params(seed=0) if init is None else init
        # one untimed step first: the first optimizer step of a process
        # carries one-time set-up (torch.optim's lazy imports)
        ttrain.fit(p, init, x[:warm_rows], num_steps=1,
                   conditional_input=ci_map(ci, lambda c: c[:warm_rows]),
                   learning_rate=TRAIN_LR)
        torch.cuda.synchronize()
        report("the one-step warm-up fit")
        t0 = time.time()
        (_, losses), l_fit, _, _ = train_path(
            label, "fit", p, lambda: ttrain.fit(
                p, init, x, conditional_input=ci, num_steps=fit_steps,
                learning_rate=TRAIN_LR), record=False)
        torch.cuda.synchronize()
        fit_s = time.time() - t0
        launches["fit"] = l_fit
        log(f"{label}: train.fit {fit_steps} Adam steps (lr {TRAIN_LR:g}, "
            f"{N_TRAIN} rows): NLL {losses[0]:.6f} -> {losses[-1]:.6f}; "
            f"{fit_s / fit_steps * 1e3:.3f} ms per step (host clock, mean, "
            "after a one-step warm-up fit)")
        log(f"{label}: loss history {' '.join(f'{v:.6f}' for v in losses)}")
        report("train.fit")
        if not (len(losses) == fit_steps and all(map(math.isfinite, losses))
                and losses[-1] < losses[0]):
            raise AssertionError(f"{label}: training did not lower the "
                                 f"loss: {list(losses)}")

    # one timed call needs no warm-up: the paths above ran the same call
    step_fused = cuda_ms(lambda: p.nll_value_and_grad(params, x, ci), reps,
                         warm=reps > 1)
    step_auto = cuda_ms(lambda: p._value_and_grad(
        lambda pp: -p.log_prob(pp, x, ci)[0].mean(), params), reps,
                        warm=reps > 1)
    log(f"{label} value-and-grad step at {N_TRAIN} rows: nll_value_and_grad "
        f"{step_fused:.3f} ms, autograd {step_auto:.3f} ms (median of "
        f"{reps})")
    report("the timed steps")
    return (launches, errs, c_nll + c_lp + c_sg, lc_calls,
            (step_fused, step_auto))


def nan_report(what, outs):
    """Each (name, kernel's outputs, plain version's, kernel's without the
    NaN, per row) of ``outs``: NaN in exactly the plain version's places,
    at least one, and (per row) every row the plain version keeps free of
    NaN equal to the kernel's result without the NaN, bit for bit."""
    torch.cuda.synchronize()
    for name, got, ref, want, per_row in outs:
        n_nan = [int(torch.isnan(a).sum()) for a in got]
        same = all(torch.equal(torch.isnan(a), torch.isnan(r))
                   for a, r in zip(got, ref))
        kept = True
        if per_row:
            rows = ~torch.isnan(ref[0]).any(dim=1)
            kept = all(torch.equal(a[rows], c[rows])
                       for a, c in zip(got, want))
        log(f"NaN in {what}: {name}: NaN entries {n_nan} (plain "
            f"{[int(torch.isnan(r).sum()) for r in ref]}), in the same "
            f"places {same}" + (f", rows without NaN equal to the "
                                f"clean run's {kept}" if per_row else ""))
        if not (same and kept and sum(n_nan)):
            raise AssertionError(f"NaN in {what}: {name} does not keep "
                                 "the NaN as its plain version does")


def mean_row(meta, layer, comp, dim):
    """The row of a block's mixture mean (layer, component, dimension) in
    its (P,) parameter vector and its MLP's final rows."""
    from jammy_flows_tpu_torch.ops import gf_block as gb
    k, d, layers = meta
    idx = torch.arange(gb.block_rows(k, d, layers), dtype=torch.float64)
    means = gb._make_slabs([idx[:, None]], k, d, layers, "perm")[layer][2][0]
    return int(means[comp, dim, 0])


def nan_check(dev):
    """One NaN made on the card as 0/0 (0x7fffffff) in the summary or in w
    of the flagship's lazy2 block, through T1 lazy2 (both directions) and
    T3 lazy2; and one mixture mean (the last layer's component 3 of
    dimension 2) made NaN in flow_0 or in the lazy2 block's final bias,
    through T1 sample_perm and sample_lazy2 (the solve's bracket keeps it,
    as the plain version's does): NaN in exactly the outputs where the
    plain version has it, and every row it does not reach equal to the
    kernel's result without the NaN, bit for bit (the 3xTF32 split and
    the mixtures keep a NaN)."""
    from jammy_flows_tpu_torch import pdf
    from jammy_flows_tpu_torch.ops import gf_block as gb
    p = pdf(*FLAGSHIP, device=dev)
    prep, meta = p._block_meta[2]
    par = jittered_params(p, seed=90)
    mlp = p.mlp_predictors[2]
    w1, b1 = (t.contiguous() for t in mlp.first_layer_weights(par["mlp_2"]))
    w, b = (t.contiguous() for t in mlp.final_layer_weights(par["mlp_2"]))
    g = torch.Generator(device=dev).manual_seed(91)
    x = 0.8 * torch.randn((N_NAN, 4), generator=g, device=dev)
    summary = torch.randn((N_NAN, mlp.input_dim), generator=g, device=dev)
    clean = (summary, w1, b1, w, b)
    zero = torch.zeros((), device=dev)
    for what in ("summary", "w"):
        bad_s, bad_w = summary.clone(), w.clone()
        if what == "summary":
            bad_s[5, 1] = zero / zero
        else:
            bad_w[9, 7] = zero / zero
        params = (bad_s, w1, b1, bad_w, b)
        outs = []
        for direction in ("density", "sample"):
            got = gb._launch(x, params, prep, meta, "lazy2", direction)
            want = gb._launch(x, clean, prep, meta, "lazy2", direction)
            ref = gb.block_plain(direction, x, params, prep, meta, "lazy2")
            outs.append((f"{direction}_lazy2", got, ref, want, True))
        wv, wl = 1.0 / N_NAN, -1.0 / N_NAN
        got = gb._launch_bwd("nll", x, params, None, None, prep, meta,
                             "lazy2", wv, wl)
        want = gb._launch_bwd("nll", x, clean, None, None, prep, meta,
                              "lazy2", wv, wl)
        ref = gb.block_nll_plain(x, params, prep, meta, "lazy2", wv, wl)
        # per row: val, ld, gx, gsummary; then the broadcast gradients
        outs.append(("nll_lazy2", (*got[:3], got[3][0]),
                     (*ref[:3], ref[3][0]), (*want[:3], want[3][0]), True))
        outs.append(("nll_lazy2 broadcast", got[3][1:], ref[3][1:], None,
                     False))
        nan_report(what, outs)
    outs = []
    for mode, blk, ps in (("perm", 0, (par["flow_0"].contiguous(),)),
                          ("lazy2", 2, clean)):
        prep_b, meta_b = p._block_meta[blk]
        bad = list(ps)
        bad[-1] = bad[-1].clone()
        bad[-1][mean_row(meta_b, len(meta_b[2]) - 1, 3, 2)] = zero / zero
        bad = tuple(bad)
        outs.append((f"sample_{mode}",
                     gb._launch(x, bad, prep_b, meta_b, mode, "sample"),
                     gb.block_plain("sample", x, bad, prep_b, meta_b, mode),
                     gb._launch(x, ps, prep_b, meta_b, mode, "sample"), True))
    nan_report("a component's mean", outs)


def perm_repeat_check(calls):
    """The perm backward kernels (T3, both T2 bodies) on the first recorded
    call's own inputs, launched twice more: the same bits each time."""
    from jammy_flows_tpu_torch.ops import gf_block as gb
    for name in PERM_BWD:
        _, kind, kept, prep, meta, mode, _ = next(c for c in calls
                                                  if c[0] == name)
        x, params = kept[:2]
        g_out, g_ld = (None, None) if kind == "nll" else kept[2:]
        wv, wl = kept[2:] if kind == "nll" else (0.0, 0.0)
        a, b = (gb._launch_bwd(kind, x, params, g_out, g_ld, prep, meta,
                               mode, wv, wl) for _ in range(2))
        torch.cuda.synchronize()
        same = all((u is None and v is None) or torch.equal(u, v)
                   for u, v in zip((*a[:3], *a[3]), (*b[:3], *b[3])))
        log(f"{name} ({x.shape[0]} rows): two launches bit-equal {same}")
        if not same:
            raise AssertionError(f"{name}: two launches on the same inputs "
                                 "differ")


def mlp_widths(mode, params):
    """(n_in, hid) of a block call's parameters."""
    if mode == "lazy2":
        return params[0].shape[1], params[1].shape[0]
    if mode == "lazy":
        return 0, params[0].shape[1]
    return 0, 0


def time_bwd_kernels(names, calls, launches_by_path, errs, card):
    """Each backward kernel in ``names`` on the first recorded call's own
    inputs (an unconditional training path): kernel, plain version, bound;
    returns the JSON rows."""
    from jammy_flows_tpu_torch.ops import gf_block as gb
    rows = []
    for name in names:
        _, kind, kept, prep, meta, mode, _ = next(c for c in calls
                                                  if c[0] == name)
        if kind == "nll":
            x, params, wv, wl = kept
            fn = lambda: gb._launch_bwd("nll", x, params, None, None, prep,
                                        meta, mode, wv, wl)
            plain = lambda: gb.block_nll_plain(x, params, prep, meta, mode,
                                               wv, wl)
        else:
            x, params, g_out, g_ld = kept
            fn = lambda: gb._launch_bwd(kind, x, params, g_out, g_ld, prep,
                                        meta, mode)
            plain = lambda: gb.block_bwd_plain(kind, x, params, g_out, g_ld,
                                               prep, meta, mode)
        ms = cuda_ms(fn, TIMING_REPS)
        plain_ms = cuda_ms(plain, TIMING_REPS)
        n_in, hid = mlp_widths(mode, params)
        flops, byts = work(name, x.shape[0], meta, n_in, hid)
        b_ms, b_by = bound_ms(flops, byts)
        p_rows = gb.block_rows(*meta)
        tc_ms = tc_bound_ms(flops, byts, product_flops(name, x.shape[0],
                                                       p_rows, hid))
        log(f"{name} at {x.shape[0]} rows on {card}: kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
            f"{flops:.4g} flop, {byts:.4g} B), tensor-core bound "
            f"{tc_ms:.4f} ms")
        by_path = {f"{cfg} {what}": n[name]
                   for cfg, paths in launches_by_path.items()
                   for what, n in paths.items() if n[name]}
        replaces = "jammy_flows_tpu/ops/pallas_gf_block.py:" + (
            "536" if kind == "nll" else "514")
        rows.append({"name": f"gf_block_{name}", "route": "cuda",
                     "source": "jammy_flows_tpu_torch/csrc/gf_block_bwd.cu",
                     "replaces": replaces,
                     "launches": sum(by_path.values()),
                     "launches_by_path": by_path,
                     "max_abs_err": errs[name],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "tc_bound_ms": tc_ms,
                     "library_ms": None})
        if name in TILE_KERNELS:
            rows[-1]["products_matmul_ms"] = products_matmul_ms(
                name, x.shape[0], p_rows, hid, x.device)
            log(f"{name}: its P x H products alone as torch.matmul (f32, "
                f"highest) {rows[-1]['products_matmul_ms']:.4f} ms (a "
                f"yardstick)")
    return rows


# ---------------------------------------------------------------------------
# the per-layer route (T4-T7), held against the plain versions
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recording_layer(calls):
    """Wrap the per-layer kernel calls (every entry point and the T7 bodies
    go through ``gf_layer._run`` / ``_run_bwd``) so that each appends (name,
    mode or body, interface, inputs, ift, prep, kd, outputs) to ``calls``,
    as copies; the wrapped call still launches, and counts, its kernel
    once."""
    from jammy_flows_tpu_torch.ops import gf_layer as gl
    run, run_bwd = gl._run, gl._run_bwd

    def fwd(mode, iface, x, params, ift, prep, kd):
        kept = (x.clone(), tuple(t.clone() for t in params))
        out = run(mode, iface, x, params, ift, prep, kd)
        outs = out if isinstance(out, tuple) else (out,)
        calls.append((f"{mode}_{iface}", mode, iface, kept, ift, prep, kd,
                      tuple(o.clone() for o in outs)))
        return out

    def bwd(body, iface, x, params, g1, g2, ift, prep, kd):
        kept = (x.clone(), tuple(t.clone() for t in params),
                g1.contiguous().clone(), g2.contiguous().clone())
        gx, grads = run_bwd(body, iface, x, params, g1, g2, ift, prep, kd)
        calls.append((f"{body}_bwd_{iface}", body, iface, kept, ift, prep, kd,
                      (gx.clone(), *(g.clone() for g in grads))))
        return gx, grads

    gl._run, gl._run_bwd = fwd, bwd
    try:
        yield
    finally:
        gl._run, gl._run_bwd = run, run_bwd


def first_calls(calls):
    """The first recorded per-layer call of each name, broadcast and per row
    (the ones timed); the others are dropped to free the card's memory."""
    kept, seen = [], set()
    for c in calls:
        key = (c[0], c[2] != "lazy" and c[3][1][0].ndim == 3)
        if key not in seen:
            seen.add(key)
            kept.append(c)
    return kept


def layer_per_row(iface, params):
    """Which outputs of a T7 call are per row: gx, then the parameters'
    gradients (lazy: hidden per row, w and b summed; raw: the slabs)."""
    if iface == "lazy":
        return (True, True, False, False)
    return (True,) + tuple(t.ndim == 3 for t in params)


def err_key(name, iface, prep):
    """The key of a per-layer call's largest |diff|: its name, with
    "_unskewed" for a raw or lazy call on the plain mixture."""
    return name if iface == "prepared" or prep[3] is not None \
        else f"{name}_unskewed"


def check_layer_calls(label, calls):
    """Each recorded per-layer call against its plain version on the same
    inputs; returns the largest |diff| per entry point / body (err_key)."""
    from jammy_flows_tpu_torch.ops import gf_layer as gl
    errs = {}
    for name, mode, iface, kept, ift, prep, kd, outs in calls:
        if "_bwd_" in name:
            x, params, g1, g2 = kept
            rgx, rgp = gl.layer_bwd_plain(mode, iface, x, params, g1, g2,
                                          ift, prep, kd)
            torch.cuda.synchronize()
            rel, absd, worst = grad_errors(outs, (rgx, *rgp),
                                           layer_per_row(iface, params))
            tol = TOL_GRAD["density" if mode == "forward" else "sample"]
            ok = rel < tol
            err, what = absd, f"largest relative error {rel:.3e} (output " \
                f"{worst}), max|diff| {absd:.3e}"
        else:
            x, params = kept
            ref = gl.layer_plain(mode, iface, x, params, ift, prep, kd)
            ref = ref if isinstance(ref, tuple) else (ref,)
            torch.cuda.synchronize()
            err = max((a - b).abs().max().item() for a, b in zip(outs, ref))
            tol = TOL_DENSITY if mode == "forward" else TOL_SAMPLE
            ok = err < tol and all(torch.isfinite(o).all() for o in outs)
            what = f"max|diff| {err:.3e}"
        log(f"kernel vs plain {label} {name} {ift} ({x.shape[0]} rows): "
            f"{what} (limit {tol:g})")
        if not ok:
            raise AssertionError(f"{label} {name}: kernel disagrees with its "
                                 f"plain version")
        key = err_key(name, iface, prep)
        errs[key] = max(errs.get(key, 0.0), err)
    return errs


def layer_repeat_check(calls):
    """T7 lazy and raw with broadcast slabs (both bodies) on the first
    recorded call's own inputs, launched twice more: the same bits each
    time (persistent blocks walking the tiles in a fixed order, partials
    summed in warp and block order)."""
    from jammy_flows_tpu_torch.ops import gf_layer as gl
    for name in ("forward_bwd_lazy", "sample_bwd_lazy", "forward_bwd_raw",
                 "sample_bwd_raw"):
        _, body, iface, kept, ift, prep, kd, _ = next(
            c for c in calls if c[0] == name and (
                c[2] == "lazy" or c[3][1][0].ndim == 2))
        x, params, g1, g2 = kept
        a, b = (gl._launch_bwd(body, iface, x, params, g1, g2, ift, prep, kd)
                for _ in range(2))
        torch.cuda.synchronize()
        same = all(torch.equal(u, v) for u, v in zip((a[0], *a[1]),
                                                     (b[0], *b[1])))
        log(f"{name} ({x.shape[0]} rows): two launches bit-equal {same}")
        if not same:
            raise AssertionError(f"{name}: two launches on the same inputs "
                                 "differ")


def layer_nan_check(calls):
    """One NaN made on the card as 0/0 in hidden or in w of the first
    recorded forward_lazy call (the skewed flagship's layer, its first
    N_NAN rows), through T4 lazy, T5 lazy (at the same rows as targets) and
    T7 lazy's density body; one row of x made NaN in the first recorded
    broadcast forward_bwd_raw / sample_bwd_raw call (its first N_NAN rows),
    through T7 raw; and one component's mean made NaN in the first recorded
    inverse_prepared calls (the centred flagship's, their first N_NAN
    rows; broadcast, and per row at row 5), through T6 prepared with the
    isigmoid iCDF (its start's bracket keeps the NaN; a regula-falsi start
    bisects to a finite root, in the plain version too): NaN in exactly
    the outputs where the plain version has it (for T7 that row's gx and
    every broadcast gradient), and every row whose per-row outputs it does
    not reach equal to the kernel's result without the NaN, bit for
    bit."""
    from jammy_flows_tpu_torch.ops import gf_layer as gl
    _, _, _, kept, ift, prep, kd, _ = next(c for c in calls
                                           if c[0] == "forward_lazy")
    x = kept[0][:N_NAN].contiguous()
    clean = (kept[1][0][:N_NAN].contiguous(), *kept[1][1:])
    g = torch.Generator(device=x.device).manual_seed(92)
    g1, g2 = (torch.randn(x.shape, generator=g, device=x.device)
              for _ in range(2))
    zero = torch.zeros((), device=x.device)

    def bwd(fn):
        gx, grads = fn
        return (gx, *grads)

    def check(what, name, n_per_row, got, want, ref):
        """got (the kernel's outputs with the NaN) against ref (the plain
        version's) and want (the kernel's without it); the first
        n_per_row outputs are per row."""
        torch.cuda.synchronize()
        n_nan = [int(torch.isnan(a).sum()) for a in got]
        same = all(torch.equal(torch.isnan(a), torch.isnan(r))
                   for a, r in zip(got, ref))
        rows = ~torch.stack([torch.isnan(r).any(dim=1)
                             for r in ref[:n_per_row]]).any(dim=0)
        kept_bits = all(torch.equal(a[rows], c[rows]) for a, c in
                        zip(got[:n_per_row], want[:n_per_row]))
        log(f"NaN in {what}: {name}: NaN entries {n_nan} (plain "
            f"{[int(torch.isnan(r).sum()) for r in ref]}), in the same "
            f"places {same}, rows without NaN equal to the clean run's "
            f"{kept_bits}")
        if not (same and kept_bits and sum(n_nan)):
            raise AssertionError(f"NaN in {what}: {name} does not keep "
                                 "the NaN as its plain version does")

    for what in ("hidden", "w"):
        hidden, w, b = (t.clone() for t in clean)
        if what == "hidden":
            hidden[5, 1] = zero / zero
        else:
            w[9, 7] = zero / zero
        params = (hidden, w, b)
        cases = [(f"{m}_lazy", 2,
                  lambda ps, m=m: gl._launch(m, "lazy", x, ps, ift, prep, kd),
                  lambda m=m: gl.layer_plain(m, "lazy", x, params, ift, prep,
                                             kd))
                 for m in ("forward", "sample")]
        cases.append(("forward_bwd_lazy", 2, lambda ps: bwd(gl._launch_bwd(
            "forward", "lazy", x, ps, g1, g2, ift, prep, kd)),
            lambda: bwd(gl.layer_bwd_plain("forward", "lazy", x, params, g1,
                                           g2, ift, prep, kd))))
        for name, n_per_row, kernel, plain in cases:
            check(what, name, n_per_row, kernel(params), kernel(clean),
                  plain())
    for name in ("forward_bwd_raw", "sample_bwd_raw"):
        _, body, _, kept, ift, prep, _, _ = next(
            c for c in calls if c[0] == name and c[3][1][0].ndim == 2)
        x_clean = kept[0][:N_NAN].contiguous()
        x = x_clean.clone()
        x[5] = zero / zero
        params = kept[1]

        def kernel(xx):
            return bwd(gl._launch_bwd(body, "raw", xx, params, g1, g2, ift,
                                      prep, None))

        check("a row of x", name, 1, kernel(x), kernel(x_clean),
              bwd(gl.layer_bwd_plain(body, "raw", x, params, g1, g2, ift,
                                     prep)))
    for per_row in (False, True):
        kept = next(c[3] for c in calls if c[0] == "inverse_prepared"
                    and (c[3][1][0].ndim == 3) == per_row)
        x = kept[0][:N_NAN].contiguous()
        clean = tuple(t[..., :N_NAN].contiguous() if per_row else t
                      for t in kept[1])
        bad = tuple(t.clone() for t in clean)
        bad[0][(3, 1, 5) if per_row else (3, 1)] = zero / zero

        def kernel(ps):
            return (gl._launch("inverse", "prepared", x, ps, "isigmoid",
                               None, None),)

        check("a component's mean", "inverse_prepared "
              f"({'per row' if per_row else 'broadcast'})", 1, kernel(bad),
              kernel(clean), (gl.layer_plain("inverse", "prepared", x, bad,
                                             "isigmoid"),))


def layer_width_check(dev):
    """The lazy instances of T4 / T5 and both T7 bodies beyond the
    flagship's H = 128: the skewed unconditional flagship with
    amortization_mlp_dims = H for each H in LAYER_WIDTHS (its block-2
    layers take hidden rows of that width) serves N_WIDTH rows (sample,
    then log_prob of rows drawn by a second jittered model) and takes the
    gradients of -log_prob().mean() and of the sample objective; every
    per-layer lazy call is recorded and held against its plain version on
    its inputs.  Returns the largest differences."""
    from jammy_flows_tpu_torch import pdf
    errs = {}
    for hid in LAYER_WIDTHS:
        label = f"skewed H = {hid}"
        p = pdf(*FLAGSHIP, options_overwrite=SKEW,
                amortization_mlp_dims=str(hid), device=dev)
        params = jittered_params(p, seed=94, flow_scale=0.02)
        g = torch.Generator(device=dev).manual_seed(95)
        calls = []
        with recording_layer(calls):
            with torch.no_grad():
                x = p.sample(jittered_params(p, seed=96, flow_scale=0.1),
                             samplesize=N_WIDTH, generator=g)[0]
                p.sample(params, samplesize=N_WIDTH, generator=g)
                p.log_prob(params, x)
            z = torch.randn((N_WIDTH, p.total_base_dim), generator=g,
                            device=dev)
            p._value_and_grad(lambda pp: -p.log_prob(pp, x)[0].mean(),
                              params)
            p._value_and_grad(lambda pp: sample_objective(p, pp, z, None),
                              params)
        lazy = [c for c in calls if c[2] == "lazy"]
        widths = {c[3][1][0].shape[1] for c in lazy}
        if {c[0] for c in lazy} != set(LAYER_TILE_KERNELS) or \
                widths != {hid}:
            raise AssertionError(f"{label}: lazy calls "
                                 f"{sorted({c[0] for c in lazy})} at "
                                 f"widths {widths}")
        for k, v in check_layer_calls(label, lazy).items():
            errs[k] = max(errs.get(k, 0.0), v)
        del calls, lazy
        torch.cuda.empty_cache()
    return errs


def block_lazy_width_check(dev):
    """The block's lazy mode (T1 / T2 lazy) at each width of LAZY_WIDTHS:
    the flagship with "64-<H>" MLPs, block 2, on N_WIDTH rows (hidden rows
    made by its jittered MLP from a random summary): both directions and
    both backward bodies against their plain versions on the same inputs,
    and each T2 lazy body's bits on two launches.  Returns the largest
    differences (values: absolute; gradients: relative norm)."""
    from jammy_flows_tpu_torch import pdf
    from jammy_flows_tpu_torch.ops import gf_block as gb
    errs = {}
    for hid in LAZY_WIDTHS:
        p = pdf(*FLAGSHIP, amortization_mlp_dims=f"64-{hid}", device=dev)
        prep, meta = p._block_meta[2]
        mlp = p.mlp_predictors[2]
        flat = jittered_params(p, seed=97)["mlp_2"]
        g = torch.Generator(device=dev).manual_seed(98)
        with torch.no_grad():
            hidden = mlp.apply_penultimate(flat, torch.randn(
                (N_WIDTH, mlp.input_dim), generator=g, device=dev))
        params = (hidden.contiguous(),
                  *(t.contiguous() for t in mlp.final_layer_weights(flat)))
        x = 0.8 * torch.randn((N_WIDTH, meta[1]), generator=g, device=dev)
        g_out, g_ld = (torch.randn(x.shape, generator=g, device=dev)
                       for _ in range(2))
        for direction in ("density", "sample"):
            out, ld = gb._launch(x, params, prep, meta, "lazy", direction)
            ref = gb.block_plain(direction, x, params, prep, meta, "lazy")
            torch.cuda.synchronize()
            err = max((out - ref[0]).abs().max().item(),
                      (ld - ref[1]).abs().max().item())
            tol = TOL_DENSITY if direction == "density" else TOL_SAMPLE
            log(f"kernel vs plain {direction}_lazy (H = {hid}, {N_WIDTH} "
                f"rows): max|diff| {err:.3e} (limit {tol:g})")
            if not (err < tol and torch.isfinite(out).all()
                    and torch.isfinite(ld).all()):
                raise AssertionError(f"{direction}_lazy at H = {hid}: kernel "
                                     f"disagrees with its plain version "
                                     f"({err:.3e})")
            errs[f"{direction}_lazyh"] = max(errs.get(f"{direction}_lazyh",
                                                  0.0), err)
            res = x if direction == "density" else out
            got, again = (gb._launch_bwd(direction, res, params, g_out, g_ld,
                                         prep, meta, "lazy")[2:]
                          for _ in range(2))
            r_gx, r_gp = gb.block_bwd_plain(direction, res, params, g_out,
                                            g_ld, prep, meta, "lazy")
            torch.cuda.synchronize()
            name = f"{direction}_bwd_lazyh"
            rels = [rel_norm(a, r) for a, r in zip((got[0], *got[1]),
                                                   (r_gx, *r_gp))]
            same = all(torch.equal(a, b) for a, b in zip(
                (got[0], *got[1]), (again[0], *again[1])))
            log(f"kernel vs plain {name} (H = {hid}, {N_WIDTH} rows): "
                f"relative errors gx, ghidden, gw, gb "
                f"{', '.join(f'{e:.3e}' for e in rels)} (limit "
                f"{TOL_GRAD[direction]:g}); bit-equal on two launches: "
                f"{same}")
            if not (max(rels) < TOL_GRAD[direction] and same):
                raise AssertionError(f"{name} at H = {hid}: relative errors "
                                     f"{rels}, repeat bits equal {same}")
            errs[name] = max(errs.get(name, 0.0), *rels)
        del p, params, hidden, x
        torch.cuda.empty_cache()
    return errs


def materialized_ms(call):
    """A yardstick the port never calls: the function of a recorded lazy
    call (T4 / T5 lazy, T7 lazy) through the materialized route on its own
    inputs (tools/tile_breakdown.materialized_route: the rows as
    torch.matmul into per-row slabs, then the raw per-row kernel; T7 also
    ghidden and gw as matmuls and gb as a sum).  Median of 5."""
    from jammy_flows_tpu_torch.ops import gf_layer as gl
    from jammy_flows_tpu_torch.tools import tile_breakdown
    torch.set_float32_matmul_precision("highest")
    name, mode, _, kept, ift, prep, kd, _ = call
    cts = kept[2:] if "_bwd_" in name else None
    ms = cuda_ms(tile_breakdown.materialized_route(
        gl, mode, kept[0], kept[1], ift, prep, kd, cts), 5)
    torch.cuda.empty_cache()
    return ms


def centred_params(p, params):
    """``params`` with the means of every g layer (in flow_0, or in the final
    bias of an MLP) scaled by CENTRE_MEAN_SCALE."""
    out = dict(params)
    for k, layers in enumerate(p.layer_list):
        key = "flow_0" if f"mlp_{k}" not in params else f"mlp_{k}"
        if key not in params:
            continue
        vec = out[key].clone()
        row = vec.shape[0] - sum(p.num_parameter_list[k])
        for lay in layers:
            if getattr(lay, "center_mean", 0):
                lo = row + lay.model_offset * lay.dimension \
                    + lay.num_rotation_params
                vec[lo:lo + lay.num_mean_params] *= CENTRE_MEAN_SCALE
            row += lay.num_params
        out[key] = vec
    return out


# FP32 operations of the per-layer kernels, counted from their expressions
# as work() counts the block kernels' (an FMA as 2, every other operation
# as 1; each function's minimum once; a data-dependent branch counted as a
# row in the bulk takes it), split as work()'s constants are.  The plain
# mixture and the iCDF constants are work()'s.
SKEW_MIX = ops(54, exp=6, log=3)    # per component: c, two softplus, the
                                    # selected branch's logs with the series
                                    # of log((1+e^u)^a - 1), three logsumexp
                                    # terms
SKEW_VAL = ops(45, exp=5, log=3)    # the same without log_pdf (solve-side
                                    # value)
SKEW_DIM = ops(3, log=3)    # per dimension: the three logsumexps' log and add
SKEW_PREP = ops(17, exp=3, log=3)   # per component: log iw, the exponent
                                    # regulator, exp
SKEW_BRACKET = ops(20, exp=1, log=1)    # per component: the skewed
                                        # component quantile
SKEW_BRACKET_DIM = ops(19, exp=2, log=2)    # per dimension: log q,
                                            # log(1-q), the margin
SKEW_ADJ = ops(101, exp=6, log=1)   # per component: partials, softmax
                                    # weights, the cotangents of c, ls, lnw
SKEW_REG_ADJ = ops(3, exp=12, log=6)    # per component: the three
                                        # regulators' derivatives
SKEW_JVP = ops(9)   # sample body, per component: the tangent along dx
LOGIT_PHI = ops(22, exp=1, log=2)   # per dimension, inormal solves
# the plain mixture's solve (work()'s block solve): per component the
# bracket, isigmoid's weighted-quantile start, a value pass of the other
# starts and a Newton evaluation; per dimension a start's value pass and a
# Newton evaluation's logs and iCDF pieces
BRACKET, SIG_START = ops(4), ops(3)
START_COMP, START_PASS = ops(11, exp=1), ops(12, exp=1, log=2)
NEWTON_COMP, NEWTON_EVAL = ops(15, exp=1), ops(24, exp=2, log=4)


def layer_work(name, n, k, d, ift, skew, per_row, n_groups, hid, slots=None):
    """(flops, bytes) of one per-layer kernel call on n rows, name as in
    gf_layer.LAUNCHES.  Per row and dimension: the mixture pass (plain:
    MIX per component; skewed: SKEW), its iCDF pieces, and for a solve the
    bracket, the start (two value passes unless the plain isigmoid start),
    four Newton steps and, for the sample mode, the log-derivative at the
    root; T7 adds the adjoint (and the JVP of the sample body).
    Preparation (regulators, log-softmax, exponents) and T7's regulator
    derivatives count per row for per-row and lazy parameters, once for
    broadcast ones; the lazy interface adds 2 P H + P per row for the
    parameter rows and, in T7, dh = w^T dp and gw = sum_rows dp x hidden
    (2 P H each) and gb (P), P = n_groups K d.  Bytes: each input read
    once, each output written once.  With ``slots`` ({"exp": ops, "log":
    ops}) each library call counts at those operations (the slot bound),
    else at 1."""
    def c(x):
        return cost(x, slots)

    parts = name.split("_")
    mode, iface, bwd = parts[0], parts[-1], parts[1] == "bwd"
    p_rows = n_groups * k * d
    mix_v = k * c(SKEW_VAL) + c(SKEW_DIM)
    mix_p = k * c(SKEW_MIX if skew else MIX) + \
        c(SKEW_DIM if skew else MIX_DIM)
    icdf = c(ICDF.get(ift, ICDF["inormal_partly_precise"]))
    row = 0
    n_eval = 4 + (mode == "sample")     # Newton steps (+ the root's ld)
    if mode == "forward" or bwd:
        row += d * (mix_p + icdf)
    elif not skew:                      # as work()'s block solve
        start = k * c(SIG_START) if ift == "isigmoid" else \
            2 * (k * c(START_COMP) + c(START_PASS))
        row += d * (k * c(BRACKET) + start + n_eval * (
            k * c(NEWTON_COMP) + c(NEWTON_EVAL)))
    else:
        bracket = k * c(SKEW_BRACKET) + c(SKEW_BRACKET_DIM) + (
            0 if ift == "isigmoid" else c(LOGIT_PHI))
        start = 2 * (mix_v + icdf // 2) + 15
        row += d * (bracket + start + n_eval * (mix_p + icdf + 8))
    prep = d * (k * (1 if iface == "prepared" else c(PREP)
                     + (c(SKEW_PREP) if skew else 0)) + c(PREP_DIM))
    if bwd:
        adj, reg = (SKEW_ADJ, SKEW_REG_ADJ) if skew else (ADJ, PREP_ADJ)
        reg_per_row = per_row or iface == "lazy"
        row += d * (k * (c(adj) + (c(reg) if reg_per_row else 0))
                    + c(ADJ_DIM) + c(ICDF_ADJ.get(
                        ift, ICDF_ADJ["inormal_partly_precise"])))
        prep += 0 if reg_per_row else d * k * c(reg)
        if mode == "sample":
            row += d * (k * c(SKEW_JVP if skew else JVP) + c(JVP_DIM)
                        + c(ICDF_JVP.get(
                            ift, ICDF_JVP["inormal_partly_precise"])))
    n_io = 4 if bwd else (2 if mode == "inverse" else 3)
    byts = n_io * n * d * 4
    if iface == "lazy":
        row += prep + 2 * p_rows * hid + p_rows
        if bwd:
            row += 4 * p_rows * hid + p_rows
        weights = p_rows * (hid + 1)
        byts += 4 * (n * hid + weights) * (2 if bwd else 1)
        return row * n, byts
    if per_row:
        row += prep
        byts += 4 * n * p_rows * (2 if bwd else 1)
        return row * n, byts
    byts += 4 * p_rows * (2 if bwd else 1)
    return row * n + prep + (p_rows * n if bwd else 0), byts


def layer_model(opts, cond, dev, seed, defs=FLAGSHIP):
    """The flagship (or ``defs``) with one layer option; its weights are
    init_params(seed=0) with every MLP weight and the permanent flow_0
    (skew exponents and rotation angles included) moved by 0.02 N(0, 1); a
    centred model's means then scaled."""
    from jammy_flows_tpu_torch import pdf
    p = pdf(*defs, options_overwrite=opts, conditional_input_dim=cond,
            device=dev)
    params = jittered_params(p, seed, flow_scale=0.02)
    if opts is CENTRE:
        params = centred_params(p, params)
    return p, params


def centred_grads(label, p, params, opts, seed):
    """The centred model's gradients of log_prob and of the sample objective
    on N_CROSS rows, each path with its own launch counts and recorded calls,
    against the port's f64 CPU path; returns (launches, recorded calls,
    prepared launches by form)."""
    dev = p.device
    g = torch.Generator(device=dev).manual_seed(seed)
    ci = None if p.conditional_input_dim is None else torch.randn(
        (N_CROSS, p.conditional_input_dim), generator=g, device=dev)
    with torch.no_grad():
        x = p.sample(params, samplesize=N_CROSS, conditional_input=ci,
                     generator=g)[0]
    z = torch.randn((N_CROSS, p.total_base_dim), generator=g, device=dev)
    launches, calls, forms = {}, [], {}
    for what, fn in (("log_prob_grad", lambda: p._value_and_grad(
            lambda pp: -p.log_prob(pp, x, ci)[0].mean(), params)),
                     ("sample_grad", lambda: p._value_and_grad(
            lambda pp: sample_objective(p, pp, z, ci), params))):
        got = []
        reset_counts()
        with recording_layer(got):
            _, grads = fn()
        torch.cuda.synchronize()
        launches[what] = counts()
        log(f"{label} {what} ({N_CROSS} rows): launches "
            f"{ {k: v for k, v in launches[what].items() if v} }")
        if launches[what] != all_counts(EXPECTED_CENTRED_GRAD[what]):
            raise AssertionError(f"{label} {what}: launches {launches[what]}")
        for k, v in grads.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"{label}: non-finite gradient {k}")
        forms[what] = prepared_forms(label, what, got, launches[what])
        calls += got
    card_vs_f64_grads(label, p, params, x, z, ci, opts, sample_f32=True)
    return launches, calls, forms


def prepared_forms(label, what, calls, launches):
    """{(name, per row): launches} of the prepared entry points among one
    path's recorded per-layer calls (broadcast slabs run the persistent
    kernel, per-row slabs one block per tile; one counter for both),
    checked against the path's launch counts."""
    forms = collections.Counter(
        (c[0], c[3][1][0].ndim == 3) for c in calls
        if c[0] in ("forward_prepared", "inverse_prepared"))
    for name in ("forward_prepared", "inverse_prepared"):
        if forms[(name, False)] + forms[(name, True)] != launches[name]:
            raise AssertionError(f"{label} {what}: {name} calls {forms} for "
                                 f"{launches[name]} launches")
    return dict(forms)


def time_layer_call(call, card):
    """Kernel, plain version and bound of one recorded per-layer call, on its
    own inputs; logs them and returns (ms, plain_ms, bound_ms, bound_by,
    tc_bound_ms, slot_bound): slot_bound(slots) is the call's bound with
    each library call at ``slots`` operations (layer_work)."""
    from jammy_flows_tpu_torch.ops import gf_layer as gl
    name, mode, iface, kept, ift, prep, kd, _ = call
    if "_bwd_" in name:
        x, params, g1, g2 = kept
        fn = lambda: gl._launch_bwd(mode, iface, x, params, g1, g2, ift,
                                    prep, kd)
        plain = lambda: gl.layer_bwd_plain(mode, iface, x, params, g1, g2,
                                           ift, prep, kd)
    else:
        x, params = kept
        fn = lambda: gl._launch(mode, iface, x, params, ift, prep, kd)
        plain = lambda: gl.layer_plain(mode, iface, x, params, ift, prep, kd)
    ms = cuda_ms(fn, TIMING_REPS)
    plain_ms = cuda_ms(plain, PLAIN_REPS)
    skew = iface != "prepared" and prep[3] is not None
    k, d = kd if iface == "lazy" else params[0].shape[:2]
    n_groups = 3 if iface == "prepared" else 2 + int(prep[2]) + skew
    hid = params[0].shape[1] if iface == "lazy" else 0
    per_row = iface != "lazy" and params[0].ndim == 3
    flops, byts = layer_work(name, x.shape[0], k, d, ift, skew, per_row,
                             n_groups, hid)
    b_ms, b_by = bound_ms(flops, byts)
    tc_ms = tc_bound_ms(flops, byts, product_flops(name, x.shape[0],
                                                   n_groups * k * d, hid))
    log(f"{name} ({ift}, {'per-row' if per_row else 'broadcast'}"
        f"{', skewed' if skew else ''}) at {x.shape[0]} rows on {card}: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of "
        f"{PLAIN_REPS}), bound {b_ms:.4f} ms ({b_by}: {flops:.4g} flop, "
        f"{byts:.4g} B), tensor-core bound {tc_ms:.4f} ms")

    def slot_bound(slots):
        f, b = layer_work(name, x.shape[0], k, d, ift, skew, per_row,
                          n_groups, hid, slots)
        return bound_ms(f, b)[0]

    return ms, plain_ms, b_ms, b_by, tc_ms, slot_bound


def layer_row(label, call, by_path, err, card):
    """The JSON row ``label`` of one recorded per-layer call, timed on its
    own inputs (time_layer_call), its launches those of ``by_path``."""
    name = call[0]
    ms, plain_ms, b_ms, b_by, tc_ms, slot = time_layer_call(call, card)
    source, replaces = ("gf_layer_bwd.cu", "730") if "_bwd_" in name \
        else ("gf_layer.cu", {"forward": "754", "sample": "761",
                              "inverse": "767"}[name.split("_")[0]])
    return {"name": label, "route": "cuda",
            "source": f"jammy_flows_tpu_torch/csrc/{source}",
            "replaces": f"jammy_flows_tpu/ops/pallas_gf.py:{replaces}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "tc_bound_ms": tc_ms,
            "library_ms": None, "_slot": slot}


def time_layer_kernels(calls, launches, forms, errs, skewed, card,
                       ptxas=None):
    """Each per-layer entry point and T7 body on its first recorded call's
    inputs (the unconditional serving or training paths): kernel, plain
    version, bound; returns the JSON rows.  The raw, lazy and T7 rows are
    the skewed instances: their launches those of the models whose
    ``skewed`` is true.  The prepared entry points take
    two rows, one for broadcast slabs (the centred block 0, the persistent
    kernel) and one for per-row slabs (the centred block 2, ``_per_row``),
    their launches by form from ``forms`` (prepared_forms).  The lazy rows
    also carry two yardsticks on the same inputs (their P x H products
    alone as torch.matmul, and the materialized route); the lazy and the
    broadcast (T4-T7) rows their registers, stack and spills (``ptxas``:
    tools/tile_breakdown.layer_ptxas / layer_raw_ptxas /
    layer_fwd_raw_ptxas / layer_prep_ptxas of the build's -Xptxas -v
    lines) and blocks per SM, the per-row prepared rows their kernel's
    registers."""
    rows = []
    entries = [(name, None) for name in LAYER_ENTRY + LAYER_BWD]
    entries[:2] = [(name, per_row) for name in LAYER_ENTRY[:2]
                   for per_row in (False, True)]
    for name, per_row in entries:
        call = next(c for c in calls if c[0] == name and (
            per_row is None or (c[3][1][0].ndim == 3) == per_row))
        if per_row is None:
            by_path = {f"{cfg} {what}": n[name]
                       for cfg, paths in launches.items() if skewed[cfg]
                       for what, n in paths.items() if n[name]}
        else:
            by_path = {f"{cfg} {what}": f[(name, per_row)]
                       for cfg, paths in forms.items()
                       for what, f in paths.items()
                       if f.get((name, per_row))}
        rows.append(layer_row(f"gf_{name}{'_per_row' if per_row else ''}",
                              call, by_path, errs[name], card))
        if name in LAYER_TILE_KERNELS:
            x, (hidden, w, _) = call[3][:2]
            row = rows[-1]
            row["products_matmul_ms"] = products_matmul_ms(
                name, x.shape[0], w.shape[0], w.shape[1], x.device)
            row["materialized_ms"] = materialized_ms(call)
            row["blocks_per_sm"] = layer_occupancy(name, w.shape[1])[0]
            row["ptxas"] = (ptxas or {}).get(f"{name} (K=10, skewed)")
            log(f"{name}: yardsticks on its inputs on {card}: its P x H "
                f"products alone as torch.matmul {row['products_matmul_ms']:.4f}"
                f" ms, the materialized route (torch.matmul + raw per-row "
                f"kernel) {row['materialized_ms']:.4f} ms; "
                f"{row['blocks_per_sm']} blocks per SM; {row['ptxas']}")
        if name in ("forward_raw", "sample_raw", "forward_bwd_raw",
                    "sample_bwd_raw"):
            row = rows[-1]
            row["blocks_per_sm"] = layer_occupancy(name, 0)[0]
            row["ptxas"] = (ptxas or {}).get(
                f"{name} {'broadcast ' if '_bwd_' in name else ''}(K=10, "
                "skewed)")
            log(f"{name} (broadcast, K=10, skewed): "
                f"{row['blocks_per_sm']} blocks per SM; {row['ptxas']}")
        if per_row is not None:
            row = rows[-1]
            mode = name.split("_")[0]
            if per_row:
                row["ptxas"] = (ptxas or {}).get(
                    f"{mode} one block per tile (K=10)")
            else:
                row["blocks_per_sm"] = layer_occupancy(name, 0, 3, False)[0]
                row["ptxas"] = (ptxas or {}).get(f"{name} broadcast (K=10)")
            log(f"{row['name']} (K=10): {row.get('blocks_per_sm', '-')} "
                f"blocks per SM; {row['ptxas']}")
    return rows


def time_unskewed_rows(calls, launches, errs, skewed, card, ptxas=None):
    """The plain-mixture instances of T4 / T5 raw broadcast and lazy and of
    both T7 bodies (raw broadcast, lazy), each on its first recorded call
    in ``calls`` (the rotated unconditional flagship's serving and
    training paths): kernel, plain version, bound, launches by path over
    the models whose ``skewed`` is false, blocks per SM and registers;
    returns the JSON rows (``gf_<name>_unskewed``)."""
    rows = []
    for name in UNSKEWED:
        call = next(c for c in calls if c[0] == name and c[5][3] is None
                    and (c[2] == "lazy" or c[3][1][0].ndim == 2))
        by_path = {f"{cfg} {what}": n[name]
                   for cfg, paths in launches.items() if not skewed[cfg]
                   for what, n in paths.items() if n[name]}
        row = layer_row(f"gf_{name}_unskewed", call, by_path,
                        errs[f"{name}_unskewed"], card)
        lazy = name.endswith("_lazy")
        row["blocks_per_sm"] = layer_occupancy(
            name, call[3][1][0].shape[1] if lazy else 0, 3, False)[0]
        row["ptxas"] = (ptxas or {}).get(
            f"{name} {'broadcast ' if '_bwd_' in name and not lazy else ''}"
            "(K=10)")
        log(f"{name} (unskewed, {'lazy' if lazy else 'broadcast'}, K=10): "
            f"{row['blocks_per_sm']} blocks per SM; {row['ptxas']}")
        rows.append(row)
    return rows


def euclid_model(i, dev):
    """EUCLID_MODELS[i] on ``dev``: (model, parameters, rows, conditional
    input or None)."""
    _, defs, opts, cond, _ = EUCLID_MODELS[i]
    p, params = layer_model(opts, cond, dev, seed=90 + i, defs=defs)
    n = N_SAMPLE_UNCOND if cond is None else N_COND
    ci = None if cond is None else torch.randn(
        (n, cond), generator=torch.Generator(device=dev).manual_seed(100 + i),
        device=dev)
    return p, params, n, ci


def euclid_phase(dev, card, launches, forms, merge, skewed):
    """The remaining Euclidean options (EUCLID_MODELS): each model served
    (sample, then log_prob of the samples, with its exact launch counts),
    every recorded per-layer call against its plain version, log_prob
    against the port's f64 CPU path, sample and log_prob timed; the rotated
    unconditional model also trained (train()).  Adds each model's
    launches, prepared forms and skew to ``launches`` / ``forms`` /
    ``skewed`` and its errors through ``merge``; returns the rotated
    unconditional model's first recorded per-layer calls."""
    t_phase = time.time()
    unskewed_calls = []
    for i, (label, _, opts, _, trained) in enumerate(EUCLID_MODELS):
        p, params, n, ci = euclid_model(i, dev)
        skewed[label] = bool(opts.get("g", {}).get("add_skewness"))
        x, launch, block_calls, layer_calls = serve(label, p, params, n, ci,
                                                    seed=110 + i)
        if block_calls:
            raise AssertionError(f"{label}: a block kernel ran")
        merge(check_layer_calls(label, layer_calls))
        cross_check(label, p, params, x, ci, opts)
        launches[label] = {"serving": launch}
        forms[label] = {"serving": prepared_forms(label, "serving",
                                                  layer_calls, launch)}
        g = torch.Generator(device=dev).manual_seed(120 + i)
        sample_ms = cuda_ms(lambda: p.sample(
            params, samplesize=n, conditional_input=ci, generator=g), 5)
        log_prob_ms = cuda_ms(lambda: p.log_prob(params, x, ci), 5)
        for what, ms in (("sample", sample_ms), ("log_prob", log_prob_ms)):
            log(f"{label} {what} on {card}: {ms:.3f} ms per {n} rows = "
                f"{n / ms * 1e3:.6g} rows/s (median of 5)")
        if trained:
            unskewed_calls += first_calls(layer_calls)
        del layer_calls, x
        torch.cuda.empty_cache()
        if trained:
            l_t, e, _, layer_calls, (step_nll, step_auto) = train(
                label, p, params, seed=130 + i, opts=opts)
            launches[label].update(l_t)
            merge(e)
            log(f"{label} training step on {card}: nll_value_and_grad "
                f"{step_nll:.3f} ms, autograd of -log_prob().mean() "
                f"{step_auto:.3f} ms per {N_TRAIN} rows")
            unskewed_calls += layer_calls
            del layer_calls
            torch.cuda.empty_cache()
    log(f"Euclidean options phase {time.time() - t_phase:.1f} s")
    return unskewed_calls


def kernel_census(fn):
    """(CUDA events, their summed device time in ms, the host's wall time in
    ms) of one call of fn under torch.profiler, after a warm-up call; None
    where the profiler records no device event."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None
    return len(dev), sum(e.time_range.elapsed_us() for e in dev) / 1e3, wall


def time_serving(label, p, params, x, n, ci, seed, card, reps=5):
    """sample (n rows) and log_prob (of x) timed, median of ``reps``, and
    one call of each censused by torch.profiler (kernel_census)."""
    g = torch.Generator(device=p.device).manual_seed(seed)

    def sample():
        return sample_rows(p, params, n, ci, g)

    def log_prob():
        return p.log_prob(params, x, ci)

    for what, fn in (("sample", sample), ("log_prob", log_prob)):
        ms = cuda_ms(fn, reps)
        log(f"{label} {what} on {card}: {ms:.3f} ms per {n} rows = "
            f"{n / ms * 1e3:.6g} rows/s (median of {reps})")
        census = kernel_census(fn)
        log(f"{label} {what}: " + (
            "torch.profiler recorded no device event (not measured)"
            if census is None else
            f"{census[0]} CUDA events (kernels, copies, fills) summing "
            f"to {census[1]:.3f} ms on the device, {census[2]:.3f} ms on "
            f"the host's clock under the profiler (one call)"))


def circle_phase(dev, card):
    """The circle and interval layers (CIRCLE_MODELS): each model served
    (sample, then log_prob of the samples, with its exact launch counts),
    every recorded block call against its plain version, log_prob against
    the port's f64 CPU path, sample and log_prob timed, and one sample and
    log_prob censused by torch.profiler; the first model also trained
    (train()).  Returns (launches by model and path, errors per kernel)."""
    from jammy_flows_tpu_torch import pdf
    t_phase = time.time()
    launches, errs = {}, {}
    for i, (label, defs, flows, cond, trained) in enumerate(CIRCLE_MODELS):
        p = pdf(defs, flows, conditional_input_dim=cond, device=dev)
        params = jittered_params(p, seed=140 + i)
        n = N_SAMPLE_UNCOND if cond is None else N_COND
        ci = None if cond is None else torch.randn(
            (n, cond), generator=torch.Generator(device=dev).manual_seed(
                150 + i), device=dev)
        x, launch, calls, layer_calls = serve(label, p, params, n, ci,
                                              seed=160 + i)
        if layer_calls:
            raise AssertionError(f"{label}: a per-layer kernel ran")
        for k, v in check_calls(label, calls).items():
            errs[k] = max(errs.get(k, 0.0), v)
        del calls
        cross_check(label, p, params, x, ci)
        launches[label] = {"serving": launch}
        time_serving(label, p, params, x, n, ci, 170 + i, card)
        del x
        torch.cuda.empty_cache()
        if trained:
            # the sample gradient's distance to f64 read against the f32
            # CPU path too: the f32 Moebius solve's own, or the card's
            l_t, e, _, _, (step_nll, step_auto) = train(
                label, p, params, seed=180 + i, f32_reading=True)
            launches[label].update(l_t)
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)
            log(f"{label} training step on {card}: nll_value_and_grad "
                f"{step_nll:.3f} ms, autograd of -log_prob().mean() "
                f"{step_auto:.3f} ms per {N_TRAIN} rows")
            torch.cuda.empty_cache()
    log(f"circle and interval phase {time.time() - t_phase:.1f} s")
    return launches, errs


def simplex_model(i, dev):
    """SIMPLEX_MODELS[i]'s model on ``dev``."""
    import jammy_flows_tpu_torch as jft
    _, ctor, defs, flows, cond, _, _ = SIMPLEX_MODELS[i]
    return getattr(jft, ctor)(defs, flows, conditional_input_dim=cond,
                              device=dev)


def simplex_params(p, seed):
    """init_params(seed=0) with every parameter moved by 0.02 N(0, 1) (the
    `u` layer's four permanent ones by 0.3): the amortized parameters then
    differ from row to row, and so do the `w` layer's inner pdf's."""
    g = torch.Generator(device=p.device).manual_seed(seed)
    return {k: v + (0.3 if v.numel() < 8 else 0.02) * torch.randn(
        v.shape, generator=g, device=v.device)
        for k, v in p.init_params(seed=0).items()}


def peak_memory(label, what):
    gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"{label}: peak device memory of {what} {gb:.3f} GiB "
        "(torch.cuda.max_memory_allocated)")
    torch.cuda.reset_peak_memory_stats()


def fully_amortized_grad(label, i, p, params, card):
    """Autograd of -log_prob().mean() of the fully amortized model at
    N_TRAIN rows (drawn from another jittered model): its launches, the
    gradient on N_CROSS rows against the port's f64 CPU path, the step
    timed; returns (launches, recorded per-layer calls)."""
    from jammy_flows_tpu_torch import PDF
    g = torch.Generator(device=p.device).manual_seed(220 + i)
    ci = torch.randn((N_TRAIN, p.conditional_input_dim), generator=g,
                     device=p.device)
    with torch.no_grad():
        x = p.sample(simplex_params(p, 230 + i), conditional_input=ci,
                     generator=g)[0]

    def step(pp, x=x, ci=ci):
        return PDF._value_and_grad(
            lambda q: -p.log_prob(q, x, ci)[0].mean(), pp)

    (_, grads), launch, _, calls = train_path(label, "log_prob_grad", p,
                                              lambda: step(params))
    p_cpu = simplex_model(i, "cpu")
    par64 = {k: v.double().cpu() for k, v in params.items()}
    xs, cis = x[:N_CROSS], ci[:N_CROSS]
    _, g_card = step(params, xs, cis)
    _, g_cpu = PDF._value_and_grad(lambda q: -p_cpu.log_prob(
        q, xs.double().cpu(), cis.double().cpu())[0].mean(), par64)
    rels = {k: rel_norm(g_card[k], g_cpu[k]) for k in g_card}
    log(f"{label}: card f32 vs CPU f64 log_prob gradient on {N_CROSS} rows: "
        f"relative norms {', '.join(f'{k} {v:.3e}' for k, v in rels.items())}"
        f" (limit {TOL_CROSS_GRAD:g})")
    if not (max(rels.values()) < TOL_CROSS_GRAD
            and all(torch.isfinite(v).all() for v in grads.values())):
        raise AssertionError(f"{label}: card vs CPU f64 gradient")
    ms = cuda_ms(lambda: step(params), 10)
    log(f"{label} value-and-grad step at {N_TRAIN} rows on {card}: autograd "
        f"of -log_prob().mean() {ms:.3f} ms (median of 10)")
    return launch, calls


def simplex_phase(dev, card):
    """The simplex layers and the fully amortized model (SIMPLEX_MODELS):
    each served (sample, then log_prob of the samples, with exact launch
    counts; every recorded per-layer call against its plain version),
    log_prob against the port's f64 CPU path, sample and log_prob timed and
    censused, its peak device memory; the conditional `w` model trained as
    the flagship (train()), the fully amortized one's log_prob gradient
    (fully_amortized_grad).  Returns the JSON rows of the per-row raw
    kernels it runs (PER_ROW_RAW), timed on its first recorded calls."""
    t_phase = time.time()
    launches, errs, calls = {}, {}, []
    for i, (label, _, _, _, cond, n, trained) in enumerate(SIMPLEX_MODELS):
        torch.cuda.reset_peak_memory_stats()
        p = simplex_model(i, dev)
        params = simplex_params(p, seed=190 + i)
        ci = None if cond is None else torch.randn(
            (n, cond), generator=torch.Generator(device=dev).manual_seed(
                200 + i), device=dev)
        p_cpu = simplex_model(i, "cpu")
        held = label in F32_HELD
        x, launch, block_calls, layer_calls = serve(
            label, p, params, n, ci, seed=210 + i, f32_twin=(p_cpu, {
                k: v.cpu() for k, v in params.items()}) if held else None)
        if block_calls:
            raise AssertionError(f"{label}: a block kernel ran")
        cross_check(label, p, params, x, ci, p_cpu=p_cpu, f32_held=held)
        launches[label] = {"serving": launch}
        time_serving(label, p, params, x, n, ci, 240 + i, card)
        peak_memory(label, f"serving {n} rows")
        del x
        if trained == "fit":
            l_t, _, _, _, (step_nll, step_auto) = train(label, p, params,
                                                        seed=250 + i)
            launches[label].update(l_t)
            log(f"{label} training step on {card}: nll_value_and_grad "
                f"{step_nll:.3f} ms, autograd of -log_prob().mean() "
                f"{step_auto:.3f} ms per {N_TRAIN} rows")
            peak_memory(label, f"training at {N_TRAIN} rows")
        elif trained == "grad":
            l_g, g_calls = fully_amortized_grad(label, i, p, params, card)
            launches[label]["log_prob_grad"] = l_g
            layer_calls += g_calls
            peak_memory(label, f"the log_prob gradient at {N_TRAIN} rows")
        for name, err in check_layer_calls(label, layer_calls).items():
            errs[name] = max(errs.get(name, 0.0), err)
        calls += first_calls(layer_calls)
        del layer_calls
        torch.cuda.empty_cache()
    rows = []
    for name in PER_ROW_RAW:
        call = next(c for c in calls if c[0] == name and c[3][1][0].ndim == 3)
        by_path = {f"{cfg} {what}": n[name] for cfg, paths in launches.items()
                   for what, n in paths.items() if n[name]}
        rows.append(layer_row(f"gf_{name}_per_row_unskewed", call, by_path,
                              errs[f"{name}_unskewed"], card))
    del calls
    torch.cuda.empty_cache()
    log(f"simplex and fully amortized phase {time.time() - t_phase:.1f} s")
    return rows


def solve_report(label, what):
    """Log the sphere-Newton solves since the last report (ops/inverse.py
    SPHERE_SOLVES): each call's iteration count at which its last row
    converged, and its rows still unconverged at max_iter."""
    from jammy_flows_tpu_torch.ops import inverse
    if inverse.SPHERE_SOLVES:
        log(f"{label} {what}: sphere-Newton solves (iterations, rows at "
            f"max_iter) {list(inverse.SPHERE_SOLVES)}")
    inverse.SPHERE_SOLVES.clear()


def sphere_phase(dev, card):
    """The s2 options of `f` and the `v` layer (SPHERE_MODELS), at full
    width: each model served at N_COND rows (sample, then log_prob of the
    samples, with exact launch counts; every block call against its plain
    version), log_prob against the port's f64 CPU path, sample and log_prob
    timed and censused, its peak device memory and every sphere solve's
    iterations; the production models and the conditional exponential `v`
    model trained as the flagship (train(): the flagship with the
    production `f` runs T3 / T2 lazy2, held against their plain versions,
    T3's val / ld against T1's).  Returns (launches by model and path,
    errors per kernel)."""
    from jammy_flows_tpu_torch import pdf
    t_phase = time.time()
    launches, errs = {}, {}
    solve_report("sphere phase", "start")
    for i, (label, defs, flows, opts, cond, trained) in enumerate(
            SPHERE_MODELS):
        torch.cuda.reset_peak_memory_stats()
        p = pdf(defs, flows, options_overwrite=opts,
                conditional_input_dim=cond, device=dev)
        params = jittered_params(p, seed=260 + i)
        ci = None if cond is None else torch.randn(
            (N_COND, cond), generator=torch.Generator(device=dev).manual_seed(
                270 + i), device=dev)
        x, launch, calls, layer_calls = serve(label, p, params, N_COND, ci,
                                              seed=280 + i)
        solve_report(label, "serving (sample, log_prob)")
        if layer_calls:
            raise AssertionError(f"{label}: a per-layer kernel ran")
        for k, v in check_calls(label, calls).items():
            errs[k] = max(errs.get(k, 0.0), v)
        del calls
        cross_check(label, p, params, x, ci, opts)
        solve_report(label, "log_prob cross-check")
        launches[label] = {"serving": launch}
        time_serving(label, p, params, x, N_COND, ci, 290 + i, card)
        solve_report(label, "timed sample / log_prob calls")
        peak_memory(label, f"serving {N_COND} rows")
        del x
        torch.cuda.empty_cache()
        if trained:
            # the card's gradients against the port's f32 CPU path, their
            # f64 distance printed: the production `f` stack's f32
            # gradients lie 4.8e-3 from f64 in both packages (3.1e-5
            # apart, 512 rows), the `v` sample gradient goes through the
            # f32 sphere solve, which stops ~1e-3 rad from the root in both
            # (PERF.md)
            l_t, e, _, _, (step_nll, step_auto) = train(
                label, p, params, seed=300 + i, opts=opts, f32_reading=True,
                f32_held=True)
            solve_report(label, "training")
            launches[label].update(l_t)
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)
            log(f"{label} training step on {card}: nll_value_and_grad "
                f"{step_nll:.3f} ms, autograd of -log_prob().mean() "
                f"{step_auto:.3f} ms per {N_TRAIN} rows")
            peak_memory(label, f"training at {N_TRAIN} rows")
            torch.cuda.empty_cache()
    log(f"sphere phase {time.time() - t_phase:.1f} s")
    return launches, errs


def ode_report(label, what):
    """Log the ODE integrations since the last report (ops/odeint.py
    ODE_SOLVES), forward and adjoint apart: each chart's (accepted,
    rejected, stopped at max_steps); a summary where there are more than
    16."""
    from jammy_flows_tpu_torch.ops import odeint
    solves = list(odeint.ODE_SOLVES)
    odeint.ODE_SOLVES.clear()
    for kind in ("forward", "adjoint"):
        got = [(a, r, m) for k, a, r, m in solves if k == kind]
        if not got:
            continue
        if len(got) <= 16:
            text = str(got)
        else:
            acc, rej = [a for a, _, _ in got], [r for _, r, _ in got]
            text = (f"{len(got)} charts, accepted {min(acc)}-{max(acc)} "
                    f"(mean {statistics.mean(acc):.1f}), rejected "
                    f"{min(rej)}-{max(rej)} (mean {statistics.mean(rej):.1f}),"
                    f" {sum(m for _, _, m in got)} at max_steps")
        log(f"{label} {what}: {kind} ODE steps per chart (accepted, "
            f"rejected, at max_steps) {text}")


def cnf_phase(dev, card):
    """The manifold CNF `c` (CNF_MODELS), at full width: each model served
    at N_COND rows (sample, then log_prob of the samples, with exact launch
    counts; every block call against its plain version), log_prob against
    the port's f64 CPU path (on N_CROSS rows: the card and the CPU each
    integrate those rows as one batch, whose step sequence the batch-global
    error norm sets, so the two agree to the solver's tolerance), sample
    and log_prob timed and censused, peak device memory; trained as the
    flagship (train(): the fused NLL, autograd of log_prob and of a sample
    objective through the continuous adjoint or rk4's checkpointed steps;
    the flagship with `c` runs T3 / T2 lazy2, held against their plain
    versions, T3's val / ld against T1's); every ODE integration's steps
    per chart, forward and adjoint apart.  Returns (launches by model and
    path, errors per kernel)."""
    from jammy_flows_tpu_torch import pdf
    t_phase = time.time()
    launches, errs = {}, {}
    ode_report("cnf phase", "start")
    for i, (label, defs, flows, opts, cond, fit_steps) in enumerate(
            CNF_MODELS):
        t_model = time.time()
        torch.cuda.reset_peak_memory_stats()
        p = pdf(defs, flows, options_overwrite=opts,
                conditional_input_dim=cond, device=dev)
        params = jittered_params(p, seed=310 + i)
        ci = cond_input(p, N_COND, torch.Generator(device=dev).manual_seed(
            320 + i))
        x, launch, calls, layer_calls = serve(label, p, params, N_COND, ci,
                                              seed=330 + i)
        ode_report(label, "serving (sample, log_prob)")
        if layer_calls:
            raise AssertionError(f"{label}: a per-layer kernel ran")
        for k, v in check_calls(label, calls).items():
            errs[k] = max(errs.get(k, 0.0), v)
        del calls
        cross_check(label, p, params, x, ci, opts)
        ode_report(label, "log_prob cross-check (the card, then the CPU "
                   "f64 path)")
        launches[label] = {"serving": launch}
        time_serving(label, p, params, x, N_COND, ci, 340 + i, card,
                     reps=CNF_REPS)
        ode_report(label, "timed and censused sample / log_prob calls")
        peak_memory(label, f"serving {N_COND} rows")
        del x
        torch.cuda.empty_cache()
        # the sample objective's f32 gradient is held against the port's
        # f32 CPU path, its f64 distance printed: a sample within ~1e-4 of
        # the azimuth pi, where the conversion to (theta, phi) clips in
        # float32, puts it 5e-2 - 7e-2 from f64 in both packages
        # (tests/f32_cnf_reading.py, PERF.md)
        l_t, e, _, _, (step_nll, step_auto) = train(
            label, p, params, seed=350 + i, opts=opts, f32_reading=True,
            sample_f32=True, fit_steps=fit_steps, reps=1,
            n_cross=N_CROSS_CNF, warm_rows=256,
            report=lambda what, label=label: ode_report(label, what))
        launches[label].update(l_t)
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        log(f"{label} training step on {card}: nll_value_and_grad "
            f"{step_nll:.3f} ms, autograd of -log_prob().mean() "
            f"{step_auto:.3f} ms per {N_TRAIN} rows")
        peak_memory(label, f"training at {N_TRAIN} rows")
        torch.cuda.empty_cache()
        log(f"{label}: {time.time() - t_model:.1f} s")
    log(f"cnf phase {time.time() - t_phase:.1f} s")
    return launches, errs


def options_phase(dev, card):
    """The PDF-level options on OPTIONS_MODEL at N_COND rows: init_params
    from the training rows' first sub-pdf (data-driven init), served with
    failsafe sampling (FAILSAFE_TOL, FAILSAFE_ROUNDS) in embedding
    coordinates and log_prob of those rows with forced embedding
    coordinates (exact launch counts, every block call against its plain
    version, the roundtrip's q999), log_mean_poisson and log_prob against
    the port's f64 CPU path, sample and log_prob timed, trained as the
    flagship from the data-driven init (its NLL through autograd: T1 / T2
    lazy2).  Returns (launches by path, errors per kernel)."""
    from jammy_flows_tpu_torch import pdf
    from jammy_flows_tpu_torch.utils.convert import params_from_jax
    t_phase = time.time()
    label = "options"
    defs, flows, cond = OPTIONS_MODEL
    p = pdf(defs, flows, conditional_input_dim=cond,
            predict_log_normalization=True, device=dev)
    g = torch.Generator(device=dev).manual_seed(400)
    ci = cond_input(p, N_COND, g)
    with torch.no_grad():
        rows = p.sample(jittered_params(p, 401, flow_scale=0.1),
                        conditional_input=ci, generator=g)[0]
    lo, hi = p.target_dim_indices[0]
    t0 = time.time()
    init = p.init_params(seed=0, data=rows[:, lo:hi])
    plain = p.init_params(seed=0)
    moved = (init["mlp_0"] - plain["mlp_0"]).abs().max().item()
    log(f"{label}: init_params(data=) from {rows.shape[0]} rows' first "
        f"sub-pdf in {time.time() - t0:.2f} s (host); mlp_0 moved by "
        f"{moved:.4g} from the plain init")
    if not (moved > 1e-3 and all(torch.isfinite(v).all()
                                 for v in init.values())):
        raise AssertionError(f"{label}: the data-driven init")
    gj = torch.Generator(device=dev).manual_seed(402)
    params = {k: v + 0.02 * torch.randn(v.shape, generator=gj, device=dev)
              if k.startswith("mlp_") else v for k, v in init.items()}

    calls = []
    reset_counts()
    with recording(calls):
        g = torch.Generator(device=dev).manual_seed(403)
        x, z, lp_s, _ = p.sample(params, conditional_input=ci, generator=g,
                                 failsafe_crosscheck_tolerance=FAILSAFE_TOL,
                                 failsafe_rounds=FAILSAFE_ROUNDS,
                                 force_embedding_coordinates=True)
        lp_e = p.log_prob(params, x, conditional_input=ci,
                          force_embedding_coordinates=True)[0]
    torch.cuda.synchronize()
    launch = counts()
    log(f"{label} ({N_COND} rows, failsafe sampling in embedding "
        f"coordinates, then log_prob of them): launches "
        f"{ {k: v for k, v in launch.items() if v} }")
    if launch != all_counts(EXPECTED_LAUNCHES[label]) or             len(calls) != sum(launch.values()):
        raise AssertionError(f"{label}: launches {launch}, "
                             f"{len(calls)} recorded calls")
    d = (lp_e - lp_s).abs()
    off = (d > FAILSAFE_TOL).float().mean().item()
    log(f"{label}: rows of width {x.shape[1]} (embedding: "
        f"{p.total_target_dim_embedded}); sample->log_prob |dlogp| q999 "
        f"{torch.quantile(d.float(), 0.999).item():.3e} max "
        f"{d.max().item():.3e}, {off:.3e} of the rows beyond the failsafe "
        f"tolerance {FAILSAFE_TOL:g} after {FAILSAFE_ROUNDS} rounds "
        "(printed)")
    if not (x.shape == (N_COND, p.total_target_dim_embedded)
            and torch.isfinite(x).all() and torch.isfinite(lp_e).all()):
        raise AssertionError(f"{label}: failsafe / embedding serving")
    errs = check_calls(label, calls)
    del calls

    # the data-initialized model's float32 sampling solve (4 Newton steps,
    # the JAX package's kernels') leaves ~12% of the rows beyond 1e-3 in
    # both packages (tests/f32_options_reading.py, PERF.md): the card's
    # roundtrip is held against the port's f32 CPU path on the same merged
    # base draws, N_CROSS of them
    from jammy_flows_tpu_torch.ops.special import std_normal_log_prob
    p_cpu = cpu_twin(p)
    par32 = {k: v.cpu() for k, v in params.items()}
    cis = ci_map(ci, lambda c: c[:N_CROSS])
    ci32 = ci_map(cis, lambda c: c.cpu())
    zc = z[:N_CROSS].cpu()
    xc, ldc = p_cpu.all_layer_forward(par32, zc, torch.zeros(N_CROSS), ci32,
                                      force_embedding_coordinates=True)
    dc = (p_cpu.log_prob(par32, xc, conditional_input=ci32,
                         force_embedding_coordinates=True)[0]
          - (std_normal_log_prob(zc) - ldc)).abs()
    q_card = torch.quantile(d[:N_CROSS].float(), 0.999).item()
    q_cpu = torch.quantile(dc, 0.999).item()
    log(f"{label}: on the first {N_CROSS} rows the card's roundtrip q999 "
        f"{q_card:.3e}, the port's CPU f32 path on the same base draws "
        f"{q_cpu:.3e} (limit |q999 - its| < {TOL_ROUNDTRIP_Q999:g})")
    if not abs(q_card - q_cpu) < TOL_ROUNDTRIP_Q999:
        raise AssertionError(f"{label}: roundtrip q999 {q_card:.3e}, the CPU "
                             f"f32 path's {q_cpu:.3e}")

    par64 = params_from_jax({k: v.cpu().numpy() for k, v in params.items()},
                            dtype=torch.float64)
    lm = p.log_mean_poisson(params, ci)
    lm_cpu = p_cpu.log_mean_poisson(par64, ci_map(cis, lambda c:
                                                  c.double().cpu()))
    lm_err = (lm[:N_CROSS].double().cpu() - lm_cpu).abs().max().item()
    log(f"{label}: log_mean_poisson {tuple(lm.shape)}, card f32 vs CPU f64 "
        f"on {N_CROSS} rows max|diff| {lm_err:.3e} (limit {TOL_CROSS:g})")
    if not (lm.shape == (N_COND, 1) and torch.isfinite(lm).all()
            and lm_err < TOL_CROSS):
        raise AssertionError(f"{label}: log_mean_poisson")
    x_def = p.transform_target_space(x, transform_from="embedding",
                                     transform_to="default")[0]
    cross_check(label, p, params, x_def, ci, p_cpu=p_cpu)
    launches = {label: {"serving": launch}}
    time_serving(label, p, params, x_def, N_COND, ci, 404, card)
    g = torch.Generator(device=dev).manual_seed(405)
    ms = cuda_ms(lambda: p.sample(params, conditional_input=ci, generator=g,
                                  failsafe_crosscheck_tolerance=FAILSAFE_TOL,
                                  failsafe_rounds=FAILSAFE_ROUNDS,
                                  force_embedding_coordinates=True), 5)
    log(f"{label} failsafe sample ({FAILSAFE_ROUNDS} rounds, embedding "
        f"coordinates) on {card}: {ms:.3f} ms per {N_COND} rows (median of 5)")
    peak_memory(label, f"serving {N_COND} rows")
    del x, x_def, rows
    torch.cuda.empty_cache()
    # its f32 sample gradient lies 2.6e-3 from f64 in both packages' kernel
    # route (tests/f32_options_reading.py): held against the f32 CPU path
    l_t, e, _, _, (step_nll, step_auto) = train(
        label, p, params, seed=410, init=init, f32_reading=True,
        sample_f32=True)
    launches[label].update(l_t)
    for k, v in e.items():
        errs[k] = max(errs.get(k, 0.0), v)
    log(f"{label} training step on {card}: nll_value_and_grad (autograd: a "
        f"Poisson head) {step_nll:.3f} ms, autograd of -log_prob().mean() "
        f"{step_auto:.3f} ms per {N_TRAIN} rows")
    peak_memory(label, f"training at {N_TRAIN} rows")
    torch.cuda.empty_cache()
    log(f"options phase {time.time() - t_phase:.1f} s")
    return launches, errs


def diag_path(label, what, fn, expected, grads=False):
    """One diagnostics or CLI path with the launch counts set to 0 just
    before it and read just after; every block call (with ``grads`` every
    T2 / T3 call too) recorded and held against its plain version.
    Returns (result, launches, errors per kernel)."""
    calls, bwd_calls = [], []
    reset_counts()
    with contextlib.ExitStack() as stack:
        stack.enter_context(recording(calls))
        if grads:
            stack.enter_context(recording_bwd(bwd_calls))
        out = fn()
        torch.cuda.synchronize()
    launch = counts()
    log(f"{label} {what}: launches "
        f"{ {k: v for k, v in launch.items() if v} }")
    if launch != all_counts(expected) or \
            len(calls) + len(bwd_calls) != sum(launch.values()):
        raise AssertionError(f"{label} {what}: launches {launch}, expected "
                             f"{expected}, {len(calls) + len(bwd_calls)} "
                             "recorded calls")
    errs = check_calls(f"{label} {what}", calls)
    for k, v in check_bwd_calls(f"{label} {what}", bwd_calls).items():
        errs[k] = max(errs.get(k, 0.0), v)
    return out, launch, errs


def host_ms(fn, reps=3):
    """Median host-clock time of fn() ending in a synchronize, after one
    warm-up call: the diagnostics mix device work with host reductions."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
    return statistics.median(times)


def rel_err(a, b):
    """max|a - b| / max(max|b|, 1e-30) of two arrays or tensors."""
    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b).double().cpu()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def diagnostics_cross_check(label, p, params, ci, g):
    """The card's f32 sub-manifold mappings (on shared base draws z and
    their targets) and marginal entropies (on shared targets) against the
    port's f64 CPU path; returns the largest difference."""
    from jammy_flows_tpu_torch.utils.convert import params_from_jax
    p_cpu = cpu_twin(p)
    par64 = params_from_jax({k: v.cpu().numpy() for k, v in params.items()},
                            dtype=torch.float64)
    z = torch.randn((N_CROSS_DIAG, p.total_base_dim), generator=g, device=p.device)
    ci_x = ci[:N_CROSS_DIAG]
    ci64 = ci_x.double().cpu()
    errs = {}
    with torch.no_grad():
        x, ld = p.all_layer_forward_subdims(params, z, ci_x,
                                            force_embedding_coordinates=True)
        xc, ldc = p_cpu.all_layer_forward_subdims(
            par64, z.double().cpu(), ci64, force_embedding_coordinates=True)
        errs["all_layer_forward_subdims"] = max(
            [(x.double().cpu() - xc).abs().max().item()]
            + [(ld[k].double().cpu() - ldc[k]).abs().max().item() for k in ld])
        b, lb = p.all_layer_inverse_subdims(params, x, ci_x,
                                            force_embedding_coordinates=True)
        bc, lbc = p_cpu.all_layer_inverse_subdims(
            par64, x.double().cpu(), ci64, force_embedding_coordinates=True)
        errs["all_layer_inverse_subdims"] = max(
            [(b.double().cpu() - bc).abs().max().item()]
            + [(lb[k].double().cpu() - lbc[k]).abs().max().item() for k in lb])
        ds = ci[:1].repeat_interleave(CROSS_S, dim=0)
        targets = p.sample_with_subdim_logprobs(params, g, CROSS_S, ds)[0]
        for k in (1, 2):
            e = p._marginal_entropy(params, targets, ds, k, CROSS_S, 1, True,
                                    False, CROSS_S)
            ec = p_cpu._marginal_entropy(par64, targets.double().cpu(),
                                         ds.double().cpu(), k, CROSS_S, 1,
                                         True, False, CROSS_S)
            errs[f"_marginal_entropy {k}"] = (e.double().cpu()
                                              - ec).abs().max().item()
    for what, err in errs.items():
        log(f"{label}: card f32 vs CPU f64 {what} ({N_CROSS_DIAG} rows): "
            f"max|diff| {err:.3e} (limit {TOL_CROSS:g})")
        if not err < TOL_CROSS:
            raise AssertionError(f"{label}: card vs CPU {what} differ by "
                                 f"{err:.3e}")


def scan_ties(p, scan, labels):
    """Per event of a device scan (return_scan=True): how many other cells
    have exactly the density of the label's cell, and their mass.  The HPD
    order of equal densities is the sort's (the host scan: numpy's
    ascending argsort reversed; the device scan: a stable descending one,
    as in the JAX package), so the two coverages may differ by it."""
    pos, lab = scan["scan_positions"], labels
    if p.pdf_defs_list == ["s2"]:
        b, g, _ = pos.shape
        pos = p._to_embedding(pos.reshape(b * g, 2)).reshape(b, g, 3)
        lab = p._to_embedding(labels)
    lp = scan["scan_log_evals"]
    cell = torch.argmin(torch.linalg.norm(pos - lab[:, None, :], dim=2),
                        dim=1)
    lc = torch.gather(lp, 1, cell[:, None])
    ties = (lp == lc).sum(dim=1) - 1
    mass = ties * torch.exp(lc[:, 0]) * scan["scan_volumes"][:, 0]
    return ties.cpu().numpy(), mass.double().cpu().numpy()


def diagnostics_phase(dev, card):
    """The diagnostics (models/diagnostics.py) on the conditional flagship
    at 262,144 rows per marginal or sample call: entropy of one conditional
    row (DIAG_S draws, both marginals' S x S blocks), entropy_iterative and
    entropy_device on the same generator state, the entropy's gradient
    (joint + the s2 marginal: T1 / T2 lazy2 through autograd), marginal
    moments with the zlp-Kent fit and their device twin on the same draws,
    the chi^2 coverage of the model's own samples; then the pdf scans of
    SCAN_E and SCAN_S (host and device on one generator state), the s2
    entropy scan against Monte Carlo, and the card against the port's f64
    CPU path.  Each path has its own exact launch counts; every block call
    is held against its plain version.  Returns (launches by path, errors
    per kernel)."""
    from jammy_flows_tpu_torch import pdf
    t_phase = time.time()
    label = "diagnostics"
    p = pdf(*FLAGSHIP, conditional_input_dim=3, device=dev)
    params = jittered_params(p, seed=500)
    g = torch.Generator(device=dev).manual_seed(501)
    ci1 = torch.randn((1, 3), generator=g, device=dev)
    launches, errs = {label: {}}, {}

    def run(what, fn, grads=False, model=label):
        out, launch, e = diag_path(model, what, fn,
                                   EXPECTED_DIAG_LAUNCHES[model][what], grads)
        launches.setdefault(model, {})[what] = launch
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        return out

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    subs = (-1, 0, 1, 2)
    with torch.no_grad():
        ent = run("entropy", lambda: p.entropy(
            params, gen(502), sub_manifolds=subs, conditional_input=ci1,
            samplesize=DIAG_S))
        ent_it = run("entropy_iterative", lambda: p.entropy_iterative(
            params, gen(502), sub_manifolds=subs, conditional_input=ci1,
            samplesize=DIAG_S, iterative_samplesize=DIAG_ITER))
        ent_dev = run("entropy_device", lambda: p.entropy_device(
            params, gen(502), sub_manifolds=subs, conditional_input=ci1,
            samplesize=DIAG_S))
    gaps = {k: max((ent_it[k] - v).abs().max().item(),
                   (ent_dev[str(k)] - v).abs().max().item())
            for k, v in ent.items()}
    log(f"{label}: entropy of one conditional row from {DIAG_S} draws "
        f"({DIAG_S}x{DIAG_S} = {DIAG_S**2} rows per marginal) "
        f"{ {k: round(v.item(), 6) for k, v in ent.items()} }; "
        f"entropy_iterative (chunks of {DIAG_ITER}) and entropy_device on "
        f"the same generator state: largest gap per key {gaps} (limit "
        f"{TOL_ENTROPY:g})")
    if not (all(torch.isfinite(v).all() for v in ent.values())
            and max(gaps.values()) < TOL_ENTROPY):
        raise AssertionError(f"{label}: entropy twins differ: {gaps}")
    for what, fn in (
            ("entropy", lambda: p.entropy(
                params, gen(502), sub_manifolds=subs, conditional_input=ci1,
                samplesize=DIAG_S)),
            ("entropy_iterative", lambda: p.entropy_iterative(
                params, gen(502), sub_manifolds=subs, conditional_input=ci1,
                samplesize=DIAG_S, iterative_samplesize=DIAG_ITER))):
        with torch.no_grad():
            ms = host_ms(fn)
        log(f"{label} {what} (sub-manifolds {subs}) on {card}: {ms:.3f} ms "
            "(host clock, median of 3)")

    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}

    def ent_grad():
        e = p.entropy(leaves, gen(503), sub_manifolds=(-1, 1),
                      conditional_input=ci1, samplesize=DIAG_S)
        return torch.autograd.grad((e["total"] + e[1]).sum(),
                                   list(leaves.values()))

    grads = run("entropy_grad", ent_grad, grads=True)
    norms = {k: gr.norm().item() for k, gr in zip(leaves, grads)}
    log(f"{label}: gradient of the joint + s2-marginal entropy, norms per "
        f"parameter {norms}")
    if not all(math.isfinite(v) and v > 0 for v in norms.values()):
        raise AssertionError(f"{label}: entropy gradient {norms}")
    del grads, leaves

    ci_m = torch.randn((DIAG_ITEMS, 3), generator=g, device=dev)
    t0 = time.time()
    mm = run("moments", lambda: p.marginal_moments(
        params, gen(504), conditional_input=ci_m, samplesize=DIAG_S,
        calc_zlp_kent_fit=True))
    t_mm = time.time() - t0
    mmd = run("moments_device", lambda: p.marginal_moments_device(
        params, gen(504), conditional_input=ci_m, samplesize=DIAG_S))
    m_err = {k: rel_err(v, mm[k]) for k, v in mmd.items()}
    fit = mm["zlp_kent_pars_1"]
    log(f"{label}: marginal moments of {DIAG_ITEMS} items x {DIAG_S} "
        f"samples ({DIAG_ITEMS * DIAG_S} rows) in {t_mm:.3f} s with the "
        f"zlp-Kent fit of the s2 marginal on the card (150 Adam + up to 8 "
        f"Newton steps on {DIAG_S // 2} samples per item): kappa median "
        f"{np.median(fit['kappa']):.4g}, grad_norm median "
        f"{np.median(fit['grad_norm']):.3e} max {fit['grad_norm'].max():.3e}"
        f"; device twin vs host, relative, per key {m_err} (limit "
        f"{TOL_MOMENTS:g})")
    if not (max(m_err.values()) < TOL_MOMENTS and all(
            np.isfinite(v).all() for v in fit.values())):
        raise AssertionError(f"{label}: moments {m_err}")
    with torch.no_grad():
        ms = host_ms(lambda: p.marginal_moments_device(
            params, gen(504), conditional_input=ci_m, samplesize=DIAG_S))
    log(f"{label} marginal_moments_device on {card}: {ms:.3f} ms per "
        f"{DIAG_ITEMS * DIAG_S} rows (host clock, median of 3)")

    ci_c = torch.randn((N_COND, 3), generator=g, device=dev)

    def coverage():
        with torch.no_grad():
            x = p.sample(params, conditional_input=ci_c, generator=gen(505))[0]
        return p.approximate_coverage(params, x, conditional_input=ci_c,
                                      sub_manifolds=subs)

    cov = run("coverage", coverage)
    dev_cov = {k: float(np.abs(cov["expected"] - v).max())
               for k, v in cov["true"].items()}
    log(f"{label}: chi^2 coverage of {N_COND} of the model's own samples, "
        f"max |expected - actual| per sub-manifold {dev_cov} (limit "
        f"{TOL_COVERAGE:g})")
    if not max(dev_cov.values()) < TOL_COVERAGE:
        raise AssertionError(f"{label}: coverage {dev_cov}")
    with torch.no_grad():
        run("cross", lambda: diagnostics_cross_check(label, p, params, ci_c,
                                                     gen(506)))
    del p, params, ci_c
    torch.cuda.empty_cache()

    for model, (defs, flows), seed in (("scan e4", SCAN_E, 510),
                                       ("scan s2", SCAN_S, 520)):
        pm = pdf(defs, flows, conditional_input_dim=3, device=dev)
        pp = jittered_params(pm, seed=seed)
        ci_e = torch.randn((N_SCAN_EVENTS, 3), generator=gen(seed + 1),
                           device=dev)

        def host_scan():
            with torch.no_grad():
                labels = pm.sample(pp, conditional_input=ci_e,
                                   generator=gen(seed + 2))[0]
            return labels, pm.coverage_and_or_pdf_scan(
                pp, labels=labels, conditional_input=ci_e,
                exact_coverage_calculation=True, calculate_MAP=True,
                save_pdf_scan=True, samples_per_event=N_SCAN,
                generator=gen(seed + 3))

        t0 = time.time()
        labels, host = run("host scan", host_scan, model=model)
        t_host = time.time() - t0
        t0 = time.time()
        with torch.no_grad():
            dv = run("device scan", lambda: pm.coverage_scan_device(
                pp, labels, conditional_input=ci_e, samples_per_event=N_SCAN,
                generator=gen(seed + 3), return_scan=True), model=model)
        t_dev = time.time() - t0
        rc = host["real_cov_values"]
        # the mass each event's scan holds: a coarse grid's Riemann sum may
        # pass 1, and the HPD coverage goes up to it
        mass = np.asarray([np.exp(lp).sum() * np.asarray(v).max()
                           for lp, v in zip(host["pdf_scan_log_evals"],
                                            host["pdf_scan_volume_sizes"])])
        ties, tie_mass = scan_ties(pm, dv, labels)
        gap = np.abs(dv["real_cov_values"].cpu().numpy() - rc)
        cov_err = float((gap - tie_mass).max())
        map_err = float(np.abs(dv["map_positions"].cpu().numpy()
                               - host["map_positions"]).max())
        log(f"{label} {model}: {N_SCAN_EVENTS} events x {N_SCAN} points "
            f"({N_SCAN_EVENTS * N_SCAN} rows): host scan {t_host:.3f} s, "
            f"device scan {t_dev:.3f} s (host clock, first calls); device vs "
            f"host coverage max|diff| {gap.max():.3e}, beyond the mass of "
            f"the cells of the label cell's density ({ties.max()} at most) "
            f"{cov_err:.3e} (limit {TOL_SCAN:g}), MAP "
            f"positions max|diff| {map_err:.3e}; coverage values in "
            f"[{rc.min():.4f}, {rc.max():.4f}], each at most its event's "
            f"scanned mass ({mass.min():.4f}-{mass.max():.4f})")
        if not (cov_err < TOL_SCAN and map_err < TOL_SCAN
                and ((rc >= 0) & (rc <= mass + 1e-5)).all()):
            raise AssertionError(f"{label} {model}: scans differ")
        if defs == "s2":
            lp = dv["scan_log_evals"].double()
            theta = dv["scan_positions"][..., 0].double()
            area = 4.0 * math.pi / N_SCAN
            mass = (area * torch.exp(lp - torch.log(torch.sin(theta)))).sum(1)
            mass_ref = (area * torch.exp(lp)).sum(1)
            mass_err = (mass - 1.0).abs().max().item()
            log(f"{label} {model}: each event's lattice mass of the density "
                f"per steradian (log_prob - log sin theta) within "
                f"{mass_err:.3e} of 1 (limit {TOL_LATTICE_MASS:g}); the "
                f"scans' own sum of area * exp(intrinsic log_prob), which "
                f"the HPD coverage accumulates as the JAX package does, "
                f"{mass_ref.min().item():.4f}-{mass_ref.max().item():.4f} "
                "(printed)")
            if not mass_err < TOL_LATTICE_MASS:
                raise AssertionError(f"{label} {model}: lattice mass")
            t0 = time.time()
            with torch.no_grad():
                e_scan = pm.marginal_moments(
                    pp, gen(seed + 4), conditional_input=ci_e[:1],
                    samplesize=200, calc_kl_diff_and_entropic_quantities=True,
                    s2_entropy_scanning=True)["entropy_0"][0]
            t_scan = time.time() - t0
            e_mc = pm.marginal_moments(
                pp, gen(seed + 5), conditional_input=ci_e[:1],
                samplesize=N_S2_MC, iterative_samplesize=DIAG_ITER,
                calc_kl_diff_and_entropic_quantities=True)["entropy_0"][0]
            log(f"{label} {model}: s2 entropy scan (multires, nside 32) "
                f"{e_scan:.6f} in {t_scan:.3f} s, Monte Carlo from {N_S2_MC} "
                f"draws {e_mc:.6f}: |diff| {abs(e_scan - e_mc):.3e} (limit "
                f"{TOL_S2_SCAN_ENTROPY:g})")
            if not abs(e_scan - e_mc) < TOL_S2_SCAN_ENTROPY:
                raise AssertionError(f"{label}: s2 entropy scan")
        del pm, pp, host, dv
        torch.cuda.empty_cache()
    peak_memory(label, "the diagnostics")
    log(f"diagnostics phase {time.time() - t_phase:.1f} s")
    return launches, errs


def cli_phase(dev, card):
    """The CLI in-process (``jammy_flows_tpu_torch.__main__.main``) on
    ``--platform default``: fit of the unconditional flagship (TRAIN_STEPS
    steps on N_CLI rows it drew on the CPU), then sample, eval and moments
    on the saved model; train.fit with checkpoints every
    CLI_CHECKPOINT_EVERY steps against the unchunked fit, the checkpoint
    restored bit-equal, a save / restore roundtrip with extra state, and
    the profiling helpers.  Returns (launches by path, errors per
    kernel)."""
    import io
    import os
    import tempfile
    from jammy_flows_tpu_torch import pdf, train
    from jammy_flows_tpu_torch.__main__ import main as cli_main
    from jammy_flows_tpu_torch.utils import checkpoint, profiling
    t_phase = time.time()
    label = "cli"
    launches, errs = {label: {}}, {}

    def run(what, argv_or_fn, expected, grads=False):
        def fn():
            if callable(argv_or_fn):
                return argv_or_fn()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli_main(argv_or_fn + ["--platform", "default"])
            return buf.getvalue()
        t0 = time.time()
        out, launch, e = diag_path(label, what, fn, expected, grads)
        log(f"{label} {what}: {time.time() - t0:.3f} s on the host's clock "
            "(with the calls' recording)")
        launches[label][what] = launch
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        return out

    p_cpu = pdf(*FLAGSHIP, device="cpu")
    with torch.no_grad():
        data = p_cpu.sample(jittered_params(p_cpu, seed=600, flow_scale=0.1),
                            samplesize=N_CLI,
                            generator=torch.Generator().manual_seed(601))[0]
    with tempfile.TemporaryDirectory() as tmp:
        data_path = os.path.join(tmp, "data.npy")
        model = os.path.join(tmp, "model")
        np.save(data_path, data.numpy())
        out = run("fit", ["fit", "--pdf-defs", FLAGSHIP[0], "--flow-defs",
                          FLAGSHIP[1], "--data", data_path, "--out", model,
                          "--steps", str(TRAIN_STEPS), "--lr",
                          str(TRAIN_LR), "--no-data-init"],
                  EXPECTED_CLI_LAUNCHES["fit"],
                  grads=True)
        log(f"{label} fit: {out.strip().splitlines()[-1]}")
        out = run("sample", ["sample", "--model", model, "-n", str(N_CLI),
                             "--out", os.path.join(tmp, "s.npy")],
                  EXPECTED_CLI_LAUNCHES["sample"])
        xs = np.load(os.path.join(tmp, "s.npy"))
        log(f"{label} sample: {out.strip()}")
        if not (xs.shape == (N_CLI, 10) and np.isfinite(xs).all()):
            raise AssertionError(f"{label}: samples {xs.shape}")
        out = run("eval", ["eval", "--model", model, "--data", data_path],
                  EXPECTED_CLI_LAUNCHES["eval"])
        ev = json.loads(out)
        from jammy_flows_tpu_torch.__main__ import _load_model
        p, params, _ = _load_model(model, dev)
        x = data.to(dev)
        direct = run("direct log_prob", lambda: -p.log_prob(
            params, x)[0].mean().item(), EXPECTED_CLI_LAUNCHES["eval"])
        log(f"{label} eval: {ev}; the restored model's mean NLL "
            f"{direct:.6f} (limit |diff| < 1e-5)")
        if not (ev["finite_fraction"] == 1.0 and ev["n"] == N_CLI
                and abs(ev["mean_nll"] - direct) < 1e-5):
            raise AssertionError(f"{label}: eval {ev}")
        out = run("moments", ["moments", "--model", model, "-n",
                              str(CLI_MOMENTS_N)],
                  EXPECTED_CLI_LAUNCHES["moments"])
        mm = json.loads(out)
        log(f"{label} moments: keys {sorted(mm)}; s2 kappa "
            f"{mm['varlike_1']}")
        if not all(np.isfinite(np.asarray(v, dtype=float)).all()
                   for v in mm.values()):
            raise AssertionError(f"{label}: moments")

        init = p.init_params(seed=0)
        ck = os.path.join(tmp, "ckpt")
        chunked, l_chunk = run("fit checkpointed", lambda: train.fit(
            p, init, x, num_steps=TRAIN_STEPS, learning_rate=TRAIN_LR,
            checkpoint_path=ck, checkpoint_every=CLI_CHECKPOINT_EVERY),
            EXPECTED_CLI_LAUNCHES["fit"], grads=True)
        whole, l_whole = run("fit unchunked", lambda: train.fit(
            p, init, x, num_steps=TRAIN_STEPS, learning_rate=TRAIN_LR),
            EXPECTED_CLI_LAUNCHES["fit"], grads=True)
        saved = sorted(os.listdir(ck))
        restored, _ = checkpoint.restore(os.path.join(ck, saved[-1]),
                                         like_params=init)
        l_err = float(np.abs(l_chunk - l_whole).max())
        same = all(torch.equal(restored[k], chunked[k]) for k in chunked)
        log(f"{label}: train.fit with checkpoint_every="
            f"{CLI_CHECKPOINT_EVERY} saved {saved}; its losses vs the "
            f"unchunked fit's max|diff| {l_err:.3e} (limit 1e-6), the last "
            f"checkpoint restored bit-equal to the returned parameters: "
            f"{same}")
        if not (saved == [f"step_{s:08d}" for s in range(
                CLI_CHECKPOINT_EVERY, TRAIN_STEPS + 1, CLI_CHECKPOINT_EVERY)]
                and l_err < 1e-6 and same):
            raise AssertionError(f"{label}: checkpointed fit")
        extra = {"step": TRAIN_STEPS, "moments": [v.square() for v in
                                                  whole.values()]}
        path = os.path.join(tmp, "roundtrip.pt")
        checkpoint.save(path, whole, extra_state=extra)
        back, back_extra = checkpoint.restore(
            path, like_params=whole, like_extra_state=extra)
        same = all(torch.equal(back[k], v) and back[k].device == v.device
                   for k, v in whole.items()) and \
            back_extra["step"] == TRAIN_STEPS and all(
                torch.equal(a, b) for a, b in zip(back_extra["moments"],
                                                  extra["moments"]))
        log(f"{label}: checkpoint save / restore on {dev}: bit-equal "
            f"{same}")
        if not same:
            raise AssertionError(f"{label}: checkpoint roundtrip")

        def profiled():
            with torch.no_grad():
                rate = profiling.throughput(p.log_prob, params, x,
                                            items_per_call=N_CLI, reps=5)
                with profiling.trace(os.path.join(tmp, "trace")) as d:
                    with profiling.annotate("log_prob"):
                        p.log_prob(params, x)
                    torch.cuda.synchronize()
            return rate, os.path.getsize(os.path.join(d, "trace.json"))

        rate, size = run("profiling", profiled,
                         EXPECTED_CLI_LAUNCHES["profiling"])
        log(f"{label}: profiling.throughput of log_prob on {card}: "
            f"{rate['items_per_s']:.6g} rows/s ({N_CLI} rows, 5 reps, a "
            f"scalar pulled to the host each rep); profiling.trace wrote a "
            f"{size}-byte Chrome trace")
        if not size > 0:
            raise AssertionError(f"{label}: empty trace")
    log(f"cli phase {time.time() - t_phase:.1f} s")
    return launches, errs


def add_phase_launches(rows, launches, errs):
    """The block rows (T1-T3) gain a phase's launches (``launches``: model
    -> path -> counts) under "<model> <path>" and its kernel-vs-plain
    errors."""
    for row in rows:
        name = row["name"][len("gf_block_"):]
        key = counter(name) if name in ENTRY_POINTS else name
        for label, paths in launches.items():
            for what, n in paths.items():
                if n.get(key):
                    row["launches_by_path"][f"{label} {what}"] = n[key]
        row["launches"] = sum(row["launches_by_path"].values())
        if name in errs:
            row["max_abs_err"] = max(row["max_abs_err"], errs[name])


def inverse_raw_row(args, card, ptxas=None):
    """T6's raw interface (gf_inverse_raw) has no caller in either package:
    it is timed once at the serving batch on the flagship's first g layer
    (block 0, layer 0: its means, log-widths and log-norms as broadcast raw
    slabs, K = 10, d = 4) and the recorded sample_perm call's input
    (``args``), which that layer solves first; held against its plain
    version there.  Returns its JSON row (no launches on any path), with
    its broadcast kernel's blocks per SM and registers (``ptxas``)."""
    from jammy_flows_tpu_torch.ops import gf_block as gb, gf_layer as gl
    _, _, z, (pvec,), prep, meta = split_args("sample_perm", args)
    k, d, layers = meta
    mix = gb._make_slabs([pvec[:, None]], k, d, layers, "perm")[0][2]
    params = tuple(t[..., 0].contiguous() for t in mix if t is not None)
    ift, prep = layers[0][3], tuple(prep) + (None, None)
    root = gl._launch("inverse", "raw", z, params, ift, prep, None)
    ref = gl.layer_plain("inverse", "raw", z, params, ift, prep)
    torch.cuda.synchronize()
    err = (root - ref).abs().max().item()
    log(f"kernel vs plain inverse_raw {ift} ({z.shape[0]} rows): max|diff| "
        f"{err:.3e} (limit {TOL_SAMPLE:g})")
    if not (err < TOL_SAMPLE and torch.isfinite(root).all()):
        raise AssertionError(f"inverse_raw: kernel disagrees with its plain "
                             f"version ({err:.3e} >= {TOL_SAMPLE:g})")
    ms, plain_ms, b_ms, b_by, tc_ms, slot = time_layer_call(
        ("inverse_raw", "inverse", "raw", (z, params), ift, prep, None,
         None), card)
    occ = layer_occupancy("inverse_raw", 0, len(params), False)[0]
    regs = (ptxas or {}).get("inverse_raw broadcast (K=10)")
    log(f"inverse_raw (broadcast, K=10): {occ} blocks per SM; {regs}")
    return {"name": "gf_inverse_raw", "route": "cuda",
            "source": "jammy_flows_tpu_torch/csrc/gf_layer.cu",
            "replaces": "jammy_flows_tpu/ops/pallas_gf.py:767",
            "launches": 0, "launches_by_path": {}, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "tc_bound_ms": tc_ms, "library_ms": None,
            "blocks_per_sm": occ, "ptxas": regs, "_slot": slot}


def layer_phase(dev, card, ptxas=None):
    """The per-layer route: serving of the four models, training of the
    skewed ones, gradients of the centred ones, the remaining Euclidean
    options (euclid_phase), the lazy kernels' repeat, NaN and width checks,
    kernel times (the plain-mixture instances' from the rotated model);
    returns the kernels' JSON rows."""
    t_phase = time.time()
    launches, errs, calls, forms = {}, {}, [], {}
    skewed = {label: opts is SKEW for label, opts, _ in LAYER_MODELS}

    def merge(e):
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)

    models = {}
    for i, (label, opts, cond) in enumerate(LAYER_MODELS):
        p, params = layer_model(opts, cond, dev, seed=20 + i)
        models[label] = (p, params, opts)
        n = N_SAMPLE_UNCOND if cond is None else N_COND
        ci = None if cond is None else torch.randn(
            (n, cond), generator=torch.Generator(device=dev).manual_seed(30 + i),
            device=dev)
        x, launch, block_calls, layer_calls = serve(label, p, params, n, ci,
                                                    seed=40 + i)
        if block_calls:
            raise AssertionError(f"{label}: a block kernel ran")
        merge(check_layer_calls(label, layer_calls))
        cross_check(label, p, params, x, ci, opts)
        launches[label] = {"serving": launch}
        forms[label] = {"serving": prepared_forms(label, "serving",
                                                  layer_calls, launch)}
        if cond is None or opts is SKEW:
            # whole-call times on this path's own inputs
            g = torch.Generator(device=dev).manual_seed(50 + i)
            sample_ms = cuda_ms(lambda: p.sample(
                params, samplesize=n, conditional_input=ci, generator=g), 5)
            log_prob_ms = cuda_ms(lambda: p.log_prob(params, x, ci), 5)
            for what, ms in (("sample", sample_ms), ("log_prob", log_prob_ms)):
                log(f"{label} {what} on {card}: {ms:.3f} ms per {n} rows = "
                    f"{n / ms * 1e3:.6g} rows/s (median of 5)")
        if cond is None:
            calls += first_calls(layer_calls)
        del layer_calls, x
        torch.cuda.empty_cache()
    for i, (label, (p, params, opts)) in enumerate(models.items()):
        if opts is SKEW:
            l_t, e, _, layer_calls, (step_nll, step_auto) = train(
                label, p, params, seed=60 + i, opts=opts)
            launches[label].update(l_t)
            merge(e)
            log(f"{label} training step on {card}: nll_value_and_grad "
                f"{step_nll:.3f} ms, autograd of -log_prob().mean() "
                f"{step_auto:.3f} ms per {N_TRAIN} rows")
            if p.conditional_input_dim is None:
                calls += layer_calls
            del layer_calls
            torch.cuda.empty_cache()
        else:
            l_g, layer_calls, f_g = centred_grads(label, p, params, opts,
                                                  seed=60 + i)
            launches[label].update(l_g)
            forms[label].update(f_g)
            merge(check_layer_calls(label, layer_calls))
    unskewed_calls = euclid_phase(dev, card, launches, forms, merge, skewed)
    layer_repeat_check(calls)
    layer_nan_check(calls)
    merge(layer_width_check(dev))
    rows = time_layer_kernels(calls, launches, forms, errs, skewed, card,
                              ptxas)
    rows += time_unskewed_rows(unskewed_calls, launches, errs, skewed, card,
                               ptxas)
    log(f"per-layer phase {time.time() - t_phase:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# the block's lazy mode (precomputed hidden, T1 / T2) and the routing by MLP
# shape
# ---------------------------------------------------------------------------

def wide_summary_check(dev):
    """The flagship with a 200-wide conditional input and the default
    128-wide MLP: both blocks take the lazy mode (a summary wider than 128
    is not fused), serving at N_COND rows; returns (launches, errors)."""
    from jammy_flows_tpu_torch import pdf
    label = "wide summary"
    p = pdf(*FLAGSHIP, conditional_input_dim=WIDE_SUMMARY, device=dev)
    params = jittered_params(p, seed=80)
    ci = torch.randn((N_COND, WIDE_SUMMARY), generator=torch.Generator(
        device=dev).manual_seed(81), device=dev)
    x, launch, calls, _ = serve(label, p, params, N_COND, ci, seed=82)
    errs = check_calls(label, calls)
    cross_check(label, p, params, x, ci)
    return launch, errs


def h1024_check(dev):
    """The conditional flagship with amortization_mlp_dims="1024", the
    widest hidden layer the kernels take: nll_value_and_grad (T3 lazy2) and
    a sample-objective gradient (T1 / T2 lazy2 sample) at N_CROSS rows,
    each with its own launch counts, every T2 / T3 call against its plain
    version, the gradients against the port's f64 CPU path; returns
    (launches, errors)."""
    from jammy_flows_tpu_torch import pdf
    label = "H=1024"
    p = pdf(*FLAGSHIP, conditional_input_dim=3, amortization_mlp_dims="1024",
            device=dev)
    params = jittered_params(p, seed=83)
    g = torch.Generator(device=dev).manual_seed(84)
    ci = torch.randn((N_CROSS, 3), generator=g, device=dev)
    with torch.no_grad():
        x = p.sample(jittered_params(p, seed=85, flow_scale=0.1),
                     conditional_input=ci, generator=g)[0]
    z = torch.randn((N_CROSS, p.total_base_dim), generator=g, device=dev)
    _, l_nll, c_nll, _ = train_path(
        label, "nll", p, lambda: p.nll_value_and_grad(params, x, ci))
    _, l_sg, c_sg, _ = train_path(
        label, "sample_grad", p, lambda: p._value_and_grad(
            lambda pp: sample_objective(p, pp, z, ci), params))
    errs = check_bwd_calls(label, c_nll + c_sg)
    # the sample-objective gradient against the port's f32 CPU path (its
    # distance to f64 printed): the `f` layer's MLP carries the f32 path's
    # own deviation (PERF.md, section 7)
    card_vs_f64_grads(label, p, params, x, z, ci, None, sample_f32=True)
    return {"nll": l_nll, "sample_grad": l_sg}, errs


def lazy_phase(dev, card):
    """The "64-64" flagships (block 2 of the unconditional one and both
    blocks of the conditional one in the lazy mode): serving at 1,048,576 /
    262,144 rows and training at 262,144 as the flagship's; the lazy-mode
    kernels' times on the unconditional paths' own inputs; then the routing
    checks (wide summary, H = 1024).  Returns the kernels' JSON rows."""
    from jammy_flows_tpu_torch import pdf
    t_phase = time.time()
    launches, errs = {}, {}

    def merge(e):
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)

    for i, (label, cond) in enumerate(LAZY_MODELS):
        p = pdf(*FLAGSHIP, conditional_input_dim=cond,
                amortization_mlp_dims=DIMS_LAZY, device=dev)
        params = jittered_params(p, seed=70 + i)
        n = N_SAMPLE_UNCOND if cond is None else N_COND
        ci = None if cond is None else torch.randn(
            (n, cond), generator=torch.Generator(device=dev).manual_seed(
                72 + i), device=dev)
        x, launch, calls, layer_calls = serve(label, p, params, n, ci,
                                              seed=74 + i)
        if layer_calls:
            raise AssertionError(f"{label}: a per-layer kernel ran")
        merge(check_calls(label, calls))
        cross_check(label, p, params, x, ci)
        launches[label] = {"serving": launch}
        if cond is None:
            serve_calls = [c for c in calls if c[0].endswith("_lazy")]
            g = torch.Generator(device=dev).manual_seed(76)
            sample_ms = cuda_ms(lambda: p.sample(params, samplesize=n,
                                                 generator=g), 5)
            log_prob_ms = cuda_ms(lambda: p.log_prob(params, x), 5)
            for what, ms in (("sample", sample_ms), ("log_prob", log_prob_ms)):
                log(f"{label} {what} on {card}: {ms:.3f} ms per {n} rows = "
                    f"{n / ms * 1e3:.6g} rows/s (median of 5)")
        del calls, x
        l_t, e, c_t, _, (step_nll, step_auto) = train(label, p, params,
                                                      seed=77 + i)
        launches[label].update(l_t)
        merge(e)
        log(f"{label} training step on {card}: nll_value_and_grad "
            f"{step_nll:.3f} ms, autograd of -log_prob().mean() "
            f"{step_auto:.3f} ms per {N_TRAIN} rows")
        if cond is None:
            train_calls = [c for c in c_t if c[0] in LAZYH_BWD]
        del c_t
        torch.cuda.empty_cache()

    rows = []
    for name in ("density_lazy", "sample_lazy"):
        args = next(a for nm, a, _, _ in serve_calls if nm == name)
        by_path = {f"{cfg} {what}": v[counter(name)]
                   for cfg, paths in launches.items()
                   for what, v in paths.items() if v[counter(name)]}
        rows.append(entry_row(name, args, by_path, errs[name], card))
    rows += time_bwd_kernels(LAZYH_BWD, train_calls, launches, errs, card)
    del serve_calls, train_calls
    torch.cuda.empty_cache()

    errs_l = block_lazy_width_check(dev)
    log(f"lazy mode at H = {', '.join(map(str, LAZY_WIDTHS))}: largest "
        f"errors {errs_l}")
    launch_w, errs_w = wide_summary_check(dev)
    launch_h, errs_h = h1024_check(dev)
    log(f"routing: wide summary launches "
        f"{ {k: v for k, v in launch_w.items() if v} }, errors {errs_w}; "
        f"H=1024 launches "
        f"{ {w: {k: v for k, v in n.items() if v} for w, n in launch_h.items()} }"
        f", errors {errs_h}")
    log(f"lazy-mode phase {time.time() - t_phase:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# the chain-rate probe (T8)
# ---------------------------------------------------------------------------

def chain_phase(dev, card):
    """The probe's own entry point, measure_peak, for every op with the
    launch counts set to 0 before and read after; then each op's kernel
    against its plain chain on a short chain, and the plain chain's time at
    the long length.  Logs the measured rates beside the data-sheet FP32
    rate the bounds assume; returns the JSON rows."""
    from jammy_flows_tpu_torch.tools import transcendental_peak as tp
    reset_counts()
    peaks = {op: tp.measure_peak(op, dev) for op in tp.OPS}
    torch.cuda.synchronize()
    launches = counts()
    per_op = 2 * (1 + 3 * tp.TIMED_LAUNCHES)
    want = all_counts({f"chain_{op}": per_op for op in tp.OPS})
    log(f"chain probe: launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if launches != want:
        raise AssertionError(f"chain probe: launches {launches}, expected "
                             f"{want}")
    rows = []
    for op in tp.OPS:
        rate, t_lo, t_hi = peaks[op]
        x0 = tp.initial(op, dev)
        g = torch.Generator(device=x0.device).manual_seed(tp.OPS.index(op))
        x = x0 + 0.1 * torch.rand(x0.shape, generator=g, device=x0.device)
        got = tp.chain(x, op, CHAIN_CHECK_STEPS)
        ref = tp.chain_plain(x, op, CHAIN_CHECK_STEPS)
        err = (got - ref).abs().max().item()
        log(f"kernel vs plain chain_{op} ({CHAIN_CHECK_STEPS} steps, "
            f"{x.numel()} elements): max|diff| {err:.3e} (limit "
            f"{TOL_CHAIN:g})")
        if not (err < TOL_CHAIN and torch.isfinite(got).all()):
            raise AssertionError(f"chain_{op}: kernel disagrees with its "
                                 f"plain version ({err:.3e})")
        plain_ms = cuda_ms(lambda: tp.chain_plain(x0, op, tp.CHAIN_HI), 3)
        flops = CHAIN_OPS[op] * tp.CHAIN_HI * x0.numel()
        b_ms, b_by = bound_ms(flops, 8 * x0.numel())
        counted = CHAIN_OPS[op] * rate
        log(f"chain_{op} on {card}: {rate:.6g} steps/s ({x0.numel()} "
            f"elements, chains of {tp.CHAIN_LO} and {tp.CHAIN_HI} steps: "
            f"{t_lo:.4f} / {t_hi:.4f} ms); {counted:.6g} FP32 op/s as work() "
            f"counts a step ({CHAIN_OPS[op]}), {counted / PEAK_F32_FLOPS:.4f}"
            f" of the {PEAK_F32_FLOPS:.3g} FLOP/s data-sheet rate; plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        rows.append({"name": f"chain_{op}", "route": "cuda",
                     "source": "jammy_flows_tpu_torch/csrc/chain_peak.cu",
                     "replaces": "tools/transcendental_peak.py:89",
                     "launches": launches[f"chain_{op}"],
                     "max_abs_err": err, "ms": t_hi, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "tc_bound_ms": b_ms,
                     "library_ms": None, "steps_per_s": rate})
    fma = 2 * peaks["fma"][0]
    log(f"measured rates on {card}: FMA {fma:.6g} FLOP/s "
        f"({fma / PEAK_F32_FLOPS:.4f} of the {PEAK_F32_FLOPS:.3g} FLOP/s "
        f"FP32 data-sheet rate bound_ms assumes); per step: "
        + ", ".join(f"{op} {peaks[op][0]:.6g}/s" for op in tp.OPS))
    return rows


def add_slot_bounds(rows, chain_rows, card):
    """Each per-layer row's slot_bound_ms: its layer_work count with every
    library exp and log call at the multiply-add slots this run's T8 rows
    measured (the multiply-add chain's rate over the op's chain's, less the
    one multiply-add of its step), two operations a slot, at the FP32 rate,
    or the bytes bound where larger."""
    rate = {r["name"][len("chain_"):]: r["steps_per_s"] for r in chain_rows}
    fma_slots = {kind: rate["fma"] / rate[kind] - 1.0
                 for kind in ("exp", "log")}
    log(f"library calls on {card} (T8 rows of this run): "
        + ", ".join(f"{k} {v:.4g} multiply-add slots"
                    for k, v in fma_slots.items()))
    slots = {kind: 2.0 * v for kind, v in fma_slots.items()}
    for row in rows:
        row["slot_bound_ms"] = row.pop("_slot")(slots)
        log(f"{row['name']}: slot bound {row['slot_bound_ms']:.4f} ms "
            f"(bound {row['bound_ms']:.4f} ms), kernel {row['ms']:.4f} ms: "
            f"{row['slot_bound_ms'] / row['ms']:.3f} of the slot bound")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from jammy_flows_tpu_torch import pdf
    from jammy_flows_tpu_torch.ops import cuda_build, gf_block as gb
    from jammy_flows_tpu_torch.tools import tile_breakdown

    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    ptxas = []
    built = cuda_build.build_all(["gf_block", "gf_block_bwd", "gf_layer",
                                  "gf_layer_bwd", "chain_peak"],
                                 log=ptxas.append)
    for name, (lib, compiled) in built.items():
        log(f"built {name}.cu (nvcc processes in parallel, "
            f"{time.time() - t0:.1f} s in all)" if compiled
            else f"loaded cached library {lib.name} (not rebuilt)")
    for line in ptxas_summary("".join(ptxas)):
        log(line)
    perm_ptxas = tile_breakdown.perm_ptxas("".join(ptxas))
    layer_ptxas = {**tile_breakdown.layer_ptxas("".join(ptxas)),
                   **tile_breakdown.layer_raw_ptxas("".join(ptxas)),
                   **tile_breakdown.layer_fwd_raw_ptxas("".join(ptxas)),
                   **tile_breakdown.layer_prep_ptxas("".join(ptxas))}
    tile_kernel_report(built, card)
    dev = torch.device("cuda", torch.cuda.current_device())
    # the T1 perm kernels' reciprocal of 1 + e against the IEEE one, every
    # float32 of [1, 2^88)
    bad = gb.recip_mismatches(dev)
    log(f"perm forward reciprocal (recip_ge1) vs 1.0f / d over every float "
        f"of [1, 2^88): {bad} differ")
    if bad:
        raise AssertionError(f"recip_ge1 differs from 1.0f / d on {bad} "
                             "inputs")

    p_u = pdf(*FLAGSHIP, device=dev)
    par_u = jittered_params(p_u, seed=1)
    p_c = pdf(*FLAGSHIP, conditional_input_dim=3, device=dev)
    par_c = jittered_params(p_c, seed=2)
    g = torch.Generator(device=dev).manual_seed(3)
    ci = torch.randn((N_COND, 3), generator=g, device=dev)

    # the serving paths, each with its own launch counts; every kernel call
    # they made is then held against the plain version on its inputs
    x_u, launch_u, calls_u, _ = serve("unconditional", p_u, par_u,
                                      N_SAMPLE_UNCOND, None, seed=4)
    x_c, launch_c, calls_c, _ = serve("conditional", p_c, par_c, N_COND, ci,
                                      seed=5)
    errs_u = check_calls("unconditional", calls_u)
    errs_c = check_calls("conditional", calls_c)
    del calls_c
    errs = {k: max(errs_u.get(k, 0.0), errs_c.get(k, 0.0))
            for k in ENTRY_POINTS}

    cross_check("unconditional", p_u, par_u, x_u, None)
    cross_check("conditional", p_c, par_c, x_c, ci)

    # times on the unconditional serving path's own inputs (1M rows)
    rows = []
    for name in ENTRY_POINTS[:4]:
        args = next(a for n, a, _, _ in calls_u if n == name)
        rows.append(entry_row(name, args, {"unconditional": launch_u[name],
                                           "conditional": launch_c[name]},
                              errs[name], card, perm_ptxas))
    layer_rows = [inverse_raw_row(
        next(a for n, a, _, _ in calls_u if n == "sample_perm"), card,
        layer_ptxas)]
    del calls_u

    g = torch.Generator(device=dev).manual_seed(6)
    sample_ms = cuda_ms(lambda: p_u.sample(par_u, samplesize=N_SAMPLE_UNCOND,
                                           generator=g), 10)
    log_prob_ms = cuda_ms(lambda: p_u.log_prob(par_u, x_u), 10)
    for what, ms in (("sample", sample_ms), ("log_prob", log_prob_ms)):
        log(f"unconditional {what} on {card}: {ms:.3f} ms per "
            f"{N_SAMPLE_UNCOND} rows = {N_SAMPLE_UNCOND / ms * 1e3:.6g} rows/s")

    # training: both configurations at N_TRAIN rows
    t_train = time.time()
    launch_t, errs_t, calls_t, steps = {}, {}, {}, {}
    for label, p, par, seed in (("unconditional", p_u, par_u, 7),
                                ("conditional", p_c, par_c, 8)):
        launch_t[label], e, calls_t[label], _, steps[label] = train(
            label, p, par, seed)
        for k, v in e.items():
            errs_t[k] = max(errs_t.get(k, 0.0), v)
    del calls_t["conditional"]
    perm_repeat_check(calls_t["unconditional"])
    rows += time_bwd_kernels(BWD_KERNELS, calls_t["unconditional"],
                             launch_t, errs_t, card)
    del calls_t
    for label, (fused, auto) in steps.items():
        log(f"{label} training step on {card}: fused nll_value_and_grad "
            f"{fused:.3f} ms, autograd of -log_prob().mean() {auto:.3f} ms "
            f"per {N_TRAIN} rows")
    log(f"training phase {time.time() - t_train:.1f} s")
    del p_u, p_c, par_u, par_c, x_u, x_c
    nan_check(dev)
    log(f"{time.time() - t0:.1f} s since the build started")
    add_phase_launches(rows, *circle_phase(dev, card))
    layer_rows += simplex_phase(dev, card)
    add_phase_launches(rows, *sphere_phase(dev, card))
    add_phase_launches(rows, *cnf_phase(dev, card))
    add_phase_launches(rows, *options_phase(dev, card))
    add_phase_launches(rows, *diagnostics_phase(dev, card))
    add_phase_launches(rows, *cli_phase(dev, card))
    log(f"{time.time() - t0:.1f} s since the build started")

    layer_rows += layer_phase(dev, card, layer_ptxas)
    log(f"{time.time() - t0:.1f} s since the build started")
    rows += lazy_phase(dev, card)
    log(f"{time.time() - t0:.1f} s since the build started")
    chain_rows = chain_phase(dev, card)
    log(f"{time.time() - t0:.1f} s since the build started")
    add_slot_bounds(layer_rows, chain_rows, card)
    rows += layer_rows + chain_rows

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
