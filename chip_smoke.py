"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA block kernels from jammy_flows_tpu_torch/csrc,
then drives the flagship ``pdf("e4+s2+e4", "gggg+f+gggg")`` serving path
twice, unconditional (1,048,576 rows) and conditional_input_dim=3 (262,144
rows): ``sample``, then ``log_prob`` of the samples.  Each path has its own
launch counts, which must be exactly the kernels that path runs.  Every
kernel call of both paths is recorded and held against the plain PyTorch
version on the same inputs; the card's float32 log-prob is cross-checked
against the port's float64 CPU path for both models; then each kernel, its
plain version and the whole ``sample`` / ``log_prob`` are timed.  Every
failure raises (non-zero exit).  The last line of standard output is the
device JSON; the line before it the per-kernel JSON.  Needs one CUDA device;
imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time

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
ENTRY_POINTS = ("density_perm", "sample_perm", "density_lazy2",
                "sample_lazy2")
# launches of one sample + log_prob: the unconditional flagship's block 0
# has permanent parameters (perm) and block 2 a fused MLP (lazy2); the
# conditional one amortizes both blocks (lazy2, 3- and 10-wide summaries)
EXPECTED_LAUNCHES = {
    "unconditional": {"density_perm": 1, "sample_perm": 1,
                      "density_lazy2": 1, "sample_lazy2": 1},
    "conditional": {"density_perm": 0, "sample_perm": 0,
                    "density_lazy2": 2, "sample_lazy2": 2},
}
# H100 SXM peaks (NVIDIA data sheet): FP32 on the CUDA cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def log(msg):
    print(msg, flush=True)


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


def cuda_ms(fn, reps):
    """Median over ``reps`` single-launch CUDA-event timings, after one
    warm-up call."""
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
    """Wrap the four block entry points so that every call the serving path
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
    """(direction, lazy, x, params, prep, meta) of an entry point's args."""
    direction, mode = name.split("_")
    *tensors, prep, meta = args
    return direction, mode == "lazy2", tensors[0], tuple(tensors[1:]), prep, meta


def check_calls(label, calls):
    """Each recorded kernel result against the plain version on the same
    inputs; returns the largest |diff| per entry point."""
    from jammy_flows_tpu_torch.ops import gf_block as gb
    errs = {}
    for name, args, out_k, ld_k in calls:
        direction, lazy, x, params, prep, meta = split_args(name, args)
        out_p, ld_p = gb.block_plain(direction, x, params, prep, meta, lazy)
        torch.cuda.synchronize()
        e_out = (out_k - out_p).abs().max().item()
        e_ld = (ld_k - ld_p).abs().max().item()
        tol = TOL_DENSITY if direction == "density" else TOL_SAMPLE
        what = f"{label} {name} ({x.shape[0]} rows" + (
            f", {params[0].shape[1]}-wide summary)" if lazy else ")")
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

def block_work(name, n, meta, n_in=0, hid=0):
    """(flops, bytes) the block function needs for n rows.  Flops count an
    FMA as 2 and every other f32 operation, transcendentals included, as 1;
    per mixture component: 12 for a value, 16 with the pdf, 28 with the
    density form's fallback terms, 31 for the regulators and log-softmax of
    its parameters; an iCDF pass with its log-derivative 30; a householder
    reflection 8 per dimension.  The trip counts are fixed (no early exit),
    so this is what every run needs."""
    from jammy_flows_tpu_torch.ops.gf_block import block_rows
    k, d, layers = meta
    direction, mode = name.split("_")
    p = block_rows(k, d, layers)
    per_row = 0
    for has_off, rot_it, _, ift in layers:
        per_row += d * (has_off + 8 * rot_it)
        if direction == "density":
            unit = 28 * k + 30
        else:
            start = 3 * k if ift == "isigmoid" else 2 * (12 * k + 15)
            unit = 4 * k + start + 4 * (16 * k + 30) + (16 * k + 30)
        per_row += d * unit
        if mode == "lazy2":
            per_row += d * 31 * k
    byts = 3 * n * d * 4
    if mode == "lazy2":
        per_row += 2 * hid * n_in + 2 * hid + 2 * p * hid + p
        byts += 4 * (n * n_in + hid * n_in + hid + p * hid + p)
    else:
        byts += 4 * p
    return per_row * n, byts


def bound_ms(flops, byts):
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = byts / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def jittered_params(p, seed):
    """init_params(seed=0) with every MLP's weights moved by 0.02 * N(0, 1):
    the initial MLP's output hardly depends on its input (its weights are
    damped by 1000), so this gives the lazy2 kernel parameters that differ
    from row to row, as a trained model's do."""
    params = p.init_params(seed=0)
    g = torch.Generator(device=p.device).manual_seed(seed)
    return {k: v + 0.02 * torch.randn(v.shape, generator=g, device=v.device)
            if k.startswith("mlp_") else v for k, v in params.items()}


def roundtrip(p, params, n, ci, seed):
    """sample n rows, then log_prob of them; returns (x, |dlogp|)."""
    g = torch.Generator(device=p.device).manual_seed(seed)
    x, z, lp_sample, _ = p.sample(params, samplesize=n, conditional_input=ci,
                                  generator=g)
    lp_eval, _, _ = p.log_prob(params, x, conditional_input=ci)
    torch.cuda.synchronize()
    for name, t in (("x", x), ("log_pdf", lp_sample), ("log_prob", lp_eval)):
        if t.shape[0] != n or not torch.isfinite(t).all():
            raise AssertionError(f"non-finite or misshapen {name}")
    if x.shape[1] != p.total_target_dim:
        raise AssertionError(f"samples have width {x.shape[1]}")
    return x, (lp_eval - lp_sample).abs()


def serve(label, p, params, n, ci, seed):
    """One serving path (sample, then log_prob of the samples) with the
    launch counts set to 0 just before it and read just after; returns
    (samples, launches, recorded entry-point calls)."""
    from jammy_flows_tpu_torch.ops import gf_block as gb
    calls = []
    gb.reset_launch_counts()
    with recording(calls):
        x, d = roundtrip(p, params, n, ci, seed)
    torch.cuda.synchronize()
    launches = dict(gb.LAUNCHES)
    log(f"{label} ({n} rows): launches {launches}")
    if launches != EXPECTED_LAUNCHES[label]:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{EXPECTED_LAUNCHES[label]}")
    if len(calls) != sum(launches.values()):
        raise AssertionError(f"{label}: {len(calls)} entry-point calls for "
                             f"{sum(launches.values())} launches")
    q999 = torch.quantile(d.float(), 0.999).item()
    log(f"{label}: sample->log_prob |dlogp| q999 {q999:.3e} max "
        f"{d.max().item():.3e} (limit q999 < {TOL_ROUNDTRIP_Q999:g})")
    if not q999 < TOL_ROUNDTRIP_Q999:
        raise AssertionError(f"{label}: roundtrip q999 {q999:.3e}")
    return x, launches, calls


def cross_check(label, p, params, x, ci):
    """The card's f32 log_prob of N_CROSS samples against the port's f64
    CPU path."""
    from jammy_flows_tpu_torch import pdf
    from jammy_flows_tpu_torch.utils.convert import params_from_jax
    xs = x[:N_CROSS]
    cis = None if ci is None else ci[:N_CROSS]
    lp_gpu = p.log_prob(params, xs, conditional_input=cis)[0].double().cpu()
    p_cpu = pdf(*FLAGSHIP, conditional_input_dim=p.conditional_input_dim,
                device="cpu")
    par64 = params_from_jax({k: v.cpu().numpy() for k, v in params.items()},
                            dtype=torch.float64)
    lp_cpu = p_cpu.log_prob(par64, xs.double().cpu(), conditional_input=(
        None if cis is None else cis.double().cpu()))[0]
    cross = (lp_gpu - lp_cpu).abs().max().item()
    log(f"{label}: card f32 vs CPU f64 log_prob on {N_CROSS} samples: "
        f"max|diff| {cross:.3e} (limit {TOL_CROSS:g})")
    if not cross < TOL_CROSS:
        raise AssertionError(f"{label}: card vs CPU f64 log_prob differ by "
                             f"{cross:.3e}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from jammy_flows_tpu_torch import pdf
    from jammy_flows_tpu_torch.ops import cuda_build, gf_block as gb

    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    ptxas = []
    lib, compiled = cuda_build.build("gf_block", log=ptxas.append)
    if compiled:
        log(f"built gf_block.cu in {time.time() - t0:.1f} s")
        for line in ptxas_summary("".join(ptxas)):
            log(line)
    else:
        log(f"loaded cached library {lib.name} (not rebuilt)")
    dev = torch.device("cuda", torch.cuda.current_device())

    p_u = pdf(*FLAGSHIP, device=dev)
    par_u = jittered_params(p_u, seed=1)
    p_c = pdf(*FLAGSHIP, conditional_input_dim=3, device=dev)
    par_c = jittered_params(p_c, seed=2)
    g = torch.Generator(device=dev).manual_seed(3)
    ci = torch.randn((N_COND, 3), generator=g, device=dev)

    # the serving paths, each with its own launch counts; every kernel call
    # they made is then held against the plain version on its inputs
    x_u, launch_u, calls_u = serve("unconditional", p_u, par_u,
                                   N_SAMPLE_UNCOND, None, seed=4)
    x_c, launch_c, calls_c = serve("conditional", p_c, par_c, N_COND, ci,
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
    for name in ENTRY_POINTS:
        args = next(a for n, a, _, _ in calls_u if n == name)
        fn = getattr(gb, f"gf_block_{name}")
        direction, lazy, x, params, prep, meta = split_args(name, args)
        ms = cuda_ms(lambda: fn(*args), TIMING_REPS)
        plain_ms = cuda_ms(lambda: gb.block_plain(direction, x, params, prep,
                                                  meta, lazy), TIMING_REPS)
        n_in, hid = (params[0].shape[1], params[1].shape[0]) if lazy \
            else (0, 0)
        flops, byts = block_work(name, x.shape[0], meta, n_in, hid)
        b_ms, b_by = bound_ms(flops, byts)
        log(f"{name} at {x.shape[0]} rows on {card}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
            f"{flops:.4g} flop, {byts:.4g} B)")
        rows.append({"name": f"gf_block_{name}", "route": "cuda",
                     "source": "jammy_flows_tpu_torch/csrc/gf_block.cu",
                     "replaces": "jammy_flows_tpu/ops/pallas_gf_block.py:489",
                     "launches": launch_u[name] + launch_c[name],
                     "launches_by_path": {"unconditional": launch_u[name],
                                          "conditional": launch_c[name]},
                     "max_abs_err": errs[name],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
    del calls_u

    g = torch.Generator(device=dev).manual_seed(6)
    sample_ms = cuda_ms(lambda: p_u.sample(par_u, samplesize=N_SAMPLE_UNCOND,
                                           generator=g), 10)
    log_prob_ms = cuda_ms(lambda: p_u.log_prob(par_u, x_u), 10)
    for what, ms in (("sample", sample_ms), ("log_prob", log_prob_ms)):
        log(f"unconditional {what} on {card}: {ms:.3f} ms per "
            f"{N_SAMPLE_UNCOND} rows = {N_SAMPLE_UNCOND / ms * 1e3:.6g} rows/s")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
