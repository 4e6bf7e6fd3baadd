"""Chain-rate probe: the measured per-op rate of the flow kernels' operations.

PyTorch counterpart of part 1 of ``tools/transcendental_peak.py`` (the TPU
kernel ``_chain_kernel``, T8): every element of a 1,048,576-element float32
array runs a dependent chain of one operation (exp, log, softplus, sin,
arccos, or a multiply-add), timed at two chain lengths; the difference of
the two times over the difference of the steps is the time of one step over
all elements, free of launch overhead (``measure_peak``).  On a CUDA tensor
:func:`chain` launches the hand-written kernel (``csrc/chain_peak.cu``) and
counts the launch in ``LAUNCHES``; on a CPU tensor it runs the plain
PyTorch chain.  Parts 2-3 of the JAX tool (the jaxpr census, the ROOFLINE
patching) are JAX-specific and not ported; the port's operation census is
``work()`` in chip_smoke.py.

    python -m jammy_flows_tpu_torch.tools.transcendental_peak

prints one JSON line of rates (steps/s per op) on the current CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import statistics

import torch

OPS = ("exp", "log", "softplus", "sin", "arccos", "fma")
_CODES = {op: i for i, op in enumerate(OPS)}
N_ELEMS = 8 * 128 * 1024    # the JAX probe's (8, 128 * 1024) block grid
# the JAX probe's 8:1 ratio of chain lengths (measure_peak(reps=64): 64 and
# 512 steps), 32 times longer: on the card a multiply-add chain of 512 steps
# takes less time than the host needs to issue one launch (~25 us on an
# H100), which would leave nothing but the host in the slope
CHAIN_LO, CHAIN_HI = 2048, 16384
TIMED_LAUNCHES = 20         # per chain length, after one warm-up launch
# the longer chain must take at least this many times the shorter one's
# time, else the launches did not keep the card busy and the slope is void
MIN_TIME_RATIO = 4.0

LAUNCHES = {f"chain_{op}": 0 for op in OPS}


def reset_launch_counts():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def initial(op, device, n=N_ELEMS):
    """The probe's starting values: -0.5, or 0.7 for log."""
    return torch.full((n,), 0.7 if op == "log" else -0.5,
                      dtype=torch.float32, device=device)


def chain_step_plain(x, op):
    """One step of op's chain (``_chain_kernel``'s loop body)."""
    if op == "exp":
        return torch.exp(x) * -0.4
    if op == "log":
        return torch.log(x) * -0.3 + 1.0
    if op == "softplus":        # jax.nn.softplus: max(x, 0) + log1p(e^-|x|)
        return (torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))) \
            * -0.5
    if op == "sin":
        return torch.sin(x) + 0.1
    if op == "arccos":
        return torch.arccos(x * 0.6) - 1.0
    if op == "fma":
        return x * 1.0000001 + 1e-7
    raise ValueError(f"unknown op {op!r}")


def chain_plain(x, op, n_ops):
    """The plain PyTorch version: n_ops dependent steps of op."""
    for _ in range(n_ops):
        x = chain_step_plain(x, op)
    return x


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.chain_peak_launch.argtypes = [i, p, p, i, i, p]
    lib.chain_peak_launch.restype = i
    lib.chain_peak_error_string.argtypes = [i]
    lib.chain_peak_error_string.restype = ctypes.c_char_p


def _launch(x, op, n_ops):
    if x.dtype != torch.float32 or x.ndim != 1 or not x.is_contiguous():
        raise ValueError("the chain kernel takes a contiguous 1-d float32 "
                         "tensor")
    from ..ops import cuda_build
    lib = cuda_build.load("chain_peak", _declare)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.chain_peak_launch(_CODES[op], x.data_ptr(), y.data_ptr(),
                                   x.numel(), int(n_ops), stream)
    if rc != 0:
        msg = lib.chain_peak_error_string(rc).decode()
        raise RuntimeError(f"chain_peak kernel launch failed ({rc}): {msg}")
    LAUNCHES[f"chain_{op}"] += 1
    return y


def chain(x, op, n_ops):
    """n_ops dependent steps of op on every element of x (1-d float32): the
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if op not in _CODES:
        raise ValueError(f"unknown op {op!r}")
    if x.is_cuda:
        return _launch(x, op, n_ops)
    return chain_plain(x, op, n_ops)


def time_chain(fn, launches):
    """ms per call of fn: one warm-up call, then ``launches`` calls between
    two CUDA events, three times; the median of the three means."""
    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / launches)
    return statistics.median(means)


def measure_peak(op, device, n_lo=CHAIN_LO, n_hi=CHAIN_HI):
    """(steps/s over all elements, ms at n_lo, ms at n_hi): the slope between
    two chain lengths, as ``measure_peak`` takes it (launch overhead and
    loads cancel).  Launches 2 * (1 + 3 * TIMED_LAUNCHES) kernels."""
    if torch.device(device).type != "cuda":
        raise RuntimeError("measure_peak times the CUDA kernel: it needs a "
                           "CUDA device")
    x = initial(op, device)
    t_lo = time_chain(lambda: chain(x, op, n_lo), TIMED_LAUNCHES)
    t_hi = time_chain(lambda: chain(x, op, n_hi), TIMED_LAUNCHES)
    if t_hi < MIN_TIME_RATIO * t_lo:
        raise RuntimeError(f"chain_{op}: {n_hi} steps took {t_hi:.4f} ms, "
                           f"{n_lo} steps {t_lo:.4f} ms: the launches, not "
                           "the chains, set the time")
    per_step_ms = (t_hi - t_lo) / (n_hi - n_lo)
    return x.numel() / (per_step_ms * 1e-3), t_lo, t_hi


def main():
    if not torch.cuda.is_available():
        raise SystemExit("transcendental_peak: no CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    rates = {op: measure_peak(op, dev)[0] for op in OPS}
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "elements": N_ELEMS, "chain": [CHAIN_LO, CHAIN_HI],
                      "steps_per_s": rates}))


if __name__ == "__main__":
    main()
