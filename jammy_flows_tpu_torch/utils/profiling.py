"""Profiling and throughput measurement.

PyTorch counterpart of ``jammy_flows_tpu/utils/profiling.py``:
``torch.profiler`` trace contexts that write a Chrome trace, named
annotations, and a throughput timer with a genuine sync (a scalar of the
result pulled to the host each rep, so an asynchronous CUDA launch is not
timed as done).
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


@contextlib.contextmanager
def trace(log_dir=None):
    """Profile the block with torch.profiler (the CPU, and CUDA when a
    device exists) and write the Chrome trace ``trace.json`` into
    ``log_dir`` (by default a directory under the temporary directory);
    yields the directory."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "jammy_flows_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    for v in out:
        t = _first_tensor(v) if isinstance(v, (torch.Tensor, dict, list,
                                                tuple)) else None
        if t is not None:
            return t
    return None


def throughput(fn, *args, items_per_call, reps=10, warmup=1, **kwargs):
    """Measure items/s of `fn(*args, **kwargs)` with genuine host sync.

    fn must return a tensor, or a dict / list / tuple holding one; the sum
    of the first tensor is pulled to the host each rep.
    """
    def scalar_sync(out):
        return float(_first_tensor(out).sum())

    for _ in range(warmup):
        scalar_sync(fn(*args, **kwargs))
    t0 = time.time()
    acc = 0.0
    for _ in range(reps):
        acc += scalar_sync(fn(*args, **kwargs))
    dt = time.time() - t0
    return {"items_per_s": reps * items_per_call / dt,
            "seconds_per_call": dt / reps, "reps": reps, "checksum": acc}


def annotate(name):
    """Named profiler annotation context (shows up in traces)."""
    return torch.profiler.record_function(name)
