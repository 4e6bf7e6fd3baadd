"""Where the time of chip_smoke.py's Euclidean-option models goes on the card.

    python -m jammy_flows_tpu_torch.tools.euclid_profile [--models LABEL ...]
        [--top N]

Run from the root of a checkout: the models, their weights, row counts and
conditional inputs are chip_smoke.py's (``EUCLID_MODELS``, built by its
``euclid_model``), so this profiles what its Euclidean phase serves.  For
each model, one ``sample`` and one ``log_prob`` of its samples under
``torch.profiler`` (CPU and CUDA activity), each after an unprofiled warm-up
call.  Prints the host-clock time of the profiled call (it ends in a
synchronise), the device time (the sum of every kernel's CUDA time) and the
kernels with the most device time, then one JSON line per model.  Needs one
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

import chip_smoke


def _device_ms(event):
    us = getattr(event, "self_device_time_total", None)
    if us is None:
        us = event.self_cuda_time_total
    return us / 1e3


def profile_call(fn, top):
    """(host ms, device ms, [(kernel, device ms, calls)] of the top
    kernels) of one call of fn after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
    # the kernels' own events (the ops that launched them carry their
    # time again); all events where the profiler marks none
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA] or events
    ranked = sorted(kernels, key=_device_ms, reverse=True)[:top]
    return host, sum(_device_ms(e) for e in kernels), \
        [(e.key[:100], _device_ms(e), e.count) for e in ranked]


def run(labels, top, dev, card):
    """Profile each EUCLID_MODELS entry named in ``labels`` on ``dev``;
    prints as the module says."""
    for i, (name, *_) in enumerate(chip_smoke.EUCLID_MODELS):
        if name not in labels:
            continue
        p, params, n, ci = chip_smoke.euclid_model(i, dev)
        g = torch.Generator(device=dev).manual_seed(0)
        out = {"model": name, "rows": n, "card": card}
        with torch.no_grad():
            x = p.sample(params, samplesize=n, conditional_input=ci,
                         generator=g)[0]
            for what, fn in (
                    ("sample", lambda: p.sample(params, samplesize=n,
                                                conditional_input=ci,
                                                generator=g)),
                    ("log_prob", lambda: p.log_prob(params, x, ci))):
                host, device, ops = profile_call(fn, top)
                print(f"{name} {what} ({n} rows) on {card}: host {host:.3f} "
                      f"ms, device {device:.3f} ms", flush=True)
                for op, ms, calls in ops:
                    print(f"  {ms:10.3f} ms {calls:6d} x  {op}", flush=True)
                out[what] = {"host_ms": host, "device_ms": device,
                             "top": [[op, ms, calls] for op, ms, calls in ops]}
        print(json.dumps(out), flush=True)
        del p, params, x
        torch.cuda.empty_cache()


def main(argv=None):
    labels = [m[0] for m in chip_smoke.EUCLID_MODELS]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", nargs="+", default=labels, choices=labels)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("euclid_profile: no CUDA device")
    card = chip_smoke.card_line()
    print(card, flush=True)
    run(args.models, args.top,
        torch.device("cuda", torch.cuda.current_device()), card)


if __name__ == "__main__":
    main()
