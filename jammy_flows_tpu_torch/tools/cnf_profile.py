"""Where the time of the manifold CNF `c` goes on the card: one evaluation
of its field and divergence, and of their vector-Jacobian product (the
adjoint's right-hand side), at chip_smoke.py's width.

    python -m jammy_flows_tpu_torch.tools.cnf_profile [--rows 262144]
        [--top 25]

Run from the root of a checkout: the model is chip_smoke.py's ``pdf("s2",
"c")`` at the registry's defaults with its weights (``jittered_params``).
For each of the two calls: the host-clock time per call (a mean of 10
after 3 warm-up calls, each ending in a synchronise), then one call under
``torch.profiler`` (CPU and CUDA activity): its CUDA events, their summed
device time and the ops with the most device time.  Needs one CUDA
device.
"""
from __future__ import annotations

import argparse
import time

import torch

import chip_smoke


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=chip_smoke.N_COND)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("cnf_profile: needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile
    from jammy_flows_tpu_torch import pdf
    print(chip_smoke.card_line(), flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    p = pdf("s2", "c", device=dev)
    layer = p.layer_list[0][0]
    par = chip_smoke.jittered_params(p, seed=1)["flow_0"][None]
    g = torch.Generator(device=dev).manual_seed(0)
    y = 0.1 * torch.randn((args.rows, 3), generator=g, device=dev)
    loc = torch.nn.functional.normalize(
        torch.randn((args.rows, 3), generator=g, device=dev), dim=-1)

    def field():
        return layer._rhs_and_div(0.1, y, loc, par)

    def vjp():
        leaves = [t.detach().requires_grad_() for t in (y, loc, par)]
        with torch.enable_grad():
            out = layer._rhs_and_div(0.1, *leaves)
            return torch.autograd.grad(out, leaves, [torch.ones_like(o)
                                                     for o in out])

    for name, fn in (("field and divergence", field),
                     ("their VJP", vjp)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        host = (time.time() - t0) / 10 * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev_events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
        print(f"{name} at {args.rows} rows: {host:.3f} ms per call (host "
              f"clock, mean of 10); one call {len(dev_events)} CUDA events, "
              f"{sum(e.time_range.elapsed_us() for e in dev_events) / 1e3:.3f}"
              " ms on the device", flush=True)
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=args.top), flush=True)


if __name__ == "__main__":
    main()
