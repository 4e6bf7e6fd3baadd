"""T1 perm density at a full wave of blocks +- 1 row, in separate processes:
the kernel and its plain version on the card, each held against the port's
float64 CPU path.

    python -m jammy_flows_tpu_torch.tools.perm_edge_probe [--procs 8]
        [--draws 20]

The batch is the one ``tests/test_torch_cuda.py`` builds for
``test_perm_fwd_kernels_at_tile_edges`` (the flagship's block 0, x =
0.8 N(0, 1) from numpy seed 5, at (occupancy API blocks per SM) x SMs x
128 rows +- 1), with the permanent parameters jittered by 0.1 N(0, 1) in
two ways:

* "global": from torch's global CUDA generator, as the test drew them
  before it took a generator of its own, after process i has drawn i other
  parameter vectors from it (a stand-in for the tests that ran before it
  in the same process);
* "seeded": from a generator seeded with the test's seed (5).

Each process reports, per draw: a digest of the parameters, the largest
|kernel - plain|, |kernel - f64| and |plain - f64| over out and ld at the
wave + 1 batch, whether two launches and the wave - 1 launch give the
kernel's bits again, and the worst row's float64 output (the layer-0
iCDF's seam between the erfinv polynomial and the Pade approximation lies
at sqrt(2) erfinv(2 * 0.5e-7 - 1) = -5.3267, where the float32 iCDF jumps
by ~3e-3).  Then each process makes ``--draws`` further global draws and
holds the kernel against the plain version on each; for every draw where
they differ by 3e-4 or more it reports the same as above.

Each further draw is also compared by branch.  The port's float64 CPU path
and the plain version (float32, on the card) run on the same rows with
every layer's mixture recorded, and each (layer, dimension) of a row gives
two distances from the reference's float32 seams: s = log_cdf + log_sf +
log 4 - log(4 PADE_BOUND (1 - PADE_BOUND)), zero where the normal iCDF
switches from the erfinv polynomial to the Pade tail (cdf ~ 0.5e-7; none
for isigmoid layers), and c = min_k |c_k| - 55, zero where the mixture
takes its fallback lanes.  The band of each is twice the largest
|float32 - float64| of that distance over the rows where the plain
version's outputs lie within 3e-4 of the float64 path's (the float32
spread away from the seams; kernel and plain both carry it, so two values
on opposite sides of a seam lie within it of the float64 value).  A row is
excluded from the 3e-4 limit only where the float64 s or c of some layer
lies within its band; every other row is held to 3e-4.  Per draw: the
bands, the rows excluded, the rows past the limit and whether each of them
was an excluded one, and the largest |kernel - plain| over the rows held.
Where rows are past the limit, the plain version runs four times more:
with its iCDF switch (``gf._LOG_SEAM``) moved by +- FLIP_BANDS bands of s,
and with its fallback lanes' switch (``logistic_kde.FALLBACK_SEAM``)
moved by +- FLIP_BANDS bands of c, so that the rows near either seam take
the other branch: each such row's |kernel - plain| beside its least
|kernel - flipped plain| over the four runs (and over each seam's two),
which is small where the row's gap is a seam's jump carried through the
later layers and nothing else.

Prints one JSON line per process and a summary line with the card's name
and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

FLAGSHIP = ("e4+s2+e4", "gggg+f+gggg")
SEED = 5
# sqrt(2) erfinv(2 PADE_BOUND - 1), PADE_BOUND = 0.5e-7
SEAM = -5.326723886384500
LIMIT = 3e-4                # kernel vs plain, the density direction
BAND_FACTOR = 2.0           # a seam's band: this many float32 spreads
FLIP_BANDS = 2.0            # the flipped plain version's switch: moved by
                            # this many bands of s


def _errs(a, b):
    return max(float((a[0].double() - b[0].double()).abs().max()),
               float((a[1].double() - b[1].double()).abs().max()))


def _report(gb, x, pvec, prep, meta, k1, plain):
    """The draw's parameter digest, its errors against the float64 CPU path
    and its worst element (kernel vs plain)."""
    import torch
    f64 = gb.block_plain("density", x.cpu().double(), (pvec.cpu().double(),),
                         prep, meta, "perm")
    k_cpu = tuple(t.cpu() for t in k1)
    p_cpu = tuple(t.cpu() for t in plain)
    diff = (k_cpu[0].double() - p_cpu[0].double()).abs()
    row, col = divmod(int(diff.argmax()), 4)
    return {
        "params_sha256": hashlib.sha256(
            pvec.cpu().numpy().tobytes()).hexdigest()[:16],
        "kernel_vs_plain": _errs(k_cpu, p_cpu),
        "kernel_vs_f64": _errs(k_cpu, f64),
        "plain_vs_f64": _errs(p_cpu, f64),
        "worst": {"row": row, "dim": col,
                  "kernel": float(k_cpu[0][row, col]),
                  "plain": float(p_cpu[0][row, col]),
                  "f64": float(f64[0][row, col]),
                  "f64_minus_seam": float(f64[0][row, col]) - SEAM}}


def seam_distances(x, mix, ift):
    """(s, c), each (d, B), of one layer's mixture at its input x (d, B):
    the normal iCDF's switch at s = 0 (inf for an iCDF without that seam)
    and the fallback lanes' at c = 0."""
    import torch
    from ..ops import gf, logistic_kde as lk
    means, iw, lnw = gf._unpack_mix(mix)[:3]
    common = (x[None] - means) * iw
    c = common.abs().amin(dim=0) - lk.FALLBACK_SEAM
    if ift != "inormal_partly_precise":
        return torch.full_like(c, float("inf")), c
    log_cdf, log_sf, _ = lk.mixture_linear_logs(
        common, torch.exp(lnw), lnw, iw, torch.log(iw), True)
    return log_cdf + log_sf + lk.LOG_4 - lk.LOG_SEAM, c


def recorded(fn):
    """(fn's result, [(s, c) of each layer's mixture, on the CPU]): a
    block's plain density path run with gf.mixture_value_deriv recorded."""
    import torch
    from ..ops import gf
    seen, plain = [], gf.mixture_value_deriv

    def record(x, mix, deriv_mode, ift):
        with torch.no_grad():
            seen.append(tuple(t.cpu() for t in seam_distances(x, mix, ift)))
        return plain(x, mix, deriv_mode, ift)

    gf.mixture_value_deriv = record
    try:
        return fn(), seen
    finally:
        gf.mixture_value_deriv = plain


def rows_off(a, b):
    """(B,): each row's largest |a - b| over the (out, ld) pairs a, b."""
    import torch
    return torch.stack([(u.cpu().double() - v.cpu().double()).abs()
                        .amax(dim=1) for u, v in zip(a, b)]).amax(dim=0)


def flipped(fn, shift, seam="icdf"):
    """fn's result with one switch of the plain version moved by shift:
    the normal iCDF's in s (``gf._LOG_SEAM``) or the fallback lanes' in c
    (``logistic_kde.FALLBACK_SEAM``); the rows whose s or c lies between
    0 and shift take the other branch."""
    from ..ops import gf, logistic_kde as lk
    mod, name = (gf, "_LOG_SEAM") if seam == "icdf" else \
        (lk, "FALLBACK_SEAM")
    at = getattr(mod, name)
    setattr(mod, name, at + shift)
    try:
        return fn()
    finally:
        setattr(mod, name, at)


def flip_check(kernel, plain, flips):
    """The rows of one draw past the limit: each one's |kernel - plain| and
    its least |kernel - flipped plain| over every flipped run and over
    each seam's (``flips``: {seam: [flipped runs]})."""
    import torch
    kp = rows_off(kernel, plain)
    over = torch.nonzero(kp >= LIMIT).flatten()
    by_seam = {seam: torch.stack([rows_off(kernel, f) for f in runs])
               .amin(dim=0) for seam, runs in flips.items()}
    kf = torch.stack(list(by_seam.values())).amin(dim=0)
    return {"over_limit_vs_plain": kp[over].tolist()[:20],
            "over_limit_vs_flipped_plain": kf[over].tolist()[:20],
            **{f"over_limit_vs_{seam}_flipped_plain": v[over].tolist()[:20]
               for seam, v in by_seam.items()}}


def by_branch(kernel, plain, f64, seen32, seen64):
    """The comparison by branch (module docstring) of one draw: the
    kernel's, the plain version's and the float64 path's (out, ld), and
    the seam distances recorded on the plain and the float64 paths."""
    import torch
    kp, p64, k64 = (rows_off(kernel, plain), rows_off(plain, f64),
                    rows_off(kernel, f64))
    away = p64 < LIMIT      # rows where plain and float64 agree
    out = {"rows": int(kp.shape[0]), "rows_away": int(away.sum())}
    excluded = torch.zeros_like(away)
    # each row's nearest approach to a seam, in bands
    nearest = torch.full(away.shape, float("inf"), dtype=torch.float64)
    for which, name in enumerate(("icdf", "fallback")):
        d32 = torch.stack([s[which] for s in seen32]).double()
        d64 = torch.stack([s[which] for s in seen64]).double()
        fin = torch.isfinite(d64)
        off = torch.where(fin, (d32 - d64).abs(), 0.0).amax(dim=(0, 1))
        spread = float(off[away].max()) if bool(away.any()) else 0.0
        band = BAND_FACTOR * spread
        near = ((d64.abs() < band) & fin).any(dim=0).any(dim=0)
        out[f"{name}_spread"], out[f"{name}_band"] = spread, band
        out[f"rows_near_{name}_seam"] = int(near.sum())
        excluded |= near
        dist = torch.where(fin, d64.abs(), float("inf")).amin(dim=(0, 1))
        nearest = torch.minimum(nearest, dist / max(band, 1e-30))
    over, held = kp >= LIMIT, ~excluded
    out.update({
        "rows_excluded": int(excluded.sum()),
        "rows_over_limit": int(over.sum()),
        "over_limit_all_excluded": bool((over & held).sum() == 0),
        "over_limit_not_excluded": torch.nonzero(over & held).flatten()
                                        .tolist()[:20],
        "over_limit_nearest_seam_in_bands": nearest[over].tolist()[:20],
        "kernel_vs_plain_held_max": float(kp[held].max()) if bool(
            held.any()) else 0.0,
        "kernel_vs_plain_max": float(kp.max()),
        "kernel_vs_f64_away_max": float(k64[away].max()),
        "plain_vs_f64_away_max": float(p64[away].max())})
    return out


def child(index, n_draws):
    import numpy as np
    import torch
    from .. import pdf
    from ..ops import gf_block as gb
    torch.set_num_threads(8)
    dev = torch.device("cuda", 0)
    p = pdf(*FLAGSHIP, device=dev)
    prep, meta = p._block_meta[0]
    blocks, rows = gb.perm_grid("density", 1 << 30, prep, meta)
    n = blocks * rows + 1
    rng = np.random.default_rng(SEED)
    x = torch.as_tensor(0.8 * rng.normal(size=(n, 4)), dtype=torch.float32,
                        device=dev)
    flow = p.init_params(seed=0)["flow_0"]
    for _ in range(index):
        torch.randn(flow.shape, device=dev)
    draws = {"global": flow + 0.1 * torch.randn(flow.shape, device=dev)}
    g = torch.Generator(device=dev).manual_seed(SEED)
    draws["seeded"] = flow + 0.1 * torch.randn(flow.shape, generator=g,
                                                device=dev)
    out = {"process": index, "rows": [n - 2, n], "grid": [blocks, rows]}
    for name, pvec in draws.items():
        k1 = gb._launch(x, (pvec,), prep, meta, "perm", "density")
        k2 = gb._launch(x, (pvec,), prep, meta, "perm", "density")
        k_short = gb._launch(x[:n - 2].contiguous(), (pvec,), prep, meta,
                             "perm", "density")
        plain = gb.block_plain("density", x, (pvec,), prep, meta, "perm")
        torch.cuda.synchronize()
        out[name] = _report(gb, x, pvec, prep, meta, k1, plain)
        out[name]["repeat_equal"] = bool(torch.equal(k1[0], k2[0])
                                         and torch.equal(k1[1], k2[1]))
        out[name]["wave_minus_1_equal"] = bool(
            torch.equal(k_short[0], k1[0][:n - 2])
            and torch.equal(k_short[1], k1[1][:n - 2]))
    out["draws"], out["over_3e-4"], out["by_branch"] = n_draws, [], []
    for _ in range(n_draws):
        pvec = flow + 0.1 * torch.randn(flow.shape, device=dev)
        k1 = gb._launch(x, (pvec,), prep, meta, "perm", "density")
        plain, seen32 = recorded(lambda: gb.block_plain(
            "density", x, (pvec,), prep, meta, "perm"))
        if _errs(k1, plain) >= LIMIT:
            out["over_3e-4"].append(_report(gb, x, pvec, prep, meta, k1,
                                            plain))
        f64, seen64 = recorded(lambda: gb.block_plain(
            "density", x.cpu().double(), (pvec.cpu().double(),), prep, meta,
            "perm"))
        branch = by_branch(k1, plain, f64, seen32, seen64)
        if branch["rows_over_limit"]:
            run_plain = lambda: gb.block_plain("density", x, (pvec,), prep,
                                               meta, "perm")
            branch.update(flip_check(k1, plain, {
                seam: [flipped(run_plain,
                               sign * FLIP_BANDS * branch[f"{seam}_band"],
                               seam) for sign in (1, -1)]
                for seam in ("icdf", "fallback")}))
        out["by_branch"].append(branch)
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=8)
    ap.add_argument("--draws", type=int, default=20)
    ap.add_argument("--child", type=int, default=None)
    args = ap.parse_args(argv)
    if args.child is not None:
        return child(args.child, args.draws)
    import torch
    if not torch.cuda.is_available():
        print("perm_edge_probe: no CUDA device available", file=sys.stderr)
        return 2
    from ..ops import cuda_build, gf_block as gb
    cuda_build.load("gf_block", gb._declare)   # built once, for every child
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    results = []
    for i in range(args.procs):
        res = subprocess.run([sys.executable, "-m", __spec__.name, "--child",
                              str(i), "--draws", str(args.draws)],
                             capture_output=True, text=True,
                             env=dict(os.environ), timeout=900)
        if res.returncode != 0:
            print(res.stderr, file=sys.stderr)
            return res.returncode
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    over = [o for r in results for o in r["over_3e-4"]]
    summary = {"card": card, "procs": args.procs,
               "further_global_draws": args.procs * args.draws,
               "further_over_3e-4": len(over),
               "their_worst_f64_minus_seam": [o["worst"]["f64_minus_seam"]
                                              for o in over]}
    branch = [b for r in results for b in r["by_branch"]]

    def span(key):
        return [min(b[key] for b in branch), max(b[key] for b in branch)]

    summary["by_branch"] = {
        "draws": len(branch),
        "draws_with_rows_over_limit": sum(b["rows_over_limit"] > 0
                                          for b in branch),
        "rows_over_limit": sum(b["rows_over_limit"] for b in branch),
        "every_over_limit_row_excluded": all(b["over_limit_all_excluded"]
                                             for b in branch),
        "kernel_vs_plain_held_max": max(b["kernel_vs_plain_held_max"]
                                        for b in branch),
        "over_limit_vs_plain_max": max(
            (v for b in branch for v in b.get("over_limit_vs_plain", [])),
            default=0.0),
        "over_limit_vs_flipped_plain_max": max(
            (v for b in branch
             for v in b.get("over_limit_vs_flipped_plain", [])), default=0.0),
        "over_limit_rows_within_limit_of_flipped_plain": sum(
            v < LIMIT for b in branch
            for v in b.get("over_limit_vs_flipped_plain", [])),
        **{f"over_limit_rows_within_limit_of_{seam}_flipped_plain": sum(
            v < LIMIT for b in branch
            for v in b.get(f"over_limit_vs_{seam}_flipped_plain", []))
           for seam in ("icdf", "fallback")},
        **{k: span(k) for k in ("rows_excluded", "icdf_band",
                                "fallback_band", "kernel_vs_f64_away_max",
                                "plain_vs_f64_away_max")}}
    for draw in ("global", "seeded"):
        summary[draw] = {
            "distinct_params": len({r[draw]["params_sha256"]
                                    for r in results}),
            "kernel_vs_plain_max": max(r[draw]["kernel_vs_plain"]
                                       for r in results),
            "processes_over_3e-4": sum(r[draw]["kernel_vs_plain"] >= LIMIT
                                       for r in results),
            "all_repeat_equal": all(r[draw]["repeat_equal"]
                                    and r[draw]["wave_minus_1_equal"]
                                    for r in results)}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
