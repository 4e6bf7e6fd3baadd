"""Where a block kernel's time goes: the block kernels timed as built, and
again with parts of them switched off, on the card.

    python -m jammy_flows_tpu_torch.tools.tile_breakdown [--part lazy2|perm]
        [--csrc DIR]

Builds ``csrc/gf_block.cu`` and ``csrc/gf_block_bwd.cu`` from a copy of the
sources (``--csrc``, by default the package's own: a parent tree's sources
can be measured with this tool) under ``build/tile_breakdown/``, each
variant by its own nvcc process, all at once.

lazy2 (the flagship's block 2: H = 128, a 7-wide summary): as built; with
every 3xTF32 tile product off (``rows_product`` reduced to the bias, so that
every row's parameters become b and the body still runs on finite
parameters, ``dh_product`` and ``gw_product`` returning at once); the
backward with ``dh_product`` alone off; and with ``gw_product`` alone off.
The differences are what each product, its loads and its barriers cost
inside the kernel; the all-off time is the body (hidden layer, per-row
mixture preparation, mixtures, adjoints, the stages' barriers).  The T1
perm kernels are timed beside them.

perm (the flagship's block 0, the T2 / T3 perm backward): as built, and
with the adding of each row's parameter cotangents into the block's
partials switched off (``perm_flush``: ``stage_flush`` returning at once in
perm mode, or ``warp_flush`` where the sources have it), so that the
difference is the flush and the rest the body (forward recomputation,
adjoints; the compiler may drop work whose only use was the flush, so the
body is a lower bound).  Each at two grids: two blocks per SM (the grid of
the kernels before the perm redesign) and (blocks per SM from the
occupancy API) x SMs.  With ``-Xptxas -v``: the perm kernels' registers,
stack and spills.

Forward at 1,048,576 rows, backward at 262,144; CUDA events, median of
10.  Prints one JSON line with the card's name and power limit.  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys

from ..ops import cuda_build

OUT = cuda_build.BUILD_DIR.parent / "tile_breakdown"
# the products' bodies, run after the opening brace when switched off
# (under GF_OFF_<name>)
_OFF = {
    "rows_product": "  if (n <= 0) return;\n  __syncthreads();\n"
                    "  for (int c = 0; c < (n + 7) / 8 * 8; ++c)\n"
                    "    slab[(size_t)c * tl.ts + threadIdx.x] =\n"
                    "        c < n ? __ldg(b + rows(c)) : 0.0f;\n"
                    "  __syncthreads();\n  return;\n",
    "dh_product": "  return;\n",
    "gw_product": "  return;\n",
}
# the perm flush: the function that adds a row's parameter cotangents to
# the block's partials in perm mode (the opening of its definition, as the
# sources before or after the perm redesign have it: one must be there) and
# its switched-off body
_PERM_FLUSH = {
    r"template <int MODE, class Rows>\s*__device__ void stage_flush":
        "  if (MODE == PERM) return;\n",
    r"__device__ __forceinline__ void warp_flush": "  return;\n"}


# part -> variant -> (the switches on, the libraries built)
VARIANTS = {
    "lazy2": {"as_built": ((), ("gf_block", "gf_block_bwd")),
              "products_off": (tuple(_OFF), ("gf_block", "gf_block_bwd")),
              "dh_off": (("dh_product",), ("gf_block_bwd",)),
              "gw_off": (("gw_product",), ("gf_block_bwd",))},
    "perm": {"as_built": ((), ("gf_block_bwd",)),
             "flush_off": (("perm_flush",), ("gf_block_bwd",))},
}


def _switches(src_dir):
    """Insert each switch's body into a copy of the sources; raises unless
    every product was found once and the perm flush at least once."""
    found = []
    for path in src_dir.iterdir():
        text = path.read_text()
        cases = [(name, r"__device__ void " + name, body)
                 for name, body in _OFF.items()] + \
            [("perm_flush", head, body) for head, body in _PERM_FLUSH.items()]
        for switch, head, body in cases:
            pat = re.compile("(" + head + r"\([^)]*\)\s*\{\n)")
            text, n = pat.subn(lambda m: m.group(1) + f"#ifdef GF_OFF_{switch}"
                               f"\n{body}#endif\n", text)
            found += [switch] * n
        path.write_text(text)
    if sorted(f for f in found if f in _OFF) != sorted(_OFF) or \
            "perm_flush" not in found:
        raise RuntimeError(f"switches found {found}, expected each of "
                           f"{sorted(_OFF)} once and perm_flush")


def build(part, csrc):
    """{(variant, library): path} of the builds, and the -Xptxas -v report
    of each as-built library."""
    shutil.rmtree(OUT, ignore_errors=True)
    src = OUT / "csrc"
    shutil.copytree(csrc, src)
    _switches(src)
    procs = {}
    for variant, (off, libs) in VARIANTS[part].items():
        extra = [f"-DGF_OFF_{name}" for name in off]
        flags = [f for f in cuda_build.NVCC_FLAGS
                 if variant == "as_built" or f not in ("-Xptxas", "-v")]
        for lib in libs:
            out = OUT / f"lib{lib}_{variant}.so"
            procs[(variant, lib)] = (out, subprocess.Popen(
                [cuda_build.nvcc_path(), *flags, *extra, "-I", str(src),
                 "-o", str(out), str(src / f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    paths, report = {}, ""
    for key, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{err}")
        paths[key] = out
        if key[0] == "as_built":
            report += err
    return paths, report


def perm_ptxas(report):
    """{kernel: "registers, stack, spills"} of the perm backward kernels
    (gf_block_bwd_kernel<KIND, MODE = 0, ...>) in an -Xptxas -v report."""
    out = {}
    for name, body in re.findall(r"Function properties for (\S+)\n(.*?)"
                                 r"(?=ptxas info\s+: Compil|\Z)", report, re.S):
        m = re.search(r"gf_block_bwd_kernelILi(\d)ELi0ELb\dELi(\d+)E", name)
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", body)
        if m and regs and spill:
            kind = ("density_bwd_perm", "sample_bwd_perm",
                    "nll_perm")[int(m.group(1))]
            shape = "K=10, d=4" if m.group(2) == "10" else "generic"
            out[f"{kind} ({shape})"] = (
                f"{regs.group(1)} registers, stack {spill.group(1)} B, spill "
                f"stores {spill.group(2)} B, loads {spill.group(3)} B")
    return out


def _ms(fn, reps=10):
    import torch
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


def _perm_case(gb, p, dev, g, n_sm):
    """The perm backward kernels (T2 both bodies, T3) on block 0 at
    262,144 rows: run(handle) times each at the grid of two blocks per SM
    and at the occupancy API's blocks per SM x SMs; returns ({name: ms},
    {name: blocks per SM})."""
    import torch
    prep, meta = p._block_meta[0]
    pvec = p.init_params(seed=0)["flow_0"]
    pvec = pvec + 0.1 * torch.randn(pvec.shape, generator=g, device=dev)
    x = 0.8 * torch.randn((1 << 18, 4), generator=g, device=dev)
    y = gb.block_plain("sample", x, (pvec,), prep, meta, "perm")[0]
    g_out = torch.randn(x.shape, generator=g, device=dev)
    g_ld = torch.randn(x.shape, generator=g, device=dev)
    n_tiles = (x.shape[0] + 127) // 128

    def run(handle):
        times, occ = {}, {}
        choose = handle.gf_block_bwd_blocks
        for kind in ("density", "sample", "nll"):
            name = "nll_perm" if kind == "nll" else f"{kind}_bwd_perm"
            occ[name] = gb.kernel_occupancy(name, prep, meta)[0]
            arg = y if kind == "sample" else x
            for grid, per_sm in (("2 per SM", 2), ("occupancy", occ[name])):
                handle.gf_block_bwd_blocks = (
                    lambda *a, b=min(n_tiles, per_sm * n_sm): b)
                times[f"{name} grid {grid}"] = _ms(lambda: gb._launch_bwd(
                    kind, arg, (pvec,), None if kind == "nll" else g_out,
                    None if kind == "nll" else g_ld, prep, meta, "perm",
                    1.0 / x.shape[0], -1.0 / x.shape[0]))
        handle.gf_block_bwd_blocks = choose
        return times, occ

    return run


def _lazy2_case(gb, p, dev, g):
    """The flagship's lazy2 block 2 (and T1 perm beside it): run(lib,
    variant) times the kernels of library ``lib``; returns {name: ms}."""
    import torch
    prep, meta = p._block_meta[2]
    prep0, meta0 = p._block_meta[0]
    mlp = p.mlp_predictors[2]
    flat = p.init_params(seed=0)["mlp_2"]
    flat = flat + 0.02 * torch.randn(flat.shape, generator=g, device=dev)
    w1, b1 = mlp.first_layer_weights(flat)
    w, b = mlp.final_layer_weights(flat)
    pvec = p.init_params(seed=0)["flow_0"]

    def inputs(n):
        return (0.8 * torch.randn((n, 4), generator=g, device=dev),
                (torch.randn((n, mlp.input_dim), generator=g, device=dev),
                 w1.contiguous(), b1.contiguous(), w.contiguous(),
                 b.contiguous()))

    x1, par1 = inputs(1 << 20)
    x2, par2 = inputs(1 << 18)
    g_out = torch.randn(x2.shape, generator=g, device=dev)
    g_ld = torch.randn(x2.shape, generator=g, device=dev)

    def run(lib, variant):
        times = {}
        if lib == "gf_block":
            for d in ("density", "sample"):
                times[f"{d}_lazy2 {variant}"] = _ms(
                    lambda: gb._launch(x1, par1, prep, meta, "lazy2", d))
                if variant == "as_built":
                    times[f"{d}_perm"] = _ms(lambda: gb._launch(
                        x1, (pvec,), prep0, meta0, "perm", d))
        else:
            for kind in ("density", "sample", "nll"):
                name = "nll_lazy2" if kind == "nll" else f"{kind}_bwd_lazy2"
                times[f"{name} {variant}"] = _ms(lambda: gb._launch_bwd(
                    kind, x2, par2, None if kind == "nll" else g_out,
                    None if kind == "nll" else g_ld, prep, meta, "lazy2",
                    1.0 / x2.shape[0], -1.0 / x2.shape[0]))
        return times

    return run


def main(argv=None):
    import torch
    from .. import pdf
    from ..ops import gf_block as gb
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=sorted(VARIANTS), default="lazy2")
    ap.add_argument("--csrc", type=pathlib.Path, default=cuda_build.CSRC)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tile_breakdown: no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    paths, report = build(args.part, args.csrc)
    dev = torch.device("cuda", torch.cuda.current_device())
    p = pdf("e4+s2+e4", "gggg+f+gggg", device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    times, extra = {}, {}
    if args.part == "perm":
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        run = _perm_case(gb, p, dev, g, n_sm)
        extra = {"rows_backward": 1 << 18, "blocks_per_sm": {},
                 "ptxas": perm_ptxas(report)}
    else:
        run = _lazy2_case(gb, p, dev, g)
        extra = {"rows_forward": 1 << 20, "rows_backward": 1 << 18}
    for (variant, lib), path in paths.items():
        handle = ctypes.CDLL(str(path))
        (gb._declare if lib == "gf_block" else gb._declare_bwd)(handle)
        cuda_build._LOADED[lib] = handle
        if args.part == "perm":
            t, extra["blocks_per_sm"][variant] = run(handle)
            times.update({f"{k} {variant}": v for k, v in t.items()})
        else:
            times.update(run(lib, variant))
    cuda_build._LOADED.clear()
    print(json.dumps({"card": card, "part": args.part,
                      "csrc": str(args.csrc), "ms": times, **extra}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
