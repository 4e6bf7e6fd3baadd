"""Where a lazy2 kernel's time goes: the block kernels timed as built, and
again with their 3xTF32 tile products switched off, on the card.

    python -m jammy_flows_tpu_torch.tools.tile_breakdown

Builds ``csrc/gf_block.cu`` and ``csrc/gf_block_bwd.cu`` from a copy of the
sources under ``build/tile_breakdown/`` in four variants (all nvcc
processes at once): as they are; with every product off (``rows_product``
reduced to the bias, so that every row's parameters become b and the body
still runs on finite parameters, ``dh_product`` and ``gw_product``
returning at once); the backward with ``dh_product`` alone off; and with
``gw_product`` alone off.  The differences are what each product, its
loads and its barriers cost inside the kernel; the all-off time is the
body (hidden layer, per-row mixture preparation, mixtures, adjoints, the
stages' barriers).  The perm kernels (the same mixture math with one
broadcast parameter vector) are timed beside them.
The flagship's lazy2 block 2 (H = 128, a 7-wide summary) at 1,048,576 rows
forward and 262,144 backward; CUDA events, median of 10.  Prints one JSON
line with the card's name and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
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


# variant -> (the products switched off, the libraries built)
VARIANTS = {"as_built": ((), ("gf_block", "gf_block_bwd")),
            "products_off": (tuple(_OFF), ("gf_block", "gf_block_bwd")),
            "dh_off": (("dh_product",), ("gf_block_bwd",)),
            "gw_off": (("gw_product",), ("gf_block_bwd",))}


def _switches(src_dir):
    """Insert each product's switched-off body into a copy of the
    sources; raises unless every product was found once."""
    found = []
    for path in src_dir.iterdir():
        text = path.read_text()
        for name, body in _OFF.items():
            pat = re.compile(r"(__device__ void " + name + r"\([^)]*\)\s*\{\n)")
            text, n = pat.subn(lambda m: m.group(1) + f"#ifdef GF_OFF_{name}\n"
                               + body + "#endif\n", text)
            found += [name] * n
        path.write_text(text)
    if sorted(found) != sorted(_OFF):
        raise RuntimeError(f"products found {found}, expected each of "
                           f"{sorted(_OFF)} once")


def build():
    """{(variant, library): path} of the builds."""
    shutil.rmtree(OUT, ignore_errors=True)
    src = OUT / "csrc"
    shutil.copytree(cuda_build.CSRC, src)
    _switches(src)
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for variant, (off, libs) in VARIANTS.items():
        extra = [f"-DGF_OFF_{name}" for name in off]
        for lib in libs:
            out = OUT / f"lib{lib}_{variant}.so"
            procs[(variant, lib)] = (out, subprocess.Popen(
                [cuda_build.nvcc_path(), *flags, *extra, "-I", str(src),
                 "-o", str(out), str(src / f"{lib}.cu")],
                stderr=subprocess.PIPE, text=True))
    paths = {}
    for key, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{err}")
        paths[key] = out
    return paths


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


def main():
    import torch
    from .. import pdf
    from ..ops import gf_block as gb
    if not torch.cuda.is_available():
        print("tile_breakdown: no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    paths = build()
    dev = torch.device("cuda", torch.cuda.current_device())
    p = pdf("e4+s2+e4", "gggg+f+gggg", device=dev)
    prep, meta = p._block_meta[2]
    prep0, meta0 = p._block_meta[0]
    mlp = p.mlp_predictors[2]
    g = torch.Generator(device=dev).manual_seed(0)
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
    times = {}
    for (variant, lib), path in paths.items():
        handle = ctypes.CDLL(str(path))
        (gb._declare if lib == "gf_block" else gb._declare_bwd)(handle)
        cuda_build._LOADED[lib] = handle
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
    cuda_build._LOADED.clear()
    print(json.dumps({"card": card, "rows_forward": x1.shape[0],
                      "rows_backward": x2.shape[0], "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
