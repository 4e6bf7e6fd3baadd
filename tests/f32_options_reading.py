"""How far the float32 path of chip_smoke.py's options model lies from its
float64 path, in the JAX package and in the port, on the CPU: the
conditional flagship ``pdf("e4+s2+e4", "gggg+f+gggg",
conditional_input_dim=[3, 2, 2], predict_log_normalization=True)``,
initialized from data as chip_smoke initializes it (``init_params(seed=0,
data=...)`` on the first sub-pdf's columns of rows drawn from the model
with its MLPs moved by 0.02 N(0, 1) and its permanent parameters by
0.1 N(0, 1)), then its MLPs moved by 0.02 N(0, 1); the same numbers in
both packages (the JAX package's data init, loaded into the port).

Prints, per package and dtype, on seeded base draws and conditional
inputs: the sample -> log_prob roundtrip |dlogp| (q999, max, the share of
rows above 1e-3), and the sample objective's gradient (mean(x**2) - 0.1
mean(log det) through all_layer_forward) in float32 against float64, as
relative norms per parameter.  The JAX package's float32 runs twice: on
its XLA route (the one it takes without Pallas: 18 bisection and 8 Newton
steps a layer) and on its whole-block Pallas kernels in interpret mode
(the route it takes on the TPU: 4 Newton steps, as the port's kernels and
plain versions).  A reading, not a test:

    JAX_PLATFORMS=cpu python tests/f32_options_reading.py [--rows 16384]
"""
import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jammy_flows_tpu.ops.pallas_gf as pg  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)

from jammy_flows_tpu import pdf as jpdf  # noqa: E402
from jammy_flows_tpu_torch import pdf as tpdf  # noqa: E402
from jammy_flows_tpu_torch.utils.convert import params_from_jax  # noqa: E402

MODEL = ("e4+s2+e4", "gggg+f+gggg")
KW = dict(conditional_input_dim=[3, 2, 2], predict_log_normalization=True)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _objective(x, ld):
    return (x**2).mean() - 0.1 * ld.mean()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=16384)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    n = args.rows
    jp, tp = jpdf(*MODEL, **KW), tpdf(*MODEL, device="cpu", **KW)
    rng = np.random.default_rng(args.seed)
    base = {k: np.asarray(v) for k, v in jp.init_params(
        seed=0, dtype=jnp.float64).items()}
    moved = {k: v + (0.02 if k.startswith("mlp_") else 0.1)
             * rng.normal(size=v.shape) for k, v in base.items()}
    ci = [rng.normal(size=(n, w)) for w in (3, 2, 2)]
    rows = np.asarray(jax.jit(lambda p, z, c: jp.all_layer_forward(
        p, z, jnp.zeros(n), c)[0])(moved, rng.normal(size=(n, 10)), ci))
    init = {k: np.asarray(v) for k, v in jp.init_params(
        seed=0, dtype=jnp.float64, data=rows[:, :4]).items()}
    par = {k: v + (0.02 * rng.normal(size=v.shape) if k.startswith("mlp_")
                   else 0.0) for k, v in init.items()}
    z = rng.normal(size=(n, 10))
    res = {}
    for dt, jdt, tdt, kernels in (("f64", jnp.float64, torch.float64, False),
                                  ("f32", jnp.float32, torch.float32, False),
                                  ("f32 kernels", jnp.float32, torch.float32,
                                   True)):
        pg._INTERPRET = kernels
        jax.clear_caches()
        pj = {k: v.astype(jdt) for k, v in par.items()}
        zj, cj = z.astype(jdt), [c.astype(jdt) for c in ci]

        def roundtrip(p, zz, c):
            x, ld = jp.all_layer_forward(p, zz, jnp.zeros(n, jdt), c)
            lp = jp.log_prob(p, x, conditional_input=c)[0]
            return jnp.abs(lp - (-0.5 * (zz**2).sum(1)
                                 - 5.0 * np.log(2 * np.pi) - ld))

        d_j = np.asarray(jax.jit(roundtrip)(pj, zj, cj))
        g_j = jax.jit(jax.grad(lambda p: _objective(*jp.all_layer_forward(
            p, zj, jnp.zeros(n, jdt), cj))))(pj)
        pt = params_from_jax(pj, dtype=tdt)
        zt, ct = torch.as_tensor(zj), [torch.as_tensor(c) for c in cj]
        with torch.no_grad():
            x, ld = tp.all_layer_forward(pt, zt, torch.zeros(n, dtype=tdt), ct)
            lp = tp.log_prob(pt, x, conditional_input=ct)[0]
            d_t = (lp - (-0.5 * (zt**2).sum(1) - 5.0 * np.log(2 * np.pi)
                         - ld)).abs().numpy()
        _, g_t = tp._value_and_grad(lambda p: _objective(
            *tp.all_layer_forward(p, zt, torch.zeros(n, dtype=tdt), ct)), pt)
        res[dt] = ({k: np.asarray(v) for k, v in g_j.items()},
                   {k: v.numpy() for k, v in g_t.items()})
        for name, d in (("JAX", d_j), ("port", d_t)):
            if kernels and name == "port":
                continue
            print(f"{dt} {name}: roundtrip |dlogp| q999 "
                  f"{np.quantile(d, 0.999):.3e}, max {d.max():.3e}, "
                  f"{(d > 1e-3).mean():.3e} of {n} rows above 1e-3",
                  flush=True)
    for dt, i, name in (("f32", 0, "JAX (XLA route)"),
                        ("f32 kernels", 0, "JAX (kernels)"),
                        ("f32", 1, "port")):
        rels = {k: _rel(res[dt][i][k], res["f64"][i][k])
                for k in res["f64"][i] if np.any(res["f64"][i][k])}
        print(f"{name}: f32 vs f64 sample-objective gradient, relative "
              f"norms {', '.join(f'{k} {v:.3e}' for k, v in rels.items())}",
              flush=True)


if __name__ == "__main__":
    main()
