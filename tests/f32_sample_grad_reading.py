"""How far the float32 gradient of a sample objective lies from the float64
one, in the JAX package and in the port, on the CPU: chip_smoke.py's trained
circle model, ``pdf("s1+s2+e2", "m+f+gg", conditional_input_dim=2)`` with
its default 128-wide MLPs, and its objective mean(x**2) - 0.1 mean(log det)
through ``all_layer_forward`` on seeded base draws.

Prints, per seed and parameter, the relative norm |g32 - g64| / |g64| of
each package, and the port's float32 gradient against the JAX package's.
The parameters are init_params(seed=0) with the MLPs moved by 0.02 N(0, 1),
the same numbers in both packages.  A reading, not a test:

    JAX_PLATFORMS=cpu python tests/f32_sample_grad_reading.py [--rows 4096]
        [--seeds 180 181 182]
"""
import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)

from jammy_flows_tpu import pdf as jpdf  # noqa: E402
from jammy_flows_tpu_torch import pdf as tpdf  # noqa: E402
from jammy_flows_tpu_torch.utils.convert import params_from_jax  # noqa: E402

MODEL = ("s1+s2+e2", "m+f+gg", 2)


def _objective(x, ld):
    return (x**2).mean() - 0.1 * ld.mean()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--seeds", type=int, nargs="+", default=[180, 181, 182])
    args = ap.parse_args()
    defs, flows, cond = MODEL
    jp = jpdf(defs, flows, conditional_input_dim=cond)
    tp = tpdf(defs, flows, conditional_input_dim=cond, device="cpu")
    base = {k: np.asarray(v) for k, v in jp.init_params(
        seed=0, dtype=jnp.float64).items()}
    n = args.rows

    def jax_grad(par, z, ci, dtype):
        def obj(p):
            x, ld = jp.all_layer_forward(p, z, jnp.zeros(n, dtype), ci)
            return _objective(x, ld)
        return jax.jit(jax.grad(obj))(
            {k: jnp.asarray(v, dtype) for k, v in par.items()})

    def port_grad(par, z, ci, dtype):
        tpar = params_from_jax(par, dtype=dtype)
        zt = torch.as_tensor(z, dtype=dtype)
        ct = torch.as_tensor(ci, dtype=dtype)
        return tp._value_and_grad(lambda p: _objective(*tp.all_layer_forward(
            p, zt, torch.zeros(n, dtype=dtype), ct)), tpar)[1]

    for seed in args.seeds:
        rng = np.random.default_rng(seed)
        par = {k: v + (0.02 * rng.normal(size=v.shape) if k.startswith(
            "mlp_") else 0.0) for k, v in base.items()}
        z = rng.normal(size=(n, tp.total_base_dim))
        ci = rng.normal(size=(n, cond))
        jg = {dt.__name__: jax_grad(par, z.astype(dt), ci.astype(dt), dt)
              for dt in (np.float32, np.float64)}
        tg = {"float32": port_grad(par, z, ci, torch.float32),
              "float64": port_grad(par, z, ci, torch.float64)}
        for key in sorted(par):
            print(f"seed {seed} {key}: f32 vs f64 relative norm JAX "
                  f"{_rel(jg['float32'][key], jg['float64'][key]):.3e}, port "
                  f"{_rel(tg['float32'][key].numpy(), tg['float64'][key].numpy()):.3e}; "
                  f"port f32 vs JAX f32 "
                  f"{_rel(tg['float32'][key].numpy(), jg['float32'][key]):.3e}",
                  flush=True)


if __name__ == "__main__":
    main()
