"""How far the float32 path of the manifold CNF `c` lies from its float64
path, in the JAX package and in the port, on the CPU: ``pdf("s2", "c")`` at
the registry's defaults (hidden 32, 4 charts, dopri5 at rtol = atol =
1e-7), as chip_smoke.py runs it.

The parameters are init_params(seed=0) (the model chip_smoke serves); the
rows are drawn in float64 from the model with its parameters moved by
0.1 N(0, 1) (chip_smoke trains on rows from such a model), the same numbers
in both packages.  Prints, per package: the ODE steps per chart of the
float32 log_prob and of its NLL gradient (accepted + rejected; the JAX
package's counted through a callback), the float32 log_prob's and NLL
gradient's distance from float64 (max|diff|, relative norm), the
sample -> log_prob roundtrip's q999 on seeded base draws in float32, and
the two packages' float32 results against each other.  Then, for rk4 and
dopri5, the gradient of the sample objective mean(x**2) - 0.1 mean(log
det) through all_layer_forward on 124 seeded base draws and the 4 draws
of 100,000 whose float64 samples lie nearest the azimuth pi, where the
conversion to (theta, phi) clips x / |(x, y)| at -1 in float32: each
package's float32 distance from float64, with and without those 4.  A
reading, not a test:

    JAX_PLATFORMS=cpu python tests/f32_cnf_reading.py [--rows 1024]
        [--seeds 0 1]
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
from jammy_flows_tpu.ops import odeint as jode  # noqa: E402
from jammy_flows_tpu_torch import pdf as tpdf  # noqa: E402
from jammy_flows_tpu_torch.ops import odeint as tode  # noqa: E402
from jammy_flows_tpu_torch.utils.convert import params_from_jax  # noqa: E402

JAX_STEPS = []


def _counting(flat):
    """The JAX package's step loop, its steps sent to JAX_STEPS."""
    def wrapped(*args):
        y, steps = flat(*args)
        jax.debug.callback(lambda s: JAX_STEPS.append(int(s)), steps)
        return y, steps
    return wrapped


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = ap.parse_args()
    n = args.rows
    jode._odeint_flat = _counting(jode._odeint_flat)
    jp = jpdf("s2", "c")
    tp = tpdf("s2", "c", device="cpu")
    base = {k: np.asarray(v) for k, v in jp.init_params(
        seed=0, dtype=jnp.float64).items()}
    for seed in args.seeds:
        rng = np.random.default_rng(seed)
        moved = {k: v + 0.1 * rng.normal(size=v.shape)
                 for k, v in base.items()}
        x64 = np.asarray(jax.jit(lambda p, z: jp.all_layer_forward(
            p, z, jnp.zeros(n))[0])(moved, rng.normal(size=(n, 2))))
        z_rt = rng.normal(size=(n, 2))
        out = {}
        for dt, jdt, tdt in (("f64", jnp.float64, torch.float64),
                             ("f32", jnp.float32, torch.float32)):
            par = {k: v.astype(jdt) for k, v in base.items()}
            x = x64.astype(jdt)

            def nll(p, x=x):
                lp = jp.log_prob(p, x)[0]
                return -lp.mean(), lp

            JAX_STEPS.clear()
            (_, lp_j), g_j = jax.jit(jax.value_and_grad(nll, has_aux=True))(
                par)
            jax.block_until_ready(g_j)
            steps_j = list(JAX_STEPS)
            tpar = params_from_jax(par, dtype=tdt)
            tode.ODE_SOLVES.clear()
            _, g_t = tp.nll_value_and_grad(tpar, torch.as_tensor(x))
            steps_t = [a + r for _, a, r, _ in tode.ODE_SOLVES]
            lp_t = tp.log_prob(tpar, torch.as_tensor(x))[0].numpy()
            z = z_rt.astype(jdt)
            xs, ld = jax.jit(lambda p, z: jp.all_layer_forward(
                p, z, jnp.zeros(n, jdt)))(par, z)
            rt_j = np.abs(np.asarray(jp.log_prob(par, xs)[0]) - (
                -0.5 * (z**2).sum(1) - np.log(2 * np.pi) - np.asarray(ld)))
            xt, ldt = tp.all_layer_forward(tpar, torch.as_tensor(z),
                                           torch.zeros(n, dtype=tdt))
            rt_t = (tp.log_prob(tpar, xt)[0] - (
                -0.5 * (torch.as_tensor(z)**2).sum(1) - np.log(2 * np.pi)
                - ldt)).abs().numpy()
            out[dt] = dict(lp_j=np.asarray(lp_j), g_j=np.asarray(g_j["flow_0"]),
                           lp_t=lp_t, g_t=g_t["flow_0"].numpy())
            print(f"seed {seed} {dt}: attempted ODE steps per integration "
                  f"(the forward's 4 charts, then the adjoint's) JAX "
                  f"{steps_j[-8:]}, port {steps_t}; roundtrip |dlogp| q999 "
                  f"JAX {np.quantile(rt_j, 0.999):.3e}, port "
                  f"{np.quantile(rt_t, 0.999):.3e}", flush=True)
        r64, r32 = out["f64"], out["f32"]
        for who in ("j", "t"):
            name = "JAX" if who == "j" else "port"
            print(f"seed {seed} {name}: f32 vs f64 log_prob max|diff| "
                  f"{np.abs(r32['lp_' + who] - r64['lp_' + who]).max():.3e}, "
                  f"NLL gradient relative norm "
                  f"{_rel(r32['g_' + who], r64['g_' + who]):.3e}", flush=True)
        print(f"seed {seed}: port vs JAX, f32 log_prob max|diff| "
              f"{np.abs(r32['lp_t'] - r32['lp_j']).max():.3e}, gradient "
              f"{_rel(r32['g_t'], r32['g_j']):.3e}; f64 log_prob "
              f"{np.abs(r64['lp_t'] - r64['lp_j']).max():.3e}, gradient "
              f"{_rel(r64['g_t'], r64['g_j']):.3e}", flush=True)
        sample_gradients(seed)


def _objective(x, ld):
    return (x**2).mean() - 0.1 * ld.mean()


def sample_gradients(seed):
    """The sample objective's float32 gradient distance from float64, per
    package and solver, with and without rows near the azimuth pi."""
    rng = np.random.default_rng(seed)
    for solver in ("rk4", "dopri5"):
        opts = {"c": {"solver": solver}}
        jp = jpdf("s2", "c", options_overwrite=opts)
        tp = tpdf("s2", "c", options_overwrite=opts, device="cpu")
        par = {k: np.asarray(v) for k, v in jp.init_params(
            seed=0, dtype=jnp.float64).items()}
        pool = rng.normal(size=(100_000, 2))
        with torch.no_grad():
            phi = tp.all_layer_forward(params_from_jax(par), torch.as_tensor(
                pool), torch.zeros(len(pool), dtype=torch.float64))[0][:, 1]
        near = np.argsort(np.abs(phi.numpy() - np.pi))[:4]
        z = np.concatenate([pool[near], rng.normal(size=(124, 2))])
        res = {}
        for dt, jdt, tdt in (("f64", jnp.float64, torch.float64),
                             ("f32", jnp.float32, torch.float32)):
            p = {k: v.astype(jdt) for k, v in par.items()}
            for rows, zz in (("all", z), ("without", z[4:])):
                zj = zz.astype(jdt)
                g_j = jax.jit(jax.grad(lambda q, zj=zj: _objective(
                    *jp.all_layer_forward(q, zj, jnp.zeros(len(zj), jdt)))))(p)
                _, g_t = tp._value_and_grad(lambda q, zt=torch.as_tensor(zj): (
                    _objective(*tp.all_layer_forward(
                        q, zt, torch.zeros(len(zt), dtype=tdt)))),
                    params_from_jax(p, dtype=tdt))
                res[dt, rows] = (np.asarray(g_j["flow_0"]),
                                 g_t["flow_0"].numpy())
        for rows in ("all", "without"):
            (j64, t64), (j32, t32) = res["f64", rows], res["f32", rows]
            print(f"seed {seed} {solver} sample gradient, 128 rows "
                  f"({'with' if rows == 'all' else 'without'} the 4 nearest "
                  f"the azimuth pi, at {np.abs(phi.numpy()[near] - np.pi)}): "
                  f"f32 vs f64 relative norm JAX {_rel(j32, j64):.3e}, port "
                  f"{_rel(t32, t64):.3e}; port vs JAX f32 "
                  f"{_rel(t32, j32):.3e}", flush=True)


if __name__ == "__main__":
    main()
