"""The port's S2 ops against the JAX package: values and gradients.

* ``ops/rotations.py`` ``xyz_matrix``, ``quaternion_matrix`` and
  ``givens_matrix`` in three dimensions, applied to rows (``apply_rotation``)
  and to columns (``apply_matrix_cols``), both ways, shared and per-row;
* ``ops/manifold.py``: the S2 projection from the plane and back, the
  embedding of (theta, phi) rows and columns and back, each with its
  log-det, and the tangent basis of the exponential map;
* ``layers/sphere_s2.py`` ``ExponentialMapS2``: its map and log-det
  0.5 log det(P^T P) for each potential (the port's directional
  derivatives made alongside the map, the JAX package's ``jacfwd``), and
  the log-det's gradient in the point and the parameters against
  ``jax.vjp``;
* ``ops/inverse.py`` ``make_sphere_inverse_fn``: the solve against the JAX
  package's row solve (``make_sphere_inverse_fn``) on the same targets,
  a NaN target included, and its implicit gradient in the target and the
  parameters against ``jax.grad``, in float64 and float32.

Values are held at 1e-10 (the solve at 1e-6, float32 at 3e-3), gradients
at 1e-8 (through the solve 1e-6).  Inputs are made with numpy from a seed
and handed to both packages."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jammy_flows_tpu.layers import sphere_s2 as js2
from jammy_flows_tpu.ops import manifold as jman, rotations as jrot
from jammy_flows_tpu_torch.layers import sphere_s2 as ts2
from jammy_flows_tpu_torch.ops import (inverse as tinv, manifold as tman,
                                       rotations as trot)
from torch_one_thread import _one_torch_thread  # noqa: F401

B = 24
TOL = 1e-10
TOL_GRAD = 1e-8
# the sphere solve stops where 1 - phi . t reaches float64 resolution, a
# distance of ~1e-8: two implementations' roots differ there (the JAX
# package's fixtures hold the solve's direction at 1e-6)
TOL_SOLVE = 1e-6
TOL_F32 = 3e-3
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})


def _close(a, b, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.broadcast_to(np.asarray(b), a.shape),
                               rtol=tol, atol=tol)


def _check(fn_t, fn_j, args, seed, tol=TOL, tol_grad=TOL_GRAD):
    """Values of fn_t and fn_j on args, and the gradients of sum(w_i *
    out_i) with respect to every argument, w from a seed."""
    rng = np.random.default_rng(seed)
    got = fn_t(*[torch.as_tensor(a) for a in args])
    ws = [rng.normal(size=o.shape) for o in got]

    def ref(*a):
        outs, vjp = jax.vjp(fn_j, *a)
        return outs, vjp(tuple(jnp.asarray(w) for w in ws))

    outs, g_j = _jit(ref)(*[jnp.asarray(a) for a in args])
    for a, r in zip(got, outs):
        _close(a, r, tol)
    leaves = [torch.as_tensor(a).requires_grad_() for a in args]
    tot = sum((torch.as_tensor(w) * o).sum()
              for w, o in zip(ws, fn_t(*leaves)))
    for g, r in zip(torch.autograd.grad(tot, leaves), g_j):
        _close(g, r, tol_grad)


def _unit_rows(rng, n):
    e = rng.normal(size=(n, 3))
    return e / np.linalg.norm(e, axis=1, keepdims=True)


@pytest.mark.parametrize("bp", [1, B], ids=["shared", "per-row"])
def test_rotation_matrices_match_jax(bp):
    rng = np.random.default_rng(bp)
    xyz, quat, ang = (rng.normal(size=(bp, n)) for n in (3, 4, 3))
    x = rng.normal(size=(B, 3))

    def run(rot, xyz, quat, ang, x):
        mats = (rot.xyz_matrix(xyz), rot.quaternion_matrix(quat),
                rot.givens_matrix(ang, 3))
        outs = [*mats]
        for m in mats:
            for inv in (False, True):
                outs.append(rot.apply_rotation(m, x, inverse=inv))
                outs.extend(rot.apply_matrix_cols(
                    m, tuple(x[:, i] for i in range(3)), inverse=inv))
        return tuple(outs)

    _check(lambda *a: run(trot, *a), lambda *a: run(jrot, *a),
           (xyz, quat, ang, x), seed=bp + 1)


def test_s2_conversions_match_jax():
    """plane <-> (theta, phi) rows, (theta, phi) <-> embedding rows and
    columns, each with its log-det, and the tangent basis."""
    rng = np.random.default_rng(3)
    plane = rng.normal(size=(B, 2))
    ang = np.stack([rng.uniform(0.05, math.pi - 0.05, B),
                    rng.uniform(0.05, 2 * math.pi - 0.05, B)], axis=1)
    e = _unit_rows(rng, B) * 1.2
    e[:3] = [[0.3, 0.1, 0.95], [0.1, -0.2, -0.97], [-0.5, 0.2, 0.1]]
    ld = rng.normal(size=B)

    def fn_t(plane, ang, e, ld):
        return (*tman.plane_to_sphere2(plane, ld),
                *tman.sphere2_to_plane(ang, ld),
                *tman.spherical_to_eucl(ang, ld),
                *tman.eucl_to_spherical(e, ld),
                *tman.spherical_to_eucl_cols(ang[:, 0], ang[:, 1], ld),
                *tman.eucl_to_spherical_cols(e[:, 0], e[:, 1], e[:, 2], ld),
                tman.spherical_to_eucl(ang),
                *[torch.stack(t, dim=1) for t in
                  tman.sphere_tangent_basis_cols(*(e / e.norm(
                      dim=1, keepdim=True)).unbind(1))])

    layer = js2.ExponentialMapS2(2)

    def fn_j(plane, ang, e, ld):
        basis = layer._tangent_basis(e / jnp.linalg.norm(e, axis=1,
                                                         keepdims=True))
        return (*jman.plane_to_sphere2(plane, ld),
                *jman.sphere2_to_plane(ang, ld),
                *jman.spherical_to_eucl(2, ang, ld),
                *jman.eucl_to_spherical(2, e, ld),
                *jman.spherical_to_eucl_cols(ang[:, 0], ang[:, 1], ld),
                *jman.eucl_to_spherical_cols(e[:, 0], e[:, 1], e[:, 2], ld),
                jman.spherical_to_eucl(2, ang, 0.0)[0],
                basis[:, :, 0], basis[:, :, 1])

    _check(fn_t, fn_j, (plane, ang, e, ld), seed=4)


# potential x mean parametrization: the four potentials, each mean form twice
EXP_MAPS = [("linear", "old"), ("quadratic", "householder"),
            ("exponential", "householder"), ("splines", "old")]


def _v_pair(exp_map_type, mean, k=4):
    kw = dict(exp_map_type=exp_map_type, mean_parametrization=mean,
              num_components=k)
    return js2.ExponentialMapS2(2, **kw), ts2.ExponentialMapS2(2, **kw)


@pytest.mark.parametrize("exp_map_type,mean", EXP_MAPS,
                         ids=[f"{e}-{m}" for e, m in EXP_MAPS])
def test_exp_map_logdet_and_its_gradient_match_jax(exp_map_type, mean):
    """phi and 0.5 log det(P^T P) at points of the sphere (per-row
    parameters), and their gradients in the point and the parameters: the
    log-det's gradient is what training a `v` model differentiates."""
    jl, tl = _v_pair(exp_map_type, mean)
    rng = np.random.default_rng(5)
    x = _unit_rows(rng, B)
    par = 0.5 * rng.normal(size=(B, tl.num_params))

    def fn_t(x, par):
        phi, ld = tl._logdet(tuple(x.unbind(1)), tl._potential(par))
        return torch.stack(phi, dim=1), ld

    def fn_j(x, par):
        return jl._logdet_at(x, jl._potential_pars(par))

    _check(fn_t, fn_j, (x, par), seed=6)


def _solve_targets(tl, rng, dtype):
    """Targets phi(x) of random points (a NaN one last) and the layer's
    shared parameters."""
    par = 0.5 * rng.normal(size=(1, tl.num_params))
    x = torch.as_tensor(_unit_rows(rng, B))
    t = torch.stack(tl._exp_map(tuple(x.unbind(1)),
                                tl._potential(torch.as_tensor(par))),
                    dim=1).numpy()
    t[-1] = np.nan
    return t.astype(dtype), par.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_sphere_solve_and_its_gradient_match_jax(dtype):
    """The solve from (0, 0, -1) with damping 0.4 on the same targets:
    the roots (a NaN target's row the same as the JAX package's), the
    gradient of sum(w * root) in the target and the parameters (the 2 x 2
    tangent-plane solve, then the parameter VJP applied to -y_bar), and the
    iteration count."""
    jl, tl = _v_pair("exponential", "old")
    rng = np.random.default_rng(7)
    t, par = _solve_targets(tl, rng, dtype)
    w = rng.normal(size=(B, 3)).astype(dtype)
    w[-1] = 0.0

    def obj(t, par):
        root = jl._solve_inverse(t, jl._potential_pars(par))
        return jnp.sum(root * w), root

    (_, root_j), (gt_j, gp_j) = _jit(jax.value_and_grad(
        obj, argnums=(0, 1), has_aux=True))(jnp.asarray(t), jnp.asarray(par))
    tt = torch.as_tensor(t).requires_grad_()
    tp = torch.as_tensor(par).requires_grad_()
    tinv.SPHERE_SOLVES.clear()
    root = torch.stack(tl._solve(*tt.unbind(1), (tp,)), dim=1)
    (iters, active), = tinv.SPHERE_SOLVES
    assert 0 < iters < tl.max_num_newton_iter and active == 0
    tol = TOL_SOLVE if dtype == np.float64 else TOL_F32
    np.testing.assert_array_equal(np.isnan(root.detach().numpy()),
                                  np.isnan(np.asarray(root_j)))
    _close(root[:-1], np.asarray(root_j)[:-1], tol)
    _close(root[-1], np.asarray(root_j)[-1], 0.0)
    gt, gp = torch.autograd.grad((root[:-1] * torch.as_tensor(w[:-1])).sum(),
                                 (tt, tp))
    scale = max(np.abs(np.asarray(gp_j)).max(), 1.0)
    _close(gt[:-1], np.asarray(gt_j)[:-1], tol * 10)
    _close(gp / scale, np.asarray(gp_j) / scale, tol * 10)
