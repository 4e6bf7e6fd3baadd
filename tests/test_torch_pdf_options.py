"""The PDF-level options against the JAX package, in float64 unless named:

* list-valued ``conditional_input_dim`` (one conditional input per
  sub-pdf) on ``"e2+s2+e2", "gg+f+gg"``: init_params, log_prob, the
  samples and ``nll_value_and_grad`` against ``jax.grad``;
* the Poisson log-mean heads: standalone (its own MLP on the first
  conditional input), joined (one more output of sub-pdf 0's MLP), the
  unconditional ``log_lambda`` and the fully amortized model's; their
  init_params, count_parameters, log_mean_poisson and log_prob;
* ``init_params(data=...)`` (householder, percentile means, the `t`
  layer's covariance fit) and the fully amortized model's: the fitted
  vectors within 1e-6 of the JAX package's (scipy's minimize reads the
  loss's last bits, so the two fits end ~4e-8 apart; the rest is equal);
* ``transform_target_space`` between default, intrinsic and embedding
  coordinates on S1 / S2 / simplex / interval sub-pdfs with their
  log-dets, and the force-coordinate options of log_prob,
  all_layer_inverse, all_layer_forward and sample;
* every layer's named parameter split, and ``obtain_flow_param_structure``:
  its keys, named splits and values;
* failsafe sampling, on the port alone (its draws come from a
  torch.Generator): every returned row passes the cross-check or holds
  the last round's draw.

Inputs are made with numpy from a seed and handed to both packages."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu.models.fully_amortized import fully_amortized_pdf as jfa
from jammy_flows_tpu_torch import fully_amortized_pdf as tfa
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch.utils.convert import params_from_jax
from test_torch_cnf import _jit
from test_torch_grad_pdf import _rel
from torch_one_thread import _one_torch_thread  # noqa: F401

B = 32
TOL = 1e-10
TOL_GRAD = 1e-8
TOL_DATA_INIT = 1e-6


def _rows(tp, seed, coords="default"):
    """Target rows of tp made in intrinsic coordinates (s2 polar angles in
    (0.2, 2.9), circle angles off 0 / 2 pi, interval rows inside, simplex
    rows inside the base simplex, Euclidean 0.8 N(0, 1)) and returned in
    ``coords``."""
    rng = np.random.default_rng(seed)
    cols = []
    for k, d in enumerate(tp.pdf_defs_list):
        lo, hi = tp.target_dim_indices_intrinsic[k]
        if d == "s2":
            cols.append(np.stack([rng.uniform(0.2, 2.9, B),
                                  rng.uniform(0.1, 6.2, B)], 1))
        elif d == "s1":
            cols.append(rng.uniform(0.05, 2 * math.pi - 0.05, (B, 1)))
        elif d[0] == "i":
            cols.append(rng.uniform(0.1, 1.9, (B, 1)))
        elif d[0] == "a":
            cols.append(rng.dirichlet(np.ones(hi - lo + 1), B)[:, 1:])
        else:
            cols.append(0.8 * rng.normal(size=(B, hi - lo)))
    x = torch.as_tensor(np.concatenate(cols, 1))
    return tp.transform_target_space(x, transform_from="intrinsic",
                                     transform_to=coords)[0].numpy()


def _both(defs, flows, **kw):
    return jpdf(defs, flows, **kw), tpdf(defs, flows, device="cpu", **kw)


def _same_init(jpar, tpar, tol=0.0):
    assert sorted(jpar) == sorted(tpar)
    for key in jpar:
        assert np.abs(tpar[key].numpy() - np.asarray(jpar[key])).max() <= tol


def test_list_conditional_inputs_match_jax():
    jp, tp = _both("e2+s2+e2", "gg+f+gg", conditional_input_dim=[3, 2, 2],
                   amortization_mlp_dims="16")
    assert tp.encoding_type == jp.encoding_type == "multi"
    jpar = jp.init_params(seed=0, dtype=jnp.float64)
    tpar = tp.init_params(seed=0, dtype=torch.float64)
    _same_init(jpar, tpar)
    rng = np.random.default_rng(1)
    par = {k: np.asarray(v) + 0.02 * rng.normal(size=v.shape)
           for k, v in jpar.items()}
    x = _rows(tp, 2)
    ci = [rng.normal(size=(B, w)) for w in (3, 2, 2)]

    @_jit
    def ref(p, x, c):
        def nll(pp):
            lp = jp.log_prob(pp, x, conditional_input=c)[0]
            return -lp.mean(), lp
        return jax.value_and_grad(nll, has_aux=True)(p)

    (_, lp_j), g_j = ref(par, x, ci)
    tpar = params_from_jax(par)
    tci = [torch.as_tensor(c) for c in ci]
    lp_t = tp.log_prob(tpar, torch.as_tensor(x), conditional_input=tci)[0]
    assert np.abs(lp_t.numpy() - np.asarray(lp_j)).max() < TOL
    _, g_t = tp.nll_value_and_grad(tpar, torch.as_tensor(x), tci)
    for key in g_j:
        assert _rel(g_t[key].numpy(), g_j[key]) < TOL_GRAD
    xs, _, lp_s, _ = tp.sample(tpar, conditional_input=tci,
                               generator=torch.Generator().manual_seed(3))
    assert xs.shape == (B, tp.total_target_dim)
    lp_back = tp.log_prob(tpar, xs, conditional_input=tci)[0]
    assert (lp_back - lp_s).abs().max() < 1e-8


# label -> (definitions, flows, keywords, fully amortized)
POISSON = {
    "standalone": ("e2+e2", "gg+gg", dict(conditional_input_dim=[3, 2],
                                         hidden_mlp_dims_poisson="8-8",
                                         rank_of_mlp_mappings_poisson=2),
                   False),
    "joined": ("e2", "gg", dict(conditional_input_dim=2,
                                join_poisson_and_pdf_description=True),
               False),
    "unconditional": ("e2", "gg", {}, False),
    "fully amortized": ("e2+s1", "gg+o", dict(conditional_input_dim=3),
                        True),
}


@pytest.mark.parametrize("label", list(POISSON))
def test_poisson_heads_match_jax(label):
    defs, flows, kw, fully = POISSON[label]
    if fully:
        jp = jfa(defs, flows, predict_log_normalization=True, **kw)
        tp = tfa(defs, flows, predict_log_normalization=True, device="cpu",
                 **kw)
    else:
        jp, tp = _both(defs, flows, predict_log_normalization=True,
                       amortization_mlp_dims="16", **kw)
    jpar = jp.init_params(seed=0, dtype=jnp.float64)
    tpar = tp.init_params(seed=0, dtype=torch.float64)
    _same_init(jpar, tpar)
    assert tp.count_parameters() == jp.count_parameters()
    rng = np.random.default_rng(4)
    par = {k: np.asarray(v) + 0.05 * rng.normal(size=v.shape)
           for k, v in jpar.items()}
    tpar = params_from_jax(par)
    cd = kw.get("conditional_input_dim")
    ci = None if cd is None else [rng.normal(size=(B, w)) for w in cd] \
        if isinstance(cd, list) else rng.normal(size=(B, cd))
    tci = None if ci is None else [torch.as_tensor(c) for c in ci] \
        if isinstance(ci, list) else torch.as_tensor(ci)
    x = _rows(tp.inner_pdf if fully else tp, 5)
    want, lp_j = _jit(lambda p, x, c: (jp.log_mean_poisson(p, c), jp.log_prob(
        p, x, conditional_input=c)[0]))(par, x, ci)
    got = tp.log_mean_poisson(tpar, tci).numpy()
    assert got.shape == want.shape and np.abs(got - np.asarray(want)).max() < TOL
    lp_t = tp.log_prob(tpar, torch.as_tensor(x), conditional_input=tci)[0]
    assert np.abs(lp_t.numpy() - np.asarray(lp_j)).max() < TOL
    if not fully:
        # the plain autograd route: the head's parameters get no gradient
        loss, g = tp.nll_value_and_grad(tpar, torch.as_tensor(x), tci)
        assert abs(loss.item() + float(np.asarray(lp_j).mean())) < TOL
        head = {"standalone": "poisson_mlp",
                "unconditional": "log_lambda"}.get(label)
        if head:
            assert not g[head].any()


# label -> (definitions, flows, options, fully amortized)
# (the last layer of sub-pdf 0 is fitted first: a `g` there fits its
# householder rotation, the others take random vectors)
DATA_INIT = {
    "e2 tg full": ("e2+s2", "tg+f", {"t": {"cov_type": "full"}}, False),
    "e3 gt diagonal": ("e3", "gt", {"t": {"cov_type": "diagonal"}}, False),
    "e2 g angles, x": ("e2", "gx", {"g": {"rotation_mode": "angles",
                                          "fit_normalization": 0}}, False),
    "fully amortized": ("e2+s1", "gg+o", None, True),
}
# the force-coordinate models: an S1, an S2 (parametrized in embedding
# space) and a simplex sub-pdf
FORCE = ("s1+s2+a2", "o+f+u")


@pytest.mark.parametrize("label", list(DATA_INIT))
def test_data_init_matches_jax(label):
    defs, flows, opts, fully = DATA_INIT[label]
    rng = np.random.default_rng(6)
    dim = int(defs.split("+")[0][1:])
    data = rng.normal(size=(300, dim)) * np.array([1.0, 3.0, 0.5][:dim]) \
        + np.array([0.5, -1.0, 2.0][:dim])
    if fully:
        jp = jfa(defs, flows, options_overwrite=opts, conditional_input_dim=2)
        tp = tfa(defs, flows, options_overwrite=opts, conditional_input_dim=2,
                 device="cpu")
    else:
        jp, tp = _both(defs, flows, options_overwrite=opts)
    jpar = jp.init_params(seed=0, dtype=jnp.float64, data=data)
    tpar = tp.init_params(seed=0, dtype=torch.float64,
                          data=torch.as_tensor(data))
    _same_init(jpar, tpar, tol=TOL_DATA_INIT)
    plain = tp.init_params(seed=0, dtype=torch.float64)
    assert any((tpar[k] - plain[k]).abs().max() > 1e-3 for k in plain)


# definitions, flows, options (one sub-pdf of each manifold with an
# embedding, and a Euclidean one)
COORDS = ("e2+s1+s2+a2+i1_0.0_2.0", "gg+o+f+u+r", None)


@pytest.mark.parametrize("src,dst", [("default", "embedding"),
                                     ("embedding", "intrinsic"),
                                     ("intrinsic", "default")])
def test_transform_target_space_matches_jax(src, dst):
    jp, tp = _both(COORDS[0], COORDS[1])
    x = _rows(tp, 7, coords=src)
    ld = np.random.default_rng(8).normal(size=B)
    xj, ldj = jp.transform_target_space(x, jnp.asarray(ld), src, dst)
    xt, ldt = tp.transform_target_space(torch.as_tensor(x), torch.as_tensor(ld),
                                        src, dst)
    assert xt.shape == xj.shape
    assert np.abs(xt.numpy() - np.asarray(xj)).max() < TOL
    assert np.abs(ldt.numpy() - np.asarray(ldj)).max() < TOL
    back, ld_back = tp.transform_target_space(xt, ldt, dst, src)
    assert (back - torch.as_tensor(x)).abs().max() < 1e-9
    assert (ld_back - torch.as_tensor(ld)).abs().max() < 1e-9
    assert tp.get_total_embedding_dim() == jp.get_total_embedding_dim()
    np.testing.assert_allclose(
        tp.transform_target_into_returnable_params(torch.as_tensor(
            _rows(tp, 7))).numpy(),
        np.asarray(jp.transform_target_into_returnable_params(_rows(tp, 7))),
        atol=TOL)


@pytest.mark.parametrize("coords", ["embedding", "intrinsic"])
def test_force_coordinates_match_jax(coords):
    """log_prob, all_layer_inverse and all_layer_forward with forced
    coordinates against the JAX package; sample's forced rows and density
    agree with log_prob of them (embedding flags set on the s2 sub-pdf, so
    that default and intrinsic differ there)."""
    jp, tp = _both(*FORCE)
    jp.set_embedding_flags(True, sub_pdf_index=1)
    tp.set_embedding_flags(True, sub_pdf_index=1)
    assert tp.get_embedding_flags() == jp.get_embedding_flags()
    assert (tp.total_target_dim, tp.total_target_dim_intrinsic,
            tp.total_target_dim_embedded) == (
        jp.total_target_dim, jp.total_target_dim_intrinsic,
        jp.total_target_dim_embedded)
    jpar = jp.init_params(seed=0, dtype=jnp.float64)
    tpar = params_from_jax(jpar)
    force = {f"force_{coords}_coordinates": True}
    x = _rows(tp, 9, coords=coords)
    z = np.random.default_rng(10).normal(size=(B, tp.total_base_dim))
    ld0 = np.zeros(B)
    for name, args in (("log_prob", (x,)),
                       ("all_layer_inverse", (x, ld0)),
                       ("all_layer_forward", (z, ld0))):
        want = _jit(lambda p, *a, fn=getattr(jp, name): fn(p, *a, **force))(
            jpar, *args)
        got = getattr(tp, name)(tpar, *map(torch.as_tensor, args), **force)
        for a, b in zip(got, want):
            assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-9, name
    xs, _, lp, _ = tp.sample(tpar, samplesize=B,
                             generator=torch.Generator().manual_seed(11),
                             **force)
    assert xs.shape[1] == getattr(tp, f"total_target_dim_{coords}"
                                  if coords == "intrinsic"
                                  else "total_target_dim_embedded")
    assert (tp.log_prob(tpar, xs, **force)[0] - lp).abs().max() < 1e-7


@pytest.mark.parametrize("defs,flows,opts", [
    ("e2+s2+s1+i1_0.0_2.0+a2+a1", "gt+fvc+mo+rz+u+w",
     {"t": {"cov_type": "full"}}),
    ("s2+s2", "f+f", {0: {"f": {"add_vertical_rq_spline_flow": 1,
                                "add_circular_rq_spline_flow": 1}},
                      1: {"f": {"add_correlated_rq_spline_flow": 1}}}),
    ("e3+e2+s1", "gg+g+o", {(0, 0): {"g": {"rotation_mode": "angles",
                                           "add_skewness": 1}},
                            (1, 0): {"g": {"nonlinear_stretch_type":
                                           "rq_splines"}},
                            "o": {"smooth_second_derivative": 0}})])
def test_param_structure_matches_jax(defs, flows, opts):
    """Every layer's named parameter split."""
    jp, tp = _both(defs, flows, options_overwrite=opts)
    assert [[l.param_structure() for l in ls] for ls in tp.layer_list] == \
        [[l.param_structure() for l in ls] for ls in jp.layer_list]


def test_obtain_flow_param_structure_matches_jax():
    jp, tp = _both("e2+s1", "gg+m", conditional_input_dim=2,
                   amortization_mlp_dims="16")
    jpar = jp.init_params(seed=0, dtype=jnp.float64)
    tpar = params_from_jax(jpar)
    rng = np.random.default_rng(12)
    z, ci = rng.normal(size=(B, 3)), rng.normal(size=(B, 2))
    want = _jit(lambda p, c, zz: {
        k: v["named"] for k, v in jp.obtain_flow_param_structure(
            p, conditional_input=c, predefined_target_input=zz).items()})(
                jpar, ci, z)
    got = tp.obtain_flow_param_structure(
        tpar, conditional_input=torch.as_tensor(ci),
        predefined_target_input=torch.as_tensor(z))
    assert list(got) == list(want)
    layers = [l for ls in tp.layer_list for l in ls]
    for (key, w), layer in zip(want.items(), layers):
        g = got[key]
        assert (g["layer_type"], g["num_params"]) == (type(layer).__name__,
                                                      layer.num_params)
        assert list(g["named"]) == [n for n, _ in layer.param_structure()]
        assert sorted(g["named"]) == sorted(w)
        for name, v in w.items():
            assert np.abs(g["named"][name].numpy() - np.asarray(v)).max() < TOL


def test_failsafe_sampling_redraws_flagged_rows():
    """A float32 model whose sampling solve leaves some rows off its
    density by more than the tolerance: each returned row passes the
    cross-check or is the last round's draw; the same rounds replayed
    from the generator give the same rows; no rounds return the first
    draw."""
    tp = tpdf("e2", "gg", device="cpu")
    par = tp.init_params(seed=0)
    par = {k: v + 0.3 * torch.randn(v.shape, generator=torch.Generator()
                                     .manual_seed(13)) for k, v in par.items()}
    n, tol, rounds = 512, 2e-6, 2

    def draws():
        g = torch.Generator().manual_seed(14)
        return [tp.sample(par, samplesize=n, generator=g)
                for _ in range(rounds + 1)]

    first, *_, last = draws()
    x, z, lp, lb = tp.sample(par, samplesize=n,
                             generator=torch.Generator().manual_seed(14),
                             failsafe_crosscheck_tolerance=tol,
                             failsafe_rounds=rounds)
    off0 = (tp.log_prob(par, first[0])[0] - first[2]).abs() > tol
    assert off0.any() and not off0.all()
    ok = (tp.log_prob(par, x)[0] - lp).abs() <= tol
    is_last = (z == last[1]).all(dim=1)
    assert (ok | is_last).all()
    torch.testing.assert_close(lb, -0.5 * (z**2).sum(1) - math.log(2 * math.pi))
    x0 = tp.sample(par, samplesize=n, generator=torch.Generator().manual_seed(
        14), failsafe_crosscheck_tolerance=tol, failsafe_rounds=0)[0]
    assert torch.equal(x0, first[0])
