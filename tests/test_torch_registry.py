"""The port's flow registry equals the JAX package's: the same symbols,
manifold types, layer class names, option defaults, and validators that
accept and reject the same values."""
import pytest

from jammy_flows_tpu import registry as jreg
from jammy_flows_tpu_torch import registry as treg

PROBES = [0, 1, 2, -1, -2, 0.5, -0.5, 1e-3, 0.0, 1.0, 3, 100, -1.0,
          "isigmoid", "inormal_full_pade", "householder", "none", "angles",
          "classic", "rq_splines", "diagonal", "full", "oo", "rr", "32",
          "dopri5", "exponential", "direct_log_real_bounded", "bogus"]


def _accepts(check, sym, opt, val):
    try:
        check(sym, opt, val)
        return True
    except (AssertionError, ValueError, TypeError):
        return False


def test_option_tables_match():
    assert set(treg.OPTS) == set(jreg.OPTS)
    for sym, (mt, mod, cls, opts) in jreg.OPTS.items():
        tmt, tmod, tcls, topts = treg.OPTS[sym]
        assert (tmt, tcls) == (mt, cls)
        assert tmod.split(".")[-1] == mod.split(".")[-1]
        assert treg.obtain_default_options(sym) == \
            jreg.obtain_default_options(sym)
        assert list(topts) == list(opts)


@pytest.mark.parametrize("sym", sorted(jreg.OPTS))
def test_validators_accept_and_reject_the_same_values(sym):
    for opt, (default, _) in jreg.OPTS[sym][3].items():
        for val in PROBES + [default]:
            assert _accepts(treg.check_flow_option, sym, opt, val) == \
                _accepts(jreg.check_flow_option, sym, opt, val), (sym, opt, val)
    assert not _accepts(treg.check_flow_option, sym, "no_such_option", 1)


def test_unported_layers_raise_not_implemented(monkeypatch):
    """Every symbol loads its class; a class missing from the port's list
    still raises."""
    assert treg.get_layer_class("g").__name__ == "GaussianizationFlow"
    assert treg.get_layer_class("f").__name__ == "FisherVonMises2D"
    assert treg.get_layer_class("t").__name__ == "MultivariateNormal"
    assert treg.get_layer_class("x").__name__ == "EuclideanIdentity"
    for sym, cls in (("v", "ExponentialMapS2"), ("m", "Moebius"),
                     ("o", "CircularRQSpline"),
                     ("y", "SphericalIdentity"), ("r", "RQSplineInterval"),
                     ("z", "IntervalIdentity"), ("u", "GumbelSoftmax"),
                     ("w", "InnerLoopSimplex"), ("c", "CNFSphereCharts")):
        assert treg.get_layer_class(sym).__name__ == cls
    assert {c for _, _, c, _ in treg.OPTS.values()} <= treg._PORTED
    monkeypatch.setattr(treg, "_PORTED", treg._PORTED - {"CNFSphereCharts"})
    with pytest.raises(NotImplementedError, match="CNFSphereCharts"):
        treg.get_layer_class("c")
