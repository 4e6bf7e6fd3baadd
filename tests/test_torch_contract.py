"""The port's contract at its entry points, against the JAX package's:

* an option override for a sub-pdf the model does not have raises
  (``ValueError`` in the port, an assertion in the JAX package), while a
  tuple key whose layer index is out of range builds in both;
* every keyword of the JAX signatures of ``PDF``, ``init_params``,
  ``log_prob``, ``sample``, ``train.fit`` and the diagnostics is taken (a
  ``torch.Generator`` where the JAX package takes a key), and a value other
  than the JAX default runs and does what it says."""
import inspect

import numpy as np
import pytest
import torch

from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu import train as jtrain
from jammy_flows_tpu.models.pdf import PDF as JPDF
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch import train as ttrain
from jammy_flows_tpu_torch.models.pdf import PDF as TPDF
from jammy_flows_tpu_torch.utils import checkpoint
from torch_one_thread import _one_torch_thread  # noqa: F401

SKEW = {"g": {"add_skewness": 1}}
BAD_KEYS = [3, -1, (2, 0), (-1, 0)]


@pytest.mark.parametrize("key", BAD_KEYS, ids=str)
def test_override_for_a_missing_sub_pdf_raises(key):
    with pytest.raises(AssertionError):
        jpdf("e2", "gg", options_overwrite={key: SKEW})
    with pytest.raises(ValueError, match="sub-pdfs 0..0"):
        tpdf("e2", "gg", options_overwrite={key: SKEW}, device="cpu")


def test_tuple_key_past_the_layers_builds():
    jp = jpdf("e2", "gg", options_overwrite={(0, 5): SKEW})
    tp = tpdf("e2", "gg", options_overwrite={(0, 5): SKEW}, device="cpu")
    assert [l.add_skewness for l in tp.layer_list[0]] == \
        [l.add_skewness for l in jp.layer_list[0]] == [0, 0]
    tp = tpdf("e2", "gg", options_overwrite={0: SKEW}, device="cpu")
    assert [l.add_skewness for l in tp.layer_list[0]] == [1, 1]


# a conditional pdf with a Poisson head, for the Poisson head's keywords
POISSON = {"conditional_input_dim": 8, "predict_log_normalization": True}
# the ported keywords: (entry point, a value other than the JAX default,
# the constructor's other keywords)
PORTED = {
    "amortization_mlp_use_custom_mode": ("PDF", True, {}),
    "amortize_everything": ("PDF", True, {}),
    "use_as_passthrough_instead_of_pdf": ("PDF", True, {}),
    "amortization_parameters": ("log_prob", torch.zeros(4, 3), {}),
    "predict_log_normalization": ("PDF", True, {}),
    "join_poisson_and_pdf_description": ("PDF", True, POISSON),
    "hidden_mlp_dims_poisson": ("PDF", "64", POISSON),
    "rank_of_mlp_mappings_poisson": ("PDF", 2, POISSON),
    "skip_mlp_initialization": ("PDF", True, {}),
    "verbose": ("PDF", True, {}),
    "data": ("init_params", np.arange(8.0).reshape(4, 2), {}),
    "force_embedding_coordinates": ("log_prob", True, {}),
    "force_intrinsic_coordinates": ("sample", True, {}),
    "failsafe_crosscheck_tolerance": ("sample", 1e-3, {}),
    "failsafe_rounds": ("sample", 5, {}),
    "optimizer": ("fit", lambda ps: torch.optim.SGD(ps, lr=1e-2), {}),
    "checkpoint_every": ("fit", 1, {}),
}
# (JAX entry point, the port's) whose keywords the port takes
SIGNATURES = [(JPDF.__init__, TPDF.__init__), (jtrain.fit, ttrain.fit)] + [
    (getattr(JPDF, name), getattr(TPDF, name)) for name in (
        "init_params", "log_prob", "sample", "all_layer_forward_subdims",
        "all_layer_inverse_subdims", "sample_with_subdim_logprobs",
        "entropy", "entropy_iterative", "entropy_device",
        "approximate_coverage", "coverage_and_or_pdf_scan",
        "coverage_scan_device", "marginal_moments",
        "marginal_moments_device")]


def _call(entry, ctor=None, **kw):
    p = tpdf("e2", "gg", device="cpu", **(ctor or {}),
             **(kw if entry == "PDF" else {}))
    if entry == "PDF":
        return p
    params = p.init_params(seed=0, **(kw if entry == "init_params" else {}))
    x = torch.randn((4, 2), generator=torch.Generator().manual_seed(0))
    if entry == "log_prob":
        return p.log_prob(params, x, **kw)
    if entry == "sample":
        return p.sample(params, samplesize=4,
                        generator=torch.Generator().manual_seed(1), **kw)
    if entry == "fit":
        return ttrain.fit(p, params, x, num_steps=1, **kw)
    return params


def test_every_keyword_is_listed():
    """Every keyword of the JAX entry points is one of the port's (its
    ``key`` a ``generator``), and every keyword PORTED lists is one of
    them."""
    taken = set()
    for jfn, tfn in SIGNATURES:
        jkw = set(inspect.signature(jfn).parameters)
        tkw = set(inspect.signature(tfn).parameters)
        if "key" in jkw:
            jkw = (jkw - {"key"}) | {"generator"}
        assert jkw <= tkw, (jfn.__qualname__, jkw - tkw)
        taken |= jkw
    assert set(PORTED) <= taken


@pytest.mark.parametrize("name", sorted(PORTED))
def test_ported_keyword(name, tmp_path):
    """The value runs: custom mode builds the same model (no effect outside
    the fully amortized pdf), an amortize_everything pdf keeps no
    parameters of its own, a passthrough pdf has no log_prob, an
    amortization slab that no sub-pdf reads (an unconditional pdf's)
    leaves log_prob as it is; a Poisson head adds its parameters (one more
    output of sub-pdf 0's MLP when joined; its own MLP's width and rank);
    skip_mlp_initialization and verbose build the same model with the same
    init; data moves the init; the forced coordinates of a Euclidean pdf
    are its default ones; failsafe rounds without a tolerance change
    nothing, a tolerance gives finite rows; an optimizer takes the step
    (SGD: the parameters move by -lr times the gradient), and
    checkpoint_every with a checkpoint path saves after every chunk."""
    entry, value, ctor = PORTED[name]
    out = _call(entry, ctor, **{name: value})
    plain = _call(entry, ctor)
    if name == "amortization_mlp_use_custom_mode":
        assert out.num_parameter_list == plain.num_parameter_list
    elif name == "amortize_everything":
        assert out.init_params(seed=0) == {}
        assert out.total_number_amortizable_params == \
            sum(out.num_parameter_list[0])
    elif name == "use_as_passthrough_instead_of_pdf":
        with pytest.raises(ValueError):
            out.log_prob({}, torch.zeros((4, 2)))
    elif name == "predict_log_normalization":
        assert sorted(out.init_params()) == ["flow_0", "log_lambda"]
        assert out.count_parameters() == plain.count_parameters() + 1
    elif name == "join_poisson_and_pdf_description":
        assert out.mlp_predictors[0].output_dim == \
            plain.mlp_predictors[0].output_dim + 1
        assert out.log_normalization_mlp is None
    elif name == "hidden_mlp_dims_poisson":
        assert out.log_normalization_mlp.hidden_dims == [64]
    elif name == "rank_of_mlp_mappings_poisson":
        assert out.log_normalization_mlp.num_params < \
            plain.log_normalization_mlp.num_params
    elif name in ("skip_mlp_initialization", "verbose"):
        assert out.num_parameter_list == plain.num_parameter_list
        for key, v in plain.init_params(seed=0).items():
            assert torch.equal(out.init_params(seed=0)[key], v)
    elif name == "data":
        assert any(not torch.equal(out[k], plain[k]) for k in plain)
    elif name == "failsafe_crosscheck_tolerance":
        assert all(torch.isfinite(t).all() for t in out)
    elif name == "optimizer":
        p = tpdf("e2", "gg", device="cpu")
        params = p.init_params(seed=0)
        x = torch.randn((4, 2), generator=torch.Generator().manual_seed(0))
        _, grads = p.nll_value_and_grad(params, x)
        for key, v in params.items():
            torch.testing.assert_close(out[0][key], v - 1e-2 * grads[key],
                                       rtol=0, atol=1e-7)
        assert any(not torch.equal(out[0][k], plain[0][k]) for k in plain[0])
    elif name == "checkpoint_every":
        p = tpdf("e2", "gg", device="cpu")
        x = torch.randn((4, 2), generator=torch.Generator().manual_seed(0))
        new, _ = ttrain.fit(p, p.init_params(seed=0), x, num_steps=2,
                            checkpoint_every=value, checkpoint_path=tmp_path)
        assert sorted(f.name for f in tmp_path.iterdir()) == \
            ["step_00000001", "step_00000002"]
        last, _ = checkpoint.restore(tmp_path / "step_00000002")
        assert all(torch.equal(last[k], v) for k, v in new.items())
        for a, b in zip(out, plain):       # chunking alone changes nothing
            if isinstance(a, dict):
                assert all(torch.equal(a[k], b[k]) for k in a)
            else:
                np.testing.assert_array_equal(a, b)
    else:
        for a, b in zip(out if isinstance(out, tuple) else (out,),
                        plain if isinstance(plain, tuple) else (plain,)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
