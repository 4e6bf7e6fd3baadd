"""The port's contract at its entry points, against the JAX package's:

* an option override for a sub-pdf the model does not have raises
  (``ValueError`` in the port, an assertion in the JAX package), while a
  tuple key whose layer index is out of range builds in both;
* every keyword of the JAX signatures of ``PDF``, ``init_params``,
  ``log_prob``, ``sample`` and ``train.fit`` is taken: its JAX default runs,
  any other value raises ``NotImplementedError`` naming the ROADMAP item,
  but for the ported ones (all but ``train.fit``'s optimizer and
  checkpoints), which run."""
import re

import numpy as np
import pytest
import torch

from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch import train as ttrain
from jammy_flows_tpu_torch.models.pdf import UNPORTED_DEFAULTS
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


# keyword -> (entry point, a value other than the JAX default)
NON_DEFAULT = {
    "optimizer": ("fit", "adam"),
    "checkpoint_every": ("fit", 10),
}
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
}
ITEM = {"fit": "item 6"}


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
    assert set(NON_DEFAULT) == set(UNPORTED_DEFAULTS)
    assert not set(PORTED) & set(UNPORTED_DEFAULTS)


@pytest.mark.parametrize("name", sorted(NON_DEFAULT))
def test_unported_keyword(name):
    entry, value = NON_DEFAULT[name]
    with pytest.raises(NotImplementedError,
                       match=re.escape(ITEM[entry])) as err:
        _call(entry, **{name: value})
    assert name in str(err.value)
    out = _call(entry, **{name: UNPORTED_DEFAULTS[name]})
    assert out is not None


@pytest.mark.parametrize("name", sorted(PORTED))
def test_ported_keyword(name):
    """The value runs: custom mode builds the same model (no effect outside
    the fully amortized pdf), an amortize_everything pdf keeps no
    parameters of its own, a passthrough pdf has no log_prob, an
    amortization slab that no sub-pdf reads (an unconditional pdf's)
    leaves log_prob as it is; a Poisson head adds its parameters (one more
    output of sub-pdf 0's MLP when joined; its own MLP's width and rank);
    skip_mlp_initialization and verbose build the same model with the same
    init; data moves the init; the forced coordinates of a Euclidean pdf
    are its default ones; failsafe rounds without a tolerance change
    nothing, a tolerance gives finite rows."""
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
    else:
        for a, b in zip(out if isinstance(out, tuple) else (out,),
                        plain if isinstance(plain, tuple) else (plain,)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
