"""The trainer's optimizer and checkpoints, the checkpoint module, the
profiling helpers and the CLI:

* ``fit(optimizer=lambda ps: torch.optim.SGD(ps, lr=1e-2))`` against the
  JAX package's ``fit(optimizer=optax.sgd(1e-2))``: float64, full batch,
  the losses and final parameters;
* a fit in checkpointed chunks against the unchunked one (full batch and
  minibatches from one generator): the same losses and parameters, each
  chunk's checkpoint restored bit-equal;
* ``checkpoint.save`` / ``restore`` with extra state, the ``like_*``
  trees' dtypes;
* ``profiling.throughput`` / ``trace`` / ``annotate``;
* ``python -m jammy_flows_tpu_torch`` fit / sample / eval / moments on the
  CPU (``--platform cpu``, in-process through ``main``), and
  ``--platform default`` needing a card."""
import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jammy_flows_tpu import pdf as jpdf
from jammy_flows_tpu import train as jtrain
from jammy_flows_tpu_torch import pdf as tpdf
from jammy_flows_tpu_torch import train as ttrain
from jammy_flows_tpu_torch.__main__ import main
from jammy_flows_tpu_torch.utils import checkpoint, profiling
from jammy_flows_tpu_torch.utils.convert import params_from_jax, to_numpy
from torch_one_thread import _one_torch_thread  # noqa: F401

KW = dict(conditional_input_dim=2, amortization_mlp_dims="16")


def _two_moons(n, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, np.pi, n)
    x1 = np.stack([np.cos(t), np.sin(t)], 1) + rng.normal(0, 0.1, (n, 2))
    x2 = np.stack([1 - np.cos(t), 0.5 - np.sin(t)], 1) + \
        rng.normal(0, 0.1, (n, 2))
    return np.concatenate([x1, x2])


def test_sgd_fit_matches_jax():
    jp = jpdf("e2", "gg", **KW)
    tp = tpdf("e2", "gg", device="cpu", **KW)
    par = {k: np.asarray(v) for k, v in
           jp.init_params(seed=0, dtype=jnp.float64).items()}
    x = _two_moons(64)
    ci = np.random.default_rng(1).normal(size=(128, 2))
    jpar, jloss = jtrain.fit(jp, {k: jnp.asarray(v) for k, v in par.items()},
                             jnp.asarray(x), conditional_input=jnp.asarray(ci),
                             num_steps=6, optimizer=optax.sgd(1e-2))
    tpar, tloss = ttrain.fit(
        tp, params_from_jax(par), torch.as_tensor(x),
        conditional_input=torch.as_tensor(ci), num_steps=6,
        optimizer=lambda ps: torch.optim.SGD(ps, lr=1e-2),
        learning_rate=5.0, schedule="cosine", clip_norm=1e-9)  # ignored
    np.testing.assert_allclose(tloss, np.asarray(jloss), rtol=1e-10)
    for key, v in to_numpy(tpar).items():
        ref = np.asarray(jpar[key])
        assert np.linalg.norm(v - ref) <= 1e-10 * np.linalg.norm(ref)


@pytest.mark.parametrize("batch_size", [None, 32])
def test_chunked_fit_with_checkpoints(tmp_path, batch_size):
    p = tpdf("e2", "gg", device="cpu")
    x = torch.as_tensor(_two_moons(100))
    par = p.init_params(seed=0, dtype=torch.float64, data=x.numpy())

    def fit(**kw):
        return ttrain.fit(p, par, x, num_steps=7, learning_rate=1e-2,
                          batch_size=batch_size,
                          generator=torch.Generator().manual_seed(3), **kw)

    whole, l_whole = fit()
    chunked, l_chunk = fit(checkpoint_path=tmp_path, checkpoint_every=3)
    np.testing.assert_array_equal(l_chunk, l_whole)
    assert all(torch.equal(chunked[k], v) for k, v in whole.items())
    names = sorted(f.name for f in tmp_path.iterdir())
    assert names == ["step_00000003", "step_00000006", "step_00000007"]
    three, _ = ttrain.fit(p, par, x, num_steps=3, learning_rate=1e-2,
                          batch_size=batch_size,
                          generator=torch.Generator().manual_seed(3))
    saved3, _ = checkpoint.restore(tmp_path / "step_00000003",
                                   like_params=par)
    assert all(torch.equal(saved3[k], v) for k, v in three.items())
    saved7, _ = checkpoint.restore(tmp_path / "step_00000007")
    assert all(torch.equal(saved7[k], v) for k, v in whole.items())


def test_checkpoint_roundtrip(tmp_path):
    p = tpdf("e4+s2+e4", "gggg+f+gggg", device="cpu",
             amortization_mlp_dims="16", conditional_input_dim=3)
    par = p.init_params(seed=2)
    extra = {"step": 7, "name": "adam", "lr": 1e-3,
             "moments": [torch.randn(3, 4), (torch.arange(5),)],
             "nested": {"a": torch.ones(2, dtype=torch.float64)}}
    path = tmp_path / "sub" / "ckpt.pt"
    checkpoint.save(path, par, extra_state=extra)
    back, back_extra = checkpoint.restore(path)
    assert sorted(back) == sorted(par)
    assert all(torch.equal(back[k], v) for k, v in par.items())
    assert back_extra["step"] == 7 and back_extra["name"] == "adam"
    assert torch.equal(back_extra["moments"][0], extra["moments"][0])
    assert torch.equal(back_extra["moments"][1][0], extra["moments"][1][0])
    assert torch.equal(back_extra["nested"]["a"], extra["nested"]["a"])
    like = {k: v.double() for k, v in par.items()}
    like_extra = {**extra, "nested": {"a": torch.ones(2)}}
    back, back_extra = checkpoint.restore(path, like_params=like,
                                          like_extra_state=like_extra)
    assert all(back[k].dtype == torch.float64 for k in back)
    assert back_extra["nested"]["a"].dtype == torch.float32
    none_extra = tmp_path / "plain.pt"
    checkpoint.save(none_extra, {k: v.requires_grad_() for k, v in
                                 p.init_params(seed=3).items()})
    back, back_extra = checkpoint.restore(none_extra)
    assert back_extra is None and not any(v.requires_grad
                                          for v in back.values())


def test_profiling(tmp_path):
    p = tpdf("e2", "gg", device="cpu")
    params = p.init_params(seed=0)
    x = torch.randn((256, 2), generator=torch.Generator().manual_seed(0))
    rate = profiling.throughput(p.log_prob, params, x, items_per_call=256,
                                reps=3)
    assert rate["reps"] == 3 and rate["items_per_s"] > 0
    assert np.isfinite(rate["checksum"])
    with profiling.trace(tmp_path / "trace") as d:
        with profiling.annotate("log_prob"):
            p.log_prob(params, x)
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert d == tmp_path / "trace" and "log_prob" in text
    assert profiling.throughput(lambda: {"a": (x,)}, items_per_call=1,
                                reps=1, warmup=0)["checksum"] == \
        pytest.approx(float(x.sum()))


@pytest.fixture(scope="module")
def cli_model(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    np.save(tmp / "data.npy", _two_moons(400))
    main(["fit", "--pdf-defs", "e2", "--flow-defs", "gg", "--data",
          str(tmp / "data.npy"), "--out", str(tmp / "model"), "--steps", "60",
          "--lr", "1e-2", "--batch-size", "256", "--platform", "cpu"])
    return tmp


def test_cli_fit(cli_model, capsys):
    spec = json.loads((cli_model / "model" / "model.json").read_text())
    assert spec == {"pdf_defs": "e2", "flow_defs": "gg",
                    "conditional_input_dim": None, "options_overwrite": {},
                    "dtype": "float32"}
    assert (cli_model / "model" / "params.pt").exists()
    # a conditional fit from .npz files, without the data-driven init
    rng = np.random.default_rng(4)
    ci = rng.normal(size=(300, 1))
    np.savez(cli_model / "cond.npz", c=ci)
    np.savez(cli_model / "x.npz", x=1.5 * ci + 0.5 * rng.normal(size=ci.shape))
    main(["fit", "--pdf-defs", "e1", "--flow-defs", "g", "--data",
          str(cli_model / "x.npz"), "--cond", str(cli_model / "cond.npz"),
          "--out", str(cli_model / "cmodel"), "--steps", "5", "--dtype",
          "float64", "--platform", "cpu"])
    assert "final NLL" in capsys.readouterr().out
    spec = json.loads((cli_model / "cmodel" / "model.json").read_text())
    assert spec["conditional_input_dim"] == 1 and spec["dtype"] == "float64"


def test_cli_sample(cli_model, capsys):
    main(["sample", "--model", str(cli_model / "model"), "-n", "500",
          "--out", str(cli_model / "s.npy"), "--platform", "cpu"])
    s = np.load(cli_model / "s.npy")
    assert s.shape == (500, 2) and np.isfinite(s).all()
    assert abs(s[:, 0].mean() - 0.5) < 0.4
    assert "500 samples" in capsys.readouterr().out


def test_cli_eval(cli_model, capsys):
    main(["eval", "--model", str(cli_model / "model"), "--data",
          str(cli_model / "data.npy"), "--platform", "cpu"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["n"] == 800 and stats["finite_fraction"] == 1.0
    assert stats["mean_nll"] < 2.6


def test_cli_moments(cli_model, capsys):
    main(["moments", "--model", str(cli_model / "model"), "-n", "300",
          "--platform", "cpu"])
    out = capsys.readouterr().out
    mm = json.loads(out[out.index("{"):])
    assert {"mean_0", "varlike_0", "entropy_gauss_approx_0"} <= set(mm)
    assert np.asarray(mm["varlike_0"]).shape == (1, 2, 2)


def test_cli_default_platform_needs_a_card(cli_model):
    argv = ["eval", "--model", str(cli_model / "model"), "--data",
            str(cli_model / "data.npy")]
    if torch.cuda.is_available():
        main(argv)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
