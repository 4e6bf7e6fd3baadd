"""Command-line interface: fit / sample / eval / moments.

PyTorch counterpart of ``jammy_flows_tpu/__main__.py``, with its flags.  A
model directory holds ``model.json`` (the pdf's definition and dtype) and
``params.pt`` (utils/checkpoint.py), so ``sample`` / ``eval`` / ``moments``
rebuild the exact pdf.  ``--platform default`` runs on the current CUDA
device and fails without one; ``--platform cpu`` runs the plain PyTorch
path on the CPU.

Examples:
    python -m jammy_flows_tpu_torch fit --pdf-defs e2 --flow-defs gg \\
        --data data.npz --data-key x --out models/e2 --steps 500
    python -m jammy_flows_tpu_torch sample --model models/e2 -n 10000 \\
        --out samples.npy
    python -m jammy_flows_tpu_torch eval --model models/e2 --data test.npz
    python -m jammy_flows_tpu_torch moments --model models/e2
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

PARAMS_FILE = "params.pt"


def _load_array(path, key=None):
    p = pathlib.Path(path)
    if p.suffix == ".npz":
        payload = np.load(p)
        if key is None:
            key = list(payload.keys())[0]
        return np.asarray(payload[key])
    if p.suffix == ".npy":
        return np.load(p)
    if p.suffix in (".csv", ".txt"):
        return np.loadtxt(p, delimiter="," if p.suffix == ".csv" else None)
    raise SystemExit(f"unsupported data format: {path}")


def _device(args):
    from .models.pdf import resolve_device
    return resolve_device("cpu" if args.platform == "cpu" else None)


def _tensor(array, dtype, device):
    return None if array is None else torch.as_tensor(array, dtype=dtype,
                                                      device=device)


def _build_pdf(spec, device):
    from . import pdf
    return pdf(spec["pdf_defs"], spec["flow_defs"],
               conditional_input_dim=spec.get("conditional_input_dim"),
               options_overwrite=spec.get("options_overwrite") or {},
               device=device)


def _save_model(out, spec, params):
    from .utils import checkpoint as ckpt
    out = pathlib.Path(out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    (out / "model.json").write_text(json.dumps(spec, indent=1))
    ckpt.save(out / PARAMS_FILE, params)


def _load_model(path, device):
    from .utils import checkpoint as ckpt
    path = pathlib.Path(path).resolve()
    spec = json.loads((path / "model.json").read_text())
    p = _build_pdf(spec, device)
    like = p.init_params(seed=0, dtype=getattr(torch, spec.get("dtype",
                                                               "float32")))
    params, _ = ckpt.restore(path / PARAMS_FILE, like_params=like)
    return p, params, spec


def cmd_fit(args):
    from . import train

    dev = _device(args)
    data = _load_array(args.data, args.data_key)
    ci = _load_array(args.cond, args.cond_key) if args.cond else None
    spec = {"pdf_defs": args.pdf_defs, "flow_defs": args.flow_defs,
            "conditional_input_dim": None if ci is None else ci.shape[1],
            "options_overwrite": json.loads(args.options) if args.options
            else {},
            "dtype": args.dtype}
    p = _build_pdf(spec, dev)
    dtype = getattr(torch, args.dtype)
    params = p.init_params(seed=args.seed, dtype=dtype,
                           data=None if (ci is not None or args.no_data_init)
                           else data)
    params, hist = train.fit(
        p, params, _tensor(data, dtype, dev),
        conditional_input=_tensor(ci, dtype, dev), num_steps=args.steps,
        batch_size=args.batch_size, learning_rate=args.lr,
        schedule=args.schedule, clip_norm=args.clip_norm,
        generator=torch.Generator(device=dev).manual_seed(args.seed),
        verbose=True)
    _save_model(args.out, spec, params)
    print(f"final NLL {hist[-1]:.4f}; model saved to {args.out}")


def cmd_sample(args):
    p, params, spec = _load_model(args.model, _device(args))
    dtype = getattr(torch, spec.get("dtype", "float32"))
    ci = None
    if args.cond:
        ci = _tensor(_load_array(args.cond, args.cond_key), dtype, p.device)
    with torch.no_grad():
        x, _, logq, _ = p.sample(
            params, samplesize=args.n, conditional_input=ci,
            generator=torch.Generator(device=p.device).manual_seed(args.seed),
            dtype=dtype)
    np.save(args.out, x.cpu().numpy())
    print(f"{x.shape[0]} samples -> {args.out} "
          f"(mean log q {float(logq.mean()):.4f})")


def cmd_eval(args):
    p, params, spec = _load_model(args.model, _device(args))
    dtype = getattr(torch, spec.get("dtype", "float32"))
    data = _tensor(_load_array(args.data, args.data_key), dtype, p.device)
    ci = _tensor(_load_array(args.cond, args.cond_key), dtype, p.device) \
        if args.cond else None
    with torch.no_grad():
        lp = p.log_prob(params, data, conditional_input=ci)[0].cpu().numpy()
    print(json.dumps({"mean_nll": float(-lp.mean()),
                      "n": int(lp.size),
                      "finite_fraction": float(np.isfinite(lp).mean())}))


def cmd_moments(args):
    p, params, spec = _load_model(args.model, _device(args))
    dtype = getattr(torch, spec.get("dtype", "float32"))
    ci = _tensor(_load_array(args.cond, args.cond_key), dtype, p.device) \
        if args.cond else None
    mm = p.marginal_moments(
        params, torch.Generator(device=p.device).manual_seed(args.seed),
        conditional_input=ci, samplesize=args.n)
    out = {k: (v.tolist() if isinstance(v, np.ndarray) else str(v))
           for k, v in mm.items() if not isinstance(v, dict)}
    print(json.dumps(out, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m jammy_flows_tpu_torch",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(s):
        s.add_argument("--seed", type=int, default=0)
        s.add_argument("--cond", help="conditional-input array file")
        s.add_argument("--cond-key")
        s.add_argument("--platform", choices=["cpu", "default"],
                       default="default",
                       help="cpu: the plain PyTorch path on the CPU; "
                            "default: the current CUDA device (fails "
                            "without one)")
        return s

    f = common(sub.add_parser("fit", help="maximum-likelihood fit"))
    f.add_argument("--pdf-defs", required=True)
    f.add_argument("--flow-defs", required=True)
    f.add_argument("--data", required=True)
    f.add_argument("--data-key")
    f.add_argument("--out", required=True, help="model output directory")
    f.add_argument("--steps", type=int, default=500)
    f.add_argument("--batch-size", type=int)
    f.add_argument("--lr", type=float, default=1e-2)
    f.add_argument("--schedule", choices=["cosine", "warmup_cosine"])
    f.add_argument("--clip-norm", type=float)
    f.add_argument("--dtype", default="float32")
    f.add_argument("--options", help="options_overwrite as JSON")
    f.add_argument("--no-data-init", action="store_true")
    f.set_defaults(fn=cmd_fit)

    s = common(sub.add_parser("sample", help="draw samples from a model"))
    s.add_argument("--model", required=True)
    s.add_argument("-n", type=int, default=10000)
    s.add_argument("--out", required=True)
    s.set_defaults(fn=cmd_sample)

    e = common(sub.add_parser("eval", help="mean NLL of a dataset"))
    e.add_argument("--model", required=True)
    e.add_argument("--data", required=True)
    e.add_argument("--data-key")
    e.set_defaults(fn=cmd_eval)

    m = common(sub.add_parser("moments", help="marginal moments"))
    m.add_argument("--model", required=True)
    m.add_argument("-n", type=int, default=2000)
    m.set_defaults(fn=cmd_moments)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
