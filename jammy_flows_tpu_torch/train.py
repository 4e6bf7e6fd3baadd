"""The trainer: full-batch or minibatch NLL fitting with checkpoints.

PyTorch counterpart of ``jammy_flows_tpu/train.py``: ``torch.optim.Adam``
(optax's defaults: betas 0.9 / 0.999, eps 1e-8) on a constant, ``cosine`` or
``warmup_cosine`` learning-rate schedule written out as optax defines them,
optional global-norm clipping as ``optax.clip_by_global_norm`` does it, or
any ``torch.optim`` optimizer the caller makes; each step's gradient from
``PDF.nll_value_and_grad`` (the fused NLL kernels on the card); the
parameters saved (utils/checkpoint.py) after every ``checkpoint_every``
steps.  Minibatch rows come from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .utils import checkpoint as ckpt


def learning_rate_at(step, learning_rate=1e-3, schedule=None,
                     num_steps=None):
    """The learning rate of update ``step`` (0-based), as optax's schedule
    gives it: constant; ``cosine`` = cosine_decay_schedule(lr, num_steps);
    ``warmup_cosine`` = warmup_cosine_decay_schedule(0, lr,
    max(1, num_steps // 20), num_steps), decaying to 0."""
    if schedule is None:
        return learning_rate
    if not num_steps:
        raise ValueError(f"{schedule} schedule needs num_steps")
    if schedule == "cosine":
        t = min(step, num_steps)
        return learning_rate * 0.5 * (1.0 + math.cos(math.pi * t / num_steps))
    if schedule == "warmup_cosine":
        warm = max(1, num_steps // 20)
        if step < warm:
            return learning_rate * step / warm
        decay = num_steps - warm
        t = min(step - warm, decay)
        return learning_rate * 0.5 * (1.0 + math.cos(math.pi * t / decay))
    raise ValueError(f"unknown schedule {schedule!r}")


def make_optimizer(params, learning_rate=1e-3):
    """torch.optim.Adam over the parameter tensors (a dict), with optax's
    defaults."""
    return torch.optim.Adam(list(params.values()), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def clip_by_global_norm(grads, max_norm):
    """optax.clip_by_global_norm: every gradient scaled by max_norm / g_norm
    when the global norm g_norm is not below max_norm."""
    g_norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    if bool(g_norm < max_norm):
        return grads
    return {k: (g / g_norm) * max_norm for k, g in grads.items()}


def fit(pdf_obj, params, data, conditional_input=None, num_steps=1000,
        batch_size=None, learning_rate=1e-3, schedule=None, clip_norm=None,
        optimizer=None, generator=None, checkpoint_path=None,
        checkpoint_every=None, verbose=False):
    """Maximum-likelihood fit.  Returns (params, loss history as a numpy
    array); the input ``params`` are not modified.

    data: (N, total_target_dim) on the pdf's device; conditional_input:
    (N, c), a list of one (N, c_k) per sub-pdf (a list-valued
    conditional_input_dim), or None.  batch_size: minibatch rows drawn each
    step with ``generator`` (None = full batch).  optimizer: the port's
    counterpart of an optax transformation, a callable that takes the list
    of parameter tensors and returns a ``torch.optim.Optimizer`` (e.g.
    ``lambda ps: torch.optim.SGD(ps, lr=1e-2)``); when given,
    learning_rate / schedule / clip_norm are ignored, as the JAX package's
    make_optimizer returns it unchanged.  checkpoint_path: the parameters
    are saved to ``{checkpoint_path}/step_{done:08d}`` after every
    ``checkpoint_every`` steps and after the last (only after the last
    without checkpoint_every), as the JAX package saves after each of its
    chunks."""
    data = pdf_obj._input(data, "data")
    ci_all = pdf_obj._conditional(conditional_input)
    params = {k: v.detach().clone().requires_grad_() for k, v in
              params.items()}
    if optimizer is not None:
        opt = optimizer(list(params.values()))
    else:
        opt = make_optimizer(params, learning_rate)
    chunk = checkpoint_every or num_steps
    history = []
    for step in range(num_steps):
        if batch_size is not None:
            idx = torch.randint(0, data.shape[0], (batch_size,),
                                generator=generator, device=data.device)
            x = data[idx]
            ci = None if ci_all is None else [c[idx] for c in ci_all] \
                if isinstance(ci_all, list) else ci_all[idx]
        else:
            x, ci = data, ci_all
        loss, grads = pdf_obj.nll_value_and_grad(params, x,
                                                 conditional_input=ci)
        if optimizer is None:
            if clip_norm is not None:
                grads = clip_by_global_norm(grads, clip_norm)
            for group in opt.param_groups:
                group["lr"] = learning_rate_at(step, learning_rate, schedule,
                                               num_steps)
        for key, p in params.items():
            p.grad = grads[key]
        opt.step()
        history.append(loss.detach())
        done = step + 1
        if verbose:
            print(f"step {done}/{num_steps}: NLL {float(loss):.4f}",
                  flush=True)
        if checkpoint_path is not None and (done % chunk == 0
                                            or done == num_steps):
            ckpt.save(f"{checkpoint_path}/step_{done:08d}", params)
    losses = torch.stack(history).cpu().numpy() if history \
        else np.zeros(0)
    return {k: v.detach() for k, v in params.items()}, losses
