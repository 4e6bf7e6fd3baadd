"""AmortizableMLP: an MLP whose whole weight set is one flat vector.

PyTorch counterpart of ``jammy_flows_tpu/models/amortizable_mlp.py``: the
five highway modes (0: a plain chain of linear maps with tanh between them;
1: that chain plus a linear highway from the input; 2-4: one two-matrix
block per hidden layer, fed the input, the running sum or both, summed
with a linear highway) and per-matrix low-rank U V factors.  The packed
layout - per matrix [u (out*in) | v | bias], the blocks in order, the
linear highway last, so the final bias is last - and the numpy
initialization are identical, so a JAX ``mlp_<k>`` vector loads 1:1 and
``default_init`` reproduces JAX's values from the same seed.  Parameters
arrive as (Bp, num_params) with Bp in {1, B}: shared weights, or one weight
set per row (an amortized MLP).  The JAX package's ``precise_mlp_structure``
has no caller in either package and is not ported.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def list_from_str(s):
    if isinstance(s, int):
        return [s]
    if isinstance(s, (list, tuple)):
        return list(s)
    s = str(s).strip()
    if not s:
        return []
    return [int(tok) for tok in s.replace("-", " ").split()]


def _make_block(inputs, outputs, low_rank, add_final_bias, svd_mode):
    """Describe one chain of linear maps and its packed sizes."""
    num_u, num_v, num_b, full_flags, used_ranks = [], [], [], [], []
    total = 0
    n = len(inputs)
    for i in range(n):
        max_rank = min(inputs[i], outputs[i])
        lr = low_rank[i]
        if lr > 0:
            used_rank = min(max_rank, lr)
        else:
            used_rank = 0 if svd_mode == "naive" else max_rank
        used_ranks.append(used_rank)
        full_np = inputs[i] * outputs[i]
        use_low_rank = (lr > 0 and used_rank * (inputs[i] + outputs[i]) < full_np) \
            if svd_mode == "smart" else (svd_mode == "naive" and used_rank > 0)
        if use_low_rank:
            num_u.append(used_rank * outputs[i])
            num_v.append(used_rank * inputs[i])
            full_flags.append(False)
            total += num_u[-1] + num_v[-1]
        else:
            num_u.append(full_np)
            num_v.append(0)
            full_flags.append(True)
            total += full_np
        nb = outputs[i] if (i < n - 1 or add_final_bias) else 0
        num_b.append(nb)
        total += nb
    return dict(inputs=list(inputs), outputs=list(outputs), num_u=num_u,
                num_v=num_v, num_b=num_b, full_flags=full_flags,
                used_ranks=used_ranks, num_params=total)


def _matmat(w, rows, cols, tan):
    """tan @ W.T for K tangents tan (B, K, cols) of the packed (Bp, rows *
    cols) matrix W: (B, K, rows); one 2-D product for shared weights."""
    if w.shape[0] == 1:
        return torch.matmul(tan, w[0].view(rows, cols).T)
    return torch.bmm(tan, w.view(-1, rows, cols).transpose(1, 2))


def _matvec(w, rows, cols, vec):
    """vec @ W.T for the packed (Bp, rows * cols) matrix W: one 2-D product
    for shared weights, a batched product on a (B, rows, cols) view of the
    slab's columns for per-row ones (no copy of the slab)."""
    if w.shape[0] == 1:
        return torch.matmul(vec, w[0].view(rows, cols).T)
    return torch.bmm(w.view(-1, rows, cols), vec[:, :, None])[:, :, 0]


class AmortizableMLP:
    """Static MLP configuration; parameters always arrive packed."""

    def __init__(self, input_dim, hidden_dims, output_dim, highway_mode=0,
                 low_rank_approximations=0, svd_mode="smart"):
        if highway_mode not in (0, 1, 2, 3, 4):
            raise ValueError(f"highway_mode {highway_mode} is not 0-4")
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.highway_mode = highway_mode
        hidden = list_from_str(hidden_dims)
        self.hidden_dims = hidden
        n_mat = {0: len(hidden) + 1, 1: len(hidden) + 2}.get(
            highway_mode, 2 * len(hidden) + 1)
        if isinstance(low_rank_approximations, int):
            ranks = [low_rank_approximations] * n_mat
        elif isinstance(low_rank_approximations, str):
            ranks = list_from_str(low_rank_approximations)
        else:
            ranks = list(low_rank_approximations)
        if len(ranks) != n_mat:
            raise ValueError(f"{len(ranks)} ranks for {n_mat} matrices")
        self.mlp_list = []
        self.linear_highway = None
        if highway_mode < 2:
            ins, outs = [input_dim] + hidden, hidden + [output_dim]
            if highway_mode == 0:
                self.mlp_list.append(_make_block(ins, outs, ranks, True,
                                                 svd_mode))
            else:
                if hidden:
                    self.mlp_list.append(_make_block(ins, outs, ranks[:-1],
                                                     False, svd_mode))
                self.linear_highway = _make_block(
                    [input_dim], [output_dim], ranks[-1:], True, svd_mode)
        else:
            mlp_start = {2: input_dim, 3: output_dim,
                         4: input_dim + output_dim}[highway_mode]
            for i, h in enumerate(hidden):
                self.mlp_list.append(_make_block(
                    [input_dim if i == 0 else mlp_start, h], [h, output_dim],
                    ranks[2 * i:2 * i + 2], False, svd_mode))
            self.linear_highway = _make_block(
                [input_dim], [output_dim], ranks[-1:], True, svd_mode)
        self.blocks = self.mlp_list + ([self.linear_highway]
                                       if self.linear_highway else [])
        self.num_params = sum(b["num_params"] for b in self.blocks)
        # every packed piece's width, in packing order: one split of the
        # flat parameters gives them all (its backward is one concatenation,
        # where a slice per piece would make a slab-sized gradient each)
        self._sizes = [n for b in self.blocks
                       for i in range(len(b["inputs"]))
                       for n in (b["num_u"][i], b["num_v"][i], b["num_b"][i])]

    @property
    def block(self):
        """The one block of a highway-mode-0 MLP."""
        return self.mlp_list[0]

    @staticmethod
    def _apply_block(block, x, pieces):
        """Run one chain of (optionally low-rank) linear maps on the next
        [u, v, b] pieces of ``pieces`` (an iterator of (Bp, n) tensors)."""
        prev = x
        n = len(block["inputs"])
        for i in range(n):
            u, v, b = next(pieces), next(pieces), next(pieces)
            out_d, in_d = block["outputs"][i], block["inputs"][i]
            if block["full_flags"][i]:
                out = _matvec(u, out_d, in_d, prev)
            else:
                r = block["used_ranks"][i]
                out = _matvec(u, out_d, r, _matvec(v, r, in_d, prev))
            if b.shape[1]:
                out = out + b
            prev = out if i == n - 1 else torch.tanh(out)
        return prev

    def apply(self, flat_params, x):
        """flat_params: (num_params,) or (Bp, num_params), Bp in {1, B};
        x: (B, In)."""
        if flat_params.ndim == 1:
            flat_params = flat_params[None, :]
        if flat_params.shape[1] != self.num_params or \
                flat_params.shape[0] not in (1, x.shape[0]):
            raise ValueError(f"MLP parameters of shape {tuple(flat_params.shape)}"
                             f" for {x.shape[0]} rows, expected (1 or "
                             f"{x.shape[0]}, {self.num_params})")
        pieces = torch.split(flat_params, self._sizes, dim=1)
        n_lin = 3 * len(self.linear_highway["inputs"]) \
            if self.linear_highway is not None else 0
        out = None
        if n_lin:
            out = self._apply_block(self.linear_highway, x,
                                    iter(pieces[len(pieces) - n_lin:]))
        head = iter(pieces[:len(pieces) - n_lin])
        for j, block in enumerate(self.mlp_list):
            feed = x if j == 0 else {2: x, 3: out, 4: torch.cat(
                [x, out], dim=1)}[self.highway_mode]
            nonlinear = self._apply_block(block, feed, head)
            out = nonlinear if out is None else out + nonlinear
        return out

    __call__ = apply

    @staticmethod
    def _apply_block_jvp(block, x, tan, pieces):
        """_apply_block with tangents tan (B, K, In) carried beside x."""
        prev, prev_t = x, tan
        n = len(block["inputs"])
        for i in range(n):
            u, v, b = next(pieces), next(pieces), next(pieces)
            out_d, in_d = block["outputs"][i], block["inputs"][i]
            if block["full_flags"][i]:
                out = _matvec(u, out_d, in_d, prev)
                out_t = _matmat(u, out_d, in_d, prev_t)
            else:
                r = block["used_ranks"][i]
                out = _matvec(u, out_d, r, _matvec(v, r, in_d, prev))
                out_t = _matmat(u, out_d, r, _matmat(v, r, in_d, prev_t))
            if b.shape[1]:
                out = out + b
            if i == n - 1:
                prev, prev_t = out, out_t
            else:
                prev = torch.tanh(out)
                prev_t = (1.0 - prev * prev)[:, None, :] * out_t
        return prev, prev_t

    def apply_jvp(self, flat_params, x, tan):
        """(apply(flat_params, x), its directional derivatives along the
        K input tangents tan (B, K, In): (B, K, Out)), forward mode by
        hand."""
        if flat_params.ndim == 1:
            flat_params = flat_params[None, :]
        pieces = torch.split(flat_params, self._sizes, dim=1)
        n_lin = 3 * len(self.linear_highway["inputs"]) \
            if self.linear_highway is not None else 0
        out = out_t = None
        if n_lin:
            out, out_t = self._apply_block_jvp(
                self.linear_highway, x, tan, iter(pieces[len(pieces) - n_lin:]))
        head = iter(pieces[:len(pieces) - n_lin])
        for j, block in enumerate(self.mlp_list):
            if j == 0 or self.highway_mode == 2:
                feed, feed_t = x, tan
            elif self.highway_mode == 3:
                feed, feed_t = out, out_t
            else:
                feed = torch.cat([x, out], dim=1)
                feed_t = torch.cat([tan, out_t], dim=2)
            y, y_t = self._apply_block_jvp(block, feed, feed_t, head)
            out, out_t = (y, y_t) if out is None else (out + y, out_t + y_t)
        return out, out_t

    def supports_penultimate(self):
        """True when ``apply`` factorizes as ``hidden(x) @ w.T + b`` with a
        full-rank final matrix and a final bias: the per-layer kernels' lazy
        interface then runs the final product itself
        (``amortizable_mlp.py:237-254`` of the JAX package).  False for
        every highway mode but 0: such an MLP takes the materialized route."""
        return (self.highway_mode == 0 and self.block["full_flags"][-1]
                and self.block["num_b"][-1] > 0)

    def supports_full_fusion(self):
        """True for a plain one-hidden-layer full-rank tanh MLP with both
        biases: the whole-block kernel then runs both matmuls itself."""
        if self.highway_mode != 0:
            return False
        blk = self.block
        return (len(blk["inputs"]) == 2 and all(blk["full_flags"])
                and blk["num_b"][0] > 0 and blk["num_b"][-1] > 0)

    def apply_penultimate(self, flat_params, x):
        """hidden (B, H) with ``apply(flat_params, x) == hidden @ w.T + b``
        for (w, b) = :meth:`final_layer_weights`: every map but the last,
        as ``torch.matmul`` (the JAX package leaves it to XLA); x itself when
        the MLP has no hidden layer."""
        if flat_params.ndim == 1:
            flat_params = flat_params[None, :]
        blk = self.block
        n = len(blk["inputs"])
        if n == 1:
            return x
        sub = {key: (val[:-1] if isinstance(val, list) else val)
               for key, val in blk.items()}
        pieces = torch.split(flat_params, self._sizes[:3 * (n - 1)] + [
            self.num_params - sum(self._sizes[:3 * (n - 1)])], dim=1)
        return torch.tanh(self._apply_block(sub, x, iter(pieces)))

    def first_layer_weights(self, flat_params):
        """(w1 (H, In), b1 (H,)) with hidden = tanh(x @ w1.T + b1)."""
        if flat_params.ndim == 2:
            flat_params = flat_params[0]
        nu0, nb0 = self.block["num_u"][0], self.block["num_b"][0]
        w1 = flat_params[:nu0].reshape(self.block["outputs"][0],
                                       self.block["inputs"][0])
        return w1, flat_params[nu0:nu0 + nb0]

    def final_layer_weights(self, flat_params):
        """(w (P, H), b (P,)) with output = hidden @ w.T + b."""
        if flat_params.ndim == 2:
            flat_params = flat_params[0]
        nu, nb = self.block["num_u"][-1], self.block["num_b"][-1]
        w = flat_params[self.num_params - nu - nb:self.num_params - nb]
        return (w.reshape(self.block["outputs"][-1], self.block["inputs"][-1]),
                flat_params[self.num_params - nb:])

    def fused_grads_to_flat(self, gw1, gb1, gw, gb):
        """The fused kernel's (gw1 (H, In), gb1 (H,), gw (P, H), gb (P,))
        as one gradient of the packed flat vector: a one-hidden-layer
        highway-0 MLP packs [w1, b1, w, b] (as ``pdf.py:869-876``)."""
        if not self.supports_full_fusion():
            raise ValueError("only a one-hidden-layer full-rank MLP with "
                             "both biases has fused-kernel gradients")
        flat = torch.cat([gw1.reshape(-1), gb1, gw.reshape(-1), gb])
        if flat.numel() != self.num_params:
            raise ValueError(f"{flat.numel()} gradient entries for "
                             f"{self.num_params} parameters")
        return flat

    def default_init(self, rng=None, fix_final_bias=None,
                     prev_damping_factor=1000.0):
        """Packed init vector: kaiming-uniform full matrices, randn low-rank
        factors, uniform biases; optionally pin the final bias and damp all
        upstream parameters."""
        rng = rng or np.random.default_rng(0)
        init = rng.standard_normal(self.num_params)
        idx = 0
        for block in self.blocks:
            for i in range(len(block["inputs"])):
                nu, nv, nb = (block["num_u"][i], block["num_v"][i],
                              block["num_b"][i])
                if block["full_flags"][i]:
                    fan_in = block["inputs"][i]
                    gain = math.sqrt(2.0 / (1.0 + 5.0))
                    bound = math.sqrt(3.0) * gain / math.sqrt(fan_in)
                    init[idx:idx + nu] = rng.uniform(-bound, bound, nu)
                    if nb > 0:
                        bb = 1.0 / math.sqrt(fan_in)
                        init[idx + nu + nv:idx + nu + nv + nb] = rng.uniform(
                            -bb, bb, nb)
                idx += nu + nv + nb
        if fix_final_bias is not None:
            init = init / prev_damping_factor
            nb_final = self.blocks[-1]["num_b"][-1]
            if nb_final != len(fix_final_bias):
                raise ValueError((nb_final, len(fix_final_bias)))
            init[-nb_final:] = np.asarray(fix_final_bias)
        return init
