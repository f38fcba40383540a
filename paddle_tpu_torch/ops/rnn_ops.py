"""The stacked RNN op (counterpart of paddle_tpu/ops/rnn_ops.py): simple,
LSTM and GRU recurrences, any number of layers, one or two directions,
as one function whose time loop is a Python loop over the cell step.

Weight layout per (layer, direction): ``weight_ih [G H, in]``,
``weight_hh [G H, H]``, ``bias_ih [G H]``, ``bias_hh [G H]`` with G = 1
(simple), 4 (LSTM, gates i, f, g, o) or 3 (GRU, gates r, z, c). The
GRU keeps ``bias_hh`` inside the reset product of its candidate, as
paddle does. Inter-layer dropout draws its masks from the installed
generator (`framework.random`).
"""

from __future__ import annotations

import torch

from ..framework import random as _random

__all__ = ["GATE_MULT", "cell_step", "rnn"]

GATE_MULT = {"RNN_TANH": 1, "RNN_RELU": 1, "LSTM": 4, "GRU": 3}


def cell_step(mode, xt, h, c, w_ih, w_hh, b_ih, b_hh):
    """One time step (the reference's `_cell_step`); xt [B, in], h and c
    [B, H]. Returns (h', c')."""
    if mode == "GRU":
        hidden = h @ w_hh.T + (b_hh if b_hh is not None else 0.0)
        x_part = xt @ w_ih.T + (b_ih if b_ih is not None else 0.0)
        xr, xz, xc = x_part.chunk(3, dim=-1)
        hr, hz, hc = hidden.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        cand = torch.tanh(xc + r * hc)
        return z * h + (1.0 - z) * cand, c
    gates = xt @ w_ih.T + h @ w_hh.T
    if b_ih is not None:
        gates = gates + b_ih
    if b_hh is not None:
        gates = gates + b_hh
    if mode == "LSTM":
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c_new = f * c + i * torch.tanh(g)
        return o * torch.tanh(c_new), c_new
    return (torch.tanh(gates) if mode == "RNN_TANH" else torch.relu(gates)), c


def rnn(x, init_h, init_c, *weights, mode, num_layers=1, is_bidirec=False,
        time_major=False, dropout=0.0, has_bias=True):
    """x [B, T, in] (or [T, B, in] when time_major); init_h / init_c
    [layers * dirs, B, H]. Returns (outputs, final_h, final_c)."""
    num_dirs = 2 if is_bidirec else 1
    per = 4 if has_bias else 2
    if len(weights) != num_layers * num_dirs * per:
        raise ValueError(f"rnn: expected {num_layers * num_dirs * per} "
                         f"weights, got {len(weights)}")
    xs = x if time_major else x.transpose(0, 1)
    final_h, final_c = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(num_dirs):
            li = layer * num_dirs + d
            ws = weights[li * per:(li + 1) * per]
            b_ih, b_hh = (ws[2], ws[3]) if has_bias else (None, None)
            h, c = init_h[li], init_c[li]
            ys = [None] * xs.shape[0]
            order = range(xs.shape[0] - 1, -1, -1) if d == 1 \
                else range(xs.shape[0])
            for t in order:
                h, c = cell_step(mode, xs[t], h, c, ws[0], ws[1], b_ih, b_hh)
                ys[t] = h
            outs.append(torch.stack(ys))
            final_h.append(h)
            final_c.append(c)
        xs = outs[0] if num_dirs == 1 else torch.cat(outs, dim=-1)
        if dropout > 0.0 and layer < num_layers - 1:
            keep = torch.empty(xs.shape, device=xs.device).bernoulli_(
                1.0 - dropout, generator=_random.generator_for(xs.device))
            xs = xs * keep.to(xs.dtype) / (1.0 - dropout)
    outputs = xs if time_major else xs.transpose(0, 1)
    return outputs, torch.stack(final_h), torch.stack(final_c)
