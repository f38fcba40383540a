"""Recurrent layers (ref paddle_tpu/nn/layer/rnn.py): the cells,
`RNN` / `BiRNN` over a cell, and the stacked `SimpleRNN` / `LSTM` /
`GRU` over `ops.rnn_ops.rnn`.

Parameter names and shapes are the reference's: a cell holds
``weight_ih [G H, in]``, ``weight_hh [G H, H]``, ``bias_ih [G H]`` and
``bias_hh [G H]``; a stacked layer ``weight_ih_l{k}`` ... with a
``_reverse`` suffix for the backward direction; all drawn U(-1/sqrt(H),
1/sqrt(H)). `BiRNN`'s state names are ``cell_fw.*`` / ``cell_bw.*``
only (its two `RNN` wrappers hold no state of their own). Initial
states default to float32 zeros. Inter-layer dropout applies in
training only.
"""

from __future__ import annotations

import math

import torch

from ... import amp
from ...ops import rnn_ops
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]


# the cells' Tensor operators and methods, each cast under the op name
# the reference dispatches (amp O2; the identity under O1 and amp off)
def _add(x, y):
    return amp.binary("elementwise_add", x, y)


def _mul(x, y):
    return amp.binary("elementwise_mul", x, y)


def _split(x, n):
    (x,) = amp.cast("split", x)
    return x.chunk(n, dim=-1)


def _t(w):
    (w,) = amp.cast("transpose", w)
    return w.t()


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0):
        """float32 states of `shape` (the cell's `state_shape` by
        default) for the batch of `batch_ref`, on its device."""
        batch = batch_ref.shape[0]
        shapes = shape if shape is not None else self.state_shape

        def full(s):
            return torch.full((batch,) + tuple(s), float(init_value),
                              dtype=torch.float32, device=batch_ref.device)

        if isinstance(shapes, tuple) and isinstance(shapes[0], (tuple, list)):
            return tuple(full(s) for s in shapes)
        return full(shapes)


class _Cell(RNNCellBase):
    _gates = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 generator=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        u = I.Uniform(-std, std)
        g = self._gates * hidden_size
        self.weight_ih = self.create_parameter(
            [g, input_size], weight_ih_attr, default_initializer=u,
            generator=generator)
        self.weight_hh = self.create_parameter(
            [g, hidden_size], weight_hh_attr, default_initializer=u,
            generator=generator)
        self.bias_ih = self.create_parameter(
            [g], bias_ih_attr, is_bias=True, default_initializer=u,
            generator=generator)
        self.bias_hh = self.create_parameter(
            [g], bias_hh_attr, is_bias=True, default_initializer=u,
            generator=generator)

    def _gates_of(self, inputs, pre_h):
        x = F.linear(inputs, _t(self.weight_ih))
        if self.bias_ih is not None:
            x = _add(x, self.bias_ih)
        h = F.linear(pre_h, _t(self.weight_hh))
        if self.bias_hh is not None:
            h = _add(h, self.bias_hh)
        return x, h


class SimpleRNNCell(_Cell):
    """h' = act(x W_ih^T + b_ih + h W_hh^T + b_hh), act tanh or relu."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, generator=None):
        if activation not in ("tanh", "relu"):
            raise ValueError("activation must be 'tanh' or 'relu'")
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr,
                         generator)
        self.activation = activation

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        x, h = self._gates_of(inputs, states)
        gates = _add(x, h)
        out = F.tanh(gates) if self.activation == "tanh" else F.relu(gates)
        return out, out


class LSTMCell(_Cell):
    """Gates i, f, g, o: c' = f c + i tanh(g), h' = o tanh(c')."""
    _gates = 4

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, generator=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr,
                         generator)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        pre_h, pre_c = states
        x, h = self._gates_of(inputs, pre_h)
        i, f, g, o = _split(_add(x, h), 4)
        i, f, o = F.sigmoid(i), F.sigmoid(f), F.sigmoid(o)
        c = _add(_mul(f, pre_c), _mul(i, F.tanh(g)))
        h = _mul(o, F.tanh(c))
        return h, (h, c)


class GRUCell(_Cell):
    """Gates r, z, c: h' = z h + (1 - z) tanh(x_c + r (h W_hc + b_hc))."""
    _gates = 3

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, generator=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr,
                         generator)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        pre_h = states
        x, h = self._gates_of(inputs, pre_h)
        xr, xz, xc = _split(x, 3)
        hr, hz, hc = _split(h, 3)
        r = F.sigmoid(_add(xr, hr))
        z = F.sigmoid(_add(xz, hz))
        cand = F.tanh(_add(xc, _mul(r, hc)))
        h = _add(_mul(z, pre_h),
                 _mul(amp.binary("elementwise_sub", 1.0, z), cand))
        return h, h


class RNN(Layer):
    """Run `cell` over the time axis (1, or 0 when `time_major`),
    backwards when `is_reverse`; returns (outputs stacked on the time
    axis, final states)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, **kwargs):
        time_axis = 0 if self.time_major else 1
        steps = inputs.shape[time_axis]
        states = initial_states
        if states is None:
            batch_ref = inputs[0] if self.time_major else inputs
            states = self.cell.get_initial_states(batch_ref)
        outputs = [None] * steps
        order = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        for t in order:
            (x,) = amp.cast("getitem", inputs)
            xt = x[t] if self.time_major else x[:, t]
            outputs[t], states = self.cell(xt, states, **kwargs)
        return torch.stack(amp.cast("stack", *outputs), dim=time_axis), \
            states


class BiRNN(Layer):
    """A forward and a backward `RNN`, outputs concatenated on the last
    axis; returns (outputs, (forward states, backward states))."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        # not registered: the cells are, under the reference's names
        self.__dict__["rnn_fw"] = RNN(cell_fw, False, time_major)
        self.__dict__["rnn_bw"] = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, **kwargs):
        fw_states = bw_states = None
        if initial_states is not None:
            fw_states, bw_states = initial_states
        out_fw, st_fw = self.rnn_fw(inputs, fw_states, **kwargs)
        out_bw, st_bw = self.rnn_bw(inputs, bw_states, **kwargs)
        return torch.cat(amp.cast("concat", out_fw, out_bw), dim=-1), \
            (st_fw, st_bw)


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None,
                 generator=None):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"unknown direction {direction!r}")
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = float(dropout)
        self.num_directions = 2 if direction.startswith("bidirect") else 1
        gm = rnn_ops.GATE_MULT[mode]
        std = 1.0 / math.sqrt(hidden_size)
        u = I.Uniform(-std, std)
        self._weight_names = []
        for layer in range(num_layers):
            in_size = input_size if layer == 0 \
                else hidden_size * self.num_directions
            for d in range(self.num_directions):
                sfx = "_reverse" if d == 1 else ""
                names = [f"{kind}_l{layer}{sfx}" for kind in
                         ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
                shapes = [[gm * hidden_size, in_size],
                          [gm * hidden_size, hidden_size],
                          [gm * hidden_size], [gm * hidden_size]]
                attrs = [weight_ih_attr, weight_hh_attr, bias_ih_attr,
                         bias_hh_attr]
                for n, s, a in zip(names, shapes, attrs):
                    setattr(self, n, self.create_parameter(
                        s, a, is_bias=len(s) == 1, default_initializer=u,
                        generator=generator))
                self._weight_names.append(names)

    @property
    def state_shape(self):
        return (self.num_layers * self.num_directions, -1, self.hidden_size)

    def forward(self, inputs, initial_states=None):
        batch = inputs.shape[1 if self.time_major else 0]
        zeros = torch.zeros((self.num_layers * self.num_directions, batch,
                             self.hidden_size), dtype=torch.float32,
                            device=inputs.device)
        if self.mode == "LSTM":
            init_h, init_c = (zeros, zeros) if initial_states is None \
                else initial_states
        else:
            init_h = zeros if initial_states is None else initial_states
            init_c = zeros
        weights = [getattr(self, n) for names in self._weight_names
                   for n in names]
        # the fused op takes every floating input in the low dtype
        # under O2, as the reference's `rnn`
        inputs, init_h, init_c, *weights = amp.cast(
            "rnn", inputs, init_h, init_c, *weights)
        outputs, final_h, final_c = rnn_ops.rnn(
            inputs, init_h, init_c, *weights, mode=self.mode,
            num_layers=self.num_layers,
            is_bidirec=self.num_directions == 2, time_major=self.time_major,
            dropout=self.dropout if self.training else 0.0)
        if self.mode == "LSTM":
            return outputs, (final_h, final_c)
        return outputs, final_h

    def extra_repr(self):
        return (f"{self.input_size}, {self.hidden_size}, "
                f"num_layers={self.num_layers}")


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)
