"""The RNN layers (port of paddle_tpu/nn/layer/rnn.py): SimpleRNN, LSTM
and GRU, their cells, and the generic RNN and BiRNN wrappers.

The gate orders are torch's, as the reference's are: LSTM (i, f, g, o),
c' = f c + i g, h' = o tanh(c'); GRU (r, z, n), n = tanh(W_in x + b_in +
r (W_hn h + b_hn)), h' = (1 - z) n + z h. So ``SimpleRNN``, ``LSTM`` and
``GRU`` run the port's own parameters through torch's fused RNN op
(cuDNN on the card), one call per layer with both directions in it: the
dropout between layers (only in training with ``num_layers > 1``) is then
``F.dropout`` drawing from the layer's generator, as the reference draws
from its key, and not cuDNN's own dropout state. The cells and the
``RNN``/``BiRNN`` wrappers are loops over the steps, as in the
reference.

Parameters are ``weight_ih_l{k}``, ``weight_hh_l{k}``, ``bias_ih_l{k}``
and ``bias_hh_l{k}`` (``_reverse`` for the backward direction), all
drawn from U(-1/sqrt(H), 1/sqrt(H)), so state dicts cross unchanged.
Default initial states are zeros of the input's dtype. ``direction`` is
"forward", "bidirect" or "bidirectional". The reference never reads
``sequence_length`` (padded steps update the state there): passing one
raises (ROADMAP C-ref-17).
"""
from __future__ import annotations

import math

import torch

from ...amp.auto_cast import amp_cast
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "SimpleRNN", "LSTM",
           "GRU", "BiRNN", "RNNCellBase"]


def _refuse_sequence_length(sequence_length):
    if sequence_length is not None:
        raise NotImplementedError(
            "sequence_length: the reference never reads it, so its padded "
            "steps update the state; the port refuses it rather than "
            "diverge (ROADMAP C-ref-17). Run unpadded batches, or mask the "
            "outputs and pick the states at each length yourself")


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """States of ``init_value`` for the batch of ``batch_ref``: one
        tensor of [batch] + shape, or a tuple of them when ``shape`` (by
        default the cell's ``state_shape``) is a sequence of shapes."""
        b = batch_ref.shape[batch_dim_idx]
        state_shape = shape or self.state_shape
        dtype = dtype or batch_ref.dtype

        def full(s):
            return torch.full([b] + list(s), init_value, dtype=dtype,
                              device=batch_ref.device)
        if isinstance(state_shape[0], (list, tuple)):
            return tuple(full(s) for s in state_shape)
        return full(state_shape)


class _Cell(RNNCellBase):
    """A cell's four parameters, (gates * H, in), (gates * H, H) and two
    (gates * H,) biases, from U(-1/sqrt(H), 1/sqrt(H))."""

    def __init__(self, gates, input_size, hidden_size, weight_ih_attr,
                 weight_hh_attr, bias_ih_attr, bias_hh_attr, **factory):
        super().__init__(**factory)
        self.input_size = input_size
        self.hidden_size = hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        init = I.Uniform(-std, std)
        g = gates * hidden_size
        self.weight_ih = self.create_parameter(
            [g, input_size], weight_ih_attr, default_initializer=init)
        self.weight_hh = self.create_parameter(
            [g, hidden_size], weight_hh_attr, default_initializer=init)
        self.bias_ih = self.create_parameter(
            [g], bias_ih_attr, is_bias=True, default_initializer=init)
        self.bias_hh = self.create_parameter(
            [g], bias_hh_attr, is_bias=True, default_initializer=init)

    def _params(self, name, *tensors):
        return amp_cast(name, *tensors, self.weight_ih, self.weight_hh,
                        self.bias_ih, self.bias_hh)


class SimpleRNNCell(_Cell):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, **factory):
        super().__init__(1, input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr,
                         **factory)
        self.activation = activation

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        x, h, wi, wh, bi, bh = self._params("simple_rnn_cell", inputs,
                                            states)
        pre = x @ wi.T + h @ wh.T + bi + bh
        h = torch.tanh(pre) if self.activation == "tanh" else torch.relu(pre)
        return h, h


class LSTMCell(_Cell):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, **factory):
        super().__init__(4, input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr,
                         **factory)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        x, h, c, wi, wh, bi, bh = self._params("lstm_cell", inputs, *states)
        i, f, g, o = (x @ wi.T + h @ wh.T + bi + bh).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)


class GRUCell(_Cell):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, **factory):
        super().__init__(3, input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr,
                         **factory)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        x, h, wi, wh, bi, bh = self._params("gru_cell", inputs, states)
        xr, xz, xn = (x @ wi.T + bi).chunk(3, dim=-1)
        hr, hz, hn = (h @ wh.T + bh).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1 - z) * n + z * h
        return h, h


class RNN(Layer):
    """Runs ``cell`` over the time axis of ``inputs`` (axis 1, or 0 when
    ``time_major``), step by step; returns (outputs stacked on that axis,
    the final states)."""

    def __init__(self, cell, is_reverse=False, time_major=False, **factory):
        super().__init__(**factory)
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        _refuse_sequence_length(sequence_length)
        axis = 0 if self.time_major else 1
        steps = inputs.unbind(axis)
        if self.is_reverse:
            steps = steps[::-1]
        states = initial_states
        outs = []
        for x_t in steps:
            if states is None:
                out, states = self.cell(x_t)
            else:
                out, states = self.cell(x_t, states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return torch.stack(outs, dim=axis), states


class BiRNN(Layer):
    """``cell_fw`` forward and ``cell_bw`` backward in time; outputs
    concatenated on the last axis, states as (forward's, backward's)."""

    def __init__(self, cell_fw, cell_bw, time_major=False, **factory):
        super().__init__(**factory)
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        _refuse_sequence_length(sequence_length)
        st_fw, st_bw = (initial_states if initial_states is not None
                        else (None, None))
        out_fw, s_fw = self.rnn_fw(inputs, st_fw)
        out_bw, s_bw = self.rnn_bw(inputs, st_bw)
        return torch.cat([out_fw, out_bw], dim=-1), (s_fw, s_bw)


_FUSED = {"LSTM": torch._VF.lstm, "GRU": torch._VF.gru,
          "RNN_TANH": torch._VF.rnn_tanh, "RNN_RELU": torch._VF.rnn_relu}
_GATES = {"LSTM": 4, "GRU": 3, "RNN": 1}


class _RNNBase(Layer):
    """A multi-layer, one- or two-directional SimpleRNN/LSTM/GRU."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, **factory):
        super().__init__(**factory)
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"direction must be 'forward', 'bidirect' or "
                             f"'bidirectional', got {direction!r}")
        if activation not in ("tanh", "relu"):
            raise ValueError(f"activation must be 'tanh' or 'relu', got "
                             f"{activation!r}")
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        self.bidirect = 2 if direction != "forward" else 1
        g = _GATES[mode] * hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        init = I.Uniform(-std, std)
        self._all_weights = []
        for layer in range(num_layers):
            for d in range(self.bidirect):
                in_sz = input_size if layer == 0 \
                    else hidden_size * self.bidirect
                suffix = "_reverse" if d == 1 else ""
                group = (
                    self.create_parameter([g, in_sz], weight_ih_attr,
                                          default_initializer=init),
                    self.create_parameter([g, hidden_size], weight_hh_attr,
                                          default_initializer=init),
                    self.create_parameter([g], bias_ih_attr, is_bias=True,
                                          default_initializer=init),
                    self.create_parameter([g], bias_hh_attr, is_bias=True,
                                          default_initializer=init))
                for kind, p in zip(("weight_ih", "weight_hh", "bias_ih",
                                    "bias_hh"), group):
                    self.add_parameter(f"{kind}_l{layer}{suffix}", p)
                self._all_weights.append(group)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        _refuse_sequence_length(sequence_length)
        is_lstm = self.mode == "LSTM"
        nl, nd, hsz = self.num_layers, self.bidirect, self.hidden_size
        b = inputs.shape[1 if self.time_major else 0]
        if initial_states is None:
            zeros = inputs.new_zeros((nl * nd, b, hsz))
            initial_states = (zeros, zeros) if is_lstm else zeros
        states = initial_states if is_lstm else (initial_states,)
        flat = [w for group in self._all_weights for w in group]
        x, *rest = amp_cast(self.mode, inputs, *states, *flat)
        states, flat = rest[:len(states)], rest[len(states):]
        fused = _FUSED[self.mode if self.mode != "RNN"
                       else f"RNN_{self.activation.upper()}"]
        finals = [[] for _ in states]
        for layer in range(nl):
            rows = slice(layer * nd, (layer + 1) * nd)
            hx = [s[rows] for s in states]
            weights = flat[4 * nd * layer:4 * nd * (layer + 1)]
            res = fused(x, tuple(hx) if is_lstm else hx[0], weights, True,
                        1, 0.0, self.training, nd == 2, not self.time_major)
            x = res[0]
            for into, s in zip(finals, res[1:]):
                into.append(s)
            if self.dropout > 0 and self.training and layer < nl - 1:
                x = F.dropout(x, self.dropout, training=True,
                              generator=self._generator)
        finals = [torch.cat(f, dim=0) for f in finals]
        return x, (tuple(finals) if is_lstm else finals[0])


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        super().__init__("RNN", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation,
                         **kwargs)


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
