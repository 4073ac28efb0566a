"""Recurrent layers: the port of ``paddle_tpu/nn/rnn.py`` (``SimpleRNNCell``,
``LSTMCell``, ``GRUCell``, the ``RNN`` / ``BiRNN`` wrappers and the stacked
``SimpleRNN`` / ``LSTM`` / ``GRU``).

The JAX layout and state-dict keys are kept, so ``convert.load_jax_state``
carries weights across unchanged: ``weight_ih`` is (in, G H) and
``weight_hh`` (H, G H), with two biases ``bias_ih`` / ``bias_hh`` of G H,
every one ``Uniform(-1 / sqrt(H), 1 / sqrt(H))``; the stacked layers keep
their cells in ``cells`` (``cells.0.weight_ih``, ..., forward and backward
cells alternating when bidirectional).  Gate orders: LSTM i, f, g, o; GRU
r, z, c with the candidate ``tanh(x W_c + b_c + r (h W_hc + b_hc))``.

The time loop is a Python loop over the steps (the JAX package's
``lax.scan``): the input projection of every step is one matmul before
it (``project_inputs``), and each step's body is the (B, H) x (H, G H)
product and the gates as a few elementwise ops on views of one (B, G H)
tensor, plus the ``sequence_length`` masks when lengths are given.  A
cell is any module with ``project_inputs(x)``, ``step(xproj, state)`` and
``get_initial_states(batch_size, dtype)``; a state is a tensor or a tuple
of tensors.  With ``sequence_length`` a step at or past a row's length
passes that row's state through and outputs zeros; the reverse direction
runs over the flipped padded sequence, so a short row starts reversing at
its last real step.  Stacked layers apply dropout between layers in
training, drawn from the device's stream of ``framework/random.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..framework.errors import enforce
from . import functional as F
from . import initializer as I

__all__ = ["SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "BiRNN",
           "SimpleRNN", "LSTM", "GRU"]


class RNNCellBase(nn.Module):
    """A gate-fused single-step cell; ``gates`` is the multiple of the
    hidden width its products have.  Runs on ``cuda`` unless
    ``device="cpu"``."""

    gates = 1

    def __init__(self, input_size: int, hidden_size: int,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None,
                 device: Optional[torch.device] = None):
        super().__init__()
        dev = resolve_device(device)
        self.input_size, self.hidden_size = input_size, hidden_size
        g = self.gates
        std = 1.0 / math.sqrt(hidden_size)
        init = I.Uniform(-std, std)
        self.weight_ih = I.create_parameter(
            (input_size, g * hidden_size), default_initializer=init,
            attr=weight_ih_attr, device=dev)
        self.weight_hh = I.create_parameter(
            (hidden_size, g * hidden_size), default_initializer=init,
            attr=weight_hh_attr, device=dev)
        self.bias_ih = None if bias_ih_attr is False else \
            I.create_parameter((g * hidden_size,), default_initializer=init,
                               is_bias=True, attr=bias_ih_attr, device=dev)
        self.bias_hh = None if bias_hh_attr is False else \
            I.create_parameter((g * hidden_size,), default_initializer=init,
                               is_bias=True, attr=bias_hh_attr, device=dev)

    def project_inputs(self, x):
        """The input side of every gate, hoistable across time: ``x W_ih +
        b_ih``."""
        y = x @ self.weight_ih
        return y if self.bias_ih is None else y + self.bias_ih

    def _hidden(self, xproj, h):
        """``xproj + h W_hh + b_hh``."""
        z = torch.addmm(xproj, h, self.weight_hh)
        return z if self.bias_hh is None else z + self.bias_hh

    def get_initial_states(self, batch_size: int, dtype=torch.float32):
        """A zero state on the cell's device; tuple-state cells (LSTM, a
        user's) return a tuple, and the wrappers key off that structure,
        never off the cell's class."""
        return torch.zeros((batch_size, self.hidden_size), dtype=dtype,
                           device=self.weight_hh.device)


class SimpleRNNCell(RNNCellBase):
    """h' = act(x W_ih + b_ih + h W_hh + b_hh), act tanh or relu."""

    gates = 1

    def __init__(self, input_size: int, hidden_size: int,
                 activation: str = "tanh", **kw):
        enforce(activation in ("tanh", "relu"),
                "SimpleRNNCell activation must be tanh or relu")
        super().__init__(input_size, hidden_size, **kw)
        self.activation = activation

    def step(self, xproj, h):
        z = self._hidden(xproj, h)
        return torch.tanh(z) if self.activation == "tanh" else F.relu(z)

    def forward(self, inputs, states=None):
        h = self.get_initial_states(inputs.shape[0], inputs.dtype) \
            if states is None else states
        h = self.step(self.project_inputs(inputs), h)
        return h, h


class LSTMCell(RNNCellBase):
    """Gates i, f, g, o: c' = f c + i tanh(g), h' = o tanh(c'); the
    sigmoid runs once over the whole (B, 4 H) product."""

    gates = 4

    def get_initial_states(self, batch_size: int, dtype=torch.float32):
        z = torch.zeros((batch_size, self.hidden_size), dtype=dtype,
                        device=self.weight_hh.device)
        return (z, z)

    def step(self, xproj, state):
        h, c = state
        z = self._hidden(xproj, h)
        hs = self.hidden_size
        s = torch.sigmoid(z)
        g = torch.tanh(z[:, 2 * hs:3 * hs])
        c = torch.addcmul(s[:, hs:2 * hs] * c, s[:, :hs], g)
        h = s[:, 3 * hs:] * torch.tanh(c)
        return h, c

    def forward(self, inputs, states=None):
        st = self.get_initial_states(inputs.shape[0], inputs.dtype) \
            if states is None else states
        h, c = self.step(self.project_inputs(inputs), st)
        return h, (h, c)


class GRUCell(RNNCellBase):
    """Gates r, z, c: r, z = sigmoid(x W + b + h W_h + b_h), c = tanh(x W_c
    + b_c + r (h W_hc + b_hc)), h' = (1 - z) c + z h."""

    gates = 3

    def step(self, xproj, h):
        hproj = torch.addmm(self.bias_hh, h, self.weight_hh) \
            if self.bias_hh is not None else h @ self.weight_hh
        hs2 = 2 * self.hidden_size
        rz = torch.sigmoid(xproj[:, :hs2] + hproj[:, :hs2])
        r, z = rz[:, :self.hidden_size], rz[:, self.hidden_size:]
        c = torch.tanh(torch.addcmul(xproj[:, hs2:], r, hproj[:, hs2:]))
        return torch.lerp(c, h, z)

    def forward(self, inputs, states=None):
        h = self.get_initial_states(inputs.shape[0], inputs.dtype) \
            if states is None else states
        h = self.step(self.project_inputs(inputs), h)
        return h, h


def _scan_layer(cell, x_tbf, init_state, seq_lens=None,
                reverse: bool = False):
    """One cell over time-major (T, B, F) inputs: ``(outputs (T, B, H),
    final state)``.  With ``seq_lens`` (B,) a step at t >= the row's
    length keeps that row's state and outputs zeros."""
    T, B = x_tbf.shape[0], x_tbf.shape[1]
    xproj = cell.project_inputs(x_tbf.reshape(T * B, -1)).reshape(T, B, -1)
    is_tuple = isinstance(init_state, tuple)
    keep = None
    if seq_lens is not None:
        lens = torch.as_tensor(seq_lens, device=xproj.device)
        keep = (torch.arange(T, device=xproj.device)[:, None]
                < lens[None, :])[..., None]          # (T, B, 1)
    state = init_state
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        new = cell.step(xproj[t], state)
        h = new[0] if is_tuple else new
        if keep is not None:
            k = keep[t]
            new = (tuple(torch.where(k, n, p) for n, p in zip(new, state))
                   if is_tuple else torch.where(k, h, state))
            h = torch.where(k, h, h.new_zeros(()))
        outs[t] = h
        state = new
    return torch.stack(outs), state


def _time_major(x, time_major: bool):
    return x if time_major else x.transpose(0, 1)


class RNN(nn.Module):
    """Any cell over a sequence: ``(outputs, final_state)``; inputs (B, T,
    F), or (T, B, F) with ``time_major``."""

    def __init__(self, cell, is_reverse: bool = False,
                 time_major: bool = False):
        super().__init__()
        self.cell = cell
        self.is_reverse, self.time_major = is_reverse, time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = _time_major(inputs, self.time_major)
        init = self.cell.get_initial_states(x.shape[1], x.dtype) \
            if initial_states is None else initial_states
        outs, final = _scan_layer(self.cell, x, init, sequence_length,
                                  self.is_reverse)
        return _time_major(outs, self.time_major), final


class BiRNN(nn.Module):
    """A forward and a backward cell over the sequence, outputs
    concatenated on the last dim; final states ``(fw, bw)``."""

    def __init__(self, cell_fw, cell_bw, time_major: bool = False):
        super().__init__()
        self.cell_fw, self.cell_bw = cell_fw, cell_bw
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = _time_major(inputs, self.time_major)
        b = x.shape[1]
        if initial_states is None:
            init_fw = self.cell_fw.get_initial_states(b, x.dtype)
            init_bw = self.cell_bw.get_initial_states(b, x.dtype)
        else:
            init_fw, init_bw = initial_states
        out_fw, fin_fw = _scan_layer(self.cell_fw, x, init_fw,
                                     sequence_length)
        out_bw, fin_bw = _scan_layer(self.cell_bw, x, init_bw,
                                     sequence_length, reverse=True)
        outs = torch.cat([out_fw, out_bw], dim=-1)
        return _time_major(outs, self.time_major), (fin_fw, fin_bw)


class _StackedRNN(nn.Module):
    """``num_layers`` x (forward, or forward and backward) cells with
    dropout between layers; ``(outputs, final states)``, the final states
    stacked (L D, B, H) (a pair of them for LSTM)."""

    cell_cls = SimpleRNNCell

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, direction: str = "forward",
                 time_major: bool = False, dropout: float = 0.0,
                 device: Optional[torch.device] = None, **cell_kw):
        super().__init__()
        enforce(direction in ("forward", "bidirect", "bidirectional"),
                f"unknown direction {direction!r}")
        dev = resolve_device(device)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers = num_layers
        self.bidirect = direction != "forward"
        self.time_major, self.dropout = time_major, dropout
        self.num_directions = 2 if self.bidirect else 1
        cells = []
        for layer in range(num_layers):
            in_size = input_size if layer == 0 \
                else hidden_size * self.num_directions
            for _ in range(self.num_directions):
                cells.append(self.cell_cls(in_size, hidden_size, device=dev,
                                           **cell_kw))
        self.cells = nn.ModuleList(cells)

    def _split_states(self, initial_states, b, dtype):
        n = self.num_layers * self.num_directions
        if initial_states is None:
            return [self.cells[i].get_initial_states(b, dtype)
                    for i in range(n)]
        if isinstance(self.cells[0].get_initial_states(1), tuple):
            h0, c0 = initial_states
            return [(h0[i], c0[i]) for i in range(n)]
        return [initial_states[i] for i in range(n)]

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = _time_major(inputs, self.time_major)
        states = self._split_states(initial_states, x.shape[1], x.dtype)
        finals = []
        for layer in range(self.num_layers):
            if layer > 0 and self.dropout > 0:
                x = F.dropout(x, self.dropout, training=self.training)
            ci = layer * self.num_directions
            out, fin = _scan_layer(self.cells[ci], x, states[ci],
                                   sequence_length)
            finals.append(fin)
            if self.bidirect:
                out_bw, fin_bw = _scan_layer(self.cells[ci + 1], x,
                                             states[ci + 1], sequence_length,
                                             reverse=True)
                finals.append(fin_bw)
                out = torch.cat([out, out_bw], dim=-1)
            x = out
        if isinstance(finals[0], tuple):
            final = tuple(torch.stack([f[i] for f in finals])
                          for i in range(len(finals[0])))
        else:
            final = torch.stack(finals)
        return _time_major(x, self.time_major), final


class SimpleRNN(_StackedRNN):
    cell_cls = SimpleRNNCell


class LSTM(_StackedRNN):
    cell_cls = LSTMCell


class GRU(_StackedRNN):
    cell_cls = GRUCell
