"""Recurrent layers (LSTM, LSTMCell), needed for the paper's GNMTv2
benchmark.  Counterpart of ``repro/nn/rnn.py``: the same parameter
names (``weight_ih_l{n}[_reverse]``, ``weight_hh_...``, ``bias_...``),
shapes and initializers, so ``load_state_dict`` carries the reference's
weights across and a seed gives the same ones.

The recurrence of one layer and direction runs inside ONE tape node
(``_apply_op("lstm", ..., num_outputs=3)``), as the reference's
``lax.scan`` does: a torch loop over the steps inside the op, whose VJP
(``torch.func.vjp``) replays the loop's ops backward.  The input
projection of every step is hoisted into one matmul before the loop
(the same function; only the order of the sums differs).  The gates are
torch ops on the card: the reference computes them in XLA, not in a
Pallas kernel, so there is no kernel of the table behind them.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..core import tensor_mod as T
from ..core.tensor import Tensor, _apply_op, _coerce
from .module import Module, Parameter


def _lstm_gates(xw_t, h, c, w_hh_t):
    """One step: ``xw_t`` is the step's input projection plus the bias
    (B, 4H), ``w_hh_t`` the transposed recurrent weight (H, 4H).  Gate
    order i, f, g, o, as in the reference."""
    gates = torch.addmm(xw_t, h, w_hh_t)
    sig = torch.sigmoid(gates)
    i, f, _, o = sig.chunk(4, dim=-1)
    hidden = h.shape[-1]
    g = torch.tanh(gates[:, 2 * hidden:3 * hidden])
    c = torch.addcmul(f * c, i, g)
    h = o * torch.tanh(c)
    return h, c


def _lstm_cell(x_t, h, c, w_ih, w_hh, b):
    return _lstm_gates(torch.addmm(b, x_t, w_ih.T), h, c, w_hh.T)


def _lstm_scan(xd, wi, wh, bb, *hc, hidden: int, reverse: bool):
    """(B, S, D) inputs through one layer and direction: returns the
    (B, S, H) outputs and the final h and c (B, H)."""
    bsz, seq = xd.shape[0], xd.shape[1]
    if hc:
        h, c = hc
    else:
        h = xd.new_zeros((bsz, hidden))
        c = xd.new_zeros((bsz, hidden))
    xw = torch.matmul(xd, wi.T) + bb       # every step's projection
    wh_t = wh.T
    outs = [None] * seq
    for t in (range(seq - 1, -1, -1) if reverse else range(seq)):
        h, c = _lstm_gates(xw[:, t], h, c, wh_t)
        outs[t] = h
    return torch.stack(outs, dim=1), h, c


class LSTM(Module):
    """Multi-layer LSTM over (B, S, D) batches (batch_first semantics)."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, bias: bool = True,
                 bidirectional: bool = False, dtype=torch.float32):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        dirs = 2 if bidirectional else 1
        k = 1.0 / math.sqrt(hidden_size)
        for layer in range(num_layers):
            for d in range(dirs):
                in_sz = input_size if layer == 0 else hidden_size * dirs
                sfx = f"_l{layer}" + ("_reverse" if d else "")
                setattr(self, f"weight_ih{sfx}", Parameter(
                    T.uniform(-k, k, (4 * hidden_size, in_sz), dtype=dtype)))
                setattr(self, f"weight_hh{sfx}", Parameter(
                    T.uniform(-k, k, (4 * hidden_size, hidden_size),
                              dtype=dtype)))
                setattr(self, f"bias{sfx}", Parameter(
                    T.uniform(-k, k, (4 * hidden_size,), dtype=dtype)))

    def _run_direction(self, x: Tensor, w_ih: Tensor, w_hh: Tensor,
                       b: Tensor, reverse: bool,
                       h0c0=None) -> Tuple[Tensor, Tensor, Tensor]:
        hidden = self.hidden_size

        def scan(xd, wi, wh, bb, *hc):
            return _lstm_scan(xd, wi, wh, bb, *hc, hidden=hidden,
                              reverse=reverse)

        args = [x, w_ih, w_hh, b]
        if h0c0 is not None:
            args += [h0c0[0], h0c0[1]]
        # closure captures: hidden size + direction (an initial state
        # changes the operand count, so the signature tells it apart)
        return _apply_op("lstm", scan, *[_coerce(a) for a in args],
                         num_outputs=3, static=(hidden, reverse))

    def forward(self, x: Tensor, state=None):
        h_states, c_states = [], []
        out = x
        for layer in range(self.num_layers):
            sfx = f"_l{layer}"
            h0c0 = None
            if state is not None:
                h0c0 = (state[0][layer], state[1][layer])
            fwd, h_n, c_n = self._run_direction(
                out, getattr(self, f"weight_ih{sfx}"),
                getattr(self, f"weight_hh{sfx}"),
                getattr(self, f"bias{sfx}"), reverse=False, h0c0=h0c0)
            if self.bidirectional:
                bwd, hb, cb = self._run_direction(
                    out, getattr(self, f"weight_ih{sfx}_reverse"),
                    getattr(self, f"weight_hh{sfx}_reverse"),
                    getattr(self, f"bias{sfx}_reverse"), reverse=True)
                out = T.cat([fwd, bwd], dim=-1)
                h_states += [h_n, hb]
                c_states += [c_n, cb]
            else:
                out = fwd
                h_states.append(h_n)
                c_states.append(c_n)
        h = T.stack(h_states, dim=0)
        c = T.stack(c_states, dim=0)
        return out, (h, c)


class LSTMCell(Module):
    def __init__(self, input_size: int, hidden_size: int,
                 dtype=torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        k = 1.0 / math.sqrt(hidden_size)
        self.weight_ih = Parameter(
            T.uniform(-k, k, (4 * hidden_size, input_size), dtype=dtype))
        self.weight_hh = Parameter(
            T.uniform(-k, k, (4 * hidden_size, hidden_size), dtype=dtype))
        self.bias = Parameter(T.uniform(-k, k, (4 * hidden_size,),
                                        dtype=dtype))

    def forward(self, x: Tensor, state=None):
        if state is None:
            z = T.zeros(x.shape[0], self.hidden_size, dtype=x.dtype)
            state = (z, z)
        h, c = state
        return _apply_op("lstm_cell", _lstm_cell, _coerce(x), _coerce(h),
                         _coerce(c), self.weight_ih, self.weight_hh,
                         self.bias, num_outputs=2, static=())
