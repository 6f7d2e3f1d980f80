"""Recurrent cells and stacked/bidirectional runners (apex.RNN parity),
mirroring `ghost_tpu/nn/rnn.py`.

The reference vendors apex.RNN (reference apex/apex/RNN/models.py:20-55,
cells.py:56-85, RNNBackend.py:25-230): LSTM / GRU / ReLU / Tanh cells
plus the multiplicative mLSTM, wrapped by stackedRNN / bidirectionalRNN.
GHOST itself never imports it; it is part of the vendored capability
surface.

Plain torch, as the JAX package computes it: the input projection
`x @ W_ih` of ALL timesteps is one batched matmul before the time loop
(it does not depend on the recurrence), so each step only carries the
small h-projection and the cell's pointwise ops; the loop runs in
Python, one step after the other (JAX runs it as one `lax.scan`).

Weight layout matches torch.nn.LSTM/GRU (w_ih: (gates*H, in),
w_hh: (gates*H, H), gate order i,f,g,o for LSTM and r,z,n for GRU), so
torch state dicts map on directly.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class RNNParams(NamedTuple):
    """One layer's weights (torch layout)."""

    w_ih: Any  # (G*H, in)
    w_hh: Any  # (G*H, H)
    b_ih: Any | None = None  # (G*H,)
    b_hh: Any | None = None  # (G*H,)
    w_mih: Any | None = None  # mLSTM only: (H, in)
    w_mhh: Any | None = None  # mLSTM only: (H, H)


def _linear(x, w, b=None):
    y = x @ w.T
    return y if b is None else y + b


def lstm_cell(p: RNNParams, hidden, x_proj, x=None):
    """Torch LSTMCell: gates i,f,g,o (reference torch LSTMCell used by
    apex models.py:24). x_proj = x @ w_ih.T (+ b_ih), precomputed."""
    hx, cx = hidden
    gates = x_proj + _linear(hx, p.w_hh, p.b_hh)
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    cy = f * cx + i * g
    hy = o * torch.tanh(cy)
    return (hy, cy), hy


def gru_cell(p: RNNParams, hidden, x_proj, x=None):
    """Torch GRUCell: r,z,n with the reset gate applied to the full
    hidden projection INCLUDING its bias (torch semantics)."""
    (hx,) = hidden
    h_proj = _linear(hx, p.w_hh, p.b_hh)
    xr, xz, xn = torch.chunk(x_proj, 3, dim=-1)
    hr, hz, hn = torch.chunk(h_proj, 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    hy = (1.0 - z) * n + z * hx
    return (hy,), hy


def rnn_tanh_cell(p: RNNParams, hidden, x_proj, x=None):
    (hx,) = hidden
    hy = torch.tanh(x_proj + _linear(hx, p.w_hh, p.b_hh))
    return (hy,), hy


def rnn_relu_cell(p: RNNParams, hidden, x_proj, x=None):
    (hx,) = hidden
    hy = torch.relu(x_proj + _linear(hx, p.w_hh, p.b_hh))
    return (hy,), hy


def mlstm_cell(p: RNNParams, hidden, x_proj, x):
    """Multiplicative LSTM (reference apex/apex/RNN/cells.py:56-85):
    m = (x @ w_mih) * (h @ w_mhh); gates = x@w_ih + b_ih + m@w_hh + b_hh.
    x_proj is the pair (x @ w_ih.T + b_ih, x @ w_mih.T), both
    precomputed."""
    hx, cx = hidden
    x_gates, x_m = x_proj
    m = x_m * _linear(hx, p.w_mhh)
    gates = x_gates + _linear(m, p.w_hh, p.b_hh)
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    cy = f * cx + i * g
    hy = o * torch.tanh(cy)
    return (hy, cy), hy


_CELLS = {
    "lstm": (lstm_cell, 4, 2),
    "gru": (gru_cell, 3, 1),
    "relu": (rnn_relu_cell, 1, 1),
    "tanh": (rnn_tanh_cell, 1, 1),
    "mlstm": (mlstm_cell, 4, 2),
}


def init_rnn_params(generator: torch.Generator, kind: str, input_size: int,
                    hidden_size: int, num_layers: int = 1, bias: bool = True,
                    bidirectional: bool = False, dtype=torch.float32,
                    device=None):
    """Uniform(-1/sqrt(H), 1/sqrt(H)) init (torch default), drawn from
    `generator` (a CPU generator) and moved to `device`."""
    _, gates, _ = _CELLS[kind]
    bound = 1.0 / (hidden_size ** 0.5)
    dirs = 2 if bidirectional else 1

    def u(*shape):
        t = torch.empty(shape, dtype=dtype).uniform_(-bound, bound,
                                                     generator=generator)
        return t.to(device)

    layers = []
    for layer in range(num_layers):
        per_dir = []
        for _ in range(dirs):
            isz = input_size if layer == 0 else hidden_size * dirs
            g = gates * hidden_size
            per_dir.append(RNNParams(
                w_ih=u(g, isz), w_hh=u(g, hidden_size),
                b_ih=u(g) if bias else None, b_hh=u(g) if bias else None,
                w_mih=u(hidden_size, isz) if kind == "mlstm" else None,
                w_mhh=u(hidden_size, hidden_size) if kind == "mlstm"
                else None))
        layers.append(tuple(per_dir) if dirs == 2 else per_dir[0])
    return layers


def _run_layer(cell, p: RNNParams, x, h0, reverse=False):
    """x: (T, B, in) -> ((T, B, H), last hidden). The input projection
    is hoisted out of the recurrence as one batched matmul."""
    if cell is mlstm_cell:
        x_proj = (_linear(x, p.w_ih, p.b_ih), _linear(x, p.w_mih))
        step_proj = [tuple(a[t] for a in x_proj) for t in range(x.shape[0])]
    else:
        x_proj = _linear(x, p.w_ih, p.b_ih)
        step_proj = list(x_proj.unbind(0))
    if reverse:
        step_proj = step_proj[::-1]
    hidden, ys = tuple(h0), []
    for xp in step_proj:
        hidden, y = cell(p, hidden, xp, None)
        ys.append(y)
    if reverse:
        ys = ys[::-1]
    return torch.stack(ys, 0), hidden


def rnn_forward(kind: str, params, x, h0=None, bidirectional: bool = False):
    """Stacked (and optionally bidirectional) RNN over x (T, B, in).

    Mirrors apex stackedRNN/bidirectionalRNN (RNNBackend.py:90-196,
    25-50): layer l consumes layer l-1's full output sequence;
    bidirectional concatenates forward and reverse features per layer.

    h0, when given, warm-starts the recurrence (streaming continuation
    across chunks): the same structure this function RETURNS as
    last_hidden: a list with one entry per layer, each a tuple of
    n_state (B, H) tensors (a (fwd, rev) pair of such tuples per layer
    when bidirectional). None (the default) zero-initializes.

    Returns (ys (T, B, H*dirs), last_hidden list per layer)."""
    cell, _, n_state = _CELLS[kind]
    b = x.shape[1]
    if h0 is not None and len(h0) != len(params):
        raise ValueError(
            f"h0 has {len(h0)} layer states for {len(params)} layers")
    lasts = []
    h = x
    for li, layer_p in enumerate(params):
        if bidirectional:
            pf, pr = layer_p
            z = h.new_zeros(b, pf.w_hh.shape[-1])
            zl = tuple(z for _ in range(n_state))
            h0f, h0r = h0[li] if h0 is not None else (zl, zl)
            yf, hf = _run_layer(cell, pf, h, h0f)
            yr, hr = _run_layer(cell, pr, h, h0r, reverse=True)
            h = torch.cat([yf, yr], dim=-1)
            lasts.append((hf, hr))
        else:
            z = h.new_zeros(b, layer_p.w_hh.shape[-1])
            h0l = (h0[li] if h0 is not None
                   else tuple(z for _ in range(n_state)))
            h, hl = _run_layer(cell, layer_p, h, h0l)
            lasts.append(hl)
    return h, lasts


def lstm(params, x, bidirectional=False):
    return rnn_forward("lstm", params, x, bidirectional=bidirectional)


def gru(params, x, bidirectional=False):
    return rnn_forward("gru", params, x, bidirectional=bidirectional)


def mlstm(params, x, bidirectional=False):
    return rnn_forward("mlstm", params, x, bidirectional=bidirectional)
