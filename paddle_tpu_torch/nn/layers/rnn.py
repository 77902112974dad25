"""Recurrent layers (``paddle_tpu/nn/layers/rnn.py``): the cells
`SimpleRNNCell`, `LSTMCell` and `GRUCell`, the runners `RNN` and
`BiRNN`, and the stacks `SimpleRNN`, `LSTM` and `GRU`.

Weights keep the JAX layout, ``[G·H, in]`` with the gates in JAX's
order (LSTM i, f, g, o; GRU r, z, candidate), under the JAX names:
``weight_ih``, ``weight_hh``, ``bias_ih``, ``bias_hh`` in a cell,
``weight_ih_l{k}`` and ``..._l{k}_reverse`` in a stack, so
``models.layer_from_numpy`` carries a JAX layer's ``state_dict``
across.  Each is ``Uniform(-1/sqrt(H), 1/sqrt(H))``, drawn on the CPU
from the layer's `generator` in the JAX creation order.

The time loop is a Python loop over T of the JAX step's arithmetic on
the inputs' device, with no host sync: ``x wᵢᵀ + bᵢ + h wₕᵀ + bₕ`` in
that order (a stack computes ``x wᵢᵀ + bᵢ`` for every step in one
product first).  The stacks give `sequence_length` ``scan_fn``'s
semantics: past each length the carry is frozen and the output zero
(`torch.where`), and the reverse direction walks each sequence's valid
part reversed.  `RNN` blends multiplicatively, ``new live + old (1 -
live)``, as JAX's does, but with ``initial_states=None`` it starts
from the zero state, which is what the JAX runner computes only when
given explicit zeros: its first step's state there is taken unmasked,
so a reversed padded row enters its valid part from ``cell(pad, 0)``.
No recurrent op is on an AMP list, so nothing here casts."""
import math

import torch
from torch import nn

from ...dtype import convert_dtype
from ..initializer import Uniform
from ..layer import create_parameter


def _zip_state(a, b, fn):
    if isinstance(a, (list, tuple)):
        return type(a)(_zip_state(x, y, fn) for x, y in zip(a, b))
    return fn(a, b)


class RNNCellBase(nn.Module):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """A [batch, hidden_size] state filled with `init_value`, on
        `batch_ref`'s device and, unless `dtype` says otherwise, in its
        floating dtype."""
        if dtype is None:
            dtype = batch_ref.dtype if batch_ref.is_floating_point() \
                else torch.float32
        return torch.full([batch_ref.shape[batch_dim_idx],
                           self.hidden_size], init_value,
                          dtype=convert_dtype(dtype),
                          device=batch_ref.device)

    def _make_weights(self, gates, input_size, hidden_size, attrs,
                      generator):
        self.input_size, self.hidden_size = input_size, hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        wi_attr, wh_attr, bi_attr, bh_attr = attrs
        init = Uniform(-std, std)
        g = gates * hidden_size
        self.weight_ih = create_parameter([g, input_size], wi_attr,
                                          default_initializer=init,
                                          generator=generator)
        self.weight_hh = create_parameter([g, hidden_size], wh_attr,
                                          default_initializer=init,
                                          generator=generator)
        self.bias_ih = create_parameter([g], bi_attr, is_bias=True,
                                        default_initializer=init,
                                        generator=generator)
        self.bias_hh = create_parameter([g], bh_attr, is_bias=True,
                                        default_initializer=init,
                                        generator=generator)

    @property
    def state_shape(self):
        return (self.hidden_size,)


def simple_rnn_step(x_wi, h, wh, bh, act):
    """``act(x wᵢᵀ + bᵢ + h wₕᵀ + bₕ)``, with ``x wᵢᵀ + bᵢ`` given."""
    return act(x_wi + h @ wh.t() + bh)


def lstm_step(x_wi, h, c, wh, bh):
    """The LSTM step on ``x wᵢᵀ + bᵢ``: gates i, f, g, o; returns (h, c)."""
    gates = x_wi + h @ wh.t() + bh
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c2 = f * c + i * torch.tanh(g)
    return o * torch.tanh(c2), c2


def gru_step(x_wi, h, wh, bh):
    """The GRU step on ``x wᵢᵀ + bᵢ``: r scales ``h wₕᵀ + bₕ``'s third
    part; ``(1 - z) g + z h``."""
    gh = h @ wh.t() + bh
    ir, iz, ig = x_wi.chunk(3, dim=-1)
    hr, hz, hg = gh.chunk(3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    g = torch.tanh(ig + r * hg)
    return (1 - z) * g + z * h


_ACTS = {"tanh": torch.tanh, "relu": torch.relu}


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, generator=None):
        super().__init__()
        if activation not in _ACTS:
            raise ValueError(f"activation must be 'tanh' or 'relu', not "
                             f"{activation!r}")
        self._make_weights(1, input_size, hidden_size, (
            weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr),
            generator)
        self.activation = activation

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = simple_rnn_step(inputs @ self.weight_ih.t() + self.bias_ih,
                            states, self.weight_hh, self.bias_hh,
                            _ACTS[self.activation])
        return h, h


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, generator=None):
        super().__init__()
        self._make_weights(4, input_size, hidden_size, (
            weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr),
            generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = (self.get_initial_states(inputs),
                      self.get_initial_states(inputs))
        h, c = states
        h2, c2 = lstm_step(inputs @ self.weight_ih.t() + self.bias_ih, h, c,
                           self.weight_hh, self.bias_hh)
        return h2, (h2, c2)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, generator=None):
        super().__init__()
        self._make_weights(3, input_size, hidden_size, (
            weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr),
            generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = gru_step(inputs @ self.weight_ih.t() + self.bias_ih, states,
                     self.weight_hh, self.bias_hh)
        return h, h


def _time_major(x, time_major):
    return x if time_major else x.transpose(0, 1)


def _lengths(sequence_length, device):
    if sequence_length is None:
        return None
    if isinstance(sequence_length, torch.Tensor):
        return sequence_length.to(device)
    return torch.as_tensor(sequence_length, device=device)


def _zero_states(cell, x):
    """Zeros in the cell's state structure ([batch, H] each, or a tuple of
    them for the LSTM), on x's device and in its dtype."""
    def make(shape):
        if isinstance(shape[0], (tuple, list)):
            return tuple(make(s) for s in shape)
        return torch.zeros((x.shape[0],) + tuple(shape), dtype=x.dtype,
                           device=x.device)

    return make(cell.state_shape)


class RNN(nn.Module):
    """A cell run over time, forward or reversed.  With
    `sequence_length`, a step past a row's length outputs zeros and
    keeps its state, blended as ``new live + old (1 - live)``."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        tm = _time_major(inputs, self.time_major)
        n_steps = tm.shape[0]
        lens = _lengths(sequence_length, tm.device)
        states = initial_states
        if states is None and lens is not None:
            states = _zero_states(self.cell, tm[0])
        outs = [None] * n_steps
        steps = range(n_steps - 1, -1, -1) if self.is_reverse \
            else range(n_steps)
        xs = tm.unbind(0)
        for t in steps:
            out, new_states = self.cell(xs[t], states)
            if lens is not None:
                live = (lens > t).to(out.dtype).reshape(-1, 1)
                out = out * live
                states = _zip_state(new_states, states,
                                    lambda n, o: n * live + o * (1.0 - live))
            else:
                states = new_states
            outs[t] = out
        out = torch.stack(outs, dim=0)
        return _time_major(out, self.time_major), states


class BiRNN(nn.Module):
    """A forward and a reversed `RNN`, their outputs concatenated."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        if initial_states is None:
            initial_states = (None, None)
        out_fw, st_fw = self.rnn_fw(inputs, initial_states[0],
                                    sequence_length=sequence_length)
        out_bw, st_bw = self.rnn_bw(inputs, initial_states[1],
                                    sequence_length=sequence_length)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)


class _RNNBase(nn.Module):
    """A stack of `num_layers` recurrent layers, one or two directions
    each; states [L·D, B, H] (the LSTM's an (h, c) pair).  Between
    stacked layers, in training, dropout draws from the layer's own
    generator on the inputs' device (seeded once from `generator` at
    construction)."""

    MODE = "RNN_TANH"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, generator=None):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"direction must be 'forward' or 'bidirect', "
                             f"not {direction!r}")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirectional = direction != "forward"
        self.num_directions = 2 if self.bidirectional else 1
        gates = {"LSTM": 4, "GRU": 3}.get(self.MODE, 1) * hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        self._all_weights = []
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_sz = input_size if layer == 0 \
                    else hidden_size * self.num_directions
                suffix = "_reverse" if d else ""
                names = [f"weight_ih_l{layer}{suffix}",
                         f"weight_hh_l{layer}{suffix}",
                         f"bias_ih_l{layer}{suffix}",
                         f"bias_hh_l{layer}{suffix}"]
                for n, shape, attr, is_bias in zip(
                        names, ([gates, in_sz], [gates, hidden_size],
                                [gates], [gates]),
                        (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                         bias_hh_attr), (False, False, True, True)):
                    self.register_parameter(n, create_parameter(
                        shape, attr, is_bias=is_bias,
                        default_initializer=init, generator=generator))
                self._all_weights.append(names)
        self._drop_seed = None
        if dropout and num_layers > 1:
            self._drop_seed = int(torch.randint(
                2 ** 62, (1,), generator=generator))
        self._drop_gen = None

    def _dropout_generator(self, device):
        if self._drop_gen is None or self._drop_gen.device != device:
            self._drop_gen = torch.Generator(device=device).manual_seed(
                self._drop_seed)
        return self._drop_gen

    def _step(self):
        if self.MODE == "LSTM":
            return lambda xw, carry, wh, bh: lstm_step(xw, *carry, wh, bh)
        if self.MODE == "GRU":
            return lambda xw, carry, wh, bh: (gru_step(xw, carry[0], wh,
                                                       bh),)
        act = torch.tanh if self.MODE == "RNN_TANH" else torch.relu
        return lambda xw, carry, wh, bh: (simple_rnn_step(xw, carry[0], wh,
                                                          bh, act),)

    def _direction(self, seq, h0, wi, wh, bi, bh, live):
        """One direction of one layer over time-major `seq` [T, B, in]:
        outputs [T, B, H] and the final carry."""
        step = self._step()
        # unbind, not x_wi[t]: each index's backward would add a
        # zero-filled [T, B, G·H] gradient, T times over
        carry, ys = h0, []
        for t, x_wi in enumerate((seq @ wi.t() + bi).unbind(0)):
            new = step(x_wi, carry, wh, bh)
            if live is not None:
                new = tuple(torch.where(live[t], n, c)
                            for n, c in zip(new, carry))
                ys.append(torch.where(live[t], new[0],
                                      torch.zeros_like(new[0])))
            else:
                ys.append(new[0])
            carry = new
        return torch.stack(ys), carry

    def forward(self, inputs, initial_states=None, sequence_length=None):
        n_states = 2 if self.MODE == "LSTM" else 1
        L, D, H = self.num_layers, self.num_directions, self.hidden_size
        x = _time_major(inputs, self.time_major)
        n_steps, batch = x.shape[0], x.shape[1]
        if initial_states is None:
            zeros = torch.zeros([L * D, batch, H], dtype=x.dtype,
                                device=x.device)
            states = [zeros] * n_states
        else:
            states = list(initial_states) if n_states == 2 \
                else [initial_states]
        lens = _lengths(sequence_length, x.device)
        live = rev_idx = None
        if lens is not None:
            t_col = torch.arange(n_steps, device=x.device)[:, None]
            alive = t_col < lens[None, :]                       # [T, B]
            live = alive[:, :, None]
            # each row's valid part reversed, its padding in place: an
            # involution, so the same gather maps the outputs back
            rev_idx = torch.where(alive, lens[None, :] - 1 - t_col,
                                  t_col)[:, :, None]
        drop = self.dropout and self.training and L > 1
        generator = self._dropout_generator(x.device) \
            if drop and self.dropout < 1.0 else None
        layer_in = x
        out_h, out_c = [], []
        for layer in range(L):
            dir_outs = []
            for d in range(D):
                wi, wh, bi, bh = (getattr(self, n) for n in
                                  self._all_weights[layer * D + d])
                h0 = tuple(s[layer * D + d] for s in states)
                seq = layer_in
                if d == 1:
                    seq = torch.flip(seq, [0]) if rev_idx is None else \
                        torch.gather(seq, 0, rev_idx.expand_as(seq))
                ys, final = self._direction(seq, h0, wi, wh, bi, bh, live)
                if d == 1:
                    ys = torch.flip(ys, [0]) if rev_idx is None else \
                        torch.gather(ys, 0, rev_idx.expand_as(ys))
                dir_outs.append(ys)
                out_h.append(final[0])
                if n_states == 2:
                    out_c.append(final[1])
            layer_in = torch.cat(dir_outs, dim=-1) if D == 2 \
                else dir_outs[0]
            if drop and layer < L - 1:
                if self.dropout >= 1.0:
                    layer_in = torch.zeros_like(layer_in)
                else:
                    keep = torch.rand(layer_in.shape, generator=generator,
                                      device=layer_in.device) \
                        < 1.0 - self.dropout
                    layer_in = torch.where(
                        keep, layer_in / (1.0 - self.dropout),
                        torch.zeros_like(layer_in))
        final_h = torch.stack(out_h)
        final = (final_h, torch.stack(out_c)) if n_states == 2 else final_h
        return _time_major(layer_in, self.time_major), final


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        if activation not in _ACTS:
            raise ValueError(f"activation must be 'tanh' or 'relu', not "
                             f"{activation!r}")
        self.MODE = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, **kwargs)


class LSTM(_RNNBase):
    MODE = "LSTM"


class GRU(_RNNBase):
    MODE = "GRU"
