"""Port parity: the recurrent layers (``paddle_tpu_torch.nn``:
`SimpleRNNCell`, `LSTMCell`, `GRUCell`, `RNN`, `BiRNN`, `SimpleRNN` with
tanh and relu, `LSTM`, `GRU`) against the JAX package's, both on the
CPU, the JAX layer's ``state_dict()`` carried across by
``models.layer_from_numpy``.

Outputs and final states within 1e-5 (atol and rtol), and under one
random cotangent per output the gradients of the input, the given
initial states and every parameter within 1e-4: each cell with and
without given states; the runners forward and reversed, with and
without `sequence_length`; the stacks at 1 and 2 layers, forward and
bidirect, batch- and time-major, with and without `sequence_length`
and initial states, at T 6, H 8.  Every JAX result is computed once, at
module scope, traced into one jitted forward and one jitted gradient.

The JAX runner's fault (``paddle_tpu/nn/layers/rnn.py:185-186``): with
`sequence_length` and no initial states it takes the first step's
state unmasked, so a reversed padded row enters its valid part from
``cell(pad, 0)``.  The port starts from zeros: its `RNN(is_reverse=True)`
and `BiRNN` with no states equal JAX's given explicit zeros, and JAX's
own call with none differs on the padded rows."""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models import layer_from_numpy, layer_to_numpy

B, T, D, H = 3, 6, 5, 8
LENS = np.array([6, 4, 1], np.int64)
TOL, GRAD_TOL = 1e-5, 1e-4


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def mcase(build, x, states=None, lens=None, **kw):
    """A layer (``build(nn, **gen)`` for either package) called on `x`
    with initial `states` (an array, a tuple of them, or None) and
    `lens`, its other keyword arguments `kw`."""
    return dict(build=build, x=x, states=states, lens=lens, kw=kw)


def _cell(name, **ckw):
    return lambda nn, **g: getattr(nn, name)(D, H, **ckw, **g)


CELLS = {
    "simple_tanh": mcase(_cell("SimpleRNNCell"), _x((B, D), 1)),
    "simple_relu": mcase(_cell("SimpleRNNCell", activation="relu"),
                         _x((B, D), 1), _x((B, H), 2)),
    "lstm": mcase(_cell("LSTMCell"), _x((B, D), 1)),
    "lstm_states": mcase(_cell("LSTMCell"), _x((B, D), 1),
                         (_x((B, H), 2), _x((B, H), 3))),
    "gru": mcase(_cell("GRUCell"), _x((B, D), 1)),
    "gru_states": mcase(_cell("GRUCell"), _x((B, D), 1), _x((B, H), 2)),
}

SEQ = _x((B, T, D), 4)
ZERO = np.zeros((B, H), np.float32)


def _runner(cell, **kw):
    return lambda nn, **g: nn.RNN(getattr(nn, cell)(D, H, **g), **kw)


def _bi(cell, **kw):
    return lambda nn, **g: nn.BiRNN(getattr(nn, cell)(D, H, **g),
                                    getattr(nn, cell)(D, H, **g), **kw)


RUNNERS = {
    "rnn_lstm_lens_states": mcase(_runner("LSTMCell"), SEQ,
                                  (_x((B, H), 2), _x((B, H), 3)), LENS),
    "rnn_gru_reverse": mcase(_runner("GRUCell", is_reverse=True), SEQ),
    "rnn_gru_reverse_zeros": mcase(_runner("GRUCell", is_reverse=True), SEQ,
                                   ZERO, LENS),
    "rnn_simple_time_major": mcase(_runner("SimpleRNNCell", time_major=True),
                                   SEQ.transpose(1, 0, 2).copy()),
    "birnn_lstm_zeros": mcase(_bi("LSTMCell"), SEQ, ((ZERO, ZERO),
                                                      (ZERO, ZERO)), LENS),
    "birnn_gru": mcase(_bi("GRUCell"), SEQ),
    "birnn_gru_zeros": mcase(_bi("GRUCell"), SEQ, (ZERO, ZERO), LENS),
}
# the fault: JAX's runner with no states (the port's equals *_zeros)
FAULT = {"rnn_gru_reverse_none": mcase(_runner("GRUCell", is_reverse=True),
                                       SEQ, None, LENS),
         "birnn_gru_none": mcase(_bi("GRUCell"), SEQ, None, LENS)}


def _stack(cls, **kw):
    return lambda nn, **g: getattr(nn, cls)(D, H, **kw, **g)


STACK_MODES = {"simple_tanh": ("SimpleRNN", {}, 1),
               "simple_relu": ("SimpleRNN", {"activation": "relu"}, 1),
               "lstm": ("LSTM", {}, 2), "gru": ("GRU", {}, 1)}
# (layers, direction, time_major, lens, initial states)
STACK_SHAPES = {"l1_forward": (1, "forward", False, False, False),
                "l2_bidirect_lens": (2, "bidirect", False, True, False),
                "l2_forward_time_major_lens_states": (2, "forward", True,
                                                      True, True),
                "l1_bidirect_time_major_states": (1, "bidirect", True,
                                                  False, True)}
STACKS = {}
for _mode, (_cls, _kw, _n_states) in STACK_MODES.items():
    for _shape, (_L, _dir, _tm, _lens, _st) in STACK_SHAPES.items():
        _nd = 2 if _dir == "bidirect" else 1
        _states = None
        if _st:
            _states = tuple(_x((_L * _nd, B, H), 10 + k)
                            for k in range(_n_states))
            _states = _states if _n_states == 2 else _states[0]
        STACKS[f"{_mode}_{_shape}"] = mcase(
            _stack(_cls, num_layers=_L, direction=_dir, time_major=_tm,
                   **_kw), SEQ.transpose(1, 0, 2).copy() if _tm else SEQ,
            _states, LENS if _lens else None)

ALL = {**CELLS, **RUNNERS, **FAULT, **STACKS}


def _flat(v):
    if isinstance(v, (list, tuple)):
        return [leaf for x in v for leaf in _flat(x)]
    return [v]


def _unflat(template, it):
    if isinstance(template, (list, tuple)):
        return type(template)(_unflat(t, it) for t in template)
    return next(it)


def _state_leaves(c):
    return [] if c["states"] is None else _flat(c["states"])


def _call(layer, c, x, states, lens):
    if c["lens"] is None:
        return layer(x, states)
    return layer(x, states, sequence_length=lens)


def _jax_layers():
    """Each case's JAX layer, built from one seed, and its state as numpy
    arrays."""
    seeds = {name: 100 + k for k, name in enumerate(ALL)}
    # a fault case shares its explicit-zeros twin's weights
    seeds.update({n: seeds[n.replace("_none", "_zeros")] for n in FAULT})
    layers = {}
    for name, c in ALL.items():
        paddle.seed(seeds[name])
        layer = c["build"](jnn)
        layers[name] = (layer, {n: np.asarray(t._data)
                                for n, t in layer.state_dict().items()})
    return layers


@pytest.fixture(scope="module")
def jax_results():
    """Every case's JAX outputs and gradients (input, given states, then
    parameters in ``named_parameters`` order), one jitted forward and
    gradient over all of them."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.core.tensor import _wrap_data

    layers = _jax_layers()
    names = list(ALL)
    inputs = [[ALL[n]["x"]] + _state_leaves(ALL[n])
              + [p for p in layers[n][1].values()] for n in names]

    def forward(all_inputs):
        outs = []
        with paddle.no_grad():
            for n, vals in zip(names, all_inputs):
                c, (layer, _) = ALL[n], layers[n]
                params = [p for _, p in layer.named_parameters()]
                n_st = len(_state_leaves(c))
                x, st = vals[0], vals[1:1 + n_st]
                kept = [p._data for p in params]
                for p, v in zip(params, vals[1 + n_st:]):
                    p._data = v
                try:
                    states = None if c["states"] is None else _unflat(
                        c["states"], iter([_wrap_data(s) for s in st]))
                    out = _call(layer, c, _wrap_data(x), states,
                                paddle.to_tensor(LENS))
                finally:
                    for p, v in zip(params, kept):
                        p._data = v
                outs.append([o._data for o in _flat(out)])
        return outs

    shapes = jax.eval_shape(forward, inputs)
    cots = [[np.random.default_rng(k).standard_normal(v.shape).astype(
        np.float32) for k, v in enumerate(o)] for o in shapes]

    def loss(all_inputs):
        outs = forward(all_inputs)
        return sum(jnp.sum(o * c) for os_, cs in zip(outs, cots)
                   for o, c in zip(os_, cs)), outs

    (_, vals), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        inputs)
    vals = [[np.asarray(v) for v in o] for o in vals]
    return {n: (layers[n][1], v, c, [np.asarray(g) for g in gs])
            for n, v, c, gs in zip(names, vals, cots, grads)}


def _port_run(c, state, cots):
    """The port layer holding `state`, called on the case's inputs;
    outputs and the gradients in the JAX order."""
    layer = c["build"](pnn, generator=torch.Generator().manual_seed(0))
    layer_from_numpy(layer, state, device="cpu")
    x = torch.from_numpy(c["x"].copy()).requires_grad_()
    st = [torch.from_numpy(s.copy()).requires_grad_()
          for s in _state_leaves(c)]
    states = None if c["states"] is None else _unflat(c["states"], iter(st))
    out = _call(layer, c, x, states, torch.from_numpy(LENS))
    outs = _flat(out)
    sum((o * torch.from_numpy(ct)).sum() for o, ct in zip(outs,
                                                          cots)).backward()
    grads = [t.grad for t in [x] + st] + [p.grad for p in layer.parameters()]
    return ([o.detach().numpy() for o in outs],
            [g.numpy() if g is not None else None for g in grads], layer)


def _hold(name, jax_results, want_name=None):
    state, want, cots, want_g = jax_results[want_name or name]
    got, got_g, layer = _port_run(ALL[name], state, cots)
    assert [n for n, _ in layer.named_parameters()] == list(state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    assert len(got_g) == len(want_g)
    for g, w in zip(got_g, want_g):
        g = np.zeros_like(w) if g is None else g
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL)
    assert layer_to_numpy(layer).keys() == state.keys()


@pytest.mark.parametrize("name", list(CELLS))
def test_cells_match_jax(name, jax_results):
    _hold(name, jax_results)


@pytest.mark.parametrize("name", list(RUNNERS))
def test_rnn_and_birnn_match_jax(name, jax_results):
    _hold(name, jax_results)


@pytest.mark.parametrize("name", list(STACKS))
def test_stacks_match_jax(name, jax_results):
    _hold(name, jax_results)


@pytest.mark.parametrize("name", list(FAULT))
def test_no_initial_states_start_from_zero_unlike_the_jax_runner(
        name, jax_results):
    """On one set of weights: the port with no initial states equals JAX
    given explicit zeros; JAX's own call with none differs on the padded
    rows (lengths 4 and 1 of 6) by far more than the tolerance, and not
    on the full row."""
    zeros = name.replace("_none", "_zeros")
    state, want, cots, _ = jax_results[zeros]
    none_state, jax_none = jax_results[name][:2]
    assert all(np.array_equal(none_state[n], v) for n, v in state.items())
    got, _, _ = _port_run(ALL[name], state, cots)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    rows = np.abs(jax_none[0] - want[0]).reshape(B, -1).max(1)
    assert rows[0] < TOL and (rows[1:] > 1e-3).all(), rows


def test_defaults_follow_the_input_and_dropout_draws_from_the_layer():
    """A default state takes the input's dtype and device; between
    stacked layers, in training, dropout draws from the layer's own
    generator (the same masks on every call from one seed, none in eval
    or after the last layer)."""
    g = torch.Generator().manual_seed(0)
    cell = pnn.GRUCell(D, H, generator=g)
    x = torch.from_numpy(_x((B, D), 1)).double()
    assert cell.get_initial_states(x).dtype == torch.float64
    lstm = pnn.LSTM(D, H, num_layers=2, dropout=0.5,
                    generator=torch.Generator().manual_seed(1))
    seq = torch.from_numpy(SEQ)
    a, b = lstm(seq)[0], lstm(seq)[0]
    assert not torch.equal(a, b)          # the generator moved on
    lstm2 = pnn.LSTM(D, H, num_layers=2, dropout=0.5,
                     generator=torch.Generator().manual_seed(1))
    assert torch.equal(lstm2(seq)[0], a)  # one seed, one stream
    lstm.eval()
    e1, e2 = lstm(seq)[0], lstm(seq)[0]
    assert torch.equal(e1, e2)
    with pytest.raises(ValueError, match="direction"):
        pnn.GRU(D, H, direction="backward",
                generator=torch.Generator().manual_seed(0))
