"""Port parity: beam search (``ops.sequence_ops.beam_search``,
``beam_search_decode``, ``ops.nn_extra.gather_tree``) and seq2seq
decoding (``nn.BeamSearchDecoder``, ``nn.dynamic_decode``) against the
JAX package's, both on the CPU: ids identical, scores within 1e-5.

Cases: an expansion step with finished beams among live ones, another
with candidates of equal scores (JAX's ``lax.top_k`` order, lower index
first), a backtrace over random parents, and decoders over a GRU cell
carried from JAX by ``models.layer_from_numpy``: one that runs to its
step cap, one in which every beam ends early, with `return_length` and
time-major output."""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.ops import nn_extra as jextra
from paddle_tpu.ops import sequence_ops as jseq
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models import layer_from_numpy
from paddle_tpu_torch.ops import nn_extra as pextra
from paddle_tpu_torch.ops import sequence_ops as pseq

BATCH, BEAM, K, V, H, END = 3, 4, 5, 11, 8, 2
SCORE_TOL = 1e-5


def _np(t):
    return np.asarray(t._data) if hasattr(t, "_data") else \
        t.detach().numpy()


def _step_inputs(seed, ties=False):
    rng = np.random.default_rng(seed)
    pre_ids = rng.integers(0, V, (BATCH * BEAM, 1))
    pre_ids[[1, 6]] = END                         # two finished beams
    pre_scores = rng.normal(size=(BATCH * BEAM, 1)).astype(np.float32)
    ids = rng.integers(0, V, (BATCH * BEAM, K))
    scores = rng.normal(size=(BATCH * BEAM, K)).astype(np.float32)
    if ties:
        scores = np.round(scores)                 # many equal candidates
        pre_scores = np.round(pre_scores)
    return pre_ids, pre_scores, ids, scores


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("accumulated", [True, False])
def test_beam_search_step_matches_jax(ties, accumulated):
    pre_ids, pre_scores, ids, scores = _step_inputs(3, ties)
    if not accumulated:
        scores = np.abs(scores) + 0.01            # probabilities' scale
    kw = dict(beam_size=BEAM, end_id=END, is_accumulated=accumulated)
    want = jseq.beam_search(*[paddle.to_tensor(a) for a in (
        pre_ids, pre_scores, ids, scores)], **kw)
    got = pseq.beam_search(*[torch.from_numpy(a) for a in (
        pre_ids, pre_scores, ids, scores)], **kw)
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_array_equal(_np(got[2]), _np(want[2]))
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=SCORE_TOL,
                               atol=SCORE_TOL)


def test_beam_search_ties_take_the_lower_index():
    """Every candidate of equal score: the first `beam_size` flat
    positions win, all from beam 0, in order; a finished beam offers
    itself once, at its frozen score."""
    pre_ids = torch.tensor([[4], [END]])
    pre_scores = torch.tensor([[0.0], [-0.5]])
    ids = torch.tensor([[7, 8, 9], [5, 6, 7]])
    sel, score, parent = pseq.beam_search(
        pre_ids, pre_scores, ids, torch.zeros(2, 3), beam_size=2,
        end_id=END)
    assert sel[:, 0].tolist() == [7, 8] and parent.tolist() == [0, 0]
    sel, score, parent = pseq.beam_search(
        pre_ids, pre_scores, ids, torch.full((2, 3), -1.0), beam_size=2,
        end_id=END)
    assert sel[:, 0].tolist() == [END, 7] and parent.tolist() == [1, 0]
    assert score[:, 0].tolist() == [-0.5, -1.0]


def test_gather_tree_and_beam_search_decode_match_jax():
    rng = np.random.default_rng(4)
    t = 7
    ids = rng.integers(0, V, (t, BATCH, BEAM))
    parents = rng.integers(0, BEAM, (t, BATCH, BEAM))
    want = jextra.gather_tree(paddle.to_tensor(ids), paddle.to_tensor(
        parents))
    got = pextra.gather_tree(torch.from_numpy(ids), torch.from_numpy(
        parents))
    np.testing.assert_array_equal(_np(got), _np(want))
    step_ids = [rng.integers(0, V, (BATCH * BEAM, 1)) for _ in range(t)]
    flat_parents = [rng.integers(0, BEAM, (BATCH, BEAM))
                    + np.arange(BATCH)[:, None] * BEAM for _ in range(t)]
    flat_parents = [p.reshape(-1) for p in flat_parents]
    want = jseq.beam_search_decode(
        [paddle.to_tensor(a) for a in step_ids],
        [paddle.to_tensor(a) for a in flat_parents], BEAM, END)
    got = pseq.beam_search_decode(
        [torch.from_numpy(a) for a in step_ids],
        [torch.from_numpy(a) for a in flat_parents], BEAM, END)
    np.testing.assert_array_equal(_np(got), _np(want))


class _Cell:
    """The decoder contract over a GRU cell, an embedding and an output
    projection of either package: ids and states in, logits and states
    out."""

    def __init__(self, emb, cell, out):
        self.emb, self.cell, self.out = emb, cell, out

    def __call__(self, ids, states):
        h, _ = self.cell(self.emb(ids), states[0])
        return self.out(h), (h,)


def _decoders(end_bias):
    """A JAX and a port decoder cell holding the same weights; the output
    bias of the end token raised by `end_bias`."""
    paddle.seed(7)
    j = [jnn.Embedding(V, H), jnn.GRUCell(H, H), jnn.Linear(H, V)]
    g = torch.Generator().manual_seed(0)
    p = [pnn.Embedding(V, H, generator=g), pnn.GRUCell(H, H, generator=g),
         pnn.Linear(H, V, generator=g)]
    for jl, pl in zip(j, p):
        state = {n: np.array(t._data) for n, t in jl.state_dict().items()}
        if "bias" in state and state["bias"].shape == (V,):
            state["bias"][END] += end_bias
            jl.set_state_dict({n: paddle.to_tensor(v)
                               for n, v in state.items()})
        layer_from_numpy(pl, state, device="cpu")
    return _Cell(*j), _Cell(*p)


@pytest.mark.parametrize("end_bias,steps", [(0.0, 6), (40.0, 9)],
                         ids=["to_the_cap", "every_beam_ends_early"])
@pytest.mark.parametrize("time_major", [False, True])
def test_dynamic_decode_matches_jax(end_bias, steps, time_major):
    """`dynamic_decode` over `BeamSearchDecoder`: the backtracked ids
    identical, the final scores within 1e-5, the lengths equal; where
    the end token dominates, every beam ends after its first steps and
    the loop stops before the cap."""
    jcell, pcell = _decoders(end_bias)
    h0 = np.random.default_rng(5).standard_normal((BATCH, H)).astype(
        np.float32)
    kw = dict(start_token=0, end_token=END, beam_size=BEAM)
    want = jnn.dynamic_decode(jnn.BeamSearchDecoder(jcell, **kw),
                              inits=(paddle.to_tensor(h0),),
                              max_step_num=steps,
                              output_time_major=time_major,
                              return_length=True)
    got = pnn.dynamic_decode(pnn.BeamSearchDecoder(pcell, **kw),
                             inits=(torch.from_numpy(h0),),
                             max_step_num=steps,
                             output_time_major=time_major,
                             return_length=True)
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    np.testing.assert_array_equal(_np(got[2]), _np(want[2]))
    t_axis = 0 if time_major else 1
    if end_bias:
        assert got[0].shape[t_axis] < steps
        assert (_np(got[2]) <= 1).all()
    else:
        assert got[0].shape[t_axis] == steps


def test_decoder_initialize_and_tile():
    """`initialize` tiles each state row over the beams, starts every
    beam at the start token and only each batch row's first beam live
    (the rest at -1e9), on the states' device; decoding carries no
    gradient."""
    dec = pnn.BeamSearchDecoder(lambda i, s: None, 1, END, BEAM)
    h = torch.arange(6.0, requires_grad=True).reshape(2, 3)
    ids, scores, (st,) = dec.initialize((h,))
    assert ids.shape == (2 * BEAM, 1) and (ids == 1).all()
    assert scores.view(2, BEAM)[:, 0].eq(0).all()
    assert scores.view(2, BEAM)[:, 1:].eq(-1e9).all()
    assert torch.equal(st, h.detach().repeat_interleave(BEAM, 0))
    assert not st.requires_grad
