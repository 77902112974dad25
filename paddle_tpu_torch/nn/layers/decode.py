"""Seq2seq decoding (``paddle_tpu/nn/layers/decode.py``):
`BeamSearchDecoder` and `dynamic_decode`.

Beams ride a flat [batch·beam] leading axis, so the wrapped cell runs one
batched step per time step; each step's expansion is
``ops.sequence_ops.beam_search`` over the float32 log-softmax of the
logits, and the end is backtracked through ``gather_tree``.  Everything
stays on the cell's device: the one host read is `dynamic_decode`'s end
check, once a step, as in the JAX loop.  Decoding carries no gradient:
the scores and the gathered states are detached, as the JAX decoder's
numpy round trips make them."""
import torch

from ...ops.sequence_ops import NEG_INF, beam_search, beam_search_decode

__all__ = ["BeamSearchDecoder", "dynamic_decode"]

# dynamic_decode's cap when max_step_num is None
MAX_STEPS = 1024


def _map_state(state, fn):
    if isinstance(state, (list, tuple)):
        return type(state)(_map_state(s, fn) for s in state)
    return fn(state)


def _first(state):
    while isinstance(state, (list, tuple)):
        state = state[0]
    return state


class BeamSearchDecoder:
    """Beam search over a cell ``cell(inputs, states) -> (outputs,
    new_states)``: `embedding_fn` maps [batch·beam] int64 ids to the
    cell's inputs and `output_fn` its outputs to logits (both the
    identity when None)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[B, ...] to [B·beam, ...], each row repeated `beam_size` times
        in place, detached."""
        return x.detach().repeat_interleave(beam_size, dim=0)

    def initialize(self, initial_cell_states):
        """The states tiled over the beams; start ids [B·beam, 1]; scores
        [B·beam, 1], 0 for each batch row's first beam and -1e9 for the
        rest."""
        k = self.beam_size
        states = _map_state(initial_cell_states,
                            lambda s: self.tile_beam_merge_with_batch(s, k))
        ref = _first(initial_cell_states)
        b = ref.shape[0]
        ids = torch.full((b * k, 1), self.start_token, dtype=torch.int64,
                         device=ref.device)
        scores = torch.full((b, k), NEG_INF, dtype=torch.float32,
                            device=ref.device)
        scores[:, 0] = 0.0
        return ids, scores.reshape(b * k, 1), states

    def step(self, ids, scores, cell_states):
        """One expansion: embed, run the cell, score every token of the
        vocabulary on every beam, keep the top `beam_size` of each batch
        row.  Returns the chosen ids, their scores, their parents (flat
        beam rows) and the cell's new states gathered at the parents."""
        flat = ids.reshape(-1)
        inputs = flat if self.embedding_fn is None \
            else self.embedding_fn(flat)
        out, new_states = self.cell(inputs, cell_states)
        logits = out if self.output_fn is None else self.output_fn(out)
        with torch.no_grad():
            acc = scores + torch.log_softmax(logits.detach().float(), dim=-1)
            v = acc.shape[-1]
            cand = torch.arange(v, device=acc.device).expand(acc.shape[0], v)
            sel_ids, sel_scores, parent = beam_search(
                ids, scores, cand, acc, beam_size=self.beam_size,
                end_id=self.end_token, is_accumulated=True)
        gathered = _map_state(new_states,
                              lambda s: s.detach().index_select(0, parent))
        return sel_ids, sel_scores, parent, gathered


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, return_length=False, **kwargs):
    """Step `decoder` until every beam's last id is its end token, or
    `max_step_num` steps (1024 when None).  Returns the backtracked ids
    [B, T, beam] ([T, B, beam] with `output_time_major`) and the last
    step's scores [B·beam, 1], and with `return_length` each beam's
    count of ids other than the end token [B, beam]."""
    if max_step_num is None:
        max_step_num = MAX_STEPS
    ids, scores, states = decoder.initialize(inits)
    step_ids, step_parents = [], []
    for _ in range(int(max_step_num)):
        ids, scores, parent, states = decoder.step(ids, scores, states)
        step_ids.append(ids)
        step_parents.append(parent)
        if bool((ids == decoder.end_token).all()):
            break
    seqs = beam_search_decode(step_ids, step_parents,
                              beam_size=decoder.beam_size,
                              end_id=decoder.end_token)      # [T, B, beam]
    out = seqs if output_time_major else seqs.permute(1, 0, 2)
    if return_length:
        return out, scores, (seqs != decoder.end_token).sum(dim=0)
    return out, scores
