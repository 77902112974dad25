"""The tensor-parallel layers
(``paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py``).

Each parameter carries its ``dist_spec``, a tuple naming the mesh axis
each dim shards over (None: whole), as the JAX layers carry a
PartitionSpec: the train steps cut each rank's shard by it.  Called on
one tensor (outside any group) a layer computes with its whole weights;
called on a per-rank list inside a `spmd.scope`, each rank computes with
its shard and the ``model`` collectives join them, as under the JAX
step's ``shard_map``:

- `ColumnParallelLinear` enters with `copy_to_model_parallel` (identity
  forward, the sum over ``model`` backward) and, with `gather_output`,
  gathers the column shards;
- `RowParallelLinear` sums the ranks' partial products (the sum forward,
  identity backward) and then adds its replicated bias; its input is the
  rank's column slice whatever `input_is_parallel` says, as in JAX;
- `VocabParallelEmbedding` looks up the ids of its rank's vocabulary
  range (others masked to 0) and sums over ``model``;
- `ParallelCrossEntropy` takes vocabulary-sharded logits: the max over
  the shards (no gradient: the shift cancels), the sums of exp and of
  the label's logit over ``model``.

The two conjugate pairs decide the gradients' scale: each rank's loss
is the whole loss, and its cotangent enters every rank once.  A weight
the step left whole (its dim not divisible by the axis: the spec falls
back to whole) computes on each rank as outside a group, with no
collective, where the JAX layers would still split the work.
"""
import torch

from ....nn import functional as F
from ....nn.layers.common import Embedding, Linear
from ... import spmd

AXIS = "model"


def copy_to_model_parallel(x):
    """Identity forward, the sum over ``model`` backward: the entry of a
    tensor-parallel region for an activation feeding a model-sharded
    product outside these layers (the tied LM head).  A tensor outside
    any group passes as it is."""
    if not isinstance(x, list):
        return x
    return spmd.current()[0].copy_to(x, AXIS)


def _spec(p, spec):
    if p is not None:
        p.dist_spec = spec
        p.is_distributed = any(a is not None for a in spec)
    return p


class ColumnParallelLinear(Linear):
    """Weight [in, out] sharded on out (its columns) over ``model``; the
    bias with it."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, generator=None):
        super().__init__(in_features, out_features, weight_attr,
                         None if has_bias else False, generator=generator)
        self.gather_output = gather_output
        _spec(self.weight, (None, AXIS))
        _spec(self.bias, (AXIS,))

    def forward(self, x):
        grp, mods, xs = spmd.ranks_of(self, x)
        split = mods[0].weight.shape[1] < self.out_features  # a shard
        if split:
            xs = grp.copy_to(xs, AXIS)
        ys = [F.linear(xi, m.weight, m.bias) for m, xi in zip(mods, xs)]
        if split and self.gather_output:
            ys = grp.gather_last(ys, AXIS)
        return spmd.unlisted(ys, x)


class RowParallelLinear(Linear):
    """Weight [in, out] sharded on in (its rows) over ``model``; the
    products summed over ``model``, then the replicated bias added."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 generator=None):
        super().__init__(in_features, out_features, weight_attr,
                         None if has_bias else False, generator=generator)
        self.input_is_parallel = input_is_parallel
        _spec(self.weight, (AXIS, None))
        _spec(self.bias, (None,))

    def forward(self, x):
        grp, mods, xs = spmd.ranks_of(self, x)
        ys = [F.linear(xi, m.weight) for m, xi in zip(mods, xs)]
        if mods[0].weight.shape[0] < self.in_features:      # a shard
            ys = grp.reduce_from(ys, AXIS)
        if self.bias is not None:
            ys = [y + m.bias for m, y in zip(mods, ys)]
        return spmd.unlisted(ys, x)


class VocabParallelEmbedding(Embedding):
    """Table [vocab, dim] sharded on the vocabulary over ``model``,
    Normal(0, 0.02)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, generator=None):
        super().__init__(num_embeddings, embedding_dim,
                         weight_attr=weight_attr, generator=generator,
                         std=0.02)
        self.num_embeddings = num_embeddings
        _spec(self.weight, (AXIS, None))

    def forward(self, x):
        grp, mods, ids = spmd.ranks_of(self, x)
        n = grp.axis_size(AXIS)
        if mods[0].weight.shape[0] == self.num_embeddings:  # whole
            return spmd.unlisted([F.embedding(i, m.weight)
                                  for m, i in zip(mods, ids)], x)
        per = self.num_embeddings // n
        out = []
        for r, (m, i) in enumerate(zip(mods, ids)):
            lo = grp.coord(r, AXIS) * per
            i = i.long()
            emb = F.embedding((i - lo).clamp(0, per - 1), m.weight)
            keep = ((i >= lo) & (i < lo + per))[..., None]
            out.append(emb * keep.to(emb.dtype))
        return spmd.unlisted(grp.reduce_from(out, AXIS), x)


class ParallelCrossEntropy(torch.nn.Module):
    """Softmax cross entropy over vocabulary-sharded logits, [..., 1];
    outside a group (or at ``model`` 1) `softmax_with_cross_entropy`."""

    def __init__(self, mp_group=None, name=None):
        super().__init__()

    def forward(self, input, label):
        grp = spmd.current()[0] if isinstance(input, list) else spmd.SOLO
        logits, labels = spmd.listed(input, 1), spmd.listed(label, 1)
        if grp.axis_size(AXIS) == 1:
            return spmd.unlisted([F.softmax_with_cross_entropy(z, li)
                                  for z, li in zip(logits, labels)], input)
        local_v = logits[0].shape[-1]
        gmax = grp.pmax([z.amax(-1, keepdim=True) for z in logits], AXIS)
        shifted = [z - g for z, g in zip(logits, gmax)]
        denom = grp.reduce_from([torch.exp(s).sum(-1, keepdim=True)
                                 for s in shifted], AXIS)
        picked = []
        for r, (s, li) in enumerate(zip(shifted, labels)):
            if li.dim() == s.dim() and li.shape[-1] == 1:
                li = li.squeeze(-1)
            li = li.long()
            lo = grp.coord(r, AXIS) * local_v
            got = s.gather(-1, (li - lo).clamp(0, local_v - 1)[..., None])
            keep = ((li >= lo) & (li < lo + local_v))[..., None]
            picked.append(got * keep.to(got.dtype))
        num = grp.reduce_from(picked, AXIS)
        return [torch.log(d) - p for d, p in zip(denom, num)]


__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy",
           "RowParallelLinear", "VocabParallelEmbedding",
           "copy_to_model_parallel"]
