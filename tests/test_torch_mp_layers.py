"""Port parity: the tensor-parallel layers
(``paddle_tpu_torch/distributed/fleet/meta_parallel/mp_layers.py``) and
the RNG trackers (``random_rng.py``).

Each layer runs at ``{"model": 2}`` on the CPU: two ranks in one group
(``distributed.spmd``), each holding its shard of the weights as the
train steps cut it by ``dist_spec``, every rank with its own leaf copy
of the input, and each rank's loss ``sum(out * w)`` with one seeded
cotangent ``w`` (the JAX step's semantics: every device's own loss).
Held to the JAX layer eagerly with its whole weights (the product the
JAX mesh program shards) within 1e-5 for the output and every gradient,
and the two ranks' gradients, put back together, to the port's own
one-rank call within 1e-6 (the conjugate pairs give each rank the
whole loss's gradient once).
"""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.meta_parallel import mp_layers as jmp
from paddle_tpu_torch.distributed import spmd
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    RNGStatesTracker, get_rng_state_tracker, model_parallel_random_seed)
from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_layers as pmp
from paddle_tpu_torch.parallel.hybrid import shard_of

TP, IN, OUT, VOCAB = 2, 16, 24, 32
X_SHAPE = (3, 5)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return np.asarray(t._data)


def _build(kind):
    """(JAX layer, port layer with the same weights, the input as numpy)."""
    paddle.seed(4)
    rng = np.random.default_rng(5)
    if kind.startswith("column"):
        gather = kind == "column_gather"
        jl = jmp.ColumnParallelLinear(IN, OUT, gather_output=gather)
        pl = pmp.ColumnParallelLinear(IN, OUT, gather_output=gather,
                                      generator=torch.Generator())
        x = rng.standard_normal(X_SHAPE + (IN,)).astype(np.float32)
    elif kind == "row":
        jl = jmp.RowParallelLinear(IN, OUT, input_is_parallel=True)
        pl = pmp.RowParallelLinear(IN, OUT, input_is_parallel=True,
                                   generator=torch.Generator())
        x = rng.standard_normal(X_SHAPE + (IN,)).astype(np.float32)
    else:
        jl = jmp.VocabParallelEmbedding(VOCAB, IN)
        pl = pmp.VocabParallelEmbedding(VOCAB, IN,
                                        generator=torch.Generator())
        x = rng.integers(0, VOCAB, X_SHAPE).astype(np.int32)
    with torch.no_grad():
        named = dict(pl.named_parameters())
        for n, p in jl.named_parameters():
            # a bias of zeros would hide a bias gradient's placement
            value = _np(p) + (0.1 * rng.standard_normal(p.shape) if
                              n == "bias" else 0)
            p._data = paddle.to_tensor(value.astype(np.float32))._data
            named[n].copy_(torch.from_numpy(np.array(_np(p))))
    return jl, pl, x


def _input_shard(kind, x, r):
    """What rank `r` takes: the row-parallel layer its column slice of the
    input, every other layer the whole input."""
    if kind == "row":
        w = IN // TP
        return x[..., r * w:(r + 1) * w]
    return x


def _ranks(layer, kind, x, w):
    """The layer over two ranks: each rank's output, its parameter
    gradients and its input gradient (None for ids)."""
    grp = spmd.RankGroup({"model": TP}, [torch.device("cpu")] * TP)
    reps = spmd.replicas(layer, TP)
    shards = [{n: shard_of(p.detach(), p.dist_spec, {"model": r},
                           {"model": TP}).clone().requires_grad_(True)
               for n, p in layer.named_parameters()} for r in range(TP)]
    xs = [torch.from_numpy(np.ascontiguousarray(_input_shard(kind, x, r)))
          for r in range(TP)]
    if kind != "vocab":
        xs = [t.requires_grad_(True) for t in xs]
    with spmd.scope(grp, reps), spmd.swapped_all(reps, shards):
        outs = layer(xs)
    ws = [torch.from_numpy(_out_slice(kind, w, r)) for r in range(TP)]
    total = sum((o * wi).sum() for o, wi in zip(outs, ws))
    leaves = [p for s in shards for p in s.values()]
    inputs = leaves + (xs if kind != "vocab" else [])
    grads = torch.autograd.grad(total, inputs)
    k = len(shards[0])
    names = list(shards[0])
    pgrads = [dict(zip(names, grads[r * k:(r + 1) * k])) for r in range(TP)]
    xgrads = list(grads[TP * k:]) if kind != "vocab" else None
    return outs, pgrads, xgrads


def _out_slice(kind, w, r):
    if kind == "column":        # gather_output=False: the local columns
        n = OUT // TP
        return np.ascontiguousarray(w[..., r * n:(r + 1) * n])
    return w


def _whole(layer, grads_per_rank, name):
    """A parameter's gradient put back together from the ranks' shards
    (a replicated parameter's from rank 0)."""
    spec = dict(layer.named_parameters())[name].dist_spec
    dims = [d for d, a in enumerate(spec) if a is not None]
    if not dims:
        return grads_per_rank[0][name]
    return torch.cat([g[name] for g in grads_per_rank], dims[0])


@pytest.mark.parametrize("kind", ["column_gather", "column", "row", "vocab"])
def test_layer_at_model_2_matches_jax_and_one_rank(kind):
    jl, pl, x = _build(kind)
    out_dim = OUT if kind != "vocab" else IN
    w = np.random.default_rng(6).standard_normal(
        X_SHAPE + (out_dim,)).astype(np.float32)
    # JAX, whole weights, eagerly
    jx = paddle.to_tensor(x)
    if kind != "vocab":
        jx.stop_gradient = False
    jout = jl(jx)
    (jout * paddle.to_tensor(w)).sum().backward()
    jgrads = {n: _np(p.grad) for n, p in jl.named_parameters()}
    # the port on one rank
    px = torch.from_numpy(x)
    if kind != "vocab":
        px.requires_grad_(True)
    pout = pl(px)
    (pout * torch.from_numpy(w)).sum().backward()
    one = {n: p.grad for n, p in pl.named_parameters()}
    np.testing.assert_allclose(pout.detach().numpy(), _np(jout), **TOL)
    # the port on two ranks
    outs, pgrads, xgrads = _ranks(pl, kind, x, w)
    got = torch.cat(outs, -1) if kind == "column" else outs[0]
    np.testing.assert_allclose(got.detach().numpy(), _np(jout), **TOL)
    for n in jgrads:
        whole = _whole(pl, pgrads, n)
        np.testing.assert_allclose(whole.numpy(), jgrads[n], err_msg=n,
                                   **TOL)
        torch.testing.assert_close(whole, one[n], rtol=1e-6, atol=1e-6)
    if xgrads is not None:
        if kind == "row":       # each rank's slice of the input
            got_x = torch.cat(xgrads, -1)
        else:
            got_x = xgrads[0]
            torch.testing.assert_close(xgrads[1], got_x, rtol=0, atol=0)
        np.testing.assert_allclose(got_x.numpy(), _np(jx.grad), **TOL)
        torch.testing.assert_close(got_x, px.grad, rtol=1e-6, atol=1e-6)


def test_parallel_cross_entropy_over_vocab_shards():
    """Sharded logits [3, 5, 32] over two ranks, labels anywhere in the
    vocabulary: each rank's loss is JAX's softmax cross entropy, and the
    ranks' logit gradients put together are the one-rank call's."""
    rng = np.random.default_rng(7)
    logits = rng.standard_normal(X_SHAPE + (VOCAB,)).astype(np.float32)
    label = rng.integers(0, VOCAB, X_SHAPE + (1,)).astype(np.int64)
    jz = paddle.to_tensor(logits)
    jz.stop_gradient = False
    jloss = jmp.ParallelCrossEntropy()(jz, paddle.to_tensor(label))
    jloss.sum().backward()
    one_z = torch.from_numpy(logits).requires_grad_(True)
    one = pmp.ParallelCrossEntropy()(one_z, torch.from_numpy(label))
    one.sum().backward()
    grp = spmd.RankGroup({"model": TP}, [torch.device("cpu")] * TP)
    zs = [z.clone().requires_grad_(True) for z in
          torch.from_numpy(logits).chunk(TP, -1)]
    with spmd.scope(grp, spmd.replicas(torch.nn.Module(), TP)):
        losses = pmp.ParallelCrossEntropy()(zs, [torch.from_numpy(label)]
                                            * TP)
    for loss in losses:
        np.testing.assert_allclose(loss.detach().numpy(), _np(jloss), **TOL)
    grads = torch.autograd.grad(sum(x.sum() for x in losses), zs)
    got = torch.cat(grads, -1)
    np.testing.assert_allclose(got.numpy(), _np(jz.grad), **TOL)
    torch.testing.assert_close(got, one_z.grad, rtol=1e-6, atol=1e-6)


def test_dist_specs_match_jax():
    """Each layer's parameters carry the JAX layer's PartitionSpec as a
    tuple, and the tied-head entry passes a tensor through."""
    for jl, pl in ((jmp.ColumnParallelLinear(4, 6),
                    pmp.ColumnParallelLinear(4, 6,
                                             generator=torch.Generator())),
                   (jmp.RowParallelLinear(4, 6),
                    pmp.RowParallelLinear(4, 6,
                                          generator=torch.Generator())),
                   (jmp.VocabParallelEmbedding(8, 4),
                    pmp.VocabParallelEmbedding(
                        8, 4, generator=torch.Generator()))):
        for n, p in jl.named_parameters():
            want = tuple(p.dist_spec)
            got = dict(pl.named_parameters())[n].dist_spec
            assert got + (None,) * (len(want) - len(got)) == want \
                + (None,) * (len(got) - len(want)), n
    t = torch.ones(2)
    assert pmp.copy_to_model_parallel(t) is t


def test_rng_tracker_names_and_advances():
    tr = RNGStatesTracker()
    tr.add("a", 1)
    with pytest.raises(ValueError, match="already exists"):
        tr.add("b", 1)
    with pytest.raises(ValueError, match="already exists"):
        tr.add("a", 2)
    with pytest.raises(ValueError, match="does not exist"):
        with tr.rng_state("c"):
            pass
    snap = tr.get_states_tracker()
    with tr.rng_state("a") as g:
        first = torch.rand(3, generator=g)
    with tr.rng_state("a") as g:
        second = torch.rand(3, generator=g)
    assert not torch.equal(first, second)
    tr.set_states_tracker(snap)
    with tr.rng_state("a") as g:
        assert torch.equal(torch.rand(3, generator=g), first)
    seed = model_parallel_random_seed(100, rank=1)
    assert seed == 100
    with get_rng_state_tracker().rng_state() as g:
        want = torch.Generator().manual_seed(100 + 1024 + 1)
        assert torch.equal(torch.rand(2, generator=g),
                           torch.rand(2, generator=want))
