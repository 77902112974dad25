"""Port parity: the mixture of experts
(``paddle_tpu_torch/distributed/fleet/meta_parallel/moe_layer.py``)
against the JAX package's ``moe_layer.py``.

`top2_dispatch` is held to ``_top2_dispatch`` on identical float32
logits: the expert choices and the capacity slots exactly, the combine
weights and the aux loss within 1e-6, with and without capacity drops.
`MoELayer` (hidden 16, ffn 32, 4 experts, x [2, 8, 16] from a numpy
seed, the JAX layer's weights) eagerly: output, aux loss and every
gradient of ``sum(out * w) + 0.01 aux`` within 1e-5.  At ``{"expert":
2}`` (two ranks, each holding 2 experts and the same tokens, each rank's
loss its own as in the JAX step): each rank's output is the eager one,
the gate's gradient is the eager one, and each expert's weight gradient
is twice the eager one: both ranks' losses reach the experts a rank
holds through the all-to-all, which is what the JAX step's transpose of
``all_to_all`` gives them.
"""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.meta_parallel import moe_layer as jmoe
from paddle_tpu_torch.distributed import spmd
from paddle_tpu_torch.distributed.fleet.meta_parallel import moe_layer as pmoe
from paddle_tpu_torch.parallel.hybrid import shard_of

H, F, E, SHAPE = 16, 32, 4, (2, 8, 16)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return np.asarray(t._data)


@pytest.mark.parametrize("n,capacity", [(64, 40), (64, 4), (7, 4)],
                         ids=["roomy", "drops", "short"])
def test_top2_dispatch_matches_jax(n, capacity):
    logits = np.random.default_rng(n + capacity).standard_normal(
        (n, E)).astype(np.float32)
    jc, jd, ja = jmoe._top2_dispatch(jnp.asarray(logits), capacity)
    pc, pd, pa = pmoe.top2_dispatch(torch.from_numpy(logits), capacity)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(pa), float(ja), rtol=1e-6)
    kept = pd.any(-1).any(-1)
    if capacity == 4 and n == 64:
        assert not kept.all()       # over capacity: some tokens dropped
    assert pmoe.capacity_of(n, E, 1.25) == max(int(np.ceil(
        2 * n / E * 1.25)), 4)


def _pair():
    paddle.seed(8)
    jl = jmoe.MoELayer(H, F, E)
    pl = pmoe.MoELayer(H, F, E, generator=torch.Generator())
    with torch.no_grad():
        named = dict(pl.named_parameters())
        rng = np.random.default_rng(9)
        for n, p in jl.named_parameters():
            value = _np(p)
            if n.startswith("b"):       # zeros would hide a bias's use
                value = value + 0.1 * rng.standard_normal(value.shape)
            p._data = paddle.to_tensor(value.astype(np.float32))._data
            named[n].copy_(torch.from_numpy(np.array(_np(p))))
    rng = np.random.default_rng(10)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    w = rng.standard_normal(SHAPE).astype(np.float32)
    return jl, pl, x, w


def _jax_eager(jl, x, w):
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    out = jl(jx)
    total = (out * paddle.to_tensor(w)).sum() + paddle.scale(jl.aux_loss,
                                                            0.01)
    total.backward()
    return (_np(out), float(_np(jl.aux_loss)),
            {n: _np(p.grad) for n, p in jl.named_parameters()}, _np(jx.grad))


def test_moe_layer_eager_matches_jax():
    jl, pl, x, w = _pair()
    jout, jaux, jgrads, jxg = _jax_eager(jl, x, w)
    px = torch.from_numpy(x).requires_grad_(True)
    out = pl(px)
    ((out * torch.from_numpy(w)).sum() + 0.01 * pl.aux_loss).backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL)
    np.testing.assert_allclose(float(pl.aux_loss.detach()), jaux, rtol=1e-6)
    for n, p in pl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n], err_msg=n,
                                   **TOL)
    np.testing.assert_allclose(px.grad.numpy(), jxg, **TOL)
    assert pl.w1.dist_spec == ("expert",)
    assert getattr(pl.gate_weight, "dist_spec", None) is None


def test_moe_layer_at_expert_2():
    jl, pl, x, w = _pair()
    jout, jaux, jgrads, _ = _jax_eager(jl, x, w)
    ep = 2
    grp = spmd.RankGroup({"expert": ep}, [torch.device("cpu")] * ep)
    reps = spmd.replicas(pl, ep)
    shards = [{n: shard_of(p.detach(), getattr(p, "dist_spec", ()) or
                           (None,), {"expert": r}, {"expert": ep})
               .clone().requires_grad_(True)
               for n, p in pl.named_parameters()} for r in range(ep)]
    xs = [torch.from_numpy(x) for _ in range(ep)]
    with spmd.scope(grp, reps), spmd.swapped_all(reps, shards):
        outs = pl(xs)
    auxes = [m.aux_loss for m in reps]
    total = sum((o * torch.from_numpy(w)).sum() + 0.01 * a
                for o, a in zip(outs, auxes))
    names = list(shards[0])
    grads = torch.autograd.grad(total, [s[n] for s in shards for n in names])
    per = [dict(zip(names, grads[r * len(names):(r + 1) * len(names)]))
           for r in range(ep)]
    for o, a in zip(outs, auxes):
        np.testing.assert_allclose(o.detach().numpy(), jout, **TOL)
        np.testing.assert_allclose(float(a.detach()), jaux, rtol=1e-6)
    for n in names:
        if n == "gate_weight":
            for g in per:
                np.testing.assert_allclose(g[n].numpy(), jgrads[n], **TOL)
            continue
        whole = torch.cat([g[n] for g in per], 0)
        np.testing.assert_allclose(whole.numpy(), ep * jgrads[n],
                                   err_msg=n, **TOL)
    assert grp.sent["expert"] > 0
