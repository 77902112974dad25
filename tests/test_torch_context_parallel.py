"""Port parity: context parallelism (``paddle_tpu_torch.parallel.
context_parallel``: ring attention and Ulysses) against the JAX
package's ``_ring_attention_raw`` and ``_ulysses_attention_raw`` under
``shard_map`` on its forced CPU devices, at ``{"seq": 4}``.

q, k, v are [2, 4, 32, 8] from a numpy seed, their sequence cut into 4
chunks, one per rank; the loss is ``sum(out * w)`` with a seeded
non-uniform cotangent ``w`` (summed over the ranks, as the JAX global
function sums its shards).  Outputs within 2e-5, the q, k, v gradients
(the ranks' chunks put back together) within 1e-4.  The port's Ulysses
with ``use_flash`` runs the flash kernels' plain versions here; JAX's
runs its composite (its Pallas path does not trace under shard_map).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_threads  # noqa: F401
from paddle_tpu.parallel.collective import shard_map
from paddle_tpu.parallel.context_parallel import (_ring_attention_raw,
                                                  _ulysses_attention_raw)
from paddle_tpu.parallel.env import build_mesh
from paddle_tpu_torch.distributed import spmd
from paddle_tpu_torch.parallel import context_parallel as pcp

S, SHAPE = 4, (2, 4, 32, 8)
SEQ_SPEC = P(None, None, "seq", None)


def _inputs():
    rng = np.random.default_rng(3)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4)]


@functools.lru_cache(maxsize=None)
def _jax(mode, causal):
    """JAX's output and q, k, v gradients over the seq-4 mesh (one
    compiled value-and-grad)."""
    q, k, v, w = _inputs()
    if mode == "ring":
        def raw(a, b, c):
            return _ring_attention_raw(a, b, c, "seq", causal)
    else:
        def raw(a, b, c):
            return _ulysses_attention_raw(a, b, c, "seq", causal, False)
    fn = shard_map(raw, build_mesh({"seq": S}), (SEQ_SPEC,) * 3, SEQ_SPEC)
    def loss(*a):
        out = fn(*a)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port(mode, causal, flash, q, k, v, w):
    grp = spmd.RankGroup({"seq": S}, [torch.device("cpu")] * S)
    chunks = [[c.clone().requires_grad_(True)
               for c in torch.from_numpy(a).chunk(S, 2)] for a in (q, k, v)]
    with spmd.scope(grp, spmd.replicas(torch.nn.Module(), S)):
        outs = pcp.context_parallel_attention(
            *chunks, mode=mode, causal=causal, use_flash=flash)
    ws = torch.from_numpy(w).chunk(S, 2)
    total = sum((o * wi).sum() for o, wi in zip(outs, ws))
    flat = [c for group in chunks for c in group]
    grads = torch.autograd.grad(total, flat)
    return (torch.cat([o.detach() for o in outs], 2).numpy(),
            [torch.cat(grads[i * S:(i + 1) * S], 2).numpy()
             for i in range(3)])


@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "full"])
@pytest.mark.parametrize("mode,flash", [("ring", False),
                                        ("ulysses", False),
                                        ("ulysses", True)],
                         ids=["ring", "ulysses", "ulysses-flash"])
def test_matches_jax(mode, flash, causal):
    q, k, v, w = _inputs()
    want_out, want_g = _jax(mode, causal)
    got_out, got_g = _port(mode, causal, flash, q, k, v, w)
    np.testing.assert_allclose(got_out, want_out, rtol=2e-5, atol=2e-5)
    for name, a, b in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_outside_a_group_is_plain_attention():
    """On tensors (no group scope) it is scaled dot-product attention on
    the whole sequence."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs())
    got = pcp.context_parallel_attention(q, k, v, causal=True)
    want = pcp.scaled_dot_product_attention(q, k, v, is_causal=True)[0]
    assert torch.equal(got, want)
    assert not pcp.seq_axis_in_scope() and pcp.seq_chunk_offset(8) == [0]


def test_ulysses_needs_heads_divisible_by_the_axis():
    grp = spmd.RankGroup({"seq": 4}, [torch.device("cpu")] * 4)
    x = [torch.zeros(1, 2, 4, 8)] * 4
    with spmd.scope(grp, spmd.replicas(torch.nn.Module(), 4)):
        assert pcp.seq_axis_in_scope()
        assert pcp.seq_chunk_offset(4) == [0, 4, 8, 12]
        with pytest.raises(ValueError, match="divisible"):
            pcp.context_parallel_attention(x, x, x, mode="ulysses")
        with pytest.raises(ValueError, match="unknown"):
            pcp.context_parallel_attention(x, x, x, mode="tree")
