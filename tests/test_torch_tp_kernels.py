"""Port parity: the three paged attention wrappers under a
tensor-parallel mesh.

On the CPU each shard's call runs the kernel's plain version on its
``num_heads / tp`` heads over its pool shard; the JAX package runs the
Pallas kernel per shard under ``shard_map`` (``_head_shard_map``, in
interpret mode, over the conftest's forced host devices), as its
``test_mesh_kernels.py`` does.  Both read pools filled with the same
rows; the port's output shards, gathered, agree with the JAX output
within 2e-5, the slice's attention tolerance, on float32 and int8 pools
in both layouts.  The card runs the same per-shard calls through the CUDA
kernels (``chip_smoke.py`` phase 15).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

from paddle_tpu import generation as jgen
from paddle_tpu.generation import decode_attention as jattn
from paddle_tpu.parallel import tp_mesh as jax_tp_mesh
from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.parallel import gather_heads, tp_mesh

TP, H, D, PS = 4, 4, 8, 4
TOL = 2e-5
SEQS = (("A", 13), ("B", 6), ("C", 12))
STARTS = np.array([0, 1, 2, 0], np.int32)
LENS = np.array([1, 1, 5, 0], np.int32)
KV_LENS = np.array([13, 6, 12, 0], np.int32)


@pytest.fixture(scope="module")
def meshes():
    return jax_tp_mesh(TP), tp_mesh(TP, devices=["cpu"] * TP)


def _pools(meshes, layout, dtype, seed=7):
    """The JAX and the port's sharded pools over the same rows, and the
    page tables (equal in both) of sequences A, B, C."""
    rng = np.random.default_rng(seed)
    jpool = jgen.DeviceKVPool(1, H, D, num_pages=32, page_size=PS,
                              pool_layout=layout, dtype=np.dtype(dtype),
                              mesh=meshes[0])
    ppool = pgen.DeviceKVPool(1, H, D, num_pages=32, page_size=PS,
                              pool_layout=layout,
                              dtype=getattr(torch, dtype), mesh=meshes[1])
    for sid, n in SEQS:
        arr = rng.standard_normal((1, n, H, D)).astype(np.float32)
        jpool.allocate(sid)
        jpool.append_prefill(sid, arr, -arr)
        ppool.allocate(sid)
        ppool.reserve(sid, n)
        x = torch.from_numpy(arr[None])
        ppool.write_prefill_batch([sid], [0], [n], x, -x)
    pt, _ = ppool.gather_block_tables([s for s, _ in SEQS])
    assert np.array_equal(pt, jpool.gather_block_tables(
        [s for s, _ in SEQS])[0])
    return jpool, ppool, pt


def _layer(pool):
    kp, vp = pool.layer_pools(0)
    ks, vs = pool.layer_scales(0) if pool.quantized else (None, None)
    return kp, vp, ks, vs


def _i32(a):
    return torch.as_tensor(np.asarray(a, np.int32))


def _hold(out, want, mesh):
    """The port's output shards: one per shard, [rows, H/tp, D] on the
    shard's device; gathered, within TOL of the JAX output."""
    assert isinstance(out, list) and len(out) == TP
    for o, dev in zip(out, mesh.devices):
        assert o.shape[1] == H // TP and o.device == dev
    np.testing.assert_allclose(gather_heads(out, 1).numpy(),
                               np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_mesh_ragged_matches_the_jax_shard_map_kernel(meshes, layout,
                                                      dtype):
    jpool, ppool, pt = _pools(meshes, layout, dtype)
    pt4 = np.zeros((4, pt.shape[1]), np.int32)
    pt4[:3] = pt
    q = np.random.default_rng(1).standard_normal((8, H, D)).astype(
        np.float32)
    kp, vp, ks, vs = _layer(jpool)
    want = jattn.ragged_paged_attention(
        q, kp, vp, pt4, STARTS, LENS, KV_LENS, use_kernel=True,
        interpret=True, layout=layout, mesh=meshes[0], tp_axis="model",
        k_scale=ks, v_scale=vs)
    kp, vp, ks, vs = _layer(ppool)
    out = pgen.ragged_paged_attention(
        torch.from_numpy(q), kp, vp, _i32(pt4), _i32(STARTS), _i32(LENS),
        _i32(KV_LENS), layout=layout, k_scale=ks, v_scale=vs,
        mesh=meshes[1])
    _hold(out, want, meshes[1])
    # rows no descriptor owns are exact zeros on every shard
    assert all(not o[8 - 1].any() for o in out)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_mesh_chunk_prefill_matches_the_jax_shard_map_kernel(meshes, layout,
                                                             dtype):
    jpool, ppool, pt = _pools(meshes, layout, dtype, seed=8)
    q = np.random.default_rng(2).standard_normal((5, H, D)).astype(
        np.float32)
    kp, vp, ks, vs = _layer(jpool)
    want = jattn.chunk_prefill_attention(
        q, kp, vp, pt[0], 7, use_kernel=True, interpret=True, layout=layout,
        mesh=meshes[0], tp_axis="model", k_scale=ks, v_scale=vs)
    kp, vp, ks, vs = _layer(ppool)
    out = pgen.chunk_prefill_attention(
        torch.from_numpy(q), kp, vp, _i32(pt[0]), 7, layout=layout,
        k_scale=ks, v_scale=vs, mesh=meshes[1])
    _hold(out, want, meshes[1])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_mesh_paged_decode_matches_the_jax_shard_map_kernel(meshes, layout,
                                                            dtype):
    jpool, ppool, pt = _pools(meshes, layout, dtype, seed=9)
    q = np.random.default_rng(3).standard_normal((3, H, D)).astype(
        np.float32)
    lens = np.array([13, 6, 12], np.int32)
    kp, vp, ks, vs = _layer(jpool)
    want = jattn.paged_decode_attention(
        q, kp, vp, pt, lens, use_kernel=True, interpret=True, layout=layout,
        mesh=meshes[0], tp_axis="model", k_scale=ks, v_scale=vs)
    kp, vp, ks, vs = _layer(ppool)
    out = pgen.paged_decode_attention(
        torch.from_numpy(q), kp, vp, _i32(pt), _i32(lens), layout=layout,
        k_scale=ks, v_scale=vs, mesh=meshes[1])
    _hold(out, want, meshes[1])
    # the plain versions take the mesh too, with the same result
    plain = pgen.paged_decode_attention_reference(
        torch.from_numpy(q), kp, vp, _i32(pt), _i32(lens), layout=layout,
        k_scale=ks, v_scale=vs, mesh=meshes[1])
    for a, b in zip(out, plain):
        assert torch.equal(a, b)


def test_mesh_call_rejects_indivisible_heads(meshes):
    """Heads that do not divide by tp cannot shard: ValueError from every
    wrapper."""
    pool = pgen.DeviceKVPool(1, 3, D, num_pages=8, page_size=PS,
                             device="cpu")
    kp, vp = pool.layer_pools(0)
    q = torch.zeros((2, 3, D))
    pt, one = _i32([[0], [0]]), _i32([1, 1])
    for call in (
            lambda: pgen.ragged_paged_attention(
                q, kp, vp, pt, _i32([0, 1]), one, one, mesh=meshes[1]),
            lambda: pgen.paged_decode_attention(q, kp, vp, pt, one,
                                                mesh=meshes[1]),
            lambda: pgen.chunk_prefill_attention(q, kp, vp, pt[0], 0,
                                                 mesh=meshes[1])):
        with pytest.raises(ValueError, match="divisible"):
            call()


def test_raw_call_rejects_a_mesh_sharded_pool(meshes):
    """A sharded pool handed to the one-device call without ``mesh=``
    raises instead of attending over one shard as if it were the whole
    pool; with the mesh the same call runs per shard."""
    pool = pgen.DeviceKVPool(1, H, D, num_pages=8, page_size=PS,
                             mesh=meshes[1])
    kp, vp = pool.layer_pools(0)
    q = torch.zeros((1, H, D))
    pt, one = _i32([[0, 0]]), _i32([1])
    for call in (
            lambda **kw: pgen.ragged_paged_attention(
                q, kp, vp, pt, _i32([0]), one, one, **kw),
            lambda **kw: pgen.paged_decode_attention(q, kp, vp, pt, one,
                                                     **kw),
            lambda **kw: pgen.chunk_prefill_attention(q, kp, vp, pt[0], 0,
                                                      **kw)):
        with pytest.raises(NotImplementedError, match="mesh-sharded"):
            call()
        out = call(mesh=meshes[1])
        assert len(out) == TP and all(o.shape == (1, 1, D) for o in out)
