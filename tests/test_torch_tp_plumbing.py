"""Port parity: the tensor-parallel plumbing, with no engine.

The mesh (`parallel.tp_mesh`), the head-sharded `DeviceKVPool` (per-shard
bytes, every write path, the pool's lifecycle, copy on write and
truncate), the head-axis specs, and the two all-reduces of a sharded step
(`allreduce_sum`, and `quantized_ring_allreduce` against the JAX ring run
under ``shard_map`` on the conftest's forced host devices), with their
byte estimates.  The port's meshes put four shards on the CPU
(``devices=["cpu"] * 4``); a sharded pool must hold exactly the bytes an
unsharded one holds, split by heads.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from paddle_tpu.generation import fused as jfused
from paddle_tpu.parallel import tp_mesh as jax_tp_mesh
from paddle_tpu.parallel.collective import shard_map
from paddle_tpu.parallel.quantized_allreduce import (
    quantized_collective_bytes as jax_quantized_collective_bytes,
    quantized_ring_allreduce as jax_quantized_ring_allreduce)
from paddle_tpu.parallel.sharding_annotations import (
    kv_pool_spec as jax_kv_pool_spec, kv_scale_spec as jax_kv_scale_spec)
from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.generation import fused as pfused
from paddle_tpu_torch.parallel import (
    TPMesh, allreduce_sum, gather_heads, kv_pool_spec, kv_scale_spec,
    quantized_collective_bytes, quantized_ring_allreduce, shard_heads,
    tp_mesh)

TP = 4
L, H, D, PS, PAGES = 2, 4, 8, 4, 16
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}


def _mesh(tp=TP, axis_name="model"):
    return tp_mesh(tp, axis_name=axis_name, devices=["cpu"] * tp)


def _pool(mesh=None, dtype="float32", layout="token", **kw):
    return pgen.DeviceKVPool(L, H, D, num_pages=PAGES, page_size=PS,
                             dtype=DTYPES[dtype], pool_layout=layout,
                             device="cpu", mesh=mesh, **kw)


def _fill(pool, seed=0):
    """The same writes on any pool: a batched prefill of two sequences,
    a decode token, and an eager prefill chunk."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    for sid in ("a", "b"):
        pool.allocate(sid)
    pool.reserve("a", 7)
    pool.reserve("b", 5)
    pool.write_prefill_batch(["a", "b"], [0, 0], [7, 5], t(2, L, 7, H, D),
                             t(2, L, 7, H, D))
    pos = [pool.reserve("a", 1), pool.reserve("b", 1)]
    for layer in range(L):
        pool.write_decode_tokens(["a", "b"], pos, layer, t(2, H, D),
                                 t(2, H, D))
    start = pool.reserve("b", 3)
    for layer in range(L):
        pool.write_prefill_tokens("b", start, layer, t(3, H, D), t(3, H, D))


def _state_ptrs(pool):
    return [p.data_ptr() for entry in pool.take_pool_state()
            for p in (entry if isinstance(entry, list) else [entry])]


def _assert_same_bytes(a, b):
    np.testing.assert_array_equal(a.k_pool, b.k_pool)
    np.testing.assert_array_equal(a.v_pool, b.v_pool)
    if a.quantized:
        np.testing.assert_array_equal(a.k_scale, b.k_scale)
        np.testing.assert_array_equal(a.v_scale, b.v_scale)


# ------------------------------- the mesh --------------------------------


def test_tp_mesh_builds_named_mesh_and_refuses_what_it_cannot_place():
    m = _mesh()
    assert m.axis_names == ("model",) and m.shape["model"] == TP
    assert m.size == TP and m.devices == (torch.device("cpu"),) * TP
    assert m.distinct_devices == (torch.device("cpu"),)
    assert _mesh(2, axis_name="tp").shape["tp"] == 2
    x = torch.arange(4.0)
    # shards on one device share its one copy
    assert all(r is x for r in m.replicate(x))
    with pytest.raises(ValueError):
        tp_mesh(0)
    with pytest.raises(ValueError):
        tp_mesh(3, devices=["cpu"] * 4)
    # without devices= it takes visible cards only, never two shards on one
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="visible"):
        tp_mesh(visible + 1)


def test_kv_specs_match_the_jax_specs_axis():
    for layout in ("token", "kernel"):
        assert kv_pool_spec(layout) == tuple(
            jax_kv_pool_spec(layout, "model")).index("model")
    assert kv_scale_spec() == tuple(jax_kv_scale_spec("model")).index("model")


def test_shard_heads_pieces_are_fresh_and_gather_back():
    m = _mesh()
    x = torch.randn(6, 16, 5)
    for axis in (0, 1):
        if x.shape[axis] % TP:
            continue
        parts = shard_heads(x, axis, m)
        assert len(parts) == TP
        for p in parts:
            assert p.is_contiguous()
            # a fresh tensor: its storage holds its own bytes only
            assert p.untyped_storage().nbytes() == p.numel() * 4
        assert torch.equal(gather_heads(parts, axis), x)
    with pytest.raises(ValueError, match="divisible"):
        shard_heads(torch.randn(6, 3), 1, m)


# ---------------------------- the sharded pool ----------------------------


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_sharded_pool_per_shard_bytes_are_one_over_tp(layout, dtype):
    """Each shard holds num_heads/tp heads of every page: its pool and
    scale bytes are exactly 1/tp of the unsharded pool's."""
    mesh = _mesh()
    pool, plain = _pool(mesh, dtype, layout), _pool(None, dtype, layout)
    assert pool.tp_degree == TP and plain.tp_degree == 1
    assert pool.pool_sharding.axis == kv_pool_spec(layout)
    assert pool.pool_sharding.devices == mesh.devices
    assert plain.pool_sharding is None
    kp, vp = pool.layer_pools(0)
    want = (1, PAGES + 1, PS, D) if layout == "kernel" else \
        (PAGES + 1, PS, 1, D)
    for shards, whole in ((kp, plain.layer_pools(0)[0]),
                          (vp, plain.layer_pools(0)[1])):
        assert isinstance(shards, list) and len(shards) == TP
        for s in shards:
            assert s.shape == want and s.nbytes * TP == whole.nbytes
    assert [b * TP for b in pool.bytes_per_shard()] == \
        plain.bytes_per_shard() * TP
    if dtype == "int8":
        ks, _ = pool.layer_scales(0)
        assert pool.scale_sharding.axis == kv_scale_spec()
        for s in ks:
            assert s.shape == (PAGES + 1, 1)
            assert s.nbytes * TP == plain.layer_scales(0)[0].nbytes
    else:
        assert pool.layer_scales(0) == (None, None)


def test_sharded_pool_requires_divisible_heads():
    mesh = _mesh()
    with pytest.raises(ValueError, match="divisible"):
        pgen.DeviceKVPool(1, 3, 8, mesh=mesh)
    with pytest.raises(ValueError, match="axis"):
        pgen.DeviceKVPool(1, 4, 8, mesh=mesh, tp_axis="warp")
    with pytest.raises(ValueError, match="first device"):
        pgen.DeviceKVPool(1, 4, 8, mesh=TPMesh(["meta"] * 4), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_sharded_pool_writes_match_unsharded_bitwise(layout, dtype):
    """Every write path (batched prefill, decode token, eager chunk)
    lands the same bytes and scales in a sharded pool as in an unsharded
    one, writing each shard in place."""
    pool, plain = _pool(_mesh(), dtype, layout), _pool(None, dtype, layout)
    ptrs = _state_ptrs(pool)
    for c in (pool, plain):
        _fill(c)
    assert _state_ptrs(pool) == ptrs
    _assert_same_bytes(pool, plain)
    k0, v0 = pool.gather_prefix("b", 1, 9)
    k1, v1 = plain.gather_prefix("b", 1, 9)
    assert torch.equal(k0, k1) and torch.equal(v0, v1)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_sharded_pool_writes_match_the_jax_mesh_pool(dtype):
    """The port's sharded pool against the JAX package's sharded pool
    (NamedSharding over four host devices) on the same writes: equal
    bytes and scales."""
    from paddle_tpu import generation as jgen

    rng = np.random.default_rng(3)
    k = rng.standard_normal((L, 9, H, D)).astype(np.float32)
    v = rng.standard_normal((L, 9, H, D)).astype(np.float32)
    jpool = jgen.DeviceKVPool(L, H, D, num_pages=PAGES, page_size=PS,
                              dtype=np.dtype(dtype), mesh=jax_tp_mesh(TP))
    jpool.allocate("s")
    jpool.append_prefill("s", k, v)
    pool = _pool(_mesh(), dtype)
    pool.allocate("s")
    pool.reserve("s", 9)
    pool.write_prefill_batch(["s"], [0], [9], torch.from_numpy(k[None]),
                             torch.from_numpy(v[None]))
    assert pool.page_table("s") == jpool.page_table("s")
    np.testing.assert_array_equal(pool.k_pool, np.asarray(jpool.k_pool))
    np.testing.assert_array_equal(pool.v_pool, np.asarray(jpool.v_pool))
    if dtype == "int8":
        np.testing.assert_array_equal(pool.k_scale,
                                      np.asarray(jpool.k_scale))
        np.testing.assert_array_equal(pool.v_scale,
                                      np.asarray(jpool.v_scale))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_reset_pools_rebuilds_every_shard(dtype):
    pool = _pool(_mesh(), dtype)
    _fill(pool)
    held = pool.take_pool_state()   # kept alive: no address is reused
    old = _state_ptrs(pool)
    pool.reset_pools()
    kp, _ = pool.layer_pools(1)
    assert isinstance(kp, list) and len(kp) == TP
    assert all(s.shape == (PAGES + 1, PS, 1, D) for s in kp)
    assert not set(_state_ptrs(pool)) & set(old)
    assert not any(bool(p.any()) for entry in pool.take_pool_state()
                   for p in entry)
    assert any(bool(p.any()) for entry in held for p in entry)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_cow_truncate_and_export_import_run_per_shard(layout, dtype):
    """Copy on write (an append mid-page into a shared page), truncate,
    export and import, each per shard in place: the sharded pool's bytes
    and payloads stay the unsharded pool's."""
    pool, plain = _pool(_mesh(), dtype, layout), _pool(None, dtype, layout)
    ptrs = _state_ptrs(pool)
    for c in (pool, plain):
        _fill(c)
        c.register_prefix("a", [5, 6, 7, 8, 9, 1, 2, 3])
        c.allocate("w")
        c.adopt_prefix("w", c.page_table("a")[:2], 6)
        c.reserve("w", 3)          # mid-page into a shared page: a copy
        assert c.take_prefix_counters()[0] == 1
        c.truncate("w", 7)
    assert pool.page_table("w") == plain.page_table("w")
    assert _state_ptrs(pool) == ptrs
    _assert_same_bytes(pool, plain)
    payload = pool.export_pages(pool.page_table("a"))
    for x, y in zip(payload, plain.export_pages(plain.page_table("a"))):
        assert torch.equal(x, y)
    pages = pool.import_pages(*payload)
    for x, y in zip(payload, pool.export_pages(pages)):
        assert torch.equal(x, y)
    assert _state_ptrs(pool) == ptrs


def test_truncate_refcount_drain_mesh():
    """The JAX package's drain invariant on the sharded pool: truncate is
    bookkeeping only, and every page comes back."""
    cache = pgen.DeviceKVPool(2, 4, 8, num_pages=16, page_size=4,
                              mesh=_mesh())
    cache.allocate("a")
    cache.reserve("a", 10)
    assert cache.truncate("a", 3) == 2
    cache.free("a")
    cache.flush_prefix_cache()
    assert cache.num_free_pages == cache.num_pages


# ------------------------------ all-reduces -------------------------------


def test_allreduce_sum_is_the_same_bits_on_every_shard():
    rng = np.random.default_rng(1)
    parts = [torch.from_numpy(rng.standard_normal((5, 16)).astype(
        np.float32)) for _ in range(TP)]
    out = allreduce_sum(parts, _mesh())
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert len(out) == TP
    for o in out:
        assert torch.equal(o, want)
    # one sum per distinct device, shared by its shards
    assert all(o is out[0] for o in out)


def _jax_ring(parts):
    """The JAX package's quantized ring over the forced host devices on
    per-shard partials: one [rows, d] block per shard."""
    n = len(parts)
    mesh = jax_tp_mesh(n)
    fn = jax.jit(shard_map(
        lambda x: jax_quantized_ring_allreduce(x, "model", n), mesh=mesh,
        in_specs=P("model", None), out_specs=P("model", None)))
    out = np.asarray(fn(jnp.asarray(np.concatenate(parts))))
    return np.split(out, n)


@pytest.mark.parametrize("tp,rows", [(2, 6), (3, 7), (4, 8), (4, 5)])
def test_quantized_ring_matches_the_jax_ring_bitwise(tp, rows):
    """The same per-shard partials through the port's ring and the JAX
    ring under shard_map, rows that need padding included: the same
    bits on every one of the port's shards, and each value within 4 ulps
    of the JAX ring's (an int8 rounding that flipped on some hop would
    move it by a 127th of its chunk's abs-max, far past that).  Not
    bitwise in every case: for some padded shapes XLA on the CPU fuses a
    hop's ``q * (s / 127) + chunk`` into one fused multiply-add, where
    PyTorch rounds the product and then the sum.  And within int8
    rounding of the exact sum."""
    rng = np.random.default_rng(tp * 10 + rows)
    parts = [rng.standard_normal((rows, 16)).astype(np.float32)
             for _ in range(tp)]
    ours = quantized_ring_allreduce([torch.from_numpy(p) for p in parts],
                                    _mesh(tp))
    theirs = _jax_ring(parts)
    for o, t in zip(ours, theirs):
        assert o.shape == (rows, 16)
        np.testing.assert_array_equal(o.numpy(), ours[0].numpy())
        np.testing.assert_allclose(o.numpy(), t, rtol=0,
                                   atol=4 * np.spacing(np.abs(t).max()))
    exact = np.sum(parts, axis=0)
    err = np.abs(ours[0].numpy() - exact).max()
    assert err <= 2 * tp * np.abs(exact).max() / 127


def test_collective_byte_estimates_equal_jax():
    for args in ((2, 16, 32, 4), (12, 72, 768, 2), (12, 72, 768, 1),
                 (3, 5, 7, 3)):
        assert quantized_collective_bytes(*args) == \
            jax_quantized_collective_bytes(*args)
        for q in (False, True):
            assert pfused._collective_bytes_estimate(*args, quantized=q) \
                == jfused._collective_bytes_estimate(*args, quantized=q)
