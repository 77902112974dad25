"""Port parity: the paged KV cache.

The port's page bookkeeping and its in-place pool scatter against the
JAX package's DeviceKVPool and scatter_pool_update on the same scripted
inputs, plus the port's failed-step recovery contract.  Page tables,
lengths and written pool values must be EXACTLY equal: bookkeeping is
integer logic and the scatter copies values without arithmetic.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

from paddle_tpu.generation import DeviceKVPool as JaxDeviceKVPool
from paddle_tpu.generation.kv_cache import (
    scatter_pool_update as jax_scatter_pool_update)
from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.generation.kv_cache import scatter_pool_update


@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_scatter_pool_update_with_sentinel_rows_matches_jax(layout):
    """Rows whose page is the sentinel ``num_pages`` never reach a real
    page: JAX drops them, the port lands them in its sink page."""
    rng = np.random.default_rng(0)
    p, ps, h, d = 6, 4, 2, 8
    base = rng.standard_normal((p, ps, h, d)).astype(np.float32)
    pages = np.array([0, 5, 2, p, 3, p, 5], np.int32)   # two sentinels
    rows = np.array([1, 0, 3, 0, 2, 0, 3], np.int32)
    x = rng.standard_normal((len(pages), h, d)).astype(np.float32)
    if layout == "kernel":
        base = np.ascontiguousarray(base.transpose(2, 0, 1, 3))
    want = np.asarray(jax_scatter_pool_update(
        jnp.asarray(base), jnp.asarray(pages), jnp.asarray(rows),
        jnp.asarray(x), layout))
    # the port's pools carry one more page: the sink
    pad = [(0, 0)] * 4
    pad[1 if layout == "kernel" else 0] = (0, 1)
    pool = torch.from_numpy(np.pad(base, pad))
    out = scatter_pool_update(pool, torch.from_numpy(pages),
                              torch.from_numpy(rows), torch.from_numpy(x),
                              layout)
    assert out is pool                    # written in place
    got = out.numpy()
    got = got[:, :p] if layout == "kernel" else got[:p]
    np.testing.assert_array_equal(got, want)


def test_scripted_bookkeeping_matches_jax_device_pool():
    """allocate / reserve / free / gather_block_tables in one scripted
    order: the same page tables, lengths, free counts and out-of-pages
    refusals as the JAX DeviceKVPool (LIFO page reuse included)."""
    jax_pool = JaxDeviceKVPool(1, 2, 8, num_pages=12, page_size=4)
    port = pgen.DeviceKVPool(1, 2, 8, num_pages=12, page_size=4,
                             device="cpu")
    script = [("alloc", "a"), ("reserve", "a", 5), ("alloc", "b"),
              ("reserve", "b", 9), ("reserve", "a", 1),
              ("reserve", "a", 3), ("alloc", "c"), ("reserve", "c", 2),
              ("free", "b"), ("reserve", "c", 7), ("alloc", "d"),
              ("reserve", "d", 40), ("reserve", "d", 4), ("free", "a"),
              ("reserve", "d", 6), ("reserve", "c", 1)]
    for op, sid, *arg in script:
        results = []
        for cache in (jax_pool, port):
            if op == "alloc":
                results.append(cache.allocate(sid))
            elif op == "free":
                results.append(cache.free(sid))
            else:
                try:
                    results.append(cache.reserve(sid, arg[0]))
                except Exception as e:   # noqa: BLE001 — compared below
                    results.append(type(e).__name__)
            results[-1] = (results[-1], cache.num_free_pages,
                           cache.pages_needed(sid, 3)
                           if cache.has(sid) else None)
        assert results[0] == results[1], (op, sid, arg, results)
        live = [s for s in "abcd" if port.has(s)]
        assert live == [s for s in "abcd" if jax_pool.has(s)]
        if live:
            pt_j, lens_j = jax_pool.gather_block_tables(live)
            pt_p, lens_p = port.gather_block_tables(live)
            np.testing.assert_array_equal(pt_p, pt_j)
            np.testing.assert_array_equal(lens_p, lens_j)
    assert port.utilization() == pytest.approx(jax_pool.utilization())
    with pytest.raises(pgen.UnknownSequenceError):
        port.free("b")


def test_failed_step_resets_pools_and_engine_keeps_serving():
    """A step that dies after writing the pools must not wedge the
    engine: the cache comes back on fresh zeroed storage and later
    requests serve token-identically to the full-recompute oracle."""
    model = pgen.TinyCausalLM(vocab_size=48, num_layers=2, num_heads=2,
                              head_dim=8, seed=3, device="cpu")
    eng = pgen.GenerationEngine(model, pgen.GenerationConfig(
        max_decode_slots=4, num_pages=64, page_size=4,
        prefill_chunk_tokens=2, device="cpu"), start=False)
    h = eng.submit([1, 2, 3], max_new_tokens=6)
    eng.step()
    eng.step()                       # prompt consumed, first token out

    class Boom(RuntimeError):
        pass

    real_fn = eng._ragged._fn

    def poisoned(*args):
        real_fn(*args)               # the pools ARE written ...
        raise Boom("step died after writing the pools")   # ... then boom

    old_pools = eng.cache.take_pool_state()
    assert any(bool(p.any()) for p in old_pools)
    eng._ragged._fn = poisoned
    with pytest.raises(Boom):
        eng.step()
    eng._ragged._fn = real_fn
    fresh = eng.cache.take_pool_state()
    assert all(f is not o for f, o in zip(fresh, old_pools))
    assert all(not bool(f.any()) for f in fresh)
    # the worker's contract: the poisoned step's batch fails as a unit
    for state in eng.scheduler.active():
        eng.scheduler.retire(state)
        state.handle.set_exception(Boom("poisoned step"))
    with pytest.raises(Boom):
        h.result(timeout=5)
    h2 = eng.submit([4, 5], max_new_tokens=6)
    eng.run_until_idle()
    assert h2.result(timeout=5).token_ids == model.greedy_reference(
        [4, 5], 6)
    eng.shutdown()


@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_legacy_write_paths_match_jax_device_pool(layout):
    """write_prefill_batch (two padded batches) then write_decode_tokens:
    the same pool contents as the JAX DeviceKVPool (padding positions
    land in the port's sink page, never a mapped one)."""
    rng = np.random.default_rng(3)
    l, h, d = 2, 2, 8
    jax_pool = JaxDeviceKVPool(l, h, d, num_pages=12, page_size=4,
                               pool_layout=layout)
    port = pgen.DeviceKVPool(l, h, d, num_pages=12, page_size=4,
                             pool_layout=layout, device="cpu")

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    single = f32(1, l, 8, h, d)          # one prompt of 6, padded to 8
    batch = f32(2, l, 8, h, d)           # prompts of 7 and 3, padded to 8
    step = f32(3, h, d)
    for cache, t in ((jax_pool, np.asarray), (port, torch.from_numpy)):
        for sid in "abc":
            cache.allocate(sid)
        cache.write_prefill_batch(["a"], [cache.reserve("a", 6)], [6],
                                  t(single), t(-single))
        starts = [cache.reserve("b", 7), cache.reserve("c", 3)]
        cache.write_prefill_batch(["b", "c"], starts, [7, 3], t(batch),
                                  t(-batch))
        positions = [cache.reserve(sid, 1) for sid in "abc"]
        cache.write_decode_tokens(list("abc"), positions, 0, t(step),
                                  t(-step))
    np.testing.assert_array_equal(port.k_pool, np.asarray(jax_pool.k_pool))
    np.testing.assert_array_equal(port.v_pool, np.asarray(jax_pool.v_pool))
    with pytest.raises(IndexError, match="not reserved"):
        port.check_span_writable("a", port.seq_len("a"), 1)
