"""Port parity: int8 KV pools — the quantize math, the three-step
quantized write and the pool's int8 state.

The port's `quantize_int8`, `dequantize_int8` and `quantized_pool_write`
against the JAX package's on the same seeded numpy inputs, BITWISE for
the int8 bytes and the float32 scales (the same expression order, round
half to even in both), in both pool layouts; then the port's int8
DeviceKVPool against the JAX DeviceKVPool after the same writes, and the
pool-level facts of the JAX package's own int8 tests (bytes against
bfloat16, the round-trip error, the scale reset on page reuse).  The
port's pools carry one more page than the JAX pools, the sink, so only
real pages are compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

from paddle_tpu.generation import DeviceKVPool as JaxDeviceKVPool
from paddle_tpu.generation import quantized_kv as jq
from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.generation import quantized_kv as pq
from paddle_tpu_torch.ops import paged_attention as pa

L, H, D, PS = 2, 2, 8, 4
# one compile per (layout, rows) instead of one per op
_jax_write = jax.jit(jq.quantized_pool_write, static_argnums=5)


def _pool_pair(layout, n_pages):
    """An empty JAX int8 pool and scale array, and the port's (one sink
    page more)."""
    jshape = ((n_pages, PS, H, D) if layout == "token"
              else (H, n_pages, PS, D))
    pshape = ((n_pages + 1, PS, H, D) if layout == "token"
              else (H, n_pages + 1, PS, D))
    return ((jnp.zeros(jshape, jnp.int8), jnp.zeros((n_pages, H),
                                                    jnp.float32)),
            (torch.zeros(pshape, dtype=torch.int8),
             torch.zeros(n_pages + 1, H)))


def _real(pool, layout, n_pages):
    return (pool[:, :n_pages] if layout == "kernel"
            else pool[:n_pages]).numpy()


def _assert_same(jpool, jscale, ppool, pscale, layout, n_pages):
    np.testing.assert_array_equal(_real(ppool, layout, n_pages),
                                  np.asarray(jpool))
    np.testing.assert_array_equal(pscale[:n_pages].numpy(),
                                  np.asarray(jscale))


def test_constants_and_round_trip_match_jax():
    """INV_QMAX, SCALE_EPS and the kernels' literal agree; quantize and
    dequantize are bitwise equal to JAX's, sub-eps and zero scales
    included, and round half to even."""
    assert pq.INV_QMAX == jq.INV_QMAX and pq.SCALE_EPS == jq.SCALE_EPS
    assert np.float32(pa.INV_QMAX) == jq.INV_QMAX
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, H, D)) * 3).astype(np.float32)
    scale = np.abs(rng.standard_normal((64, H, 1))).astype(np.float32) * 5
    scale[:4] = 0.0                      # fresh pages
    scale[4:8] = 1e-35                   # below SCALE_EPS
    x[:4] = 0.0
    # exact halves of the grid: round half to even
    x[8, 0, :4] = np.float32([0.5, 1.5, 2.5, -2.5]) / np.float32(127.0)
    scale[8, 0] = 1.0
    want = np.asarray(jq.quantize_int8(jnp.asarray(x), jnp.asarray(scale),
                                       jnp))
    got = pq.quantize_int8(torch.from_numpy(x), torch.from_numpy(scale))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    back = np.asarray(jq.dequantize_int8(jnp.asarray(want),
                                         jnp.asarray(scale), jnp))
    np.testing.assert_array_equal(
        pq.dequantize_int8(got, torch.from_numpy(scale)).numpy(), back)


@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_quantized_pool_write_matches_jax_bitwise(layout):
    """A script of writes through one pool: duplicate pages in one write,
    sentinel rows (page num_pages), fresh zero-scale pages, a scale that
    grows and requantizes the page's old rows, and a sub-eps payload —
    pools and scales bitwise equal to JAX's after every write, sentinel
    rows landing only in the port's sink page."""
    rng = np.random.default_rng(1)
    n_pages = 6
    (jp, js), (pp, ps) = _pool_pair(layout, n_pages)
    sink = n_pages
    writes = [
        # page 0 rows 0-2 and page 3 row 1 (two entries of page 0), two
        # sentinels
        ([0, 0, sink, 3, 0, sink], [0, 1, 0, 1, 2, 3], 1.0),
        # page 0's scale grows 10x: its three old rows requantize
        ([0, 2, sink], [3, 0, 2], 10.0),
        # a tiny payload on a fresh page: scale below SCALE_EPS
        ([5, 5], [0, 1], 1e-33),
        # all-sentinel write
        ([sink, sink], [0, 1], 4.0),
        # page 3 shrinks: the scale keeps its max
        ([3, 3, 3], [0, 2, 3], 0.01),
    ]
    for pages, rows, mag in writes:
        pages = np.asarray(pages, np.int32)
        rows = np.asarray(rows, np.int32)
        x = (rng.standard_normal((len(pages), H, D)) * mag).astype(
            np.float32)
        jp, js = _jax_write(jp, js, jnp.asarray(pages),
                                         jnp.asarray(rows), jnp.asarray(x),
                                         layout)
        out = pq.quantized_pool_write(pp, ps, torch.from_numpy(pages),
                                      torch.from_numpy(rows),
                                      torch.from_numpy(x), layout)
        assert out[0] is pp and out[1] is ps          # in place
        _assert_same(jp, js, pp, ps, layout, n_pages)
    assert float(ps[sink].max()) > 0      # the sentinels wrote the sink


@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_quantized_pool_write_random_script_matches_jax(layout):
    """Many random writes of mixed magnitude over a small pool (pages
    reused within and across writes) stay bitwise equal."""
    rng = np.random.default_rng(2)
    n_pages = 5
    (jp, js), (pp, ps) = _pool_pair(layout, n_pages)
    for _ in range(12):
        n = 8
        slots = rng.permutation((n_pages + 1) * PS)[:n]
        pages = (slots // PS).astype(np.int32)       # may hit the sentinel
        rows = (slots % PS).astype(np.int32)
        x = (rng.standard_normal((n, H, D))
             * 10.0 ** rng.integers(-3, 3)).astype(np.float32)
        jp, js = _jax_write(jp, js, jnp.asarray(pages),
                                         jnp.asarray(rows), jnp.asarray(x),
                                         layout)
        pq.quantized_pool_write(pp, ps, torch.from_numpy(pages),
                                torch.from_numpy(rows), torch.from_numpy(x),
                                layout)
        _assert_same(jp, js, pp, ps, layout, n_pages)


def _fill(rng, n):
    k = rng.standard_normal((L, n, H, D)).astype(np.float32)
    v = rng.standard_normal((L, n, H, D)).astype(np.float32)
    return k, v


@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_device_pool_int8_writes_match_jax_bitwise(layout):
    """The port's int8 DeviceKVPool and the JAX one after the same
    script: a batched prefill write of two length-padded spans, decode
    writes per layer, a free and a page reuse (its scales reset), another
    prefill — bytes, scales and byte counters equal."""
    rng = np.random.default_rng(3)
    n_pages = 12
    jpool = JaxDeviceKVPool(L, H, D, num_pages=n_pages, page_size=PS,
                            dtype=np.int8, pool_layout=layout)
    ppool = pgen.DeviceKVPool(L, H, D, num_pages=n_pages, page_size=PS,
                              dtype=torch.int8, pool_layout=layout,
                              device="cpu")
    assert ppool.quantized and ppool.n_state_groups == 4

    def both(fn):
        fn(jpool, jnp.asarray)
        fn(ppool, torch.from_numpy)

    def check():
        for attr in ("k_pool", "v_pool", "k_scale", "v_scale"):
            np.testing.assert_array_equal(getattr(ppool, attr),
                                          np.asarray(getattr(jpool, attr)))
        assert ppool.take_bytes_moved() == jpool.take_bytes_moved()
        assert ppool.take_scale_bytes() == jpool.take_scale_bytes()

    k, v = _fill(rng, 7)
    kb = np.zeros((2, L, 7, H, D), np.float32)
    vb = np.zeros_like(kb)
    kb[0], vb[0] = k, v
    kb[1, :, :5], vb[1, :, :5] = k[:, :5] * 3, v[:, :5] * 3

    def prefill(c, arr):
        for sid, n in (("a", 7), ("b", 5)):
            c.allocate(sid)
            c.reserve(sid, n)
        c.write_prefill_batch(["a", "b"], [0, 0], [7, 5], arr(kb), arr(vb))

    both(prefill)
    check()
    for step in range(3):
        kd, vd = _fill(rng, 2)

        def decode(c, arr):
            pos = [c.reserve(s, 1) for s in ("a", "b")]
            for layer in range(L):
                c.write_decode_tokens(["a", "b"], pos, layer,
                                      arr(kd[layer] * (step + 1)),
                                      arr(vd[layer]))

        both(decode)
        check()
    k2, v2 = _fill(rng, 6)

    def reuse(c, arr):
        c.free("a")                       # its pages go back, LIFO
        c.allocate("c")
        c.reserve("c", 6)
        c.write_prefill_batch(["c"], [0], [6], arr(k2[None] * 0.01),
                              arr(v2[None] * 0.01))

    both(reuse)
    check()
    assert ppool.page_table("c") == tuple(jpool.page_table("c"))


def test_int8_pool_is_at_most_0_6_of_bf16_bytes():
    """Scales included, an int8 pool holds the same pages in at most 0.6x
    the bfloat16 bytes, in both layouts."""
    def pool_bytes(c):
        state = c.take_pool_state()
        return sum(t.numel() * t.element_size() for t in state)

    for layout in ("token", "kernel"):
        q = pgen.DeviceKVPool(L, H, D, num_pages=32, page_size=PS,
                              dtype=torch.int8, pool_layout=layout,
                              device="cpu")
        b16 = pgen.DeviceKVPool(L, H, D, num_pages=32, page_size=PS,
                                dtype=torch.bfloat16, pool_layout=layout,
                                device="cpu")
        assert q.k_pool.dtype == np.int8
        ratio = pool_bytes(q) / pool_bytes(b16)
        assert ratio <= 0.6, f"int8 pool is {ratio:.2f}x bf16 bytes"


def _read_rows(cache, sid, n):
    """Rows [0, n) of layer 0's K pool, dequantized with their pages'
    scales (the plain versions' expression)."""
    table = cache.page_table(sid)
    kq = cache.k_pool[0]                           # [P, ps, H, D] int8
    ks = cache.k_scale[0]                          # [P, H]
    rows = []
    for pos in range(n):
        page, row = table[pos // PS], pos % PS
        rows.append(np.asarray(pq.dequantize_int8(
            torch.from_numpy(kq[page, row]),
            torch.from_numpy(ks[page][:, None]))))
    return np.stack(rows)


def test_round_trip_error_within_half_an_lsb():
    """Rows written through the pool read back within 0.51 of the page
    grid's step (scale / 127) of the payload."""
    rng = np.random.default_rng(4)
    for layout in ("token", "kernel"):
        c = pgen.DeviceKVPool(L, H, D, num_pages=16, page_size=PS,
                              dtype=torch.int8, pool_layout=layout,
                              device="cpu")
        k, v = _fill(rng, 11)
        c.allocate("s")
        c.reserve("s", 11)
        c.write_prefill_batch(["s"], [0], [11], torch.from_numpy(k[None]),
                              torch.from_numpy(v[None]))
        got = _read_rows(c, "s", 11)
        bound = np.max(np.abs(k[0])) / 127 * 0.51 + 1e-7
        assert np.max(np.abs(got - k[0])) <= bound


def test_page_scale_resets_on_reuse():
    """A freed page's scale does not carry over: after a large-magnitude
    sequence frees its page, a small one quantizes on a fresh grid."""
    rng = np.random.default_rng(5)
    c = pgen.DeviceKVPool(L, H, D, num_pages=4, page_size=PS,
                          dtype=torch.int8, device="cpu")

    def put(sid, x):
        c.allocate(sid)
        c.reserve(sid, PS)
        t = torch.from_numpy(x[None])
        c.write_prefill_batch([sid], [0], [PS], t, t)

    big = rng.standard_normal((L, PS, H, D)).astype(np.float32) * 100
    put("big", big)
    page = c.page_table("big")[0]
    assert np.max(c.k_scale[:, page]) > 50
    c.free("big")
    small = rng.standard_normal((L, PS, H, D)).astype(np.float32)
    put("small", small)
    assert c.page_table("small")[0] == page        # LIFO reuse
    got = _read_rows(c, "small", PS)
    bound = np.max(np.abs(small[0])) / 127 * 0.51 + 1e-7
    assert np.max(np.abs(got - small[0])) <= bound
    assert np.max(c.k_scale[:, page]) <= np.max(np.abs(small))


def test_reset_pools_zeroes_scales_and_float_pools_have_none():
    c = pgen.DeviceKVPool(L, H, D, num_pages=4, page_size=PS,
                          dtype=torch.int8, device="cpu")
    c.allocate("s")
    c.reserve("s", 3)
    x = torch.ones(1, L, 3, H, D)
    c.write_prefill_batch(["s"], [0], [3], x, x)
    assert c.k_scale.max() == 1.0
    c.reset_pools()
    assert c.k_scale.max() == 0.0 and c.k_pool.max() == 0
    f = pgen.DeviceKVPool(L, H, D, num_pages=4, page_size=PS, device="cpu")
    assert f.layer_scales(0) == (None, None) and f.n_state_groups == 2
    assert len(c.take_pool_state()) == 4 * L
    with pytest.raises(ValueError, match="4 groups"):
        c.put_pool_state(c.take_pool_state()[:2 * L])
