"""Port parity: chunked-prefill attention.

The port's plain PyTorch version (the CPU path of the CUDA kernel's
wrapper) against the JAX package's Pallas chunk kernel run in interpret
mode and against its jnp reference path, on the same seeded numpy
inputs, in both pool layouts.  Tolerance atol = rtol = 2e-5 in fp32: the
online-softmax kernel and the two frameworks' einsums sum in different
orders.  Only rows < the chunk's real length are compared: padding rows
compute at their nominal positions over page-0 padding, and every caller
discards them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

from paddle_tpu.generation.decode_attention import (
    chunk_prefill_attention as jax_chunk,
    chunk_prefill_attention_reference as jax_chunk_dense)
from paddle_tpu_torch.generation import PagedKVCache
from paddle_tpu_torch.generation.decode_attention import (
    chunk_prefill_attention, chunk_prefill_attention_reference)
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import paged_attention as pa
from test_torch_ragged_attention import _items_model

TOL = dict(atol=2e-5, rtol=2e-5)
# (start, n, length): a first chunk, a chunk ending mid-page, and a last
# chunk padded past its real rows (page_size 4)
CASES = [(0, 6, 6), (9, 5, 5), (13, 8, 3)]


def _fixture(rng, start, n, length, layout="token", h=2, d=8, page_size=4,
             num_pages=32):
    """One sequence with start + length cached keys (the chunk's own
    included) among other sequences' pages, random values everywhere;
    its page table padded to the pages the chunk's padding rows reach
    plus one."""
    book = PagedKVCache(1, h, d, num_pages=num_pages, page_size=page_size)
    book.allocate("other")
    book.reserve("other", 7)
    book.allocate("seq")
    book.reserve("seq", start + length)
    pt, _ = book.gather_block_tables(
        ["seq"], max_pages=(start + n - 1) // page_size + 2)
    pools = [rng.standard_normal((num_pages, page_size, h, d))
             .astype(np.float32) for _ in range(2)]
    if layout == "kernel":   # [P, ps, H, D] -> [H, P, ps, D]
        pools = [np.ascontiguousarray(p.transpose(2, 0, 1, 3))
                 for p in pools]
    return {"q": rng.standard_normal((n, h, d)).astype(np.float32),
            "k_pool": pools[0], "v_pool": pools[1], "page_table": pt[0]}


def _args(fx):
    return [fx[k] for k in ("q", "k_pool", "v_pool", "page_table")]


def _port(fx, start, layout, kv_dtype=torch.float32):
    args = [torch.from_numpy(np.asarray(a)) for a in _args(fx)]
    args[1], args[2] = args[1].to(kv_dtype), args[2].to(kv_dtype)
    return chunk_prefill_attention(*args, start, layout=layout).numpy()


@pytest.mark.parametrize("layout", ["token", "kernel"])
@pytest.mark.parametrize("start,n,length", CASES)
def test_plain_version_matches_pallas_interpret_and_reference(
        start, n, length, layout):
    fx = _fixture(np.random.default_rng(21 + start), start, n, length,
                  layout)
    ours = _port(fx, start, layout)[:length]
    pallas = np.asarray(jax_chunk(*_args(fx), start, use_kernel=True,
                                  interpret=True, layout=layout))[:length]
    ref = np.asarray(jax_chunk(*_args(fx), start, use_kernel=False,
                               layout=layout))[:length]
    np.testing.assert_allclose(ours, pallas, **TOL)
    np.testing.assert_allclose(ours, ref, **TOL)
    assert np.isfinite(_port(fx, start, layout)).all()   # padding rows too


@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_bf16_pool_matches_jax(layout):
    """bf16 pools upcast on the gathered view: the fp32 tolerance holds
    against the JAX reference; the Pallas kernel rounds its softmax
    weights to bf16 before P.V, so against it the bound is 1e-2."""
    start, n, length = CASES[2]
    fx = _fixture(np.random.default_rng(24), start, n, length, layout)
    for key in ("k_pool", "v_pool"):
        fx[key] = np.array(jnp.asarray(fx[key], jnp.bfloat16)
                           .astype(jnp.float32))
    ours = _port(fx, start, layout, kv_dtype=torch.bfloat16)[:length]
    jargs = _args(fx)
    jargs[1] = jnp.asarray(fx["k_pool"], jnp.bfloat16)
    jargs[2] = jnp.asarray(fx["v_pool"], jnp.bfloat16)
    ref = np.asarray(jax_chunk(*jargs, start, use_kernel=False,
                               layout=layout))[:length]
    pallas = np.asarray(jax_chunk(*jargs, start, use_kernel=True,
                                  interpret=True, layout=layout))[:length]
    np.testing.assert_allclose(ours, ref, **TOL)
    np.testing.assert_allclose(ours, pallas, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("layout", ["token", "kernel"])
@pytest.mark.parametrize("start,n,length", CASES)
def test_int8_pool_matches_pallas_interpret_and_reference(
        start, n, length, layout):
    """int8 pools with [P, H] scales (every third page's 0: a fresh page)
    dequantize with the Pallas body's expression: the fp32 tolerance
    holds against the JAX reference and the Pallas kernel."""
    rng = np.random.default_rng(31 + start)
    fx = _fixture(rng, start, n, length, layout)
    n_pages = fx["k_pool"].shape[1 if layout == "kernel" else 0]
    for key in ("k_pool", "v_pool"):
        fx[key] = rng.integers(-127, 128, fx[key].shape).astype(np.int8)
    scales = {}
    for key in ("k_scale", "v_scale"):
        sc = rng.uniform(0.5, 4.0, (n_pages, 2))
        sc[::3] = 0.0
        scales[key] = sc.astype(np.float32)
    ours = chunk_prefill_attention(
        *[torch.from_numpy(np.asarray(a)) for a in _args(fx)], start,
        layout=layout,
        **{k: torch.from_numpy(v) for k, v in scales.items()}).numpy()
    pallas = np.asarray(jax_chunk(*_args(fx), start, use_kernel=True,
                                  interpret=True, layout=layout, **scales))
    ref = np.asarray(jax_chunk(*_args(fx), start, use_kernel=False,
                               layout=layout, **scales))
    np.testing.assert_allclose(ours[:length], pallas[:length], **TOL)
    np.testing.assert_allclose(ours[:length], ref[:length], **TOL)
    assert np.isfinite(ours).all()


def test_dense_reference_matches_jax():
    """The exported dense core (keys already in position order, K past
    start + n) against the JAX reference of the same signature."""
    rng = np.random.default_rng(25)
    q = rng.standard_normal((5, 2, 8)).astype(np.float32)
    k = rng.standard_normal((16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((16, 2, 8)).astype(np.float32)
    ours = chunk_prefill_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        9).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_chunk_dense(q, k, v, 9)),
                               **TOL)


def test_cpu_call_never_builds_or_loads_the_cuda_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"tried to build/load {name} for CPU tensors")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    fx = _fixture(np.random.default_rng(26), *CASES[1])
    before = pa.chunk_prefill_attention_kernel.launches
    out = pa.chunk_prefill_attention_kernel(
        *[torch.from_numpy(np.asarray(a)) for a in _args(fx)], 9)
    assert out.shape == fx["q"].shape
    assert pa.chunk_prefill_attention_kernel.launches == before
    assert not _build.loaded("chunk_prefill_attention")


def test_table_start_and_int8_checked_before_the_device_is_chosen():
    q = torch.zeros(4, 2, 8)
    pool = torch.zeros(5, 4, 2, 8)
    pt = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="page table"):
        pa.chunk_prefill_attention_kernel(q, pool, pool, pt[None], 0)
    with pytest.raises(ValueError, match="page table"):
        pa.chunk_prefill_attention_kernel(q, pool, pool, pt[:0], 0)
    with pytest.raises(ValueError, match="start"):
        pa.chunk_prefill_attention_kernel(q, pool, pool, pt, -1)
    qpool, sc = pool.to(torch.int8), torch.ones(5, 2)
    with pytest.raises(ValueError, match="int8 KV pool"):
        pa.chunk_prefill_attention_kernel(q, qpool, qpool, pt, 0)
    with pytest.raises(ValueError, match="int8 pools only"):
        pa.chunk_prefill_attention_kernel(q, pool, pool, pt, 0,
                                          k_scale=sc, v_scale=sc)
    with pytest.raises(ValueError, match="together"):
        pa.chunk_prefill_attention_kernel(q, qpool, qpool, pt, 0,
                                          v_scale=sc)


@pytest.mark.parametrize("bad", ["head_dim", "page_size", "contiguous",
                                 "dtype", "int32", "pool_shape"])
def test_kernel_argument_checks_raise(bad):
    """What the CUDA kernel does not take is refused before launch."""
    q = torch.zeros(4, 2, 16)
    k_pool = v_pool = torch.zeros(5, 4, 2, 16)
    pt = torch.zeros(3, dtype=torch.int32)
    if bad == "head_dim":
        q = torch.zeros(4, 2, 160)
        k_pool = v_pool = torch.zeros(5, 4, 2, 160)
    elif bad == "page_size":
        k_pool = v_pool = torch.zeros(5, 128, 2, 16)
    elif bad == "contiguous":
        q = torch.zeros(2, 4, 16).transpose(0, 1)
    elif bad == "dtype":
        k_pool = v_pool = k_pool.to(torch.float16)
    elif bad == "int32":
        pt = pt.long()
    else:
        v_pool = torch.zeros(6, 4, 2, 16)
    with pytest.raises(ValueError):
        pa._check_kernel_args(q, k_pool, v_pool, "token", page_table=pt)


# ---- the CUDA kernel's items and split walk, modelled in torch ----------
#
# The kernel runs the ragged kernel's split walk over one descriptor
# (lens [n], kv_lens [start + n]): `chunk_work_items` lists its items in
# the order of its blocks, and the split-and-merge model of
# tests/test_torch_ragged_attention.py over those items has to agree with
# the plain version and with the JAX package.

# (page_size, H, D, start, n, length)
SPLIT_CASES = {
    # page 4: splits of 16 pages; tile 0 at 70..85 crosses key 64; three
    # padding rows
    "ps4": (4, 2, 8, 70, 20, 17),
    # page 5: splits of 13 pages (65 keys); a one-row last tile
    "ps5": (5, 2, 6, 120, 17, 17),
    # page 16: tiles at 117..149, tile 0 crosses key 128; padding rows
    "ps16": (16, 2, 16, 117, 33, 30),
    # a first chunk, from position 0, over three tiles
    "from0": (16, 2, 8, 0, 40, 40),
}


def _split_fixture(name, kv_dtype, layout, seed=41):
    """The case's chunk over random pages of a pool of random values
    (bf16: values a bf16 pool holds exactly; int8: random codes with
    [P, H] scales, every third page's 0), its page table padded with
    page 0 past the pages its padding rows reach."""
    ps, h, d, start, n, length = SPLIT_CASES[name]
    rng = np.random.default_rng(seed)
    pages = -(-(start + length) // ps)
    n_pages = pages + 5
    pt = np.zeros((start + n - 1) // ps + 2, np.int32)
    pt[:pages] = rng.permutation(n_pages)[:pages]
    shape = (n_pages, ps, h, d)
    pools, scales = [], {}
    for key in ("k_scale", "v_scale"):
        if kv_dtype == "int8":
            pools.append(rng.integers(-127, 128, shape).astype(np.int8))
            sc = rng.uniform(0.5, 4.0, (n_pages, h))
            sc[::3] = 0.0
            scales[key] = sc.astype(np.float32)
        else:
            p = rng.standard_normal(shape).astype(np.float32)
            if kv_dtype == "bfloat16":
                p = np.array(jnp.asarray(p, jnp.bfloat16).astype(jnp.float32))
            pools.append(p)
    if layout == "kernel":
        pools = [np.ascontiguousarray(p.transpose(2, 0, 1, 3)) for p in pools]
    return dict(q=rng.standard_normal((n, h, d)).astype(np.float32),
                k_pool=pools[0], v_pool=pools[1], page_table=pt,
                start=start, length=length, page_size=ps, scales=scales)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("layout", ["token", "kernel"])
@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_model_matches_plain_version_and_jax(name, layout, kv_dtype):
    """The split walk over the chunk kernel's items against the plain
    version (every row, padding included) within 2e-5, and on the real
    rows against the JAX reference within 2e-5 and the Pallas kernel in
    interpret mode within 2e-5 (f32, int8) or 1e-2 (bf16: the Pallas body
    rounds its softmax weights to bf16 before P.V)."""
    fx = _split_fixture(name, kv_dtype, layout)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}[kv_dtype]
    q, k_pool, v_pool, pt = (torch.from_numpy(fx[k]) for k in
                             ("q", "k_pool", "v_pool", "page_table"))
    k_pool, v_pool = k_pool.to(dt), v_pool.to(dt)
    scales = {k: torch.from_numpy(v) for k, v in fx["scales"].items()}
    items = pa.chunk_work_items(q.shape[0], fx["start"], fx["page_size"],
                                pt.shape[0])
    model = _items_model(q, k_pool, v_pool, pt[None], items,
                         fx["page_size"], layout, **scales).numpy()
    plain = pa.chunk_prefill_attention_torch(
        q, k_pool, v_pool, pt, fx["start"], layout=layout, **scales).numpy()
    np.testing.assert_allclose(model, plain, **TOL)
    jargs = _args(fx)
    if kv_dtype == "bfloat16":
        jargs[1] = jnp.asarray(jargs[1], jnp.bfloat16)
        jargs[2] = jnp.asarray(jargs[2], jnp.bfloat16)
    real = slice(0, fx["length"])
    ref = np.asarray(jax_chunk(*jargs, fx["start"], use_kernel=False,
                               layout=layout, **fx["scales"]))
    pallas = np.asarray(jax_chunk(*jargs, fx["start"], use_kernel=True,
                                  interpret=True, layout=layout,
                                  **fx["scales"]))
    np.testing.assert_allclose(model[real], ref[real], **TOL)
    np.testing.assert_allclose(
        model[real], pallas[real],
        **(dict(atol=1e-2, rtol=1e-2) if kv_dtype == "bfloat16" else TOL))


@pytest.mark.parametrize("page_size", [4, 5, 16, 64])
def test_chunk_work_items_are_the_ragged_items_of_one_descriptor(page_size):
    """Over seeded random chunks: the kernel's items are exactly the
    ragged kernel's items of the descriptor (lens [n], kv_lens
    [start + n]), tiles from the last (the most splits) to the first and
    each tile's in split order; they cover each visible (row, key) pair
    once; and the grid is exactly the items times the heads."""
    rng = np.random.default_rng(page_size)
    for _ in range(30):
        n = int(rng.integers(1, 80))
        start = int(rng.integers(0, 400))
        max_pages = (start + n - 1) // page_size + 1 + int(rng.integers(-2, 3))
        max_pages = max(max_pages, 1)
        items = pa.chunk_work_items(n, start, page_size, max_pages)
        want = pa.ragged_work_items([0], [n], [start + n], page_size,
                                    max_pages, n)
        assert sorted(items) == sorted(want)
        assert len(items) * 3 == pa.chunk_grid_blocks(n, start, 3,
                                                      page_size, max_pages)
        splits = [it.n_splits for it in items]
        assert splits == sorted(splits, reverse=True)
        for a, b in zip(items, items[1:]):
            assert b.split == (a.split + 1 if b.row0 == a.row0 else 0)
        kmax = max_pages * page_size
        seen = np.zeros((n, kmax), np.int64)
        for it in items:
            keys = np.arange(it.page_lo * page_size, it.page_hi * page_size)
            pos = it.qpos0 + np.arange(it.n_rows)
            rows = it.row0 + np.arange(it.n_rows)
            seen[rows[:, None], keys[None, :]] += keys[None, :] <= pos[:, None]
        visible = (np.arange(kmax)[None, :]
                   <= start + np.arange(n)[:, None]).astype(np.int64)
        np.testing.assert_array_equal(seen, visible)


def test_chunk_items_at_the_main_shape():
    """The main path's chunk (64 rows at start 536, page 16, a pages
    bucket of 64): tiles 3, 2, 1, 0 of 10, 10, 9 and 9 splits of 4
    pages, 38 items, 456 blocks over 12 heads."""
    items = pa.chunk_work_items(64, 536, 16, 64)
    assert [it.row0 for it in items if it.split == 0] == [48, 32, 16, 0]
    assert [it.n_splits for it in items if it.split == 0] == [10, 10, 9, 9]
    assert len(items) == 38
    assert pa.chunk_grid_blocks(64, 536, 12, 16, 64) == 456
