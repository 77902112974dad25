"""Port parity: paged decode attention.

The port's plain PyTorch version (the CPU path of the CUDA kernel's
wrapper) against the JAX package's Pallas decode kernel run in interpret
mode and against its jnp reference, on the same seeded numpy inputs, in
both pool layouts.  Tolerance atol = rtol = 2e-5 in fp32: the online-
softmax kernel and the two frameworks' einsums sum in different orders.
A sequence of length 0 (the fused step's dummy rows) must come back as
exact zeros.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

from paddle_tpu.generation.decode_attention import (
    paged_decode_attention as jax_decode,
    paged_decode_attention_reference as jax_decode_reference)
from paddle_tpu_torch.generation import PagedKVCache
from paddle_tpu_torch.generation.decode_attention import (
    paged_decode_attention, paged_decode_attention_reference)
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import paged_attention as pa
from test_torch_ragged_attention import _items_model

TOL = dict(atol=2e-5, rtol=2e-5)
# lengths: a ragged tail over 4 pages, a dummy row, exactly one page, two
# pages; page_size 4
LENS = (13, 0, 4, 6)


def _fixture(rng, layout="token", h=2, d=8, page_size=4, num_pages=32):
    """Sequences of LENS over pages the host bookkeeping hands out, in a
    pool whose every page holds random values (stale contents included);
    the page-table axis is padded past the longest sequence with page 0."""
    book = PagedKVCache(1, h, d, num_pages=num_pages, page_size=page_size)
    for i, n in enumerate(LENS):
        book.allocate(i)
        book.reserve(i, n)
    pt, lens = book.gather_block_tables(list(range(len(LENS))))
    pools = [rng.standard_normal((num_pages, page_size, h, d))
             .astype(np.float32) for _ in range(2)]
    if layout == "kernel":   # [P, ps, H, D] -> [H, P, ps, D]
        pools = [np.ascontiguousarray(p.transpose(2, 0, 1, 3))
                 for p in pools]
    return {"q": rng.standard_normal((len(LENS), h, d)).astype(np.float32),
            "k_pool": pools[0], "v_pool": pools[1],
            "page_tables": np.pad(pt, ((0, 0), (0, 2))), "seq_lens": lens}


def _args(fx):
    return [fx[k] for k in ("q", "k_pool", "v_pool", "page_tables",
                            "seq_lens")]


def _port(fx, layout, kv_dtype=torch.float32):
    args = [torch.from_numpy(np.asarray(a)) for a in _args(fx)]
    args[1], args[2] = args[1].to(kv_dtype), args[2].to(kv_dtype)
    return paged_decode_attention(*args, layout=layout).numpy()


@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_plain_version_matches_pallas_interpret_and_reference(layout):
    fx = _fixture(np.random.default_rng(11), layout)
    ours = _port(fx, layout)
    pallas = np.asarray(jax_decode(*_args(fx), use_kernel=True,
                                   interpret=True, layout=layout))
    ref = np.asarray(jax_decode_reference(*_args(fx), layout=layout))
    np.testing.assert_allclose(ours, pallas, **TOL)
    np.testing.assert_allclose(ours, ref, **TOL)
    assert np.all(ours[1] == 0.0)          # seq_len 0: exact zeros
    # the exported reference IS the plain version
    direct = paged_decode_attention_reference(
        *[torch.from_numpy(np.asarray(a)) for a in _args(fx)],
        layout=layout).numpy()
    np.testing.assert_array_equal(direct, ours)


@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_bf16_pool_matches_jax(layout):
    """bf16 pools upcast on the gathered view: the port and the JAX
    reference read the same bf16 values and compute in fp32, so the fp32
    tolerance holds.  The Pallas kernel rounds its softmax weights to the
    pool dtype before P.V (``p.astype(v.dtype)``), about 2**-8 relative,
    so against it the bound is 1e-2."""
    fx = _fixture(np.random.default_rng(12), layout)
    for key in ("k_pool", "v_pool"):
        fx[key] = np.array(jnp.asarray(fx[key], jnp.bfloat16)
                           .astype(jnp.float32))
    ours = _port(fx, layout, kv_dtype=torch.bfloat16)
    jargs = _args(fx)
    jargs[1] = jnp.asarray(fx["k_pool"], jnp.bfloat16)
    jargs[2] = jnp.asarray(fx["v_pool"], jnp.bfloat16)
    ref = np.asarray(jax_decode_reference(*jargs, layout=layout))
    pallas = np.asarray(jax_decode(*jargs, use_kernel=True, interpret=True,
                                   layout=layout))
    np.testing.assert_allclose(ours, ref, **TOL)
    np.testing.assert_allclose(ours, pallas, atol=1e-2, rtol=1e-2)
    assert np.all(ours[1] == 0.0)


def _int8_pools(fx, rng, layout):
    """Random int8 codes in place of the pools, with [P, H] scales; every
    third page's scales are 0 (a fresh page: exact zeros)."""
    n_pages = fx["k_pool"].shape[1 if layout == "kernel" else 0]
    for key in ("k_pool", "v_pool"):
        fx[key] = rng.integers(-127, 128, fx[key].shape).astype(np.int8)
    scales = {}
    for key in ("k_scale", "v_scale"):
        sc = rng.uniform(0.5, 4.0, (n_pages, fx["q"].shape[1]))
        sc[::3] = 0.0
        scales[key] = sc.astype(np.float32)
    return scales


@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_int8_pool_matches_pallas_interpret_and_reference(layout):
    """int8 pools dequantize with the Pallas body's expression, so the
    operands entering the products are bitwise equal and the fp32
    tolerance holds against the JAX reference and the Pallas kernel."""
    rng = np.random.default_rng(14)
    fx = _fixture(rng, layout)
    scales = _int8_pools(fx, rng, layout)
    ours = paged_decode_attention(
        *[torch.from_numpy(np.asarray(a)) for a in _args(fx)],
        layout=layout,
        **{k: torch.from_numpy(v) for k, v in scales.items()}).numpy()
    pallas = np.asarray(jax_decode(*_args(fx), use_kernel=True,
                                   interpret=True, layout=layout, **scales))
    ref = np.asarray(jax_decode_reference(*_args(fx), layout=layout,
                                          **scales))
    np.testing.assert_allclose(ours, pallas, **TOL)
    np.testing.assert_allclose(ours, ref, **TOL)
    assert np.all(ours[1] == 0.0)          # seq_len 0: exact zeros


def test_cpu_call_never_builds_or_loads_the_cuda_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"tried to build/load {name} for CPU tensors")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    fx = _fixture(np.random.default_rng(13))
    before = pa.paged_decode_attention_kernel.launches
    out = pa.paged_decode_attention_kernel(
        *[torch.from_numpy(np.asarray(a)) for a in _args(fx)])
    assert out.shape == fx["q"].shape
    assert pa.paged_decode_attention_kernel.launches == before
    assert not _build.loaded("paged_decode_attention")


def test_shapes_and_int8_checked_before_the_device_is_chosen():
    """The wrapper refuses mismatched shapes, an int8 pool without its
    scales, scales with a float pool and one scale alone (ValueError) for
    CPU tensors too, before it picks the plain version or the kernel."""
    q = torch.zeros(3, 2, 8)
    pool = torch.zeros(5, 4, 2, 8)
    pt = torch.zeros(3, 2, dtype=torch.int32)
    lens = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="paged decode"):
        pa.paged_decode_attention_kernel(q, pool, pool, pt, lens[:2])
    with pytest.raises(ValueError, match="paged decode"):
        pa.paged_decode_attention_kernel(q[:2], pool, pool, pt, lens)
    with pytest.raises(ValueError, match="paged decode"):
        pa.paged_decode_attention_kernel(q, pool, pool, pt[0], lens)
    qpool, sc = pool.to(torch.int8), torch.ones(5, 2)
    with pytest.raises(ValueError, match="int8 KV pool"):
        pa.paged_decode_attention_kernel(q, qpool, qpool, pt, lens)
    with pytest.raises(ValueError, match="int8 pools only"):
        pa.paged_decode_attention_kernel(q, pool, pool, pt, lens,
                                         k_scale=sc, v_scale=sc)
    with pytest.raises(ValueError, match="together"):
        pa.paged_decode_attention_kernel(q, qpool, qpool, pt, lens,
                                         k_scale=sc)


@pytest.mark.parametrize("bad", ["head_dim", "page_size", "contiguous",
                                 "dtype", "int32", "device_mix"])
def test_kernel_argument_checks_raise(bad):
    """What the CUDA kernel does not take is refused before launch (the
    checks themselves need no card)."""
    q = torch.zeros(3, 2, 16)
    pool = torch.zeros(5, 4, 2, 16)
    pt = torch.zeros(3, 2, dtype=torch.int32)
    lens = torch.zeros(3, dtype=torch.int32)
    if bad == "head_dim":
        q, pool = torch.zeros(3, 2, 160), torch.zeros(5, 4, 2, 160)
    elif bad == "page_size":
        pool = torch.zeros(5, 128, 2, 16)
    elif bad == "contiguous":
        q = torch.zeros(2, 3, 16).transpose(0, 1)
    elif bad == "dtype":
        pool = pool.to(torch.float16)
    elif bad == "int32":
        lens = lens.long()
    else:
        lens = lens.to("meta")
    with pytest.raises(ValueError):
        pa._check_kernel_args(q, pool, pool, "token", page_tables=pt,
                              seq_lens=lens)


# ---- the CUDA kernel's items and split walk, modelled in torch ----------
#
# The kernel runs the ragged kernel's split walk over one-row descriptors
# (lens 1, kv_lens seq_lens): `decode_work_items` lists its live items,
# and the split-and-merge model of tests/test_torch_ragged_attention.py
# over those items has to agree with the plain version and with the JAX
# package.

# (page_size, H, D, seq_lens)
SPLIT_CASES = {
    # page 4: splits of 16 pages; dummy rows, one page, 64 and 65 keys
    "ps4": (4, 2, 8, [0, 13, 70, 1, 64, 65]),
    # page 5: splits of 13 pages (65 keys)
    "ps5": (5, 2, 6, [66, 0, 5, 130]),
    # page 16: splits of 4 pages
    "ps16": (16, 2, 16, [200, 0, 64, 65, 1]),
    # one row over 4,100 keys (65 splits): a page table of 257 entries
    "long": (16, 2, 8, [4100, 0, 3]),
}


def _split_fixture(name, kv_dtype, layout, seed=51):
    """The case's rows over distinct random pages of a pool of random
    values (bf16: values a bf16 pool holds exactly; int8: random codes
    with [P, H] scales, every third page's 0); the table axis padded
    with page 0 by one column."""
    ps, h, d, lens = SPLIT_CASES[name]
    rng = np.random.default_rng(seed)
    need = [-(-n // ps) for n in lens]
    n_pages = sum(need) + 3
    pt = np.zeros((len(lens), max(need) + 1), np.int32)
    perm = rng.permutation(n_pages)
    used = 0
    for i, k in enumerate(need):
        pt[i, :k] = perm[used:used + k]
        used += k
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
    return dict(q=rng.standard_normal((len(lens), h, d)).astype(np.float32),
                k_pool=pools[0], v_pool=pools[1], page_tables=pt,
                seq_lens=np.asarray(lens, np.int32), page_size=ps,
                scales=scales)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("layout", ["token", "kernel"])
@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_model_matches_plain_version_and_jax(name, layout, kv_dtype):
    """The split walk over the decode kernel's items against the plain
    version and the JAX reference within 2e-5, and the Pallas kernel in
    interpret mode within 2e-5 (f32, int8) or 1e-2 (bf16: the Pallas body
    rounds its softmax weights to bf16 before P.V); a seq_len 0 row has
    no item and comes out as exact zeros."""
    fx = _split_fixture(name, kv_dtype, layout)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}[kv_dtype]
    args = [torch.from_numpy(fx[k]) for k in
            ("q", "k_pool", "v_pool", "page_tables", "seq_lens")]
    args[1], args[2] = args[1].to(dt), args[2].to(dt)
    scales = {k: torch.from_numpy(v) for k, v in fx["scales"].items()}
    items = pa.decode_work_items(fx["seq_lens"].tolist(), fx["page_size"],
                                 fx["page_tables"].shape[1])
    model = _items_model(*args[:4], items, fx["page_size"], layout,
                         **scales).numpy()
    plain = pa.paged_decode_attention_torch(*args, layout=layout,
                                            **scales).numpy()
    np.testing.assert_allclose(model, plain, **TOL)
    jargs = _args(fx)
    if kv_dtype == "bfloat16":
        jargs[1] = jnp.asarray(jargs[1], jnp.bfloat16)
        jargs[2] = jnp.asarray(jargs[2], jnp.bfloat16)
    ref = np.asarray(jax_decode_reference(*jargs, layout=layout,
                                          **fx["scales"]))
    pallas = np.asarray(jax_decode(*jargs, use_kernel=True, interpret=True,
                                   layout=layout, **fx["scales"]))
    np.testing.assert_allclose(model, ref, **TOL)
    np.testing.assert_allclose(
        model, pallas,
        **(dict(atol=1e-2, rtol=1e-2) if kv_dtype == "bfloat16" else TOL))
    dummy = fx["seq_lens"] == 0
    assert dummy.any() and np.all(model[dummy] == 0.0)


@pytest.mark.parametrize("page_size", [4, 5, 16, 64])
def test_decode_work_items_are_the_ragged_items_of_one_row_descriptors(
        page_size):
    """Over seeded random batches (seq_len 0 rows, lengths past the
    table included): the kernel's live items are exactly the ragged
    kernel's items of one-row descriptors (lens 1, kv_lens seq_lens), in
    the same order; a seq_len 0 row has none; they cover each visible
    (row, key) pair once; and they fit in the grid, which is fixed by
    shapes alone."""
    rng = np.random.default_rng(page_size)
    for _ in range(30):
        b = int(rng.integers(1, 10))
        lens = [int(x) for x in rng.integers(0, 700, b)]
        lens[int(rng.integers(0, b))] = 0
        max_pages = max(-(-max(lens) // page_size)
                        + int(rng.integers(-2, 3)), 1)
        items = pa.decode_work_items(lens, page_size, max_pages)
        assert items == pa.ragged_work_items(range(b), [1] * b, lens,
                                             page_size, max_pages, b)
        assert not any(lens[it.row0] == 0 for it in items)
        assert len(items) * 3 <= pa.decode_grid_blocks(b, 3, max_pages,
                                                       page_size)
        kmax = max_pages * page_size
        seen = np.zeros((b, kmax), np.int64)
        for it in items:
            assert it.n_rows == 1 and it.qpos0 == lens[it.row0] - 1
            keys = np.arange(it.page_lo * page_size, it.page_hi * page_size)
            seen[it.row0, keys] += keys <= it.qpos0
        visible = (np.arange(kmax)[None, :]
                   < np.asarray(lens)[:, None]).astype(np.int64)
        np.testing.assert_array_equal(seen, visible)
