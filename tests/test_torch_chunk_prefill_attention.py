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

from paddle_tpu.generation.decode_attention import (
    chunk_prefill_attention as jax_chunk,
    chunk_prefill_attention_reference as jax_chunk_dense)
from paddle_tpu_torch.generation import PagedKVCache
from paddle_tpu_torch.generation.decode_attention import (
    chunk_prefill_attention, chunk_prefill_attention_reference)
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import paged_attention as pa

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
