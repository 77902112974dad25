"""Port parity: ragged paged attention.

The port's plain PyTorch version (the CPU path of the CUDA kernel's
wrapper) against the JAX package's Pallas ragged kernel run in interpret
mode and against its jnp reference, on the same seeded numpy inputs.
Tolerance atol = rtol = 2e-5: fp32 throughout, but the online-softmax
kernel and the two frameworks' einsums sum in different orders.  Rows
no descriptor owns must be exactly 0 on every path.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.generation.decode_attention import (
    ragged_paged_attention as jax_ragged,
    ragged_paged_attention_reference as jax_ragged_reference)
from paddle_tpu_torch.generation import PagedKVCache
from paddle_tpu_torch.generation.decode_attention import (
    ragged_paged_attention)
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import paged_attention as pa

TOL = dict(atol=2e-5, rtol=2e-5)


def _mixed_fixture(rng, h, d, page_size, num_pages=32):
    """Three sequences in one token-layout pool: two decode rows + one
    5-token chunk (prefix 7), packed as rows [0, 7) of an 8-slot token
    axis (slot 7 unclaimed); descriptor 3 is padding (len 0)."""
    book = PagedKVCache(1, h, d, num_pages=num_pages, page_size=page_size)
    k_pool = np.zeros((num_pages, page_size, h, d), np.float32)
    for sid, n in {"A": 13, "B": 6, "C": 12}.items():
        book.allocate(sid)
        book.reserve(sid, n)
        arr = rng.standard_normal((n, h, d)).astype(np.float32)
        table = book.page_table(sid)
        for pos in range(n):
            k_pool[table[pos // page_size], pos % page_size] = arr[pos]
    pt, _ = book.gather_block_tables(["A", "B", "C"])
    pt4 = np.zeros((4, pt.shape[1]), np.int32)
    pt4[:3] = pt
    return {
        "q": rng.standard_normal((8, h, d)).astype(np.float32),
        "k_pool": k_pool, "v_pool": -k_pool, "page_tables": pt4,
        "starts": np.array([0, 1, 2, 0], np.int32),
        "lens": np.array([1, 1, 5, 0], np.int32),
        "kv_lens": np.array([13, 6, 12, 0], np.int32),
    }


def _case(name, rng):
    fx = _mixed_fixture(rng, 2, 16, 4)
    if name == "decode_only":
        fx["lens"] = np.array([1, 1, 1, 0], np.int32)
    elif name == "chunk_only":
        fx["starts"] = np.zeros(4, np.int32)
        fx["lens"] = np.array([6, 0, 0, 0], np.int32)
        fx["kv_lens"] = np.array([13, 0, 0, 0], np.int32)
    elif name == "padding_descriptors":
        # two more len-0 descriptors whose tables point at live pages
        fx["page_tables"] = np.concatenate(
            [fx["page_tables"], fx["page_tables"][:2]])
        z = np.zeros(2, np.int32)
        for key in ("starts", "lens", "kv_lens"):
            fx[key] = np.concatenate([fx[key], z])
    return fx


def _layout(fx, layout):
    if layout == "kernel":   # [P, ps, H, D] -> [H, P, ps, D]
        for key in ("k_pool", "v_pool"):
            fx[key] = np.ascontiguousarray(fx[key].transpose(2, 0, 1, 3))
    return fx


def _port(fx, layout, kv_dtype=torch.float32):
    args = [torch.from_numpy(fx[k]) for k in
            ("q", "k_pool", "v_pool", "page_tables", "starts", "lens",
             "kv_lens")]
    args[1] = args[1].to(kv_dtype)
    args[2] = args[2].to(kv_dtype)
    return ragged_paged_attention(*args, layout=layout).numpy()


def _unowned_rows(fx):
    owned = np.zeros(fx["q"].shape[0], bool)
    for st, ln in zip(fx["starts"], fx["lens"]):
        owned[st:st + ln] = True
    return ~owned


@pytest.mark.parametrize("layout", ["token", "kernel"])
@pytest.mark.parametrize("name", ["mixed", "decode_only", "chunk_only",
                                  "padding_descriptors"])
def test_plain_version_matches_pallas_interpret_and_reference(name, layout):
    fx = _layout(_case(name, np.random.default_rng(7)), layout)
    args = [fx[k] for k in ("q", "k_pool", "v_pool", "page_tables",
                            "starts", "lens", "kv_lens")]
    ours = _port(fx, layout)
    pallas = np.asarray(jax_ragged(*args, use_kernel=True, interpret=True,
                                   layout=layout))
    ref = np.asarray(jax_ragged_reference(*args, layout=layout))
    np.testing.assert_allclose(ours, pallas, **TOL)
    np.testing.assert_allclose(ours, ref, **TOL)
    unowned = _unowned_rows(fx)
    assert unowned.any()
    assert np.all(ours[unowned] == 0.0)


def test_bf16_pool_matches_jax():
    """bf16 pools upcast on the gathered view: the port and the JAX
    reference read the same bf16 values and compute in fp32, so the fp32
    tolerance holds.  The Pallas kernel rounds its softmax weights to the
    pool dtype before P.V (``p.astype(v.dtype)``), about 2**-8 relative,
    so against it the bound is 1e-2."""
    fx = _case("mixed", np.random.default_rng(8))
    k16 = np.array(jnp.asarray(fx["k_pool"], jnp.bfloat16)
                   .astype(jnp.float32))
    fx["k_pool"], fx["v_pool"] = k16, -k16
    args = [fx["q"], jnp.asarray(k16, jnp.bfloat16),
            jnp.asarray(-k16, jnp.bfloat16), fx["page_tables"],
            fx["starts"], fx["lens"], fx["kv_lens"]]
    ours = _port(fx, "token", kv_dtype=torch.bfloat16)
    pallas = np.asarray(jax_ragged(*args, use_kernel=True, interpret=True))
    ref = np.asarray(jax_ragged_reference(*args))
    np.testing.assert_allclose(ours, ref, **TOL)
    np.testing.assert_allclose(ours, pallas, atol=1e-2, rtol=1e-2)
    assert np.all(ours[_unowned_rows(fx)] == 0.0)


def _int8_pools(fx, rng, layout):
    """Replace the pools with random int8 codes and give them [P, H]
    scales; every third page's scales are 0 (a freshly allocated page,
    which decodes to exact zeros)."""
    n_pages = fx["k_pool"].shape[1 if layout == "kernel" else 0]
    for key in ("k_pool", "v_pool"):
        fx[key] = rng.integers(-127, 128, fx[key].shape).astype(np.int8)
    for key in ("k_scale", "v_scale"):
        sc = rng.uniform(0.5, 4.0, (n_pages, fx["q"].shape[1]))
        sc[::3] = 0.0
        fx[key] = sc.astype(np.float32)
    return fx


@pytest.mark.parametrize("layout", ["token", "kernel"])
@pytest.mark.parametrize("name", ["mixed", "chunk_only",
                                  "padding_descriptors"])
def test_int8_pool_matches_pallas_interpret_and_reference(name, layout):
    """int8 pools dequantize on the gathered view with the Pallas body's
    expression, so the operands entering the products are bitwise equal
    to the JAX reference's and the kernel's: the fp32 tolerance holds
    against both (the softmax weights stay f32 in the int8 branch)."""
    rng = np.random.default_rng(17)
    fx = _int8_pools(_layout(_case(name, rng), layout), rng, layout)
    args = [fx[k] for k in ("q", "k_pool", "v_pool", "page_tables",
                            "starts", "lens", "kv_lens")]
    scales = dict(k_scale=fx["k_scale"], v_scale=fx["v_scale"])
    ours = ragged_paged_attention(
        *[torch.from_numpy(a) for a in args], layout=layout,
        **{k: torch.from_numpy(v) for k, v in scales.items()}).numpy()
    pallas = np.asarray(jax_ragged(*args, use_kernel=True, interpret=True,
                                   layout=layout, **scales))
    ref = np.asarray(jax_ragged_reference(*args, layout=layout, **scales))
    np.testing.assert_allclose(ours, pallas, **TOL)
    np.testing.assert_allclose(ours, ref, **TOL)
    assert np.all(ours[_unowned_rows(fx)] == 0.0)


def test_ragged_score_blocks_hand_computed():
    """Tiles are counted from each descriptor's first row.  page_size 4,
    q_block 2, descriptors (len, kv_len) = (1, 13), (1, 6), (5, 12):
    - A: one tile, last position 12 -> pages 0..3 -> 4 blocks;
    - B: one tile, last position 5 -> pages 0..1 -> 2 blocks;
    - C: tiles of rows {0,1}, {2,3}, {4}: last positions 8, 10, 11 ->
      3 + 3 + 3 = 9 blocks;
    tiled = 15.  Untiled: 4 tiles of the 8-row packed axis times the
    live pages (4 + 2 + 3) = 36.  The padding descriptor adds nothing."""
    tiled, untiled = pa.ragged_score_blocks(
        [0, 1, 2, 0], [1, 1, 5, 0], [13, 6, 12, 0], page_size=4,
        n_pages=4, n_rows=8, q_block=2)
    assert (tiled, untiled) == (15, 36)
    # the pages bucket caps the page walk
    assert pa.ragged_score_blocks([0], [1], [13], 4, 2, 8, 2) == (2, 8)


def test_cpu_call_never_builds_or_loads_the_cuda_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"tried to build/load {name} for CPU tensors")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    fx = _case("mixed", np.random.default_rng(9))
    before = pa.ragged_paged_attention_kernel.launches
    out = pa.ragged_paged_attention_kernel(
        *[torch.from_numpy(fx[k]) for k in
          ("q", "k_pool", "v_pool", "page_tables", "starts", "lens",
           "kv_lens")])
    assert out.shape == fx["q"].shape
    assert pa.ragged_paged_attention_kernel.launches == before
    assert not _build.loaded("ragged_paged_attention")


def test_descriptor_shapes_checked_before_the_device_is_chosen():
    """The wrapper refuses descriptors of mismatched shapes for CPU
    tensors too, before it picks the plain version or the kernel."""
    q = torch.zeros(8, 2, 16)
    pool = torch.zeros(5, 4, 2, 16)
    pt = torch.zeros(3, 2, dtype=torch.int32)
    three, two = (torch.zeros(n, dtype=torch.int32) for n in (3, 2))
    with pytest.raises(ValueError, match="descriptors"):
        pa.ragged_paged_attention_kernel(q, pool, pool, pt, three, two,
                                         three)
    with pytest.raises(ValueError, match="descriptors"):
        pa.ragged_paged_attention_kernel(q, pool, pool, pt[0], three, three,
                                         three)


def test_scales_checked_before_the_device_is_chosen():
    """An int8 pool without its scales, scales with a float pool and one
    scale alone raise ValueError from the wrapper and the plain version,
    for CPU tensors too."""
    q = torch.zeros(8, 2, 16)
    pool = torch.zeros(5, 4, 2, 16)
    pt = torch.zeros(3, 2, dtype=torch.int32)
    three = torch.zeros(3, dtype=torch.int32)
    qpool, sc = pool.to(torch.int8), torch.ones(5, 2)
    for pools, kw, match in (
            ((qpool, qpool), {}, "without k_scale"),
            ((pool, pool), dict(k_scale=sc, v_scale=sc), "int8 pools only"),
            ((qpool, qpool), dict(k_scale=sc), "together")):
        with pytest.raises(ValueError, match=match):
            pa.ragged_paged_attention_kernel(q, *pools, pt, three, three,
                                             three, **kw)
        with pytest.raises(ValueError, match=match):
            pa.ragged_paged_attention_torch(q, *pools, pt, three, three,
                                            three, **kw)


@pytest.mark.parametrize("bad", ["head_dim", "page_size", "contiguous",
                                 "dtype", "int32", "scale_dtype",
                                 "scale_shape"])
def test_kernel_argument_checks_raise(bad):
    """What the CUDA kernel does not take is refused before launch (the
    checks themselves need no card)."""
    q = torch.zeros(8, 2, 16)
    pool = torch.zeros(5, 4, 2, 16)
    pt = torch.zeros(3, 2, dtype=torch.int32)
    desc = torch.zeros(3, dtype=torch.int32)
    if bad == "head_dim":
        q, pool = torch.zeros(8, 2, 160), torch.zeros(5, 4, 2, 160)
    elif bad == "page_size":
        pool = torch.zeros(5, 128, 2, 16)
    elif bad == "contiguous":
        q = torch.zeros(2, 8, 16).transpose(0, 1)
    elif bad == "dtype":
        pool = pool.to(torch.float16)
    elif bad == "int32":
        desc = desc.long()
    scales = {}
    if bad.startswith("scale"):
        pool = pool.to(torch.int8)
        sc = (torch.ones(5, 2, dtype=torch.float64) if bad == "scale_dtype"
              else torch.ones(4, 2))       # one row per pool page: 5
        scales = dict(k_scale=sc, v_scale=sc)
    with pytest.raises(ValueError):
        pa._check_kernel_args(q, pool, pool, "token", **scales,
                              page_tables=pt, starts=desc, lens=desc,
                              kv_lens=desc)
