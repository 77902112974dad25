"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a card
(decided inside the test, never at import).  On a machine with one (JAX
not needed):

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py
"""
import math

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.ops import paged_attention as pa

TOL = 2e-5   # fp32 with f32 accumulation; the summation order differs

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _misalign(x):
    """`x`'s values, starting one element past an aligned address."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


def _case(rng, h, d, ps, layout, kv_dtype, desc, num_pages=64):
    lens = [ln for ln, _ in desc]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]) + 1  # row 0 free
    need = [math.ceil(kv / ps) for _, kv in desc]
    perm = rng.permutation(num_pages)
    pt = np.zeros((len(desc), max(need)), np.int32)
    for i, n in enumerate(need):
        pt[i, :n] = perm[sum(need[:i]):sum(need[:i]) + n]
    t = int(sum(lens)) + 2
    shape = ((h, num_pages + 1, ps, d) if layout == "kernel"
             else (num_pages + 1, ps, h, d))

    def cuda(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device="cuda")

    return [cuda(rng.standard_normal((t, h, d)), torch.float32),
            cuda(rng.standard_normal(shape), torch.float32).to(kv_dtype),
            cuda(rng.standard_normal(shape), torch.float32).to(kv_dtype),
            cuda(pt, torch.int32), cuda(starts, torch.int32),
            cuda(lens, torch.int32), cuda([kv for _, kv in desc],
                                         torch.int32)]


@pytest.mark.parametrize("layout", ["token", "kernel"])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
# head_dim 6 and 30 (D % 4 != 0) take the kernel's scalar page loads
@pytest.mark.parametrize("h,d,ps", [(2, 8, 4), (12, 64, 16), (2, 128, 64),
                                    (2, 6, 4), (3, 30, 16)])
def test_ragged_kernel_matches_plain_version(layout, kv_dtype, h, d, ps):
    _need_card()
    rng = np.random.default_rng(0)
    args = _case(rng, h, d, ps, layout, kv_dtype,
                 [(1, 13), (1, 60), (17, 40), (0, 9)])
    before = pa.ragged_paged_attention_kernel.launches
    ker = pa.ragged_paged_attention_kernel(*args, layout=layout)
    plain = pa.ragged_paged_attention_torch(*args, layout=layout)
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention_kernel.launches == before + 1
    torch.testing.assert_close(ker, plain, atol=TOL, rtol=TOL)
    assert bool((ker[0] == 0).all()) and bool((ker[-1] == 0).all())


@pytest.mark.parametrize("layout", ["token", "kernel"])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_ragged_kernel_on_misaligned_pools(layout, kv_dtype):
    """Pools that start off a 4-element boundary take the scalar page
    loads even at D % 4 == 0."""
    _need_card()
    args = _case(np.random.default_rng(1), 2, 64, 16, layout, kv_dtype,
                 [(1, 50), (12, 33), (0, 9)])
    args[1], args[2] = _misalign(args[1]), _misalign(args[2])
    ker = pa.ragged_paged_attention_kernel(*args, layout=layout)
    plain = pa.ragged_paged_attention_torch(*args, layout=layout)
    torch.cuda.synchronize()
    torch.testing.assert_close(ker, plain, atol=TOL, rtol=TOL)


def _pools(rng, h, d, ps, layout, kv_dtype, num_pages):
    shape = ((h, num_pages + 1, ps, d) if layout == "kernel"
             else (num_pages + 1, ps, h, d))
    return [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device="cuda").to(kv_dtype) for _ in range(2)]


def _decode_case(rng, h, d, ps, layout, kv_dtype, lens, num_pages=64):
    """Sequences of `lens` (0 included) over distinct random pages; the
    page-table axis is padded past the longest with page 0."""
    need = [math.ceil(n / ps) for n in lens]
    perm = rng.permutation(num_pages)
    pt = np.zeros((len(lens), max(need) + 2), np.int32)
    for i, n in enumerate(need):
        pt[i, :n] = perm[sum(need[:i]):sum(need[:i]) + n]
    k_pool, v_pool = _pools(rng, h, d, ps, layout, kv_dtype, num_pages)
    return [torch.as_tensor(rng.standard_normal((len(lens), h, d)),
                            dtype=torch.float32, device="cuda"),
            k_pool, v_pool, torch.as_tensor(pt, device="cuda"),
            torch.as_tensor(np.asarray(lens, np.int32), device="cuda")]


@pytest.mark.parametrize("layout", ["token", "kernel"])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,d,ps", [(2, 8, 4), (12, 64, 16), (2, 128, 64),
                                    (2, 6, 4), (3, 30, 16), (2, 100, 5)])
def test_decode_kernel_matches_plain_version(layout, kv_dtype, h, d, ps):
    """Lengths 0 (exact zeros), exactly one page, a ragged tail and a long
    context, over page tables padded with page 0."""
    _need_card()
    args = _decode_case(np.random.default_rng(2), h, d, ps, layout,
                        kv_dtype, [0, ps, 3 * ps + 1, 1, 40 * ps - 3])
    before = pa.paged_decode_attention_kernel.launches
    ker = pa.paged_decode_attention_kernel(*args, layout=layout)
    plain = pa.paged_decode_attention_torch(*args, layout=layout)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention_kernel.launches == before + 1
    torch.testing.assert_close(ker, plain, atol=TOL, rtol=TOL)
    assert bool((ker[0] == 0).all())


# start 0, a chunk ending mid-page, 33 rows at 117..149 (16-row tiles
# that straddle key 128, a split boundary at page 4, 16 and 64, and a
# one-row last tile), the main path's chunk
CHUNKS = [(8, 0), (13, 21), (33, 117), (64, 536)]


def _chunk_case(rng, h, d, ps, layout, kv_dtype, n, start):
    """One sequence holding start + n keys (and two spare table slots of
    page 0), its chunk's n query rows."""
    pages = math.ceil((start + n) / ps)
    num_pages = pages + 8
    pt = np.zeros((pages + 2,), np.int32)
    pt[:pages] = rng.permutation(num_pages)[:pages]
    k_pool, v_pool = _pools(rng, h, d, ps, layout, kv_dtype, num_pages)
    return [torch.as_tensor(rng.standard_normal((n, h, d)),
                            dtype=torch.float32, device="cuda"),
            k_pool, v_pool, torch.as_tensor(pt, device="cuda")]


@pytest.mark.parametrize("layout", ["token", "kernel"])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,d,ps", [(2, 8, 4), (12, 64, 16), (2, 128, 64),
                                    (2, 6, 4), (3, 30, 16), (2, 100, 5)])
@pytest.mark.parametrize("n,start", CHUNKS)
def test_chunk_kernel_matches_plain_version(layout, kv_dtype, h, d, ps, n,
                                            start):
    """Start 0, a chunk ending mid-page, tiles that straddle their key
    splits, the main path's 64-row chunk at position 536; every row
    (padding rows compute at their nominal positions in both
    versions)."""
    _need_card()
    args = _chunk_case(np.random.default_rng(3), h, d, ps, layout, kv_dtype,
                       n, start)
    before = pa.chunk_prefill_attention_kernel.launches
    ker = pa.chunk_prefill_attention_kernel(*args, start, layout=layout)
    plain = pa.chunk_prefill_attention_torch(*args, start, layout=layout)
    torch.cuda.synchronize()
    assert pa.chunk_prefill_attention_kernel.launches == before + 1
    torch.testing.assert_close(ker, plain, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("layout", ["token", "kernel"])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_decode_and_chunk_kernels_on_misaligned_pools(layout, kv_dtype):
    _need_card()
    rng = np.random.default_rng(4)
    dec = _decode_case(rng, 2, 64, 16, layout, kv_dtype, [0, 50, 16, 33])
    chunk = _chunk_case(rng, 2, 64, 16, layout, kv_dtype, 12, 21)
    for args in (dec, chunk):
        args[1], args[2] = _misalign(args[1]), _misalign(args[2])
    torch.testing.assert_close(
        pa.paged_decode_attention_kernel(*dec, layout=layout),
        pa.paged_decode_attention_torch(*dec, layout=layout),
        atol=TOL, rtol=TOL)
    torch.testing.assert_close(
        pa.chunk_prefill_attention_kernel(*chunk, 21, layout=layout),
        pa.chunk_prefill_attention_torch(*chunk, 21, layout=layout),
        atol=TOL, rtol=TOL)


def test_launch_counters_move_only_on_cuda_tensors():
    _need_card()
    rng = np.random.default_rng(6)
    dec = _decode_case(rng, 2, 8, 4, "token", torch.float32, [5, 0])
    chunk = _chunk_case(rng, 2, 8, 4, "token", torch.float32, 6, 3)
    before = (pa.paged_decode_attention_kernel.launches,
              pa.chunk_prefill_attention_kernel.launches)
    pa.paged_decode_attention_kernel(*[a.cpu() for a in dec])
    pa.chunk_prefill_attention_kernel(*[a.cpu() for a in chunk], 3)
    assert (pa.paged_decode_attention_kernel.launches,
            pa.chunk_prefill_attention_kernel.launches) == before
    pa.paged_decode_attention_kernel(*dec)
    pa.chunk_prefill_attention_kernel(*chunk, 3)
    assert (pa.paged_decode_attention_kernel.launches,
            pa.chunk_prefill_attention_kernel.launches) == (before[0] + 1,
                                                            before[1] + 1)


@pytest.mark.parametrize("settings", [
    dict(), dict(step_mode="legacy"), dict(step_mode="legacy", decode="eager"),
    dict(step_mode="legacy", prefill_chunk_tokens=0)],
    ids=["ragged", "legacy_fused", "legacy_eager", "legacy_one_shot"])
def test_engine_on_card_matches_cpu_engine_tokens(settings):
    _need_card()
    outs = []
    for device in ("cuda", "cpu"):
        model = pgen.TinyCausalLM(vocab_size=48, num_layers=2, num_heads=2,
                                  head_dim=8, seed=3, device=device)
        eng = pgen.GenerationEngine(model, pgen.GenerationConfig(
            **{"max_decode_slots": 4, "num_pages": 64, "page_size": 4,
               "prefill_chunk_tokens": 3, "device": device, **settings}),
            start=False)
        hs = [eng.submit(p, max_new_tokens=10)
              for p in ([1, 2, 3], [7, 5], [9, 9, 9, 4, 2], [11])]
        eng.run_until_idle()
        outs.append([h.result(timeout=30).token_ids for h in hs])
        eng.shutdown()
    assert outs[0] == outs[1]


# --------------------------- int8 pools ---------------------------------

SHAPES = [(2, 8, 4), (12, 64, 16), (2, 128, 64), (2, 6, 4), (3, 30, 16),
          (2, 100, 5)]


def _int8(args, rng, layout, h):
    """Replace args[1], args[2] (the pools) with random int8 codes and
    return their [pool pages, H] scales (every third page's 0: a fresh
    page, which decodes to exact zeros)."""
    n_pages = args[1].shape[1 if layout == "kernel" else 0]
    for i in (1, 2):
        args[i] = torch.as_tensor(
            rng.integers(-127, 128, tuple(args[i].shape)), dtype=torch.int8,
            device="cuda")
    scales = {}
    for key in ("k_scale", "v_scale"):
        sc = rng.uniform(0.5, 4.0, (n_pages, h))
        sc[::3] = 0.0
        scales[key] = torch.as_tensor(sc, dtype=torch.float32, device="cuda")
    return scales


@pytest.mark.parametrize("layout", ["token", "kernel"])
@pytest.mark.parametrize("h,d,ps", SHAPES)
def test_ragged_kernel_int8_matches_plain_version(layout, h, d, ps):
    _need_card()
    rng = np.random.default_rng(12)
    args = _case(rng, h, d, ps, layout, torch.float32,
                 [(1, 13), (1, 60), (17, 40), (0, 9)])
    sc = _int8(args, rng, layout, h)
    before = dict(pa.ragged_paged_attention_kernel.launches_by_dtype)
    ker = pa.ragged_paged_attention_kernel(*args, layout=layout, **sc)
    plain = pa.ragged_paged_attention_torch(*args, layout=layout, **sc)
    torch.cuda.synchronize()
    after = pa.ragged_paged_attention_kernel.launches_by_dtype
    assert after["int8"] == before["int8"] + 1
    assert after["float32"] == before["float32"]
    torch.testing.assert_close(ker, plain, atol=TOL, rtol=TOL)
    assert bool((ker[0] == 0).all()) and bool((ker[-1] == 0).all())


def _ragged_pools(kind, args, rng, layout, h):
    """The pools of `args` as `kind` ("float32", "bfloat16" or "int8",
    with its scales); returns the scale keywords."""
    if kind == "int8":
        return _int8(args, rng, layout, h)
    args[1], args[2] = (a.to(getattr(torch, kind)) for a in args[1:3])
    return {}


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_ragged_kernel_is_deterministic(kind):
    """The kernel merges a tile's key splits in a fixed order with no
    float atomics: two launches on the same inputs give the same bits."""
    _need_card()
    rng = np.random.default_rng(13)
    args = _case(rng, 12, 64, 16, "token", torch.float32,
                 [(1, 516), (1, 68), (1, 300), (64, 600), (0, 5)],
                 num_pages=128)
    sc = _ragged_pools(kind, args, rng, "token", 12)
    first = pa.ragged_paged_attention_kernel(*args, **sc)
    second = pa.ragged_paged_attention_kernel(*args, **sc)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    torch.testing.assert_close(
        first, pa.ragged_paged_attention_torch(*args, **sc), atol=TOL,
        rtol=TOL)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_ragged_kernel_long_context(kind, layout):
    """One decode row over 4,100 keys (65 splits of 4 pages, a page table
    of 257 entries) and a 3-row chunk at the end of 4,003 keys."""
    _need_card()
    rng = np.random.default_rng(14)
    args = _case(rng, 2, 64, 16, layout, torch.float32,
                 [(1, 4100), (3, 4003)], num_pages=600)
    assert args[3].shape[1] >= 256
    sc = _ragged_pools(kind, args, rng, layout, 2)
    ker = pa.ragged_paged_attention_kernel(*args, layout=layout, **sc)
    plain = pa.ragged_paged_attention_torch(*args, layout=layout, **sc)
    torch.cuda.synchronize()
    torch.testing.assert_close(ker, plain, atol=TOL, rtol=TOL)


def test_ragged_kernel_call_has_no_host_sync():
    """One wrapper call under torch's sync debug mode "error": the grid
    and the workspace come from shapes alone, so nothing reads a device
    value back to the host."""
    _need_card()
    args = _case(np.random.default_rng(15), 12, 64, 16, "token",
                 torch.float32, [(1, 200), (40, 300)], num_pages=64)
    pa.ragged_paged_attention_kernel(*args)      # builds and loads first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pa.ragged_paged_attention_kernel(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("layout", ["token", "kernel"])
@pytest.mark.parametrize("h,d,ps", SHAPES)
def test_decode_kernel_int8_matches_plain_version(layout, h, d, ps):
    _need_card()
    rng = np.random.default_rng(13)
    args = _decode_case(rng, h, d, ps, layout, torch.float32,
                        [0, ps, 3 * ps + 1, 1, 40 * ps - 3])
    sc = _int8(args, rng, layout, h)
    before = pa.paged_decode_attention_kernel.launches_by_dtype["int8"]
    ker = pa.paged_decode_attention_kernel(*args, layout=layout, **sc)
    plain = pa.paged_decode_attention_torch(*args, layout=layout, **sc)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention_kernel.launches_by_dtype["int8"] == \
        before + 1
    torch.testing.assert_close(ker, plain, atol=TOL, rtol=TOL)
    assert bool((ker[0] == 0).all())


@pytest.mark.parametrize("layout", ["token", "kernel"])
@pytest.mark.parametrize("h,d,ps", SHAPES)
@pytest.mark.parametrize("n,start", CHUNKS)
def test_chunk_kernel_int8_matches_plain_version(layout, h, d, ps, n,
                                                 start):
    _need_card()
    rng = np.random.default_rng(14)
    args = _chunk_case(rng, h, d, ps, layout, torch.float32, n, start)
    sc = _int8(args, rng, layout, h)
    before = pa.chunk_prefill_attention_kernel.launches_by_dtype["int8"]
    ker = pa.chunk_prefill_attention_kernel(*args, start, layout=layout,
                                            **sc)
    plain = pa.chunk_prefill_attention_torch(*args, start, layout=layout,
                                             **sc)
    torch.cuda.synchronize()
    assert pa.chunk_prefill_attention_kernel.launches_by_dtype["int8"] == \
        before + 1
    torch.testing.assert_close(ker, plain, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_decode_and_chunk_kernels_are_deterministic(kind):
    """Both kernels merge a tile's key splits in a fixed order with no
    float atomics: two launches on the same inputs give the same bits.
    The main path's shapes: 8 decode rows over 16..632 keys and a dummy
    row (exact zeros), the 64-row chunk at position 536."""
    _need_card()
    rng = np.random.default_rng(17)
    dec = _decode_case(rng, 12, 64, 16, "token", torch.float32,
                       [516, 68, 0, 300, 16, 632, 100, 250, 17],
                       num_pages=400)
    chunk = _chunk_case(rng, 12, 64, 16, "token", torch.float32, 64, 536)
    outs = []
    for kernel, plain, args, extra in (
            (pa.paged_decode_attention_kernel,
             pa.paged_decode_attention_torch, dec, ()),
            (pa.chunk_prefill_attention_kernel,
             pa.chunk_prefill_attention_torch, chunk, (536,))):
        sc = _ragged_pools(kind, args, rng, "token", 12)
        first = kernel(*args, *extra, **sc)
        second = kernel(*args, *extra, **sc)
        torch.cuda.synchronize()
        assert torch.equal(first, second)
        torch.testing.assert_close(first, plain(*args, *extra, **sc),
                                   atol=TOL, rtol=TOL)
        outs.append(first)
    assert bool((outs[0][2] == 0).all())


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_decode_kernel_long_context(kind, layout):
    """One decode row over 4,100 keys (65 splits of 4 pages, a page table
    of 259 entries) beside a seq_len 0 row (exact zeros) and a short
    one."""
    _need_card()
    rng = np.random.default_rng(18)
    args = _decode_case(rng, 2, 64, 16, layout, torch.float32,
                        [4100, 0, 3], num_pages=600)
    assert args[3].shape[1] >= 256
    sc = _ragged_pools(kind, args, rng, layout, 2)
    ker = pa.paged_decode_attention_kernel(*args, layout=layout, **sc)
    plain = pa.paged_decode_attention_torch(*args, layout=layout, **sc)
    torch.cuda.synchronize()
    torch.testing.assert_close(ker, plain, atol=TOL, rtol=TOL)
    assert bool((ker[1] == 0).all())


def test_decode_and_chunk_kernel_calls_have_no_host_sync():
    """One call of each wrapper under torch's sync debug mode "error":
    the decode grid and both workspaces come from shapes alone, the
    chunk's items from host ints, so nothing reads a device value back
    to the host."""
    _need_card()
    rng = np.random.default_rng(19)
    dec = _decode_case(rng, 12, 64, 16, "token", torch.float32,
                       [200, 0, 333], num_pages=64)
    chunk = _chunk_case(rng, 12, 64, 16, "token", torch.float32, 40, 300)
    calls = (lambda: pa.paged_decode_attention_kernel(*dec),
             lambda: pa.chunk_prefill_attention_kernel(*chunk, 300))
    for call in calls:      # builds and loads first
        call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_int8_kernels_on_misaligned_pools(layout):
    """int8 pools one byte off a 4-byte boundary take the scalar byte
    loads in all three kernels."""
    _need_card()
    rng = np.random.default_rng(15)
    rag = _case(rng, 2, 64, 16, layout, torch.float32,
                [(1, 50), (12, 33), (0, 9)])
    dec = _decode_case(rng, 2, 64, 16, layout, torch.float32,
                       [0, 50, 16, 33])
    chunk = _chunk_case(rng, 2, 64, 16, layout, torch.float32, 12, 21)
    scs = [_int8(args, rng, layout, 2) for args in (rag, dec, chunk)]
    for args in (rag, dec, chunk):
        args[1], args[2] = _misalign(args[1]), _misalign(args[2])
        assert args[1].data_ptr() % 4 == 1
    for kernel, plain, args, sc, extra in (
            (pa.ragged_paged_attention_kernel,
             pa.ragged_paged_attention_torch, rag, scs[0], ()),
            (pa.paged_decode_attention_kernel,
             pa.paged_decode_attention_torch, dec, scs[1], ()),
            (pa.chunk_prefill_attention_kernel,
             pa.chunk_prefill_attention_torch, chunk, scs[2], (21,))):
        torch.testing.assert_close(
            kernel(*args, *extra, layout=layout, **sc),
            plain(*args, *extra, layout=layout, **sc), atol=TOL, rtol=TOL)


def test_int8_kernels_refuse_missing_or_misshapen_scales():
    _need_card()
    rng = np.random.default_rng(16)
    dec = _decode_case(rng, 2, 8, 4, "token", torch.float32, [5, 3])
    sc = _int8(dec, rng, "token", 2)
    with pytest.raises(ValueError, match="without k_scale"):
        pa.paged_decode_attention_kernel(*dec)
    with pytest.raises(ValueError, match="float32"):
        pa.paged_decode_attention_kernel(
            *dec, k_scale=sc["k_scale"][:-1].contiguous(),
            v_scale=sc["v_scale"][:-1].contiguous())


@pytest.mark.parametrize("settings", [
    dict(), dict(step_mode="legacy"), dict(step_mode="legacy", decode="eager"),
    dict(step_mode="legacy", prefill_chunk_tokens=0, pool_layout="kernel")],
    ids=["ragged", "legacy_fused", "legacy_eager", "legacy_one_shot"])
def test_int8_engine_on_card_matches_cpu_engine_tokens(settings):
    """int8 engines card vs CPU: the same tokens, and the card run
    launched only the int8 branches of the paged kernels."""
    _need_card()
    outs = []
    wrappers = (pa.ragged_paged_attention_kernel,
                pa.paged_decode_attention_kernel,
                pa.chunk_prefill_attention_kernel)
    before = [dict(w.launches_by_dtype) for w in wrappers]
    for device in ("cuda", "cpu"):
        model = pgen.TinyCausalLM(vocab_size=48, num_layers=2, num_heads=2,
                                  head_dim=8, seed=3, device=device)
        eng = pgen.GenerationEngine(model, pgen.GenerationConfig(
            **{"max_decode_slots": 4, "num_pages": 64, "page_size": 4,
               "prefill_chunk_tokens": 3, "device": device,
               "kv_dtype": "int8", **settings}), start=False)
        hs = [eng.submit(p, max_new_tokens=10)
              for p in ([1, 2, 3], [7, 5], [9, 9, 9, 4, 2], [11])]
        eng.run_until_idle()
        outs.append([h.result(timeout=30).token_ids for h in hs])
        eng.shutdown()
    assert outs[0] == outs[1]
    moved = [{k: w.launches_by_dtype[k] - b[k] for k in b}
             for w, b in zip(wrappers, before)]
    assert sum(m["int8"] for m in moved) > 0
    assert all(m["float32"] == m["bfloat16"] == 0 for m in moved)


# ------------------------- flash attention ------------------------------

FLASH_TOL = dict(atol=2e-5, rtol=2e-5)    # out, lse: fp32, other sum order
FLASH_GRAD_TOL = dict(atol=1e-4, rtol=1e-4)  # sums of up to Lq products
FLASH_BF16_TOL = dict(atol=2e-2, rtol=2e-2)  # bf16 outputs; p rounded
                                             # against another running max


def _flash_case(rng, bh, lq, lk, d, dtype, heads=2, mask=False):
    """qs (scale folded), k, v, dO on the card; a key mask that masks
    every key of batch row 0 (its rows see nothing) and the last three
    keys of the last row."""
    def cuda(shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=torch.float32, device="cuda").to(dtype)

    qs = cuda((bh, lq, d), 1.0 / math.sqrt(d))
    k, v, do = cuda((bh, lk, d)), cuda((bh, lk, d)), cuda((bh, lq, d))
    km = None
    if mask:
        km_np = np.zeros((bh // heads, 1, lk), np.float32)
        km_np[0] = -1e30
        km_np[-1, 0, -3:] = -1e30
        km = torch.as_tensor(km_np, device="cuda")
    return qs, k, v, do, km


def _check_flash(qs, k, v, do, km, causal, heads):
    from paddle_tpu_torch.ops import flash_attention as fa

    tol = FLASH_TOL if qs.dtype == torch.float32 else FLASH_BF16_TOL
    gtol = FLASH_GRAD_TOL if qs.dtype == torch.float32 else FLASH_BF16_TOL
    before = (fa.flash_attention_fwd_kernel.launches,
              fa.flash_attention_bwd_dkdv_kernel.launches,
              fa.flash_attention_bwd_dq_kernel.launches)
    out, lse = fa.flash_attention_fwd_kernel(qs, k, v, km, causal, heads)
    out_p, lse_p = fa.flash_attention_fwd_torch(qs, k, v, km, causal, heads)
    delta = (do.float() * out_p.float()).sum(-1)
    dk, dv = fa.flash_attention_bwd_dkdv_kernel(qs, k, v, do, lse_p, delta,
                                                km, causal, heads)
    dq = fa.flash_attention_bwd_dq_kernel(qs, k, v, do, lse_p, delta, km,
                                          causal, heads)
    dk_p, dv_p = fa.flash_attention_bwd_dkdv_torch(qs, k, v, do, lse_p,
                                                   delta, km, causal, heads)
    dq_p = fa.flash_attention_bwd_dq_torch(qs, k, v, do, lse_p, delta, km,
                                           causal, heads)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd_kernel.launches,
            fa.flash_attention_bwd_dkdv_kernel.launches,
            fa.flash_attention_bwd_dq_kernel.launches) == tuple(
                n + 1 for n in before)
    assert out.dtype == qs.dtype and dk.dtype == dv.dtype == dq.dtype \
        == qs.dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), out_p.float(), **tol)
    torch.testing.assert_close(lse, lse_p, **FLASH_TOL)
    for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        torch.testing.assert_close(got.float(), want.float(), **gtol)
    return out, lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 128, 30])
@pytest.mark.parametrize("lq,lk,causal,mask", [
    (64, 64, False, False), (64, 64, True, False), (48, 48, True, False),
    (8, 64, True, False), (130, 70, True, False), (200, 200, True, True),
    (130, 70, False, True)])
def test_flash_kernels_match_plain_versions(dtype, d, lq, lk, causal, mask):
    """One tile, several tiles with ragged edges (L 48, 130, 200), Lq < Lk
    and Lq > Lk causal (bottom-right: the first Lq - Lk rows see no key),
    a key mask with fully masked rows (out 0, lse NEG_INF)."""
    _need_card()
    case = _flash_case(np.random.default_rng(7), 4, lq, lk, d, dtype,
                       mask=mask)
    out, lse = _check_flash(*case, causal, 2)
    if mask:   # batch row 0 (heads 0, 1) masks every key
        assert bool((out[:2] == 0).all()) and bool((lse[:2] == -1e30).all())
    if causal and lq > lk:
        assert bool((out[:, :lq - lk] == 0).all())


def test_flash_kernels_at_the_training_shape():
    """The train step's case: BH 96 (B 8 x H 12), L 512, D 64, f32,
    causal, no mask."""
    _need_card()
    case = _flash_case(np.random.default_rng(8), 96, 512, 512, 64,
                       torch.float32)
    _check_flash(*case, True, 12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_at_d128_l1024_causal_with_key_mask(dtype):
    """The backward's largest shared-memory footprint (D 128) and longest
    walks (16 owned tiles of 64, 32 walked tiles of 32), causal, with a
    key mask whose batch row 0 masks every key."""
    _need_card()
    case = _flash_case(np.random.default_rng(12), 4, 1024, 1024, 128,
                       dtype, mask=True)
    out, lse = _check_flash(*case, True, 2)
    assert bool((out[:2] == 0).all()) and bool((lse[:2] == -1e30).all())


def test_flash_backward_is_deterministic():
    """The two backward kernels run twice on the same inputs at the
    training shape give bitwise-equal dq, dk, dv: each output element is
    summed by one thread in a fixed order, with no atomics."""
    _need_card()
    from paddle_tpu_torch.ops import flash_attention as fa

    qs, k, v, do, _ = _flash_case(np.random.default_rng(11), 96, 512, 512,
                                  64, torch.float32)
    out, lse = fa.flash_attention_fwd_kernel(qs, k, v, None, True, 12)
    delta = (do.float() * out.float()).sum(-1)
    runs = []
    for _ in range(2):
        dk, dv = fa.flash_attention_bwd_dkdv_kernel(qs, k, v, do, lse, delta,
                                                    None, True, 12)
        dq = fa.flash_attention_bwd_dq_kernel(qs, k, v, do, lse, delta,
                                              None, True, 12)
        runs.append((dq, dk, dv))
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


def test_flash_forward_is_deterministic():
    """The forward kernel run twice on the same inputs at the training
    shape gives bitwise-equal out and lse: each row's softmax state and
    output are summed by one warp in a fixed order, with no atomics."""
    _need_card()
    from paddle_tpu_torch.ops import flash_attention as fa

    qs, k, v, _, _ = _flash_case(np.random.default_rng(13), 96, 512, 512,
                                 64, torch.float32)
    runs = [fa.flash_attention_fwd_kernel(qs, k, v, None, True, 12)
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "lse"), *runs):
        assert torch.equal(a, b), name


def test_flash_kernels_refuse_what_they_do_not_take():
    _need_card()
    from paddle_tpu_torch.ops import flash_attention as fa

    qs, k, v, _, _ = _flash_case(np.random.default_rng(9), 2, 16, 16, 8,
                                 torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd_kernel(qs.transpose(1, 2).contiguous()
                                      .transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="float32 or all"):
        fa.flash_attention_fwd_kernel(qs.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros(1, 4, 160, device="cuda")
        fa.flash_attention_fwd_kernel(big, big, big)


def test_flash_autograd_on_card_matches_cpu():
    """The public flash_attention through autograd: the card's kernels
    against the CPU's plain versions, forward and grads."""
    _need_card()
    from paddle_tpu_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(10)
    q, k, v = (rng.standard_normal((2, 3, 70, 32)).astype(np.float32)
               for _ in range(3))
    mask = np.zeros((2, 1, 1, 70), np.float32)
    mask[1, ..., -5:] = -1e30
    res = []
    for dev in ("cuda", "cpu"):
        ts = [torch.tensor(x, device=dev, requires_grad=True)
              for x in (q, k, v)]
        out = flash_attention(*ts, torch.tensor(mask, device=dev),
                              causal=True)
        out.square().sum().backward()
        res.append([out.detach().cpu()] + [t.grad.cpu() for t in ts])
    torch.testing.assert_close(res[0][0], res[1][0], **FLASH_TOL)
    for a, b in zip(res[0][1:], res[1][1:]):
        torch.testing.assert_close(a, b, **FLASH_GRAD_TOL)


def test_train_step_launches_each_flash_kernel_once_per_layer():
    """One GPT train step on the card moves each flash kernel's counter
    by num_layers (the backward included); a CPU step moves none; and
    the card's loss matches the CPU's on the same weights."""
    _need_card()
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    cfg = GPTConfig(vocab_size=256, hidden_size=64, num_layers=3,
                    num_heads=2, max_seq_len=96, dropout=0.0,
                    use_flash=True)
    wrappers = (fa.flash_attention_fwd_kernel,
                fa.flash_attention_bwd_dkdv_kernel,
                fa.flash_attention_bwd_dq_kernel)
    rng = np.random.default_rng(11)
    ids, lbl = (torch.as_tensor(rng.integers(0, 256, (2, 96)))
                for _ in range(2))
    losses = []
    for device in ("cuda", "cpu"):
        model = GPTForPretraining(cfg, seed=1, device=device)
        tr = TrainStep(model, lambda m, i, l, generator: m.loss(i, l),
                       AdamW(1e-3), amp_dtype=torch.bfloat16, device=device)
        before = [w.launches for w in wrappers]
        losses.append(float(tr.step(ids, lbl)))
        moved = [w.launches - b for w, b in zip(wrappers, before)]
        assert moved == ([cfg.num_layers] * 3 if device == "cuda"
                         else [0, 0, 0]), (device, moved)
    assert abs(losses[0] - losses[1]) <= 1e-3 * abs(losses[1])


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_captured_loop_replay_equals_eager_on_card(kv_dtype):
    """On the card: one captured loop's replay gives the eager loop's
    output and pools bitwise, on the same inputs and pool state."""
    _need_card()
    model = pgen.TinyCausalLM(vocab_size=64, num_layers=2, num_heads=2,
                              head_dim=8, seed=3, device="cuda")
    eng = pgen.GenerationEngine(model, pgen.GenerationConfig(
        max_decode_slots=4, num_pages=64, page_size=4, kv_dtype=kv_dtype,
        prefill_chunk_tokens=3, loop_steps=4, device="cuda"), start=False)
    hs = [eng.submit(p, max_new_tokens=3)
          for p in ([1, 2, 3], [7, 5], [9, 9, 9, 4, 2], [11])]
    eng.run_until_idle()                      # pools hold real content
    for h in hs:
        h.result(timeout=30)
    lp = eng._loop
    args = (np.array([3, 17], np.int32), np.array([5, 3], np.int32),
            np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32),
            np.array([0.0, 0.9], np.float32), np.array([0, 10], np.int32),
            np.array([1.0, 0.9], np.float32), np.array([0, 9], np.int32),
            np.array([0, 1], np.int32), np.array([4, 4], np.int32),
            np.full((2, 8), -1, np.int32), np.full((2, 4, 8), -1, np.int32),
            np.zeros((2, 4), np.int32), np.full((2, 7), -1, np.int32),
            np.zeros((2, 1), np.int32), np.zeros((2,), np.int32))
    start = [t.clone() for t in eng.cache.take_pool_state()]
    replays = lp.replays
    replay = lp.step(*args)
    after_replay = [t.clone() for t in eng.cache.take_pool_state()]
    for t, s in zip(eng.cache.take_pool_state(), start):
        t.copy_(s)
    lp.use_graph = False
    eager = lp.step(*args)
    np.testing.assert_array_equal(replay, eager)
    # the sink page (the last) takes every dead row's write, in no fixed
    # order, and is never read
    p = eng.cache.num_pages
    for a, b in zip(after_replay, eng.cache.take_pool_state()):
        if a.dim() == 4 and eng.cache.pool_layout == "kernel":
            a, b = a[:, :p], b[:, :p]
        else:
            a, b = a[:p], b[:p]
        assert torch.equal(a, b)
    assert lp.replays == replays + 1 and lp.captures >= 1
    eng.shutdown()


@pytest.mark.parametrize("layout", ["token", "kernel"])
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_prefix_page_copy_export_import_on_card(kv_dtype, layout):
    """The prefix cache's device work on a CUDA pool against the same
    operations on a CPU pool: a prefill, its registration, a clipped
    adoption whose next reserve copies the tail page on write (bytes and
    int8 scale rows), the export of the run, and its import into a fresh
    card pool of the other layout — the bookkeeping equal, and every
    pool byte, scale and payload bitwise equal to the CPU's.  The copy
    and the import write the pools in place (same addresses)."""
    _need_card()
    dtype = pgen.engine._kv_dtype(kv_dtype)
    rng = np.random.default_rng(0)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]
    k = torch.as_tensor(rng.standard_normal((1, 2, 12, 2, 8)),
                        dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((1, 2, 12, 2, 8)),
                        dtype=torch.float32)
    runs = {}
    for device in ("cpu", "cuda"):
        pool = pgen.DeviceKVPool(2, 2, 8, num_pages=16, page_size=4,
                                 dtype=dtype, pool_layout=layout,
                                 device=device)
        ptrs = [t.data_ptr() for t in pool.take_pool_state()]
        pool.allocate("donor")
        pool.reserve("donor", 12)
        pool.write_prefill_batch(["donor"], [0], [12], k.to(device),
                                 v.to(device))
        assert pool.register_prefix("donor", prompt) == 3
        pages, m = pool.match_prefix(prompt)
        pool.allocate("warm")
        pool.adopt_prefix("warm", pages, m)
        pool.reserve("warm", 1)                  # the copy on write
        payload = pool.export_pages(pages)
        other = pgen.DeviceKVPool(
            2, 2, 8, num_pages=16, page_size=4, dtype=dtype,
            pool_layout="token" if layout == "kernel" else "kernel",
            device=device)
        imported = other.import_pages(*payload)
        assert [t.data_ptr() for t in pool.take_pool_state()] == ptrs
        runs[device] = dict(
            tables=(pool.page_table("warm"), imported), pool=pool,
            other=other, payload=payload,
            back=other.export_pages(imported),
            counters=pool.take_prefix_counters())
    cpu, card = runs["cpu"], runs["cuda"]
    assert card["tables"] == cpu["tables"]
    assert card["counters"] == cpu["counters"] == (1, 0)
    for a, b in zip(card["payload"] + card["back"],
                    cpu["payload"] + cpu["back"]):
        assert a.device.type == "cpu" and torch.equal(a, b)
    for name in ("k_pool", "v_pool") + (("k_scale", "v_scale")
                                        if kv_dtype == "int8" else ()):
        for key in ("pool", "other"):
            np.testing.assert_array_equal(getattr(card[key], name),
                                          getattr(cpu[key], name))
