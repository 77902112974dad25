"""Port parity: ragged paged attention.

The port's plain PyTorch version (the CPU path of the CUDA kernel's
wrapper) against the JAX package's Pallas ragged kernel run in interpret
mode and against its jnp reference, on the same seeded numpy inputs.
Tolerance atol = rtol = 2e-5: fp32 throughout, but the online-softmax
kernel and the two frameworks' einsums sum in different orders.  Rows
no descriptor owns must be exactly 0 on every path.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

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


# ---- the CUDA kernel's work split and merge, modelled in torch ----------
#
# The kernel cuts each descriptor into tiles of RAGGED_TILE_ROWS rows (or
# one decode row) and each tile's visible keys into splits of whole pages
# (`ragged_work_items`); every item computes its rows' partial (m, l, acc)
# over its split, and the partials of a tile are merged in split order.
# The model below repeats that arithmetic on the CPU: it has to agree with
# the plain version and with the JAX package on every pool dtype and
# layout, which shows that the split and the merge lose nothing.

SPLIT_CASES = {
    # page 4: a padding descriptor, a chunk from position 0 (kv_len ==
    # len), horizons mid-page, a 1-row tail tile (17 rows)
    "ps4": (4, 2, 8, [(1, 13), (0, 9), (5, 12), (1, 1), (17, 17),
                      (7, 70)]),
    # page 5: splits of 13 pages (65 keys); tiles whose rows straddle a
    # split boundary
    "ps5": (5, 2, 6, [(3, 17), (1, 5), (17, 140), (0, 3), (20, 20)]),
    # page 16: splits of 4 pages; a 33-row chunk at positions 117..149
    # (tile 0 crosses the key-128 boundary), kv_len 64 and 65
    "ps16": (16, 2, 16, [(1, 200), (33, 150), (1, 64), (1, 65), (0, 0)]),
    # page 64: one page a split
    "ps64": (64, 2, 32, [(1, 130), (20, 200), (1, 64), (16, 16)]),
    # one decode row over 4100 keys and a short chunk at its end
    "long": (16, 2, 8, [(1, 4100), (3, 4003)]),
}


def _split_fixture(name, kv_dtype, layout, seed=11):
    ps, h, d, desc = SPLIT_CASES[name]
    rng = np.random.default_rng(seed)
    lens = np.array([ln for ln, _ in desc], np.int32)
    kv_lens = np.array([kv for _, kv in desc], np.int32)
    # row 0 and the last row are owned by no descriptor
    starts = (np.concatenate([[0], np.cumsum(lens)[:-1]]) + 1).astype(
        np.int32)
    t = int(lens.sum()) + 2
    need = [max(1, -(-int(kv) // ps)) for kv in kv_lens]
    n_pages = sum(need) + 3
    pt = np.zeros((len(desc), max(need)), np.int32)
    perm = rng.permutation(n_pages)
    used = 0
    for i, n in enumerate(need):
        pt[i, :n] = perm[used:used + n]
        used += n
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
            if kv_dtype == "bfloat16":   # values a bf16 pool holds exactly
                p = np.array(jnp.asarray(p, jnp.bfloat16).astype(jnp.float32))
            pools.append(p)
    if layout == "kernel":
        pools = [np.ascontiguousarray(p.transpose(2, 0, 1, 3)) for p in pools]
    return dict(q=rng.standard_normal((t, h, d)).astype(np.float32),
                k_pool=pools[0], v_pool=pools[1], page_tables=pt,
                starts=starts, lens=lens, kv_lens=kv_lens, page_size=ps,
                scales=scales)


def _torch_args(fx, kv_dtype):
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}[kv_dtype]
    args = [torch.from_numpy(fx[k]) for k in
            ("q", "k_pool", "v_pool", "page_tables", "starts", "lens",
             "kv_lens")]
    args[1], args[2] = args[1].to(dt), args[2].to(dt)
    return args, {k: torch.from_numpy(v) for k, v in fx["scales"].items()}


def _split_keys(pool, scale, table, layout):
    """[keys, H, D] f32 of the pages `table`, as the kernel reads them:
    bf16 upcast, int8 times ``scale[page, h] * (1/127)`` per element."""
    g = pool[:, table].permute(1, 2, 0, 3) if layout == "kernel" \
        else pool[table]                                  # [np, ps, H, D]
    g = g.to(torch.float32)
    if scale is not None:
        g = g * (scale[table] * pa.INV_QMAX)[:, None, :, None]
    return g.reshape(-1, g.shape[2], g.shape[3])


def _split_partial(q, k_pool, v_pool, page_tables, item, page_size, layout,
                   scale, k_scale=None, v_scale=None):
    """One item's (m, l, acc) for its rows and every head: m the row's
    largest visible score of the split (-1e30 if none), l and acc the
    sums of exp(score - m) and exp(score - m) * v over its visible keys;
    masked keys weigh exactly 0."""
    table = page_tables[item.desc, item.page_lo:item.page_hi].long()
    k = _split_keys(k_pool, k_scale, table, layout)
    v = _split_keys(v_pool, v_scale, table, layout)
    rows = slice(item.row0, item.row0 + item.n_rows)
    s = torch.einsum("nhd,khd->hnk", q[rows] * scale, k)
    col = item.page_lo * page_size + torch.arange(k.shape[0])
    qpos = item.qpos0 + torch.arange(item.n_rows)
    vis = (col[None, :] <= qpos[:, None])[None]            # [1, n, K]
    m = torch.where(vis, s, torch.full_like(s, pa.NEG_INF)).amax(-1)
    p = torch.where(vis, torch.exp(s - m[..., None]), torch.zeros_like(s))
    return m, p.sum(-1), torch.einsum("hnk,khd->hnd", p, v)


def _merge(partials):
    """The kernel's merge of one tile's split partials, in split order: a
    running (M, L, acc) starting at (-1e30, 0, 0); split i rescales it by
    exp(M - M') and adds its own by exp(m_i - M'), M' = max(M, m_i);
    out = acc / L (0 where nothing was seen)."""
    mm = torch.full_like(partials[0][0], pa.NEG_INF)
    ll = torch.zeros_like(mm)
    acc = torch.zeros_like(partials[0][2])
    for m, l, a in partials:
        m_new = torch.maximum(mm, m)
        c_old, c_new = torch.exp(mm - m_new), torch.exp(m - m_new)
        ll = ll * c_old + l * c_new
        acc = acc * c_old[..., None] + a * c_new[..., None]
        mm = m_new
    inv = torch.where(ll > 0, 1.0 / ll, torch.zeros_like(ll))
    return acc * inv[..., None]


def _split_model(q, k_pool, v_pool, page_tables, starts, lens, kv_lens,
                 page_size, layout="token", k_scale=None, v_scale=None):
    """The CUDA kernel's arithmetic: its items (`ragged_work_items`),
    each item's partial, each tile's partials merged in split order."""
    items = pa.ragged_work_items(starts.tolist(), lens.tolist(),
                                 kv_lens.tolist(), page_size,
                                 page_tables.shape[1], q.shape[0])
    return _items_model(q, k_pool, v_pool, page_tables, items, page_size,
                        layout, k_scale, v_scale)


def _items_model(q, k_pool, v_pool, page_tables, items, page_size,
                 layout="token", k_scale=None, v_scale=None):
    """The split walk's arithmetic over `items` (each tile's listed in
    split order): each item's partial, each tile's partials merged in
    split order; rows no item covers are 0."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    out = torch.zeros_like(q)
    tiles = {}
    for it in items:
        tiles.setdefault(it.row0, []).append(_split_partial(
            q, k_pool, v_pool, page_tables, it, page_size, layout, scale,
            k_scale, v_scale))
    for it in items:
        if it.split == 0:
            rows = slice(it.row0, it.row0 + it.n_rows)
            out[rows] = _merge(tiles[it.row0]).permute(1, 0, 2)
    return out


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("layout", ["token", "kernel"])
@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_model_matches_plain_version_and_jax(name, layout, kv_dtype):
    """The split-and-merge model of the CUDA kernel against the plain
    version and the JAX reference within 2e-5 (fp32; the summation
    order differs), and against the Pallas kernel in interpret mode
    within 2e-5 on f32 and int8 pools and 1e-2 on bf16 ones (the Pallas
    body rounds its softmax weights to bf16 before P.V, as
    `test_bf16_pool_matches_jax` says)."""
    fx = _split_fixture(name, kv_dtype, layout)
    args, scales = _torch_args(fx, kv_dtype)
    model = _split_model(*args, fx["page_size"], layout, **scales).numpy()
    plain = pa.ragged_paged_attention_torch(*args, layout=layout,
                                            **scales).numpy()
    np.testing.assert_allclose(model, plain, **TOL)
    jargs = [fx[k] for k in ("q", "k_pool", "v_pool", "page_tables",
                             "starts", "lens", "kv_lens")]
    if kv_dtype == "bfloat16":
        jargs[1] = jnp.asarray(jargs[1], jnp.bfloat16)
        jargs[2] = jnp.asarray(jargs[2], jnp.bfloat16)
    ref = np.asarray(jax_ragged_reference(*jargs, layout=layout,
                                          **fx["scales"]))
    pallas = np.asarray(jax_ragged(*jargs, use_kernel=True, interpret=True,
                                   layout=layout, **fx["scales"]))
    np.testing.assert_allclose(model, ref, **TOL)
    bf16 = dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(model, pallas,
                               **(bf16 if kv_dtype == "bfloat16" else TOL))
    assert np.all(model[_unowned_rows(fx)] == 0.0)


def _random_descriptors(rng, page_size):
    """A packed step of random descriptors: decode rows, chunks (some from
    position 0), len-0 padding, rows no descriptor owns."""
    lens, kvs = [], []
    for _ in range(int(rng.integers(1, 9))):
        kind = rng.integers(0, 4)
        ln = [1, int(rng.integers(2, 40)), 0, int(rng.integers(1, 20))][kind]
        kv = ln if kind == 3 else ln + int(rng.integers(0, 300))
        lens.append(ln)
        kvs.append(kv)
    gaps = rng.integers(0, 2, len(lens))
    starts, row = [], 0
    for ln, gap in zip(lens, gaps):
        row += int(gap)
        starts.append(row)
        row += ln
    max_pages = max(-(-kv // page_size) for kv in kvs) + int(
        rng.integers(0, 3))
    return starts, lens, kvs, max(max_pages, 1), row + 1


@pytest.mark.parametrize("page_size", [4, 5, 16, 64])
def test_work_items_cover_each_visible_pair_once(page_size):
    """Over seeded random steps, the items cover every visible (row, key)
    pair exactly once and nothing else, every item sees at least one key
    of its split, its pages are whole and at least 64 keys unless it is
    its tile's last split, and the items fit in the kernel's grid."""
    rng = np.random.default_rng(page_size)
    for _ in range(25):
        starts, lens, kvs, max_pages, t = _random_descriptors(rng, page_size)
        items = pa.ragged_work_items(starts, lens, kvs, page_size,
                                     max_pages, t)
        kmax = max_pages * page_size
        seen = np.zeros((t, kmax), np.int64)
        want = np.zeros((t, kmax), np.int64)
        for st, ln, kv in zip(starts, lens, kvs):
            for r in range(ln):
                want[st + r, :min(kv - ln + r + 1, kmax)] = 1
        for it in items:
            keys = np.arange(it.page_lo * page_size, it.page_hi * page_size)
            assert it.page_hi > it.page_lo
            if it.split < it.n_splits - 1:
                assert len(keys) >= pa.RAGGED_SPLIT_KEYS
            assert it.n_rows in range(1, pa.RAGGED_TILE_ROWS + 1)
            pos = it.qpos0 + np.arange(it.n_rows)
            vis = keys[None, :] <= pos[:, None]
            assert vis.any(), f"empty item {it}"
            rows = it.row0 + np.arange(it.n_rows)
            seen[rows[:, None], keys[None, :]] += vis
        np.testing.assert_array_equal(seen, want)
        assert len(items) <= pa.ragged_grid_blocks(t, len(lens), 1,
                                                   max_pages, page_size)


def test_fully_masked_split_merges_as_identity():
    """A split a row cannot see leaves (m, l, acc) = (-1e30, 0, 0), and
    the merge takes it as the identity wherever it stands: the result is
    bitwise that of the merge without it.  A row that sees no split at
    all comes out as zeros."""
    rng = np.random.default_rng(5)
    h, n, d = 2, 3, 8
    parts = [(torch.from_numpy(rng.standard_normal((h, n))).float(),
              torch.from_numpy(rng.uniform(1, 5, (h, n))).float(),
              torch.from_numpy(rng.standard_normal((h, n, d))).float())
             for _ in range(3)]
    masked = (torch.full((h, n), pa.NEG_INF), torch.zeros(h, n),
              torch.zeros(h, n, d))
    want = _merge(parts)
    for at in range(len(parts) + 1):
        got = _merge(parts[:at] + [masked] + parts[at:])
        assert torch.equal(got, want)
    assert torch.equal(_merge([masked, masked]), torch.zeros(h, n, d))
    # and through the model: the 7-row tile at positions 63..69 (page 4,
    # splits of 64 keys) has a second split its first row cannot see
    fx = _split_fixture("ps4", "float32", "token")
    args, _ = _torch_args(fx, "float32")
    items = pa.ragged_work_items(*(x.tolist() for x in args[4:7]), 4,
                                 args[3].shape[1], args[0].shape[0])
    blind = [it for it in items
             if it.qpos0 < it.page_lo * 4 and it.n_splits > 1]
    assert blind, "the fixture has no tile with a split its first row misses"
    m, l, acc = _split_partial(args[0], args[1], args[2], args[3], blind[0],
                               4, "token", 1.0 / math.sqrt(8))
    assert float(m[:, 0].max()) == float(np.float32(pa.NEG_INF))
    assert float(l[:, 0].abs().max()) == 0.0
    assert float(acc[:, 0].abs().max()) == 0.0
