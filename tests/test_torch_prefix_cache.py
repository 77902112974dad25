"""Port parity: the prefix cache's mechanics, op for op against the JAX
package's cache.

Each test replays one sequence of cache operations on the port's
`DeviceKVPool` (on the CPU) and on the JAX package's `DeviceKVPool` (or
host `PagedKVCache`), and after every operation compares what the two
return and their whole bookkeeping: page tables, lengths, refcounts, the
free list in order, the trie's nodes and the eviction heap, the COW and
eviction counters and the gauges (shared, cached and available pages,
`stats()`).  The sequences follow the JAX package's own prefix-cache
tests: match and clip, zero-copy adoption, free as a decref, the leak
invariant, double free, copy-on-write on a partial page with the donor's
bytes unmoved, a missed COW as a loud error, LRU eviction only under
pressure, the incremental eviction heap, truncate into a shared run,
`reset_pools` flushing the index, and the delta log with its
compaction.  On int8 pools: export/import round trips bitwise against
the JAX payload, the typed quantization mismatch, and COW copying the
scale rows.  Page bytes are compared on the real pages (the port's pools
carry one sink page more).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

from paddle_tpu.generation import kv_cache as jkv
from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.generation import kv_cache as pkv

L, H, D, PS = 2, 2, 4, 4
SYSTEM = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]   # 3 full pages at PS=4
_JAX_DTYPE = {"float32": np.float32, "bfloat16": jnp.bfloat16,
              "int8": np.int8}


class Pair:
    """The port's pool and the JAX package's cache driven together: an
    attribute call runs on both, the results must agree (exceptions by
    type), and `check()` compares the whole bookkeeping."""

    def __init__(self, num_pages=16, page_size=PS, dtype="float32",
                 layout="token", host=False, num_layers=L):
        self.port = pgen.DeviceKVPool(
            num_layers, H, D, num_pages=num_pages, page_size=page_size,
            dtype=pgen.engine._kv_dtype(dtype), pool_layout=layout,
            device="cpu")
        if host:
            self.jax = jkv.PagedKVCache(num_layers, H, D,
                                        num_pages=num_pages,
                                        page_size=page_size,
                                        dtype=_JAX_DTYPE[dtype])
        else:
            self.jax = jkv.DeviceKVPool(num_layers, H, D,
                                        num_pages=num_pages,
                                        page_size=page_size,
                                        dtype=_JAX_DTYPE[dtype],
                                        pool_layout=layout)

    def __getattr__(self, name):
        def call(*args):
            out = []
            for cache in (self.port, self.jax):
                try:
                    out.append(_norm(getattr(cache, name)(*args)))
                except Exception as e:   # noqa: BLE001 — compared below
                    out.append(type(e).__name__)
            assert out[0] == out[1], (name, args, out)
            self.check()
            return out[0]
        return call

    def prop(self, name):
        a, b = getattr(self.port, name), getattr(self.jax, name)
        assert a == b, (name, a, b)
        return a

    def check(self):
        p, j = self.port, self.jax
        assert p._tables == j._tables
        assert p._lens == j._lens
        assert p._refs == j._refs
        assert p._free == j._free
        assert _nodes(p) == _nodes(j)
        assert [(k, i) for k, i, _ in p._evict_heap] == \
            [(k, i) for k, i, _ in j._evict_heap]
        assert (p._cow_copies, p._prefix_evictions, p._clock) == \
            (j._cow_copies, j._prefix_evictions, j._clock)
        for name in ("shared_pages", "prefix_cached_pages",
                     "available_pages", "num_free_pages", "pages_in_use"):
            self.prop(name)
        ps, js = p.stats(), j.stats()
        for key in ("pages_in_use", "pages_free", "sequences", "tokens",
                    "unique_tokens", "shared_pages", "prefix_cached_pages",
                    "utilization_pct", "token_utilization_pct"):
            assert ps[key] == js[key], (key, ps[key], js[key])

    def prefill(self, seq, tokens_or_n, seed=0):
        """Allocate `seq` and prefill it with seeded K/V rows through
        reserve + write_prefill_batch on both."""
        n = (tokens_or_n if isinstance(tokens_or_n, int)
             else len(tokens_or_n))
        rng = np.random.default_rng(seed)
        k = rng.standard_normal((1, self.port.num_layers, n, H, D)).astype(
            np.float32)
        v = rng.standard_normal(k.shape).astype(np.float32)
        self.allocate(seq)
        start = self.reserve(seq, n)
        self.port.write_prefill_batch([seq], [start], [n],
                                      torch.from_numpy(k),
                                      torch.from_numpy(v))
        if isinstance(self.jax, jkv.DeviceKVPool):
            self.jax.write_prefill_batch([seq], [start], [n], k, v)
        else:
            self.jax._write_span(seq, start, k[0], v[0])
        self.check()

    def assert_bytes_equal(self):
        for name in ("k_pool", "v_pool"):
            np.testing.assert_array_equal(
                getattr(self.port, name),
                np.asarray(getattr(self.jax, name)).astype(
                    getattr(self.port, name).dtype))
        if self.port.quantized:
            np.testing.assert_array_equal(self.port.k_scale,
                                          self.jax.k_scale)
            np.testing.assert_array_equal(self.port.v_scale,
                                          self.jax.v_scale)


def _norm(x):
    if isinstance(x, (tuple, list)):
        return tuple(_norm(e) for e in x)
    if isinstance(x, (np.integer,)):
        return int(x)
    return x


def _nodes(cache):
    return {key: (n.page, n.ident, n.children, n.last_use, n.queued,
                  n.chain, n.demand,
                  None if n.parent is None else n.parent.ident)
            for key, n in cache._nodes.items()}


def _seeded(**kw):
    """SYSTEM's 3 full pages prefilled and registered by "donor"."""
    pair = Pair(**kw)
    pair.prefill("donor", SYSTEM)
    assert pair.register_prefix("donor", SYSTEM) == 3
    return pair


def test_chain_hash_and_delta_compaction_equal_jax():
    chain_p = chain_j = 0
    for i in range(0, len(SYSTEM), PS):
        chain_p = pkv.page_chain_hash(chain_p, SYSTEM[i:i + PS])
        chain_j = jkv.page_chain_hash(chain_j, SYSTEM[i:i + PS])
        assert chain_p == chain_j
    log = [("add", 1), ("add", 2), ("drop", 1), ("add", 3), ("add", 1),
           ("drop", 2)]
    assert pkv.compact_prefix_deltas(log) == jkv.compact_prefix_deltas(log)
    assert issubclass(pgen.KVQuantMismatchError, ValueError)


def test_match_requires_full_pages_and_clips():
    pair = _seeded()
    donor = pair.page_table("donor")
    assert pair.match_prefix(SYSTEM[:3]) == ((), 0)
    assert pair.match_prefix([99] + SYSTEM[1:]) == ((), 0)
    assert pair.match_prefix(SYSTEM + [7, 7]) == (donor, 12)
    assert pair.match_prefix(SYSTEM[:8] + [99, 99, 99, 99, 5]) == \
        (donor[:2], 8)
    # the prompt IS the cached run: clipped to len - 1, the tail page
    # still aliased
    assert pair.match_prefix(SYSTEM) == (donor, 11)
    assert pair.match_prefix_full(SYSTEM) == (donor, 12)


def test_adopt_zero_copy_free_decref_and_leak_invariant():
    pair = _seeded()
    donor = pair.page_table("donor")
    pages, m = pair.match_prefix(SYSTEM + [7])
    pair.allocate("warm")
    pair.adopt_prefix("warm", pages, m)
    assert pair.page_table("warm") == donor      # the SAME pages
    assert pair.prop("shared_pages") == 3
    assert pair.adopt_prefix("warm", pages, m) == "ValueError"
    for i in range(3):
        pages, m = pair.match_prefix(SYSTEM + [7, i])
        pair.allocate(i)
        pair.adopt_prefix(i, pages, m)
        pair.reserve(i, 2)                          # a fresh page each
    pair.free("donor")
    assert pair.prop("prefix_cached_pages") == 0
    pair.free("warm")
    for i in range(3):
        pair.free(i)
    # the last decref leaves the registered run RESIDENT at refcount 0
    assert pair.prop("prefix_cached_pages") == 3
    assert pair.prop("num_free_pages") == 16 - 3
    assert pair.prop("available_pages") == 16
    assert pair.match_prefix(SYSTEM + [7])[1] == 12
    assert pair.free("warm") == "UnknownSequenceError"   # double free
    assert pair.flush_prefix_cache() == 3
    assert pair.prop("num_free_pages") == 16                # no leak


def test_double_free_keeps_the_donor_intact():
    pair = _seeded()
    pages, m = pair.match_prefix(SYSTEM + [7])
    pair.allocate("warm")
    pair.adopt_prefix("warm", pages, m)
    pair.free("warm")
    assert pair.free("warm") == "UnknownSequenceError"
    assert pair.page_table("donor") == pages
    assert pair.match_prefix(SYSTEM + [7]) == (pages, 12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_cow_on_partial_page_divergence(layout, dtype):
    """A clipped full match leaves the sequence mid-page in a SHARED
    page; the next reserve swaps in a private copy carrying the original
    rows (and an int8 page's scale rows), and a divergent write leaves
    the donor's bytes unmoved — on both pools, bitwise equal."""
    pair = _seeded(layout=layout, dtype=dtype)
    before = pair.port.k_pool.copy()
    pages, m = pair.match_prefix(SYSTEM)             # 11 of 12
    pair.allocate("warm")
    pair.adopt_prefix("warm", pages, m)
    assert pair.pages_needed("warm", 1) == 1         # the COW page
    assert pair.reserve("warm", 1) == 11
    table = pair.page_table("warm")
    assert table[:2] == pages[:2] and table[2] != pages[2]
    np.testing.assert_array_equal(pair.port.k_pool[:, table[2]],
                                  before[:, pages[2]])
    if dtype == "int8":
        np.testing.assert_array_equal(pair.port.k_scale[:, table[2]],
                                      pair.port.k_scale[:, pages[2]])
        assert np.all(pair.port.k_scale[:, table[2]] > 0)
    pair.assert_bytes_equal()
    x = np.full((1, H, D), 7.0, np.float32)
    for layer in range(L):
        pair.port.write_decode_tokens(["warm"], [11], layer,
                                      torch.from_numpy(x),
                                      torch.from_numpy(x))
        pair.jax.write_decode_tokens(["warm"], [11], layer, x, x)
    np.testing.assert_array_equal(pair.port.k_pool[:, pages[2]],
                                  before[:, pages[2]])
    pair.assert_bytes_equal()
    assert pair.take_prefix_counters() == (1, 0)


def test_missed_cow_is_a_loud_error():
    pair = _seeded()
    pages, m = pair.match_prefix(SYSTEM)
    pair.allocate("warm")
    pair.adopt_prefix("warm", pages, m)
    # the illegal state: a write into a shared page without reserve's COW
    pair.port._lens["warm"] = pair.jax._lens["warm"] = 12
    x = torch.zeros(1, H, D)
    with pytest.raises(RuntimeError, match="copy-on-write"):
        pair.port.write_decode_tokens(["warm"], [11], 0, x, x)
    with pytest.raises(RuntimeError, match="copy-on-write"):
        pair.port.write_prefill_tokens("warm", 11, 0, x, x)
    assert pair.check_span_writable("warm", 11, 1) == "RuntimeError"
    assert pair.check_span_writable("warm", 12, 1) == "IndexError"


def test_truncate_into_a_shared_run_raises():
    pair = _seeded()
    pages, m = pair.match_prefix(SYSTEM + [7])
    pair.allocate("warm")
    pair.adopt_prefix("warm", pages, m)
    pair.reserve("warm", 3)                    # a private 4th page
    assert pair.truncate("warm", 13) == 0      # within the private page
    assert pair.truncate("warm", 12) == 1      # drops the private page
    assert pair.truncate("warm", 8) == "ValueError"    # a shared page
    assert pair.truncate("warm", 10) == "ValueError"   # mid shared page
    assert pair.seq_len("warm") == 12


def test_eviction_is_lru_and_only_under_pressure():
    pair = Pair(num_pages=8)
    for seq, toks, seed in (("a", [1] * 4, 1), ("b", [2] * 4, 2)):
        pair.prefill(seq, toks, seed)
        pair.register_prefix(seq, toks)
        pair.free(seq)
    pair.match_prefix([1] * 4 + [9])          # touch A: B is the LRU run
    assert pair.prop("prefix_cached_pages") == 2
    pair.allocate("big")
    assert pair.reserve("big", 26) == 0        # 7 pages: evicts ONE run
    assert pair.take_prefix_counters() == (0, 1)
    assert pair.match_prefix([1] * 4 + [9])[1] == 4
    assert pair.match_prefix([2] * 4 + [9])[1] == 0
    assert pair.reserve("big", 8) == "OutOfPagesError"   # all-or-nothing


def test_eviction_heap_is_incremental_and_bounded():
    """A large half-warm index: a pressured reserve evicts in O(log n)
    pops from the maintained heap, never a trie scan; warm adopt/free
    churn keeps at most one heap entry per node; the heap follows the
    refcount transitions, leaf first."""
    pair = Pair(num_pages=600, page_size=1, num_layers=1, host=True)
    for i in range(16):
        toks = [i] * 32
        pair.prefill(i, toks, seed=i)
        assert pair.register_prefix(i, toks) == 32
        if i % 2:
            pair.free(i)
    assert pair.prop("prefix_cached_pages") == 256
    heap = pair.port._evict_heap
    pair.allocate("big")
    pair.reserve("big", 100)                  # free 88: evicts 12
    assert pair.prop("prefix_cached_pages") == 256 - 12
    assert pair.port._evict_heap is heap and len(heap) <= 16

    pair = _seeded()
    assert pair._evict_prefix(3) == 0          # all pinned: nothing
    pair.free("donor")
    for i in range(50):
        pages, m = pair.match_prefix(SYSTEM + [7])
        pair.allocate(i)
        pair.adopt_prefix(i, pages, m)
        if i == 25:
            assert pair._evict_prefix(3) == 0  # re-pinned
        pair.free(i)
    assert len(pair.port._evict_heap) <= 3
    assert pair._evict_prefix(1) == 1          # the deepest leaf first
    assert pair.match_prefix(SYSTEM + [7])[1] == 8
    assert pair._evict_prefix(8) == 2
    assert pair.prop("num_free_pages") == 16


def test_unique_row_stats_count_a_shared_page_once():
    pair = _seeded()
    for i in range(3):
        pages, m = pair.match_prefix(SYSTEM + [7])
        pair.allocate(i)
        pair.adopt_prefix(i, pages, m)
    s = pair.port.stats()
    assert (s["tokens"], s["unique_tokens"], s["shared_pages"]) == \
        (48, 12, 3)
    assert pair.port.token_utilization() == 1.0


def test_reset_pools_flushes_the_index():
    pair = _seeded()
    pair.free("donor")
    assert pair.match_prefix(SYSTEM + [7])[1] == 12
    pair.reset_pools()
    assert pair.match_prefix(SYSTEM + [7]) == ((), 0)
    assert pair.prop("num_free_pages") == 16
    assert not any(bool(t.any()) for t in pair.port.take_pool_state())


def test_delta_log_and_its_compaction():
    pair = Pair()
    assert pair.take_prefix_deltas() == ()          # disabled: nothing
    pair.enable_prefix_deltas()
    pair.prefill("a", SYSTEM)
    pair.register_prefix("a", SYSTEM)
    pair.free("a")
    pair.note_fleet_demand(pair.port._page_node.keys())
    pair.flush_prefix_cache()
    deltas = pair.take_prefix_deltas()
    assert [op for op, _ in deltas] == ["add"] * 3 + ["drop"] * 3
    for cache in (pair.port, pair.jax):
        cache._delta_compact_at = 4
    pair.prefill("b", SYSTEM, seed=1)
    for _ in range(2):
        pair.register_prefix("b", SYSTEM)
        pair.flush_prefix_cache()
    assert pair.port.prefix_delta_compactions == \
        pair.jax.prefix_delta_compactions > 0
    chains = {chain for _, chain in deltas}
    left = pair.take_prefix_deltas()
    # 12 transitions of 3 chains, collapsed to net ops as the log grew
    assert len(left) < 12 and {chain for _, chain in left} == chains


def test_import_prefix_run_registers_and_first_writer_wins():
    """An exported run imported into another pool's index: its pages
    register (a second import of the same chain indexes nothing and
    frees its pages), the run matches, and its bytes are the export's."""
    src = _seeded()
    payload_p = src.port.export_pages(src.port.page_table("donor"))
    payload_j = src.jax.export_pages(src.jax.page_table("donor"))
    dst = Pair()
    got = []
    for cache, payload in ((dst.port, payload_p), (dst.jax, payload_j)):
        got.append((cache.import_prefix_run(SYSTEM, *payload),
                    cache.import_prefix_run(SYSTEM, *payload)))
    assert got[0] == got[1] == (3, 0)
    dst.check()
    assert dst.match_prefix(SYSTEM + [1])[1] == 12
    again = dst.port.export_pages(dst.port.match_prefix_full(SYSTEM)[0])
    for a, b in zip(again, payload_p):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="cannot cover"):
        dst.port.import_prefix_run(SYSTEM[:4], *payload_p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_export_import_round_trip_bitwise_against_jax(layout, dtype):
    """The export payload is the JAX package's, bitwise (bfloat16 through
    a float32 view): host tensors, the pool's dtype, int8 with its scale
    rows.  Importing it into a fresh pool of either layout takes the
    same pages as the JAX import, exporting them again gives it back
    bitwise, and the pools' bytes (and int8 scales) equal the JAX
    pools'."""
    src = Pair(layout=layout, dtype=dtype)
    src.prefill("s", 9, seed=5)
    ours = src.port.export_pages(src.port.page_table("s"))
    theirs = src.jax.export_pages(src.jax.page_table("s"))
    assert len(ours) == len(theirs) == (4 if dtype == "int8" else 2)
    assert ours[0].device.type == "cpu"
    assert ours[0].dtype == src.port._k[0].dtype
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b).astype(np.float32))
    for dst_layout in ("token", "kernel"):
        dst = Pair(layout=dst_layout, dtype=dtype)
        pages = dst.port.import_pages(*ours)
        assert pages == dst.jax.import_pages(*theirs)
        dst.check()
        for a, b in zip(ours, dst.port.export_pages(pages)):
            assert torch.equal(a, b)
        dst.assert_bytes_equal()


def test_quant_mismatch_is_typed():
    """int8 pages into a float pool, float pages into an int8 pool, and
    int8 pages without their scales raise KVQuantMismatchError (a
    ValueError) on both packages, installing nothing."""
    q, f = Pair(dtype="int8"), Pair(dtype="bfloat16")
    q.prefill("s", 6, seed=1)
    f.prefill("s", 6, seed=1)
    qp = q.port.export_pages(q.port.page_table("s"))
    fp = f.port.export_pages(f.port.page_table("s"))
    qj = q.jax.export_pages(q.jax.page_table("s"))
    fj = f.jax.export_pages(f.jax.page_table("s"))
    for port_args, jax_args, cache in ((qp, qj, f), (fp, fj, q),
                                       (qp[:2], qj[:2], q)):
        with pytest.raises(pgen.KVQuantMismatchError):
            cache.port.import_pages(*port_args)
        with pytest.raises(jkv.KVQuantMismatchError):
            cache.jax.import_pages(*jax_args)
        cache.check()
    with pytest.raises(ValueError, match="does not match"):
        q.port.import_pages(qp[0][:1], qp[1], qp[2], qp[3])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("layout", ["token", "kernel"])
def test_gather_prefix_matches_jax(layout, dtype):
    """The eager chunk path's prefix read: stored rows in position order
    (dequantized for int8), equal to the JAX pool's gather."""
    pair = Pair(layout=layout, dtype=dtype)
    pair.prefill("s", 11, seed=3)
    for layer in range(L):
        for length in (1, 4, 11):
            ours = pair.port.gather_prefix("s", layer, length)
            theirs = pair.jax.gather_prefix("s", layer, length)
            for a, b in zip(ours, theirs):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(IndexError):
        pair.port.gather_prefix("s", 0, 12)
