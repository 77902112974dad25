"""Paged KV cache: a preallocated page pool with per-sequence page tables.

Instead of one contiguous [B, L_max, H, D] buffer per sequence, the
cache is one pool of fixed-size pages per layer and every sequence owns
an ordered list of page ids (its page table): position ``t`` lives at
``page_table[t // page_size]``, row ``t % page_size``.  Appending a
token touches at most one page; freeing a finished sequence returns
whole pages to the free list.

- ``PagedKVCache`` — the host bookkeeping: page tables, the LIFO free
  list, reservations, byte accounting, and the prefix cache below.
- ``DeviceKVPool`` — the same bookkeeping plus per-layer pool tensors on
  a torch device, written in place by ``scatter_pool_update`` (float
  pools) or ``quantized_kv.quantized_pool_write`` (int8 pools, which carry
  a ``[num_pages + 1, H]`` float32 scale array per layer beside each of K
  and V).

Every pool tensor holds ONE page more than the allocator hands out: page
``num_pages`` is a SINK that no page table maps.  A packed step pads its
token axis with inert slots whose scatter target is that page id, so
``scatter_pool_update`` lands them in the sink instead of filtering them
out — filtering by a boolean mask would cost a host sync per write on
the card, and an out-of-range index is an error on the CPU and a device
assert on the card.  Nothing ever reads the sink, and the prefix cache
never matches, copies or exports it.

Prefix caching (refcounted copy-on-write page sharing) lives in the
bookkeeping: full pages of prompt token ids are CHAIN-KEYED into a
prefix index (``register_prefix``), admission looks up the longest
cached page run (``match_prefix``) and aliases those physical pages into
a new sequence's page table (``adopt_prefix``), so many users of one
system prompt hold ONE physical copy and pay its prefill once.  Every
page carries a refcount; ``free`` decrefs instead of releasing, shared
pages are read-only with copy-on-write on the first divergent append
(``reserve`` swaps in a private copy before any write can land), and
refcount-0 runs stay RESIDENT as an LRU cache evicted only under pool
pressure.  Pages move between pools through ``export_pages`` /
``import_pages`` in one canonical ``[L, n, page_size, H, D]`` payload.
"""
import heapq
import math
import threading
import zlib

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.sharding_annotations import (HeadSharding, gather_heads,
                                             kv_pool_spec, kv_scale_spec,
                                             shard_list)
from .quantized_kv import dequantize_int8, quantized_pool_write


def page_chain_hash(prev_hash, page_tokens):
    """CRC chain hash of one FULL page of token ids on top of its
    parent's chain hash: the fleet-level identity of a prefix run.
    Unlike the trie key (the literal tokens, equality-exact), the chain
    hash is a compact summary safe to gossip across replicas: a
    collision can at worst route a request to a replica whose index then
    misses, since adoption re-verifies against literal tokens."""
    return zlib.crc32(np.asarray(page_tokens, np.int64).tobytes(),
                      int(prev_hash))


def compact_prefix_deltas(deltas):
    """Collapse a register/evict delta log to its NET op per chain: an
    add followed by a drop (and any longer churn) nets to the LAST op,
    which is all a consumer's index can observe.  Keeps an undrained log
    O(live chains), not O(churn)."""
    last = {}
    for op, chain in deltas:
        last[chain] = op
    return [(op, chain) for chain, op in last.items()]


class OutOfPagesError(RuntimeError):
    """The page pool is exhausted: no free page for a required append."""


class KVQuantMismatchError(ValueError):
    """A page payload crossed a quantization boundary: an int8 pool was
    handed a float payload (or a payload without its scale arrays), or
    a float pool was handed int8 pages.  Typed and loud: a pool must
    never install bytes it would mis-decode.  A ValueError, so callers
    that skip a failed adoption on ValueError stay graceful."""


class UnknownSequenceError(KeyError):
    """A cache operation named a seq_id the cache does not hold — never
    allocated, already freed, or double-freed."""

    def __init__(self, seq_id, live_count):
        super().__init__(seq_id)
        self.seq_id = seq_id
        self.live_count = live_count

    def __str__(self):
        return (f"unknown sequence {self.seq_id!r}: not allocated or "
                f"already freed ({self.live_count} live sequence(s))")


class _PrefixNode:
    """One full page of prompt tokens in the prefix index.

    Nodes form a trie over PAGES: a node is keyed by (parent node id,
    the page's token tuple), so two prompts share a chain exactly as far
    as their token streams agree page for page.  The key stores the
    literal tokens, so lookup is dict-hash fast but equality-exact.
    `page` is the physical page holding the K/V of these tokens (valid
    for any sequence whose prefix matches: causal attention makes a
    position's K/V a function of the token prefix alone).  `last_use`
    orders LRU eviction; `children` counts cached child nodes so
    eviction peels leaves first; `queued` marks a live entry in the
    evictable-leaf heap (at most one per node); `chain` is the CRC chain
    hash the delta log reports; `demand` counts observed cross-replica
    exports (`note_fleet_demand`)."""

    __slots__ = ("page", "key", "parent", "ident", "children", "last_use",
                 "queued", "chain", "demand")

    def __init__(self, page, key, parent, ident, chain=0):
        self.page = page
        self.key = key
        self.parent = parent
        self.ident = ident
        self.children = 0
        self.last_use = 0
        self.queued = False
        self.chain = chain
        self.demand = 0


class PagedKVCache:
    """Page-table bookkeeping for `num_layers` attention layers, with the
    prefix cache.  It holds no K/V storage: `DeviceKVPool` adds the pools
    and overrides the storage hooks (`_copy_page_storage`,
    `_install_pages`, `_reset_page_scale`)."""

    pool_layout = "token"

    # recency-clock ticks one unit of observed cross-replica demand is
    # worth in the eviction order (note_fleet_demand); 0 disables it
    fleet_demand_boost = 256

    def __init__(self, num_layers, num_heads, head_dim, num_pages=256,
                 page_size=16, dtype=torch.float32):
        if num_pages < 1 or page_size < 1:
            raise ValueError("num_pages and page_size must be >= 1")
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.dtype = dtype
        # int8 storage: the pools carry per-page per-head scales, every
        # write quantizes and every read dequantizes (quantized_kv.py)
        self.quantized = dtype == torch.int8
        self._scale_bytes = 0  # scale traffic (a subset of _bytes_moved)
        # LIFO free list: a just-freed (cache-warm) page is reused first
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._tables = {}    # seq_id -> [page ids]
        self._lens = {}      # seq_id -> token count
        self._bytes_moved = 0
        # ---- prefix cache state (dormant until register_prefix) ----
        self._refs = {}       # page -> live refcount (0: resident only as
        #                       a cached prefix run)
        self._nodes = {}      # (parent ident, token tuple) -> _PrefixNode
        self._page_node = {}  # page -> its _PrefixNode (indexed pages)
        self._next_node_id = 1   # 0 is the trie root
        self._clock = 0          # LRU recency counter
        self._cow_copies = 0         # drained by take_prefix_counters
        self._prefix_evictions = 0   # drained by take_prefix_counters
        # maintained at every refcount transition, so the per-step gauges
        # and capacity checks stay O(1)
        self._n_shared = 0   # pages with refcount > 1
        self._n_cached = 0   # refcount-0 registered residents
        # register/evict delta log (None: disabled until a consumer
        # enables it), under its own lock so a drain never waits behind
        # a step
        self._prefix_deltas = None
        self._delta_lock = threading.Lock()
        self._delta_compact_at = 4096
        self.prefix_delta_compactions = 0
        self._import_seq = 0   # temp seq ids for import_prefix_run
        # min-heap of evictable LEAF nodes, (key at push, ident, node):
        # pushed at the transitions that make a node evictable, validated
        # lazily at pop
        self._evict_heap = []

    def _table(self, seq_id):
        try:
            return self._tables[seq_id]
        except KeyError:
            raise UnknownSequenceError(seq_id, len(self._tables)) from None

    # ------------------------- allocation ---------------------------
    def allocate(self, seq_id):
        """Register an empty sequence (no pages until tokens land)."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        self._tables[seq_id] = []
        self._lens[seq_id] = 0

    def free(self, seq_id):
        """Release `seq_id`'s hold on its pages: a DECREF per page.  A
        page aliased by other sequences stays theirs, and a page in the
        prefix index stays RESIDENT at refcount 0 (an evictable cached
        run); exclusive unindexed pages return to the free list.  A
        double free raises UnknownSequenceError."""
        pages = self._table(seq_id)
        del self._tables[seq_id]
        del self._lens[seq_id]
        for page in reversed(pages):   # reversed: LIFO warm reuse
            self._decref(page)

    def has(self, seq_id):
        return seq_id in self._tables

    def _take_page(self):
        if not self._free:
            raise OutOfPagesError(
                f"page pool exhausted ({self.num_pages} pages of "
                f"{self.page_size} tokens all in use)")
        return self._free.pop()

    def pages_needed(self, seq_id, new_tokens):
        """Pages an append of `new_tokens` to `seq_id` would allocate,
        the copy-on-write page included when the append's first token
        lands mid-page in a SHARED page."""
        table = self._table(seq_id)
        need = (math.ceil((self._lens[seq_id] + new_tokens) / self.page_size)
                - len(table))
        if new_tokens > 0 and self._cow_page_index(seq_id) is not None:
            need += 1
        return need

    def reserve(self, seq_id, new_tokens=1):
        """Grow `seq_id`'s page table to hold `new_tokens` more tokens and
        advance its length; returns the first new position.  All-or-
        nothing: on OutOfPagesError nothing is allocated or advanced.
        Under pool pressure refcount-0 cached prefix runs are EVICTED
        (LRU) before the error is raised.  If the append starts mid-page
        in a shared page, that page is first replaced by a private copy
        (copy-on-write), so the coming write never touches storage
        another sequence or the prefix index still reads."""
        need = self.pages_needed(seq_id, new_tokens)
        if need > len(self._free):
            self._evict_prefix(need - len(self._free))
        if need > len(self._free):
            raise OutOfPagesError(
                f"need {need} pages for {new_tokens} tokens of "
                f"{seq_id!r}, only {len(self._free)} free")
        table = self._tables[seq_id]
        if new_tokens > 0:
            self._cow_if_shared(seq_id)
        while len(table) < math.ceil(
                (self._lens[seq_id] + new_tokens) / self.page_size):
            table.append(self._take_owned_page())
        start = self._lens[seq_id]
        self._lens[seq_id] = start + new_tokens
        return start

    def truncate(self, seq_id, new_len):
        """REWIND `seq_id` to exactly `new_len` resident tokens — the
        speculative step's rejection primitive (rejected drafts, and the
        decode loop's reserved-but-unwritten tail, leave the cache here).
        Whole tail pages past the new length are released (a decref) in
        LIFO order; no device work is needed.  Rows of the retained tail
        page past `new_len` go stale: attention masks them and the next
        reservation of their positions overwrites them.

        Typed and all-or-nothing: UnknownSequenceError for a seq_id the
        cache does not hold; ValueError for growth (``new_len >
        seq_len``: growing goes through reserve) or a negative length;
        ValueError when the rewind would touch a shared prefix run (a
        dropped page other sequences or the prefix index alias, or a
        clip landing mid-page in a shared page: this sequence's next
        write would then land in bytes other readers alias).

        int8 pools: a dropped page's scale rows are reset (queued like a
        reserve's, applied before the scales are next read or written);
        the retained tail page keeps its grid, an abs-max over a superset
        of its live rows, which decodes them as before.

        Returns the number of pages freed."""
        table = self._table(seq_id)
        new_len = int(new_len)
        cur = self._lens[seq_id]
        if new_len < 0 or new_len > cur:
            raise ValueError(
                f"truncate({seq_id!r}) to {new_len} tokens, but {cur} are "
                f"resident — truncate only rewinds (growth goes through "
                f"reserve)")
        if new_len == cur:
            return 0
        keep = math.ceil(new_len / self.page_size)
        dropped = table[keep:]
        for page in dropped:
            if self._page_shared(page):
                raise ValueError(
                    f"truncate({seq_id!r}) to {new_len} would release "
                    f"shared page {page} (aliased or prefix-indexed) — "
                    f"rewinding into an adopted/shared prefix run is "
                    f"not supported")
        if new_len % self.page_size and self._page_shared(table[keep - 1]):
            raise ValueError(
                f"truncate({seq_id!r}) to {new_len} lands mid-page in "
                f"shared page {table[keep - 1]} — rewinding into an "
                f"adopted/shared prefix run is not supported")
        del table[keep:]
        self._lens[seq_id] = new_len
        for page in reversed(dropped):   # reversed: LIFO warm reuse
            self._decref(page)
            if self.quantized:
                self._reset_page_scale(page)
        return len(dropped)

    # ------------------------ prefix caching ------------------------
    def _tick(self):
        self._clock += 1
        return self._clock

    def _page_shared(self, page):
        """A page a sequence must NOT write through: aliased by more than
        one page table, or pinned read-only by the prefix index."""
        return self._refs.get(page, 0) > 1 or page in self._page_node

    def _take_owned_page(self):
        page = self._take_page()
        self._refs[page] = 1
        if self.quantized:
            self._reset_page_scale(page)
        return page

    def _incref(self, page):
        """Pin one more alias on `page` (adoption): a cached resident
        leaves the evictable set, a second alias makes it shared."""
        old = self._refs.get(page, 0)
        if old == 0:
            self._n_cached -= 1
        self._refs[page] = old + 1
        if old == 1:
            self._n_shared += 1

    def _decref(self, page):
        n = self._refs.get(page, 1) - 1
        if n == 1:
            self._n_shared -= 1
        if n > 0:
            self._refs[page] = n
            return
        node = self._page_node.get(page)
        if node is not None:
            # last live reference gone but the run is cached: resident at
            # refcount 0, evictable under pool pressure
            self._refs[page] = 0
            self._n_cached += 1
            node.last_use = self._tick()
            if node.children == 0:
                # an evictable LEAF now; interior nodes queue when
                # _drop_node peels their last child
                self._push_evictable(node)
        else:
            self._refs.pop(page, None)
            self._free.append(page)

    def _cow_page_index(self, seq_id):
        """Index into `seq_id`'s table of the page a next append would
        write MID-PAGE while it is shared — the page `reserve` must copy
        on write — or None.  Only the tail page can qualify."""
        length = self._lens[seq_id]
        if length % self.page_size == 0:
            return None
        idx = length // self.page_size
        table = self._tables[seq_id]
        if idx >= len(table) or not self._page_shared(table[idx]):
            return None
        return idx

    def _cow_if_shared(self, seq_id):
        """Swap the shared tail page for a private copy before a write
        can land in it (the caller checked capacity via pages_needed).
        The old page is decref'd: other aliases and the prefix index keep
        reading the ORIGINAL bytes."""
        idx = self._cow_page_index(seq_id)
        if idx is None:
            return
        table = self._tables[seq_id]
        old = table[idx]
        new = self._take_owned_page()
        self._copy_page_storage(old, new)
        table[idx] = new
        self._decref(old)
        self._cow_copies += 1

    def _copy_page_storage(self, src, dst):
        """Copy one physical page's K/V (and an int8 pool's scale rows)
        across every layer.  Bookkeeping alone holds no storage;
        DeviceKVPool copies."""

    def match_prefix(self, tokens):
        """Longest cached page run matching a strict prefix of `tokens`:
        ``(pages, matched_tokens)`` ready for `adopt_prefix`.  Walks the
        trie one FULL page at a time; `matched_tokens` is clipped to
        ``len(tokens) - 1``, since at least one token must remain for the
        suffix prefill whose last-position logits are the first-token
        logits.  When the clip cuts into the final matched page, that
        page is still aliased (its rows up to the clip are valid) and the
        suffix's first write copies it on write.  Touches each matched
        node's recency."""
        pages, _ = self.match_prefix_full(tokens)
        matched = min(len(pages) * self.page_size, len(tokens) - 1)
        if matched <= 0:
            return (), 0
        return pages[:math.ceil(matched / self.page_size)], matched

    def adopt_prefix(self, seq_id, pages, matched_tokens):
        """Alias a matched page run into a freshly allocated sequence: the
        pages join `seq_id`'s table with their refcounts bumped (zero
        bytes move) and its length starts at `matched_tokens`.  Must run
        in the scheduling step of the `match_prefix` that found `pages`
        (the incref is what pins them against eviction)."""
        table = self._table(seq_id)
        if table or self._lens[seq_id]:
            raise ValueError(
                f"adopt_prefix on non-empty sequence {seq_id!r} "
                f"(len={self._lens[seq_id]})")
        if not (len(pages) - 1) * self.page_size < int(matched_tokens) \
                <= len(pages) * self.page_size:
            raise ValueError(
                f"matched_tokens={matched_tokens} does not land in the "
                f"last of {len(pages)} pages of {self.page_size}")
        for page in pages:
            self._incref(page)
        table.extend(int(p) for p in pages)
        self._lens[seq_id] = int(matched_tokens)

    # -------------------- page export / import ----------------------
    # Page BYTES move between pools in ONE canonical payload, [L, n,
    # page_size, H, D] in the pool dtype (int8 pools add their [L, n, H]
    # scale rows), whatever the storage layout: the importer re-scatters
    # into its own layout.

    def match_prefix_full(self, tokens):
        """Longest cached run of FULL pages matching a prefix of `tokens`,
        unclipped (an exported run is re-registered on the importer, and
        the index holds only full pages).  Touches recency.  Returns
        ``(pages, matched_tokens)``."""
        ps = self.page_size
        pages = []
        parent_ident = 0
        i = 0
        while (i + 1) * ps <= len(tokens):
            key = (parent_ident,
                   tuple(int(t) for t in tokens[i * ps:(i + 1) * ps]))
            node = self._nodes.get(key)
            if node is None:
                break
            node.last_use = self._tick()
            pages.append(node.page)
            parent_ident = node.ident
            i += 1
        return tuple(pages), len(pages) * ps

    def _check_import_payload(self, k, v, k_scale, v_scale):
        want = (self.num_layers, k.shape[1], self.page_size,
                self.num_heads, self.head_dim)
        if tuple(k.shape) != want or tuple(v.shape) != want:
            raise ValueError(
                f"import payload shape {tuple(k.shape)}/{tuple(v.shape)} "
                f"does not match this pool's [L, n, page_size, H, D] = "
                f"{want} — pages only move between layout-compatible "
                f"pools")
        payload_q = k.dtype == torch.int8
        if payload_q != self.quantized:
            raise KVQuantMismatchError(
                f"page payload dtype {k.dtype} does not match this pool's "
                f"kv_dtype {self.dtype}: quantized and float pools cannot "
                f"trade pages")
        if self.quantized and (k_scale is None or v_scale is None):
            raise KVQuantMismatchError(
                "int8 page payload arrived without its scale arrays — "
                "refusing to install bytes with no grid")
        if self.quantized:
            swant = (self.num_layers, k.shape[1], self.num_heads)
            if tuple(k_scale.shape) != swant \
                    or tuple(v_scale.shape) != swant:
                raise KVQuantMismatchError(
                    f"scale payload shape {tuple(k_scale.shape)}/"
                    f"{tuple(v_scale.shape)} does not match [L, n, H] = "
                    f"{swant}")

    def import_pages(self, k, v, k_scale=None, v_scale=None):
        """Allocate fresh pages and install a canonical ``[L, n,
        page_size, H, D]`` payload (tensors or numpy arrays) into them;
        returns the new page ids (refcount 1 each, owned by the caller:
        hand them to adopt_imported, or register and free them).  Evicts
        cached runs (LRU) under pool pressure before raising
        OutOfPagesError, as reserve does.  int8 pools require the ``[L,
        n, H]`` scale payloads (KVQuantMismatchError otherwise)."""
        k, v = _payload(k), _payload(v)
        k_scale, v_scale = _payload(k_scale), _payload(v_scale)
        n = int(k.shape[1]) if k.dim() >= 2 else 0
        if n == 0:
            return []
        self._check_import_payload(k, v, k_scale, v_scale)
        if n > len(self._free):
            self._evict_prefix(n - len(self._free))
        if n > len(self._free):
            raise OutOfPagesError(
                f"cannot import {n} pages: only {len(self._free)} free "
                f"even after evicting cached prefix runs")
        pages = [self._take_owned_page() for _ in range(n)]
        self._install_pages(pages, k, v, k_scale, v_scale)
        self._bytes_moved += _nbytes(k) + _nbytes(v)
        self._count_scale_payload(n, self.num_layers)
        return pages

    def _install_pages(self, pages, k, v, k_scale=None, v_scale=None):
        """Write a canonical import payload into freshly owned pages (an
        int8 payload's scale rows overwrite the pages' scales).
        Bookkeeping alone holds no storage; DeviceKVPool writes."""

    def adopt_imported(self, seq_id, pages, length):
        """Install freshly imported pages as `seq_id`'s table with
        `length` tokens resident: the sequence was just allocated empty
        and the pages came from import_pages (refcount 1 each)."""
        table = self._table(seq_id)
        if table or self._lens[seq_id]:
            raise ValueError(
                f"adopt_imported on non-empty sequence {seq_id!r} "
                f"(len={self._lens[seq_id]})")
        length = int(length)
        if not (len(pages) - 1) * self.page_size < length \
                <= len(pages) * self.page_size:
            raise ValueError(
                f"length={length} does not land in the last of "
                f"{len(pages)} pages of {self.page_size}")
        table.extend(int(p) for p in pages)
        self._lens[seq_id] = length

    def import_prefix_run(self, tokens, k, v, k_scale=None, v_scale=None):
        """Adopt an exported prefix run into THIS pool and prefix index:
        install the bytes (import_pages), register the chain under a
        throwaway sequence and free it, so registered pages stay resident
        at refcount 0 like a locally prefilled run, and pages whose chain
        the index already held go back to the free list (first writer
        wins).  `tokens` must cover every imported page.  Returns the
        pages newly indexed; OutOfPagesError when the pool cannot hold
        the run even after eviction."""
        k, v = _payload(k), _payload(v)
        n = int(k.shape[1]) if k.dim() >= 2 else 0
        if n == 0:
            return 0
        covered = n * self.page_size
        if len(tokens) < covered:
            raise ValueError(
                f"{len(tokens)} tokens cannot cover {n} imported pages "
                f"of {self.page_size}")
        pages = self.import_pages(k, v, k_scale, v_scale)
        sid = ("__prefix_import__", self._import_seq)
        self._import_seq += 1
        self.allocate(sid)
        self.adopt_imported(sid, pages, covered)
        added = self.register_prefix(sid, tokens[:covered])
        # decref: indexed pages stay cached residents, duplicate-chain
        # pages go straight back to the free list
        self.free(sid)
        return added

    def register_prefix(self, seq_id, tokens):
        """Index `seq_id`'s fully written pages for future matches: every
        FULL page of `tokens` (clipped to the cache length) becomes a trie
        node mapping its chain key to the physical page.  Pages whose
        chain key is already indexed are skipped (the first writer wins;
        a later identical prefill keeps its private pages).  Indexed pages
        are read-only from here on.  Returns the number of NEW pages
        indexed."""
        table = self._table(seq_id)
        ps = self.page_size
        n_full = min(len(tokens), self._lens[seq_id]) // ps
        parent, parent_ident = None, 0
        added = 0
        chain = 0
        for i in range(n_full):
            page_tokens = tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
            key = (parent_ident, page_tokens)
            chain = page_chain_hash(chain, page_tokens)
            node = self._nodes.get(key)
            if node is None:
                page = table[i]
                if page in self._page_node:
                    # indexed under another chain: impossible by
                    # construction, but never double-index a page
                    break
                node = _PrefixNode(page, key, parent, self._next_node_id,
                                   chain=chain)
                self._next_node_id += 1
                self._nodes[key] = node
                self._page_node[page] = node
                if parent is not None:
                    parent.children += 1
                added += 1
                self._log_prefix_delta("add", node)
            node.last_use = self._tick()
            parent, parent_ident = node, node.ident
        return added

    def _log_prefix_delta(self, op, node):
        """Record one register/evict transition (no-op until enabled)."""
        if self._prefix_deltas is not None:
            with self._delta_lock:
                self._prefix_deltas.append((op, node.chain))
                if len(self._prefix_deltas) > self._delta_compact_at:
                    self._prefix_deltas = compact_prefix_deltas(
                        self._prefix_deltas)
                    self.prefix_delta_compactions += 1

    def enable_prefix_deltas(self):
        """Start recording register/evict deltas (idempotent)."""
        if self._prefix_deltas is None:
            self._prefix_deltas = []

    def take_prefix_deltas(self):
        """Drain ``[("add"|"drop", chain_hash), ...]`` since the last
        take."""
        if not self._prefix_deltas:
            return []
        with self._delta_lock:
            out, self._prefix_deltas = self._prefix_deltas, []
        return out

    def note_fleet_demand(self, pages):
        """Fold observed cross-replica demand (an export of a warm run)
        into the eviction order: each exported node's demand grows by
        one, so a run other pools keep adopting outlives a locally cold
        one.  Heap entries are corrected lazily at pop."""
        if not self.fleet_demand_boost:
            return
        for page in pages:
            node = self._page_node.get(page)
            if node is not None:
                node.demand += 1

    def _evict_key(self, node):
        """Eviction priority: LRU recency plus the demand fold (each
        observed adoption is worth fleet_demand_boost ticks)."""
        return node.last_use + node.demand * self.fleet_demand_boost

    def _push_evictable(self, node):
        """Queue an evictable leaf at its current key; `queued` keeps at
        most ONE live heap entry per node, so adopt/free churn cannot
        grow the heap past the trie."""
        if node.queued:
            return
        node.queued = True
        heapq.heappush(self._evict_heap,
                       (self._evict_key(node), node.ident, node))

    def _evict_prefix(self, n_pages):
        """Evict up to `n_pages` refcount-0 cached pages to the free
        list, least recently used LEAF nodes first (a refcount-0 node's
        descendants are refcount-0 too, so peeling leaves always makes
        progress).  The heap is maintained at the refcount and trie
        transitions, so a K-page round is O(K log n) pops, never a trie
        scan.  Stale entries (evicted, re-adopted, grown a child) are
        dropped at pop; a node touched since its push is re-queued at its
        current key.  Returns the pages freed."""
        if self._n_cached == 0:
            return 0
        heap = self._evict_heap
        freed = 0
        while freed < n_pages and heap:
            key, _, node = heapq.heappop(heap)
            node.queued = False
            if self._nodes.get(node.key) is not node or node.children \
                    or self._refs.get(node.page, 1) != 0:
                continue
            if key != self._evict_key(node):
                self._push_evictable(node)
                continue
            self._drop_node(node)
            freed += 1
        return freed

    def _drop_node(self, node):
        del self._nodes[node.key]
        del self._page_node[node.page]
        self._log_prefix_delta("drop", node)
        parent = node.parent
        if parent is not None:
            parent.children -= 1
            if parent.children == 0 \
                    and self._refs.get(parent.page, 1) == 0:
                self._push_evictable(parent)   # a leaf in turn
        del self._refs[node.page]     # refcount 0 (eviction precondition)
        self._n_cached -= 1
        self._free.append(node.page)
        self._prefix_evictions += 1

    def flush_prefix_cache(self):
        """Drop the whole prefix index: refcount-0 pages return to the
        free list; pages still aliased by live sequences are merely
        unindexed (they free on their last decref).  Returns the pages
        freed.  Flush frees are not evictions (that counter means pool
        pressure)."""
        freed = 0
        for node in list(self._nodes.values()):
            self._log_prefix_delta("drop", node)
            if self._refs.get(node.page, 1) == 0:
                del self._refs[node.page]
                self._n_cached -= 1
                self._free.append(node.page)
                freed += 1
        self._nodes.clear()
        self._page_node.clear()
        self._evict_heap = []
        return freed

    def take_prefix_counters(self):
        """(cow_copies, prefix_evictions) since the last take."""
        out = (self._cow_copies, self._prefix_evictions)
        self._cow_copies = 0
        self._prefix_evictions = 0
        return out

    @property
    def shared_pages(self):
        """Physical pages aliased by MORE than one page table (O(1))."""
        return self._n_shared

    @property
    def prefix_cached_pages(self):
        """Resident refcount-0 pages held only by the prefix index."""
        return self._n_cached

    @property
    def available_pages(self):
        """Free pages plus evictable cached pages: what admission and
        preemption compare against (a cached run is never a reason to
        preempt a live sequence)."""
        return len(self._free) + self._n_cached

    def evictable_pages_in(self, pages):
        """How many of `pages` are refcount-0 cached residents now: pages
        an adoption would pin, taking them out of available_pages."""
        return sum(1 for p in pages if self._refs.get(p, 1) == 0)

    # ------------------------- write targets -------------------------
    def _locate(self, seq_id, pos):
        """(page, row) of an already-reserved position, for a WRITE; a
        shared page there means copy-on-write was missed, and raises."""
        table = self._table(seq_id)
        if pos >= self._lens[seq_id]:
            raise IndexError(f"position {pos} not reserved for {seq_id!r} "
                             f"(len={self._lens[seq_id]})")
        page = table[pos // self.page_size]
        if self._page_shared(page):
            raise RuntimeError(
                f"write at position {pos} of {seq_id!r} targets shared "
                f"page {page} — copy-on-write was missed")
        return page, pos % self.page_size

    def _check_span(self, seq_id, start, n):
        """[start, start + n) must be reserved (reads may span shared
        pages; writes go through _check_span_writable)."""
        self._table(seq_id)
        if int(start) + n > self._lens[seq_id]:
            raise IndexError(
                f"span [{start}, {start + n}) not reserved for {seq_id!r} "
                f"(len={self._lens[seq_id]})")

    def _check_span_writable(self, seq_id, start, n):
        """Reserved AND writable: no page under the span may be shared —
        reserve's copy-on-write must have privatized the tail page."""
        self._check_span(seq_id, start, n)
        if n <= 0:
            return
        table = self._tables[seq_id]
        for idx in range(int(start) // self.page_size,
                         (int(start) + n - 1) // self.page_size + 1):
            if idx < len(table) and self._page_shared(table[idx]):
                raise RuntimeError(
                    f"write span [{start}, {start + n}) of {seq_id!r} "
                    f"overlaps shared page {table[idx]} — copy-on-write "
                    f"was missed")

    def check_span_writable(self, seq_id, start, n):
        """Pre-dispatch guard of the in-step writers (the packed, fused
        and chunk steps): positions [start, start+n) must be reserved
        (IndexError) and privately owned (RuntimeError)."""
        self._check_span_writable(seq_id, int(start), int(n))

    def _span_pages_rows(self, seq_id, start, n, pad_to=None):
        """(pages, rows) int32 for positions [start, start+n), padded to
        `pad_to` entries with the padding sentinel ``num_pages``."""
        table = self._table(seq_id)
        pad_to = n if pad_to is None else pad_to
        pages = np.full((pad_to,), self.num_pages, np.int32)
        rows = np.zeros((pad_to,), np.int32)
        pos = start + np.arange(n)
        pages[:n] = np.asarray(table, np.int32)[pos // self.page_size]
        rows[:n] = pos % self.page_size
        return pages, rows

    def _reset_page_scale(self, page):
        """A just-allocated page's scales go back to zero, so a reused
        page quantizes exactly like a fresh one.  Bookkeeping alone holds
        no scales; DeviceKVPool does."""

    # --------------------------- accounting --------------------------
    def _count_write_payload(self, tokens, layers):
        """K+V bytes a write of `tokens` tokens over `layers` layers
        moves."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        self._bytes_moved += (2 * tokens * layers * self.num_heads
                              * self.head_dim * itemsize)

    def _count_scale_payload(self, n_pages, layers):
        """Scale bytes a quantized write (or transfer) moves beside the
        int8 payload: folded into the bytes moved, and kept apart for
        ``generation.kv_scale_bytes``."""
        if not self.quantized or not n_pages:
            return
        b = int(2 * layers * n_pages * self.num_heads * 4)
        self._bytes_moved += b
        self._scale_bytes += b

    def count_fused_append(self, tokens):
        """Account an in-step write of `tokens` new tokens across every
        layer (the scatter runs inside the step; its O(tokens) payload is
        counted so ``generation.kv_bytes_moved`` keeps its meaning).
        Quantized pools count one page's scale row per written token too,
        as the JAX package does."""
        self._count_scale_payload(int(tokens), self.num_layers)
        self._count_write_payload(int(tokens), self.num_layers)

    def take_bytes_moved(self):
        """KV bytes accumulated since the last take."""
        n, self._bytes_moved = self._bytes_moved, 0
        return n

    def take_scale_bytes(self):
        """Scale bytes accumulated since the last take (already part of
        take_bytes_moved's total)."""
        n, self._scale_bytes = self._scale_bytes, 0
        return n

    def seq_len(self, seq_id):
        self._table(seq_id)
        return self._lens[seq_id]

    def page_table(self, seq_id):
        return tuple(self._table(seq_id))

    def gather_block_tables(self, seq_ids, max_pages=None):
        """``(page_tables [B, max_pages] int32, seq_lens [B] int32)`` for
        `seq_ids`; unused slots are padded with page id 0 (a valid page
        whose keys the length mask hides)."""
        tables = [self._table(s) for s in seq_ids]
        if max_pages is None:
            max_pages = max((len(t) for t in tables), default=1) or 1
        pt = np.zeros((len(seq_ids), max_pages), np.int32)
        for i, t in enumerate(tables):
            if len(t) > max_pages:
                raise ValueError(
                    f"sequence {seq_ids[i]!r} spans {len(t)} pages > "
                    f"max_pages={max_pages}")
            pt[i, :len(t)] = t
        lens = np.asarray([self._lens[s] for s in seq_ids], np.int32)
        return pt, lens

    # --------------------------- stats ------------------------------
    @property
    def num_free_pages(self):
        return len(self._free)

    @property
    def pages_in_use(self):
        return self.num_pages - len(self._free)

    def utilization(self):
        """Fraction of the pool PINNED by live sequences: refcount-0
        cached prefix residents are excluded (admission counts them
        available); `pages_in_use` stays the physical occupancy."""
        return ((self.pages_in_use - self._n_cached) / self.num_pages)

    def unique_tokens(self):
        """Token rows held across DISTINCT physical pages: each page
        contributes its deepest written row count once (a shared page is
        not counted once per alias), and a refcount-0 cached page its
        full page."""
        rows = {}
        for seq_id, table in self._tables.items():
            length = self._lens[seq_id]
            for i, page in enumerate(table):
                used = min(self.page_size, length - i * self.page_size)
                if used > 0:
                    rows[page] = max(rows.get(page, 0), used)
        for page, refs in self._refs.items():
            if refs == 0:
                rows.setdefault(page, self.page_size)
        return int(sum(rows.values()))

    def token_utilization(self):
        """Fraction of allocated page rows holding tokens, counting
        physically unique rows (never above 1 under sharing)."""
        used = self.pages_in_use * self.page_size
        if not used:
            return 0.0
        return self.unique_tokens() / used

    def stats(self):
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "kv_dtype": str(self.dtype).replace("torch.", ""),
            "pages_in_use": self.pages_in_use,
            "pages_free": self.num_free_pages,
            "sequences": len(self._tables),
            # logical tokens (a shared page counts once per alias)
            # against the physically unique rows
            "tokens": int(sum(self._lens.values())),
            "unique_tokens": self.unique_tokens(),
            "shared_pages": self.shared_pages,
            "prefix_cached_pages": self.prefix_cached_pages,
            "utilization_pct": round(100.0 * self.utilization(), 1),
            "token_utilization_pct":
                round(100.0 * self.token_utilization(), 1),
        }


def _payload(x):
    """A page payload (a tensor or a numpy array; None passes) as a
    tensor."""
    if x is None or isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _nbytes(t):
    return t.numel() * t.element_size()


def scatter_pool_update(pool, pages, rows, x, layout):
    """Write token payload `x` into ``(pages[i], rows[i])`` of one pool,
    IN PLACE, layout-aware, and return the pool.

    The pool's last page is the sink (see the module docstring): page ids
    at or past it — the padding sentinel ``num_pages`` — are clamped onto
    it, so inert slots never reach a page a table maps and the write
    needs no host sync.

    token layout:  pool [P + 1, page_size, H, D], x [n, H, D]
    kernel layout: pool [H, P + 1, page_size, D], x [n, H, D]
    """
    sink = pool.shape[1 if layout == "kernel" else 0] - 1
    pages = torch.clamp(pages.long(), max=sink)
    rows = rows.long()
    x = x.to(pool.dtype)
    if layout == "kernel":
        pool[:, pages, rows] = x.transpose(0, 1)
    else:
        pool[pages, rows] = x
    return pool


def _whole(parts, sharded):
    """The entry a pool-state slot holds: the shard list under a mesh,
    else the one tensor."""
    return parts if sharded else parts[0]


class DeviceKVPool(PagedKVCache):
    """PagedKVCache whose pools are tensors on `device` (None: "cuda",
    which raises without a card).

    pool_layout picks the storage layout of each per-layer pool:

    - ``"token"`` (default): ``[num_pages + 1, page_size, H, D]``;
    - ``"kernel"``: ``[H, num_pages + 1, page_size, D]``.

    dtype is float32, bfloat16 or int8.  An int8 pool also holds, per
    layer, a ``[num_pages + 1, H]`` float32 scale array for K and one for
    V (`layer_scales`); a page's scale rows go back to zero when the page
    is handed out again (queued at reserve, zeroed before the next read or
    write of the scales).

    mesh / tp_axis (``parallel.tp_mesh``): tensor-parallel head sharding.
    Each layer's pools and int8 scales are then lists of `tp_degree` head
    shards, shard ``i`` on ``mesh.devices[i]`` with ``num_heads / tp``
    heads of every page, so a shard's bytes are 1/tp of the whole pool's
    (`bytes_per_shard`); `layer_pools` / `layer_scales` and the pool state
    hand out the lists.  The page axis is never split: every write, scale
    reset, copy-on-write page copy and truncate runs per shard with no
    collective, and `export_pages` gathers the heads into the canonical
    payload that `import_pages` splits again, so a page moves between
    sharded and unsharded pools byte for byte.  `device` defaults to the
    mesh's first device, the home of host-fed inputs, and must be it.

    The ragged and fused steps write the pools in place
    (`scatter_pool_update`, or `quantized_pool_write` for int8) and read
    them through `layer_pools` / `layer_scales`; the legacy step's eager
    decode and one-shot prefill write through `write_decode_tokens` /
    `write_prefill_batch`, which land padding in the sink page too, and
    the eager chunk path (a warm one-shot suffix) through
    `write_prefill_tokens`.  The prefix cache's device work — the
    copy-on-write page copy, `export_pages` and the import — writes the
    live pools in place, so their addresses never change.
    ``k_pool`` / ``v_pool`` (and for int8 ``k_scale`` / ``v_scale``) are
    host copies in the canonical token layout without the sink page
    (debug and tests only).
    """

    def __init__(self, num_layers, num_heads, head_dim, num_pages=256,
                 page_size=16, dtype=torch.float32, pool_layout="token",
                 device=None, mesh=None, tp_axis=None):
        if pool_layout not in ("token", "kernel"):
            raise ValueError(
                f"pool_layout must be 'token' or 'kernel', got "
                f"{pool_layout!r}")
        if dtype not in (torch.float32, torch.bfloat16, torch.int8):
            raise NotImplementedError(
                f"kv dtype {dtype} is not supported (float32, bfloat16 "
                f"and int8 pools)")
        super().__init__(num_layers, num_heads, head_dim,
                         num_pages=num_pages, page_size=page_size,
                         dtype=dtype)
        self.pool_layout = pool_layout
        self.mesh = mesh
        self.tp_axis = None
        self.tp_degree = 1
        if mesh is not None:
            tp_axis = mesh.tp_axis(tp_axis)
            tp = int(mesh.shape[tp_axis])
            if self.num_heads % tp:
                raise ValueError(
                    f"num_heads={self.num_heads} is not divisible by "
                    f"tp_degree={tp}: the pools shard the head axis")
            self.tp_axis, self.tp_degree = tp_axis, tp
            if device is None:
                device = mesh.devices[0]
        self.device = resolve_device(device, "DeviceKVPool")
        if mesh is not None and self.device != mesh.devices[0]:
            raise ValueError(f"device {self.device} is not the mesh's first "
                             f"device {mesh.devices[0]}")
        self._devices = (list(mesh.devices) if mesh is not None
                         else [self.device])
        self._heads = self.num_heads // self.tp_degree
        # one shard's pool and scale shapes: the heads on the axes that
        # kv_pool_spec / kv_scale_spec name
        self._shape = [self.num_pages + 1, self.page_size, self.head_dim]
        self._shape.insert(kv_pool_spec(pool_layout), self._heads)
        self._scale_shape = [self.num_pages + 1]
        self._scale_shape.insert(kv_scale_spec(), self._heads)
        self._materialize_pools()

    # --------------------------- sharding ----------------------------
    @property
    def pool_sharding(self):
        """The pools' `HeadSharding` (head axis, shard devices); None
        unsharded."""
        if self.mesh is None:
            return None
        return HeadSharding(kv_pool_spec(self.pool_layout),
                            tuple(self._devices))

    @property
    def scale_sharding(self):
        """The int8 scale arrays' `HeadSharding`; None unsharded."""
        if self.mesh is None:
            return None
        return HeadSharding(kv_scale_spec(), tuple(self._devices))

    def _upload(self, a):
        """Host array `a` as a per-shard list of tensors, one upload per
        distinct device."""
        made = {}
        for d in self._devices:
            if d not in made:
                made[d] = torch.as_tensor(a, device=d)
        return [made[d] for d in self._devices]

    def _head_part(self, x, i, axis=-2):
        """Shard `i`'s heads of payload `x` (heads on `axis`), on shard
        `i`'s device; a list is already per shard."""
        if isinstance(x, list):
            return x[i]
        if self.mesh is not None:
            x = x.narrow(axis, i * self._heads, self._heads)
        return x.to(self._devices[i])

    def bytes_per_shard(self):
        """Device bytes each head shard holds: every layer's K and V pool
        shard plus, for int8, its scale shards."""
        groups = [self._k, self._v]
        if self.quantized:
            groups += [self._ks, self._vs]
        out = [0] * self.tp_degree
        for group in groups:
            for entry in group:
                for i, t in enumerate(shard_list(entry)):
                    out[i] += _nbytes(t)
        return out

    def _materialize_pools(self):
        sharded = self.mesh is not None

        def zeros(shape, dtype):
            return _whole([torch.zeros(shape, dtype=dtype, device=d)
                           for d in self._devices], sharded)

        self._k = [zeros(self._shape, self.dtype)
                   for _ in range(self.num_layers)]
        self._v = [zeros(self._shape, self.dtype)
                   for _ in range(self.num_layers)]
        if self.quantized:
            self._ks = [zeros(self._scale_shape, torch.float32)
                        for _ in range(self.num_layers)]
            self._vs = [zeros(self._scale_shape, torch.float32)
                        for _ in range(self.num_layers)]
            # pages handed out since the last flush: their scale rows are
            # zeroed together before the scales are next read or written
            self._pending_scale_reset = []

    def layer_pools(self, layer):
        """One layer's live ``(k, v)`` pool tensors (sink page included);
        under a mesh, the lists of head shards."""
        return self._k[layer], self._v[layer]

    # ---------------------- quantized-scale state --------------------
    def _reset_page_scale(self, page):
        self._pending_scale_reset.append(int(page))

    def _flush_scale_resets(self):
        if not self.quantized or not self._pending_scale_reset:
            return
        idx = self._upload(np.asarray(self._pending_scale_reset, np.int64))
        self._pending_scale_reset = []
        for entry in self._ks + self._vs:
            for i, s in enumerate(shard_list(entry)):
                s.index_fill_(0, idx[i], 0.0)

    def layer_scales(self, layer):
        """One layer's ``(k_scale, v_scale)`` ``[num_pages + 1, H]`` arrays
        for the attention dequant (under a mesh, lists of head shards);
        ``(None, None)`` for a float pool."""
        if not self.quantized:
            return None, None
        self._flush_scale_resets()
        return self._ks[layer], self._vs[layer]

    # ---------------------- legacy-step writes -----------------------
    def _pages_touched(self, pages):
        """Distinct real pages (sink excluded) in a write's targets: the
        unit of its scale traffic."""
        arr = np.asarray(pages)
        return int(len(np.unique(arr[arr < self.num_pages])))

    def _scatter(self, layers, pages, rows, k, v, real_tokens):
        """Scatter k[i], v[i] ([n, H, D] each, or under a mesh their lists
        of head shards) into the pools of ``layers[i]`` at (pages, rows) —
        host int arrays uploaded once per device; sentinel pages land in
        the sink.  int8 pools quantize."""
        pg = self._upload(np.asarray(pages, np.int32))
        rw = self._upload(np.asarray(rows, np.int32))
        layers = list(layers)
        self._flush_scale_resets()
        for li, kl, vl in zip(layers, k, v):
            for i in range(self.tp_degree):
                kp, vp = shard_list(self._k[li])[i], shard_list(self._v[li])[i]
                ki, vi = self._head_part(kl, i), self._head_part(vl, i)
                if self.quantized:
                    quantized_pool_write(kp, shard_list(self._ks[li])[i], pg[i],
                                         rw[i], ki, self.pool_layout)
                    quantized_pool_write(vp, shard_list(self._vs[li])[i], pg[i],
                                         rw[i], vi, self.pool_layout)
                else:
                    scatter_pool_update(kp, pg[i], rw[i], ki,
                                        self.pool_layout)
                    scatter_pool_update(vp, pg[i], rw[i], vi,
                                        self.pool_layout)
        if self.quantized:
            self._count_scale_payload(self._pages_touched(pages),
                                      len(layers))
        self._count_write_payload(real_tokens, len(layers))

    def write_decode_tokens(self, seq_ids, positions, layer, k, v):
        """One layer's decode write: token i (k, v [B, H, D]) at reserved
        position ``positions[i]`` of ``seq_ids[i]``."""
        targets = [self._locate(sid, int(pos))
                   for sid, pos in zip(seq_ids, positions)]
        self._scatter([layer], [p for p, _ in targets],
                      [r for _, r in targets], [k], [v], len(seq_ids))

    def write_prefill_batch(self, seq_ids, starts, lengths, k, v):
        """Write a batch of length-padded prefill spans, k, v
        ``[B, L, T_padded, H, D]``: sequence i's first ``lengths[i]``
        tokens land at reserved positions ``starts[i] ...``; its padding
        positions go to the sink page, never to a page a table maps."""
        b, _, t_pad = k.shape[:3]
        pages = np.empty((b, t_pad), np.int32)
        rows = np.empty((b, t_pad), np.int32)
        for i, sid in enumerate(seq_ids):
            n = int(lengths[i])
            self.check_span_writable(sid, int(starts[i]), n)
            pages[i], rows[i] = self._span_pages_rows(
                sid, int(starts[i]), n, pad_to=t_pad)
        h, d = self.num_heads, self.head_dim
        # [B, L, Tp, H, D] -> per layer [B * Tp, H, D]
        lk = k.transpose(0, 1).reshape(self.num_layers, b * t_pad, h, d)
        lv = v.transpose(0, 1).reshape(self.num_layers, b * t_pad, h, d)
        self._scatter(range(self.num_layers), pages.reshape(-1),
                      rows.reshape(-1), lk, lv, int(np.sum(lengths)))

    def write_prefill_tokens(self, seq_id, start, layer, k, v):
        """One layer's write of one prefill chunk: k, v [n, H, D] (under a
        mesh, or their lists of head shards) at the reserved, privately
        owned positions ``[start, start + n)`` of `seq_id` (the eager
        chunk path's attend callback)."""
        n = int(shard_list(k)[0].shape[0])
        self._check_span_writable(seq_id, int(start), n)
        pages, rows = self._span_pages_rows(seq_id, int(start), n)
        self._scatter([layer], pages, rows, [k], [v], n)

    def _seq_pages(self, seq_id, length):
        """The first ``ceil(length / page_size)`` pages of `seq_id`'s
        table, as a long tensor on the pools' device (never the sink)."""
        table = self._table(seq_id)
        n = math.ceil(int(length) / self.page_size)
        return torch.as_tensor(np.asarray(table[:n], np.int64),
                               device=self.device)

    def _take_pages(self, pool, idx):
        """Pages `idx` of one pool in the canonical ``[n, page_size, H,
        D]`` layout."""
        idx = idx.to(pool.device)
        if self.pool_layout == "kernel":
            return pool.index_select(1, idx).permute(1, 2, 0, 3)
        return pool.index_select(0, idx)

    def gather_prefix(self, seq_id, layer, length):
        """One layer's K/V for positions ``[0, length)`` of `seq_id`, in
        position order: ``(k [length, H, D], v [length, H, D])`` on the
        pools' device (the heads of every shard gathered).  Exact copies
        of the stored rows for a float pool, the DEQUANTIZED rows for an
        int8 pool (the factor the kernels' in-kernel dequant applies)."""
        self._check_span(seq_id, 0, int(length))
        length = int(length)
        idx = self._seq_pages(seq_id, length)
        self._flush_scale_resets()
        shape = (-1, self._heads, self.head_dim)

        def rows(scales):
            return torch.repeat_interleave(
                scales.index_select(0, idx.to(scales.device)),
                self.page_size, dim=0)[:length][:, :, None]

        out = []
        for pools, scales in ((self._k, getattr(self, "_ks", None)),
                              (self._v, getattr(self, "_vs", None))):
            parts = []
            for i, pool in enumerate(shard_list(pools[layer])):
                x = self._take_pages(pool, idx).reshape(shape)[:length]
                if self.quantized:
                    x = dequantize_int8(x, rows(shard_list(scales[layer])[i]))
                parts.append(x)
            out.append(gather_heads(parts, 1, self.device))
        return out[0], out[1]

    # ---------------------- prefix-cache storage ---------------------
    def _copy_page_storage(self, src, dst):
        """The copy-on-write: page `src` into page `dst` of every layer's
        K and V pools (and an int8 pool's scale rows), in place, on the
        current stream, shard by shard.  Pending scale resets are applied
        FIRST: the fresh page `dst` has one queued, and applied after the
        copy it would zero the scales just copied."""
        self._flush_scale_resets()
        for entry in self._k + self._v:
            for pool in shard_list(entry):
                if self.pool_layout == "kernel":
                    pool[:, dst].copy_(pool[:, src])
                else:
                    pool[dst].copy_(pool[src])
        if self.quantized:
            for entry in self._ks + self._vs:
                for s in shard_list(entry):
                    s[dst].copy_(s[src])

    def export_pages(self, pages):
        """Copy the given physical pages out of the pools as the canonical
        payload: host (CPU) tensors ``k, v [L, n, page_size, H, D]`` in
        the pool dtype, bitwise the stored rows (under a mesh, every
        shard's heads gathered in order), plus for an int8 pool the
        ``(k_scale, v_scale) [L, n, H]`` rows (int8 bytes never travel
        without their grid).  Counted into the bytes moved."""
        self._flush_scale_resets()
        idx = torch.as_tensor(np.asarray(pages, np.int64).reshape(-1),
                              device=self.device)

        def take(group, fn, axis):
            # heads gathered and layers stacked on the device, then one
            # copy to the host
            return torch.stack([
                gather_heads([fn(p) for p in shard_list(entry)], axis,
                             self.device)
                for entry in group]).cpu()

        k = take(self._k, lambda p: self._take_pages(p, idx), 2)
        v = take(self._v, lambda p: self._take_pages(p, idx), 2)
        self._bytes_moved += _nbytes(k) + _nbytes(v)
        if not self.quantized:
            return k, v

        def rows(s):
            return s.index_select(0, idx.to(s.device))

        ks = take(self._ks, rows, 1)
        vs = take(self._vs, rows, 1)
        self._count_scale_payload(int(idx.shape[0]), self.num_layers)
        return k, v, ks, vs

    def _install_pages(self, pages, k, v, k_scale=None, v_scale=None):
        """The import: a canonical payload into pages `pages` of every
        layer's pools in place (``index_copy_``, so the pools keep their
        addresses and a captured loop graph stays valid), split by heads
        across a mesh's shards, the payload transposed for the kernel
        layout; an int8 payload's scale rows overwrite the pages' scales,
        after the pending resets are applied."""
        self._flush_scale_resets()
        idx = self._upload(np.asarray(pages, np.int64))
        dim = 1 if self.pool_layout == "kernel" else 0
        for pools, payload in ((self._k, k), (self._v, v)):
            # one upload, then each shard's heads from the device copy
            payload = payload.to(self.device, self.dtype)
            for i in range(self.tp_degree):
                part = self._head_part(payload, i, axis=3)
                if dim:
                    part = part.permute(0, 3, 1, 2, 4)  # [L, H, n, ps, D]
                for entry, rows in zip(pools, part):
                    shard_list(entry)[i].index_copy_(dim, idx[i], rows)
        if self.quantized:
            for scales, payload in ((self._ks, k_scale), (self._vs, v_scale)):
                payload = payload.to(self.device, torch.float32)
                for i in range(self.tp_degree):
                    part = self._head_part(payload, i, axis=2)
                    for entry, rows in zip(scales, part):
                        shard_list(entry)[i].index_copy_(0, idx[i], rows)

    @property
    def n_state_groups(self):
        """Length-L groups in the pool state: the k and v pools, then the
        k and v scales when quantized."""
        return 4 if self.quantized else 2

    def take_pool_state(self):
        """The whole pool state as one flat list ``[*k_pools, *v_pools]``,
        plus ``[*k_scales, *v_scales]`` when quantized, for a step that
        writes it (under a mesh each entry is a layer's list of head
        shards).  Pending scale resets are applied first."""
        self._flush_scale_resets()
        state = list(self._k) + list(self._v)
        if self.quantized:
            state += list(self._ks) + list(self._vs)
        return state

    def put_pool_state(self, state):
        """Install the flat state list a step returned."""
        want = self.n_state_groups * self.num_layers
        if len(state) != want:
            raise ValueError(f"expected {want} state arrays "
                             f"({self.n_state_groups} groups x "
                             f"{self.num_layers} layers), got {len(state)}")
        ll = self.num_layers
        self._k = list(state[:ll])
        self._v = list(state[ll:2 * ll])
        if self.quantized:
            self._ks = list(state[2 * ll:3 * ll])
            self._vs = list(state[3 * ll:])

    def reset_pools(self):
        """Fresh zeroed pool storage (every shard, under a mesh) after a
        step died mid-write: the pools may hold a partial write, and the
        engine fails every in-flight sequence on a poisoned step, so
        zeroed storage is exactly the state later requests expect.  The
        prefix index is flushed with the storage: its nodes alias pages
        whose bytes were just zeroed, and a later warm hit on them would
        generate from zeros."""
        self._materialize_pools()
        self.flush_prefix_cache()

    def _canonical(self, entry):
        """One layer's pool as a host array in the token layout, heads
        gathered, sink page dropped."""
        parts = []
        for pool in shard_list(entry):
            pool = pool.detach().cpu()
            if pool.dtype == torch.bfloat16:   # numpy has no bfloat16
                pool = pool.float()
            pool = pool.numpy()
            if self.pool_layout == "kernel":
                pool = pool.transpose(1, 2, 0, 3)
            parts.append(pool[:self.num_pages])
        return np.concatenate(parts, axis=2)

    @property
    def k_pool(self):
        """Host copy ``[L, P, page_size, H, D]`` in the token layout, sink
        page dropped: the stored bytes of an int8 pool, float32 otherwise."""
        return np.stack([self._canonical(p) for p in self._k])

    @property
    def v_pool(self):
        return np.stack([self._canonical(p) for p in self._v])

    def _host_scales(self, scales):
        self._flush_scale_resets()
        return np.stack([
            np.concatenate([s.detach().cpu().numpy()[:self.num_pages]
                            for s in shard_list(entry)], axis=1)
            for entry in scales])

    @property
    def k_scale(self):
        """Host copy ``[L, P, H]`` of an int8 pool's K scales, sink row
        dropped."""
        return self._host_scales(self._ks)

    @property
    def v_scale(self):
        return self._host_scales(self._vs)
