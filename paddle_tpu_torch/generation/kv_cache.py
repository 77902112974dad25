"""Paged KV cache: a preallocated page pool with per-sequence page tables.

Instead of one contiguous [B, L_max, H, D] buffer per sequence, the
cache is one pool of fixed-size pages per layer and every sequence owns
an ordered list of page ids (its page table): position ``t`` lives at
``page_table[t // page_size]``, row ``t % page_size``.  Appending a
token touches at most one page; freeing a finished sequence returns
whole pages to the free list.

- ``PagedKVCache`` — the host bookkeeping: page tables, the LIFO free
  list, reservations, byte accounting.
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
assert on the card.  Nothing ever reads the sink.
"""
import math

import numpy as np
import torch

from ..device import resolve_device
from .quantized_kv import quantized_pool_write


class OutOfPagesError(RuntimeError):
    """The page pool is exhausted: no free page for a required append."""


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


class PagedKVCache:
    """Page-table bookkeeping for `num_layers` attention layers."""

    pool_layout = "token"

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
        """Return every page of `seq_id` to the free list."""
        pages = self._table(seq_id)
        del self._tables[seq_id]
        del self._lens[seq_id]
        self._free.extend(reversed(pages))   # reversed: LIFO warm reuse

    def has(self, seq_id):
        return seq_id in self._tables

    def pages_needed(self, seq_id, new_tokens):
        """Pages an append of `new_tokens` to `seq_id` would allocate."""
        table = self._table(seq_id)
        return (math.ceil((self._lens[seq_id] + new_tokens) / self.page_size)
                - len(table))

    def reserve(self, seq_id, new_tokens=1):
        """Grow `seq_id`'s page table to hold `new_tokens` more tokens and
        advance its length; returns the first new position.  All-or-
        nothing: on OutOfPagesError nothing is allocated or advanced."""
        need = self.pages_needed(seq_id, new_tokens)
        if need > len(self._free):
            raise OutOfPagesError(
                f"need {need} pages for {new_tokens} tokens of "
                f"{seq_id!r}, only {len(self._free)} free")
        table = self._tables[seq_id]
        for _ in range(need):
            page = self._free.pop()
            table.append(page)
            if self.quantized:
                self._reset_page_scale(page)
        start = self._lens[seq_id]
        self._lens[seq_id] = start + new_tokens
        return start

    def truncate(self, seq_id, new_len):
        """REWIND `seq_id` to exactly `new_len` resident tokens — the
        speculative step's rejection primitive (rejected drafts, and the
        decode loop's reserved-but-unwritten tail, leave the cache here).
        Whole tail pages past the new length return to the free list in
        LIFO order; no device work is needed (a dropped page is
        unreachable once no table maps it).  Rows of the retained tail
        page past `new_len` go stale: attention masks them (kv_len gates
        visibility) and the next reservation of their positions
        overwrites them.

        Typed and all-or-nothing: UnknownSequenceError for a seq_id the
        cache does not hold; ValueError for growth (``new_len >
        seq_len``: growing goes through reserve) or a negative length.

        int8 pools: a dropped page's scale rows are reset (queued like a
        reserve's, applied before the scales are next read or written);
        the retained tail page keeps its grid, an abs-max over a superset
        of its live rows, which decodes them as before.

        This port has no prefix caching, so no page is ever shared and
        the JAX package's guard against rewinding into a shared prefix
        run has nothing to guard yet; it comes with prefix caching.

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
        del table[keep:]
        self._lens[seq_id] = new_len
        for page in reversed(dropped):   # reversed: LIFO warm reuse
            self._free.append(page)
            if self.quantized:
                self._reset_page_scale(page)
        return len(dropped)

    # ------------------------- write targets -------------------------
    def _locate(self, seq_id, pos):
        """(page, row) of an already-reserved position, for a write."""
        table = self._table(seq_id)
        if pos >= self._lens[seq_id]:
            raise IndexError(f"position {pos} not reserved for {seq_id!r} "
                             f"(len={self._lens[seq_id]})")
        return table[pos // self.page_size], pos % self.page_size

    def check_span_writable(self, seq_id, start, n):
        """Pre-dispatch guard of the in-step writers (the fused decode and
        chunk steps): positions [start, start+n) must be reserved
        (IndexError otherwise).  Without prefix sharing no page is
        shared, so reserved is writable."""
        self._table(seq_id)
        start, n = int(start), int(n)
        if start + n > self._lens[seq_id]:
            raise IndexError(
                f"span [{start}, {start + n}) not reserved for {seq_id!r} "
                f"(len={self._lens[seq_id]})")

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
        """Scale bytes a quantized write moves beside the int8 payload:
        folded into the bytes moved, and kept apart for
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
    def available_pages(self):
        """Pages a reservation can take right now."""
        return len(self._free)

    @property
    def pages_in_use(self):
        return self.num_pages - len(self._free)

    def utilization(self):
        """Fraction of the pool held by live sequences."""
        return self.pages_in_use / self.num_pages

    def stats(self):
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "kv_dtype": str(self.dtype).replace("torch.", ""),
            "pages_in_use": self.pages_in_use,
            "pages_free": self.num_free_pages,
            "sequences": len(self._tables),
            "tokens": int(sum(self._lens.values())),
            "utilization_pct": round(100.0 * self.utilization(), 1),
        }


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

    The ragged and fused steps write the pools in place
    (`scatter_pool_update`, or `quantized_pool_write` for int8) and read
    them through `layer_pools` / `layer_scales`; the legacy step's eager
    decode and one-shot prefill write through `write_decode_tokens` /
    `write_prefill_batch`, which land padding in the sink page too.
    ``k_pool`` / ``v_pool`` (and for int8 ``k_scale`` / ``v_scale``) are
    host copies in the canonical token layout without the sink page
    (debug and tests only).
    """

    def __init__(self, num_layers, num_heads, head_dim, num_pages=256,
                 page_size=16, dtype=torch.float32, pool_layout="token",
                 device=None):
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
        self.device = resolve_device(device, "DeviceKVPool")
        if pool_layout == "kernel":
            self._shape = (self.num_heads, self.num_pages + 1,
                           self.page_size, self.head_dim)
        else:
            self._shape = (self.num_pages + 1, self.page_size,
                           self.num_heads, self.head_dim)
        self._materialize_pools()

    def _materialize_pools(self):
        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self._k = [zeros(self._shape, self.dtype)
                   for _ in range(self.num_layers)]
        self._v = [zeros(self._shape, self.dtype)
                   for _ in range(self.num_layers)]
        if self.quantized:
            sshape = (self.num_pages + 1, self.num_heads)
            self._ks = [zeros(sshape, torch.float32)
                        for _ in range(self.num_layers)]
            self._vs = [zeros(sshape, torch.float32)
                        for _ in range(self.num_layers)]
            # pages handed out since the last flush: their scale rows are
            # zeroed together before the scales are next read or written
            self._pending_scale_reset = []

    def layer_pools(self, layer):
        """One layer's live ``(k, v)`` pool tensors (sink page included)."""
        return self._k[layer], self._v[layer]

    # ---------------------- quantized-scale state --------------------
    def _reset_page_scale(self, page):
        self._pending_scale_reset.append(int(page))

    def _flush_scale_resets(self):
        if not self.quantized or not self._pending_scale_reset:
            return
        idx = torch.as_tensor(self._pending_scale_reset, dtype=torch.long,
                              device=self.device)
        self._pending_scale_reset = []
        for s in self._ks + self._vs:
            s.index_fill_(0, idx, 0.0)

    def layer_scales(self, layer):
        """One layer's ``(k_scale, v_scale)`` ``[num_pages + 1, H]`` arrays
        for the attention dequant; ``(None, None)`` for a float pool."""
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
        """Scatter k[i], v[i] ([n, H, D] each) into the pools of
        ``layers[i]`` at (pages, rows) — host int arrays uploaded once;
        sentinel pages land in the sink.  int8 pools quantize."""
        pg = torch.as_tensor(np.asarray(pages, np.int32), device=self.device)
        rw = torch.as_tensor(np.asarray(rows, np.int32), device=self.device)
        layers = list(layers)
        self._flush_scale_resets()
        for li, kl, vl in zip(layers, k, v):
            if self.quantized:
                quantized_pool_write(self._k[li], self._ks[li], pg, rw, kl,
                                     self.pool_layout)
                quantized_pool_write(self._v[li], self._vs[li], pg, rw, vl,
                                     self.pool_layout)
            else:
                scatter_pool_update(self._k[li], pg, rw, kl,
                                    self.pool_layout)
                scatter_pool_update(self._v[li], pg, rw, vl,
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

    @property
    def n_state_groups(self):
        """Length-L tensor groups in the pool state: the k and v pools,
        then the k and v scales when quantized."""
        return 4 if self.quantized else 2

    def take_pool_state(self):
        """The whole pool state as one flat list ``[*k_pools, *v_pools]``,
        plus ``[*k_scales, *v_scales]`` when quantized, for a step that
        writes it.  Pending scale resets are applied first."""
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
        """Fresh zeroed pool storage after a step died mid-write: the
        pools may hold a partial write, and the engine fails every
        in-flight sequence on a poisoned step, so zeroed storage is
        exactly the state later requests expect."""
        self._materialize_pools()

    def _canonical(self, pool):
        pool = pool.detach().cpu()
        if pool.dtype == torch.bfloat16:   # numpy has no bfloat16
            pool = pool.float()
        pool = pool.numpy()
        if self.pool_layout == "kernel":
            pool = pool.transpose(1, 2, 0, 3)
        return pool[:self.num_pages]

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
        return np.stack([s.detach().cpu().numpy()[:self.num_pages]
                         for s in scales])

    @property
    def k_scale(self):
        """Host copy ``[L, P, H]`` of an int8 pool's K scales, sink row
        dropped."""
        return self._host_scales(self._ks)

    @property
    def v_scale(self):
        return self._host_scales(self._vs)
