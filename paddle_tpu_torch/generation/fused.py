"""The engine's step owners: each pads one step's host inputs to its
shape buckets, uploads them, makes ONE call of the model's step function
on the live pools, and counts what it dispatched.

- `RaggedStep` — the ragged step (below);
- `FusedDecodeStep` — the legacy step's decode: one call of
  ``model.decode_step_fn`` per decode step;
- `ChunkedPrefillStep` — the legacy step's prefill: one call of
  ``model.prefill_chunk_fn`` per prefill chunk.

PyTorch runs eagerly: there is no jit and no donation.  A
`SignatureCache` counts the padded signatures each owner dispatched
(what a CUDA-graph capture would be keyed on).  The pools are written in
place; an int8 cache's scale arrays ride with them (the cache's pool
state is four groups of per-layer tensors then, k and v pools and k and
v scales, and the model's step functions are built with kv_quant).  If
a call fails part-way, the pools may hold a partial write, so the cache
is reset to fresh storage and the error propagates — the engine's
fail-the-batch-and-keep-serving recovery then keeps serving on clean
pools.

In the ragged step the decode batch's single-token rows AND the step's
prefill chunks ride one PACKED token axis of fixed size `max_tokens`,
described by per-sequence ``[start, len, kv_len]`` descriptors, through
one call of the model's ragged step function:

- the token axis is padded to `max_tokens` with inert slots (sink page,
  position 0), so batch size, chunk length and the decode/prefill mix
  never change a shape;
- the descriptor axis is padded to `max_seqs` with len-0 descriptors;
- the page-table axis is padded to a power-of-two pages bucket, which
  bounds the kernel's page loop and is the one signature axis (the
  SignatureCache counts the buckets dispatched — what a CUDA-graph
  capture would be keyed on);
- greedy is folded in: the step returns both the argmax ids [S] and the
  logits [S, V] on the device, and the engine fetches one of them.
"""
import numpy as np
import torch

from ..ops.paged_attention import ragged_score_blocks
from ..serving.bucketing import ShapeBucketer, SignatureCache
from .metrics import DecodeCacheMetrics


def _dispatch_in_place(cache, call):
    """Run ONE pool-writing step call: ``call(*groups)`` gets the cache's
    pool state as its per-layer groups (k_pools, v_pools, then k_scales,
    v_scales for an int8 cache) and returns ``(out, *groups)``; the
    returned groups are installed.  On ANY failure the pools may be half
    written — leave the cache on fresh storage and re-raise.  Returns the
    non-pool output, still on the device."""
    state = cache.take_pool_state()
    ll = cache.num_layers
    groups = [state[i * ll:(i + 1) * ll]
              for i in range(cache.n_state_groups)]
    try:
        out, *new = call(*groups)
        cache.put_pool_state([t for g in new for t in g])
    except BaseException:
        cache.reset_pools()
        raise
    return out


def decode_batch_menu(max_slots):
    """Power-of-two batch buckets up to (and always including) the cap —
    the one batch-menu builder for both the fused decode step and the
    engine's prefill bucketer."""
    menu, b = [], 1
    while b < max_slots:
        menu.append(b)
        b *= 2
    menu.append(int(max_slots))
    return tuple(sorted(set(menu)))


def _pages_bucketer(cache, batch_buckets=(1,)):
    """Batch buckets plus the power-of-two pages menu of `cache`."""
    return ShapeBucketer(
        batch_buckets=batch_buckets,
        length_buckets=ShapeBucketer.geometric_menu(cache.num_pages,
                                                    start=1))


class FusedDecodeStep:
    """The legacy decode step as ONE call of the model's decode step
    function per engine step.

    The live batch B is padded to the batch bucket with DUMMY rows
    (lens 0: their K/V lands in the sink page and their attention row is
    exact zeros) and the page-table axis to its pages bucket; one
    signature per (batch bucket, pages bucket, greedy).  An all-greedy
    batch takes the step function's argmax variant, so the single host
    sync fetches B ids instead of B x V logits.  `last_*` are per-call
    counts the engine's gauges are set from."""

    def __init__(self, model, cache, metrics, batch_buckets, device):
        self._cache = cache
        self.device = torch.device(device)
        self._params = model.decode_params(self.device)
        self._bucketer = _pages_bucketer(cache, tuple(batch_buckets))
        self._fns = {greedy: model.decode_step_fn(
            cache.page_size, cache.num_pages,
            pool_layout=cache.pool_layout, greedy=greedy,
            kv_quant=cache.quantized) for greedy in (False, True)}
        self._signatures = SignatureCache(DecodeCacheMetrics(metrics))
        self.last_dispatches = 0
        self.last_syncs = 0
        self.last_uploads = 0
        self.last_rows_useful = 0
        self.last_rows_dispatched = 0

    @property
    def compile_count(self):
        """Distinct (batch bucket, pages bucket, greedy) signatures — the
        bucket menu bounds it."""
        return self._signatures.compile_count

    def cached_buckets(self):
        return self._signatures.cached_buckets()

    def _signature(self, batch_rows, pages_cols, greedy):
        return (self._bucketer.batch_bucket(batch_rows),
                self._bucketer.length_bucket(max(int(pages_cols), 1)),
                bool(greedy))

    def prewarm(self, batch_rows, pages_cols, greedy):
        """Record the (batch, pages, greedy) signature a prefilling
        sequence's first decode step will land in, dispatching nothing.
        True when the signature is new."""
        rows = min(max(int(batch_rows), 1), self._bucketer.max_batch)
        return self._signatures.touch(
            self._signature(rows, pages_cols, greedy))

    def step(self, tokens, positions, page_tables, lens, greedy):
        """One decode step for `len(tokens)` live sequences: pad, upload,
        ONE step call on the live pools, and the ONE host sync.  Returns
        the real rows: [B] int32 ids when greedy, else [B, V] logits."""
        b_real = len(tokens)
        bucket_b, bucket_p, greedy = self._signature(
            b_real, page_tables.shape[1], greedy)
        tok = np.zeros((bucket_b,), np.int32)
        tok[:b_real] = tokens
        pos = np.zeros((bucket_b,), np.int32)
        pos[:b_real] = positions
        ln = np.zeros((bucket_b,), np.int32)
        ln[:b_real] = lens
        pt = np.zeros((bucket_b, bucket_p), np.int32)
        pt[:b_real, :page_tables.shape[1]] = page_tables
        self._signatures.touch((bucket_b, bucket_p, greedy))
        tok, pos, pt, ln = (torch.as_tensor(a, device=self.device)
                            for a in (tok, pos, pt, ln))
        fn = self._fns[greedy]
        out = _dispatch_in_place(
            self._cache,
            lambda *state: fn(self._params, tok, pos, *state, pt, ln))
        host = out[:b_real].cpu().numpy()      # the single host sync
        self.last_dispatches = 1
        self.last_syncs = 1
        self.last_uploads = 4
        # bucket_b - b_real DUMMY rows ran the whole masked step
        # (generation.padded_token_waste)
        self.last_rows_useful = b_real
        self.last_rows_dispatched = bucket_b
        return host


class ChunkedPrefillStep:
    """The legacy prefill step: ONE call of the model's chunk function
    per prefill chunk.  The token axis is fixed at `chunk_tokens`, so a
    chunk's signature is its pages bucket alone, whatever the prompt
    length; the signatures count under the PREFILL cache metrics (a
    chunk step is a prefill step).  `run` returns the chunk's last
    logits on the device unfetched: the engine fetches only the final
    chunk's, so mid-prompt chunks cost no host sync."""

    def __init__(self, model, cache, metrics, chunk_tokens, device):
        self._cache = cache
        self.device = torch.device(device)
        self.chunk_tokens = int(chunk_tokens)
        if self.chunk_tokens < 1:
            raise ValueError("chunk_tokens must be >= 1")
        self._params = model.decode_params(self.device)
        self._bucketer = _pages_bucketer(cache)
        self._fn = model.prefill_chunk_fn(cache.page_size, cache.num_pages,
                                          pool_layout=cache.pool_layout,
                                          kv_quant=cache.quantized)
        self._signatures = SignatureCache(metrics)
        self.last_rows_useful = 0
        self.last_rows_dispatched = 0

    @property
    def compile_count(self):
        """Distinct pages buckets dispatched — independent of prompt
        length."""
        return self._signatures.compile_count

    def run(self, seq_id, tokens, start):
        """One chunk: `tokens` (<= chunk_tokens of them, already reserved
        at positions [start, start + len)) padded to the chunk size, the
        sequence's page table to its pages bucket, ONE step call.  Returns
        the chunk's last-position logits [V] on the device."""
        n = len(tokens)
        if n > self.chunk_tokens:
            raise ValueError(f"chunk of {n} tokens > chunk_tokens="
                             f"{self.chunk_tokens}")
        self._cache.check_span_writable(seq_id, start, n)
        tok = np.zeros((self.chunk_tokens,), np.int32)
        tok[:n] = tokens
        pt_row, _ = self._cache.gather_block_tables([seq_id])
        bucket_p = self._bucketer.length_bucket(pt_row.shape[1])
        pt = np.zeros((bucket_p,), np.int32)
        pt[:pt_row.shape[1]] = pt_row[0]
        self._signatures.touch(bucket_p)
        tok, pt = (torch.as_tensor(a, device=self.device) for a in (tok, pt))
        logits = _dispatch_in_place(
            self._cache, lambda *state: self._fn(self._params, tok,
                                                 int(start), n, *state, pt))
        # chunk-axis padding rows are masked dummy work inside this
        # sequence's call (generation.padded_token_waste)
        self.last_rows_useful = n
        self.last_rows_dispatched = self.chunk_tokens
        return logits


class RaggedStep:
    """Owns the packing, the upload and the per-bucket signature cache of
    the ragged step.  `last_*` are per-call counts the engine's gauges
    are set from."""

    def __init__(self, model, cache, metrics, max_tokens, max_seqs,
                 device):
        self._cache = cache
        self.device = torch.device(device)
        self.max_tokens = int(max_tokens)
        self.max_seqs = int(max_seqs)
        if self.max_tokens < 1 or self.max_seqs < 1:
            raise ValueError("max_tokens and max_seqs must be >= 1")
        self.use_kernel = self.device.type == "cuda"
        self._params = model.decode_params(self.device)
        self._bucketer = _pages_bucketer(cache)
        self._fn = model.ragged_step_fn(cache.page_size, cache.num_pages,
                                        pool_layout=cache.pool_layout,
                                        kv_quant=cache.quantized)
        self._signatures = SignatureCache(DecodeCacheMetrics(metrics))
        self.last_dispatches = 0
        self.last_uploads = 0
        self.last_rows_useful = 0
        self.last_rows_dispatched = 0
        # FLOP proxy of the CUDA kernel (its tile rule mirrored on the
        # host): score blocks this call computed vs an untiled kernel's
        self.last_score_blocks = 0
        self.last_score_blocks_untiled = 0

    @property
    def compile_count(self):
        """Distinct pages buckets dispatched — independent of batch size,
        chunk length and sampling mix."""
        return self._signatures.compile_count

    def cached_buckets(self):
        return self._signatures.cached_buckets()

    def _upload(self, a):
        return torch.as_tensor(a, device=self.device)

    def step(self, tokens, positions, pages, rows, page_tables, starts,
             lens, kv_lens):
        """One packed mixed-batch step.  All inputs are the PACKED host
        arrays at exact sizes; this pads them (see the module docstring),
        uploads them and makes the ONE step call.  Returns ``(ids [S],
        logits [S, V])`` on the device — the caller fetches at most one
        of them."""
        t_real = len(tokens)
        s_real = len(starts)
        if t_real > self.max_tokens:
            raise ValueError(
                f"{t_real} packed rows > max_tokens={self.max_tokens}")
        if s_real > self.max_seqs:
            raise ValueError(
                f"{s_real} descriptors > max_seqs={self.max_seqs}")
        t, s = self.max_tokens, self.max_seqs
        tok = np.zeros((t,), np.int32)
        tok[:t_real] = tokens
        pos = np.zeros((t,), np.int32)
        pos[:t_real] = positions
        pg = np.full((t,), self._cache.num_pages, np.int32)  # sink page
        pg[:t_real] = pages
        rw = np.zeros((t,), np.int32)
        rw[:t_real] = rows
        page_tables = np.asarray(page_tables, np.int32)
        bucket_p = self._bucketer.length_bucket(
            max(page_tables.shape[1] if page_tables.size else 1, 1))
        pt = np.zeros((s, bucket_p), np.int32)
        if page_tables.size:
            pt[:s_real, :page_tables.shape[1]] = page_tables
        st = np.zeros((s,), np.int32)
        st[:s_real] = starts
        ln = np.zeros((s,), np.int32)
        ln[:s_real] = lens
        kv = np.zeros((s,), np.int32)
        kv[:s_real] = kv_lens
        self._signatures.touch(bucket_p)
        host = (tok, pos, pg, rw, pt, st, ln, kv)
        args = [self._params, *(self._upload(a) for a in host)]
        ids, logits = _dispatch_in_place(
            self._cache, lambda *state: self._fn(*args, *state))
        if self.use_kernel:
            self.last_score_blocks, self.last_score_blocks_untiled = \
                ragged_score_blocks(st, ln, kv, self._cache.page_size,
                                    bucket_p, t)
        else:
            # the plain version computes dense masked blocks; reporting
            # the kernel's skip statistics for it would mislead
            self.last_score_blocks = self.last_score_blocks_untiled = 0
        self.last_dispatches = 1
        self.last_uploads = len(host)
        self.last_rows_useful = t_real
        self.last_rows_dispatched = t
        return ids, logits
