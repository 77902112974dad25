"""The engine's step owners: each pads one step's host inputs to its
shape buckets, uploads them, makes ONE call of the model's step function
on the live pools, and counts what it dispatched.

- `RaggedStep` — the ragged step (below), with the speculative verify
  epilogue when built with `spec_tokens`;
- `LoopedRaggedStep` — the host-free decode loop: N ragged decode steps
  in one call and one host fetch, captured as a CUDA graph on the card;
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

Under a tensor-parallel mesh (``mesh=``) each owner calls the model's
step function built with the mesh, on params committed to their shards by
`_shard_params` (shared between an engine's owners), and records the
estimated all-reduce bytes of each call (`last_collective_bytes`,
`_collective_bytes_estimate`) from the padded rows it dispatched.
"""
import threading
import time

import numpy as np
import torch

from ..ops.paged_attention import (add_launches, ragged_score_blocks,
                                   recording_launches)
from ..parallel.quantized_allreduce import quantized_collective_bytes
from ..parallel.sharding_annotations import shard_heads
from ..serving.bucketing import ShapeBucketer, SignatureCache
from .metrics import DecodeCacheMetrics


def _shard_params(model, mesh, tp_axis=None):
    """The model's ``decode_params()`` committed to the mesh's shards, as
    per-shard lists of leaves: each leaf its model's
    ``decode_param_specs`` splits (Megatron column / row) becomes its
    `shard_heads` pieces, a fresh contiguous tensor on each shard's
    device; every other leaf one copy per distinct device.  A model
    without specs runs replicated weights."""
    tp_axis = mesh.tp_axis(tp_axis)
    params = model.decode_params()
    specs = (model.decode_param_specs(tp_axis)
             if hasattr(model, "decode_param_specs") else None)

    def place(t, spec):
        if spec and tp_axis in spec:
            return shard_heads(t, spec.index(tp_axis), mesh)
        return mesh.replicate(t)

    out = {k: place(v, () if specs is None else specs[k])
           for k, v in params.items() if k != "blocks"}
    out["blocks"] = [{k: place(v, () if specs is None
                               else specs["blocks"][i][k])
                      for k, v in blk.items()}
                     for i, blk in enumerate(params["blocks"])]
    return out


def _collective_bytes_estimate(num_layers, rows, d_model, tp_degree,
                               itemsize=4, quantized=False):
    """Estimated on-wire all-reduce bytes of ONE sharded dispatch
    (generation.collective_bytes_per_step), the JAX package's arithmetic:
    two all-reduces per layer (after wo and after w2), each over the
    [rows, d_model] activation block, a ring moving 2 (N-1)/N of the
    payload per device; `rows` is the PADDED axis dispatched (padding
    rows ride the collective too).  `quantized`: the int8 ring's bytes
    (`quantized_collective_bytes`).  0 when unsharded."""
    if tp_degree <= 1:
        return 0
    if quantized:
        return quantized_collective_bytes(num_layers, rows, d_model,
                                          tp_degree)
    payload = int(rows) * int(d_model) * int(itemsize)
    return int(2 * num_layers * payload * 2 * (tp_degree - 1)
               / tp_degree)


class _TPOwner:
    """What every step owner keeps of the tensor-parallel mesh: its
    degree, the model's widths for the collective-bytes estimate, and
    the params (the engine's shared `_shard_params` under a mesh, the
    model's on `device` otherwise)."""

    def _init_tp(self, model, device, mesh, quant_collectives, params):
        self.mesh = mesh
        self.tp_degree = 1 if mesh is None else mesh.size
        self.quant_collectives = bool(quant_collectives
                                      and self.tp_degree > 1)
        self._num_layers = int(model.num_layers)
        self._d_model = int(model.num_heads) * int(model.head_dim)
        if params is None:
            params = (model.decode_params(device) if mesh is None
                      else _shard_params(model, mesh))
        self._params = params
        self.last_collective_bytes = 0
        return {} if mesh is None else {
            "mesh": mesh, "quant_collectives": self.quant_collectives}

    def _count_collective(self, rows, iterations=1):
        self.last_collective_bytes = _collective_bytes_estimate(
            self._num_layers, rows, self._d_model, self.tp_degree,
            quantized=self.quant_collectives) * int(iterations)


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


class FusedDecodeStep(_TPOwner):
    """The legacy decode step as ONE call of the model's decode step
    function per engine step.

    The live batch B is padded to the batch bucket with DUMMY rows
    (lens 0: their K/V lands in the sink page and their attention row is
    exact zeros) and the page-table axis to its pages bucket; one
    signature per (batch bucket, pages bucket, greedy).  An all-greedy
    batch takes the step function's argmax variant, so the single host
    sync fetches B ids instead of B x V logits.  `last_*` are per-call
    counts the engine's gauges are set from."""

    def __init__(self, model, cache, metrics, batch_buckets, device,
                 mesh=None, quant_collectives=False, params=None):
        self._cache = cache
        self.device = torch.device(device)
        tp_kw = self._init_tp(model, self.device, mesh, quant_collectives,
                              params)
        self._bucketer = _pages_bucketer(cache, tuple(batch_buckets))
        self._fns = {greedy: model.decode_step_fn(
            cache.page_size, cache.num_pages,
            pool_layout=cache.pool_layout, greedy=greedy,
            kv_quant=cache.quantized, **tp_kw) for greedy in (False, True)}
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
        self._count_collective(bucket_b)
        return host


class ChunkedPrefillStep(_TPOwner):
    """The legacy prefill step: ONE call of the model's chunk function
    per prefill chunk.  The token axis is fixed at `chunk_tokens`, so a
    chunk's signature is its pages bucket alone, whatever the prompt
    length; the signatures count under the PREFILL cache metrics (a
    chunk step is a prefill step).  `run` returns the chunk's last
    logits on the device unfetched: the engine fetches only the final
    chunk's, so mid-prompt chunks cost no host sync."""

    def __init__(self, model, cache, metrics, chunk_tokens, device,
                 mesh=None, quant_collectives=False, params=None):
        self._cache = cache
        self.device = torch.device(device)
        self.chunk_tokens = int(chunk_tokens)
        if self.chunk_tokens < 1:
            raise ValueError("chunk_tokens must be >= 1")
        tp_kw = self._init_tp(model, self.device, mesh, quant_collectives,
                              params)
        self._bucketer = _pages_bucketer(cache)
        self._fn = model.prefill_chunk_fn(cache.page_size, cache.num_pages,
                                          pool_layout=cache.pool_layout,
                                          kv_quant=cache.quantized, **tp_kw)
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
        self._count_collective(self.chunk_tokens)
        return logits


class RaggedStep(_TPOwner):
    """Owns the packing, the upload and the per-bucket signature cache of
    the ragged step.  `last_*` are per-call counts the engine's gauges
    are set from."""

    def __init__(self, model, cache, metrics, max_tokens, max_seqs,
                 device, spec_tokens=0, mesh=None, quant_collectives=False,
                 params=None):
        self._cache = cache
        self.device = torch.device(device)
        self.max_tokens = int(max_tokens)
        self.max_seqs = int(max_seqs)
        # > 0: the step carries the speculative verify epilogue and returns
        # (ints [S, 3], aug [S, V + 3]); the signature stays the pages
        # bucket alone
        self.spec_tokens = int(spec_tokens)
        if self.max_tokens < 1 or self.max_seqs < 1:
            raise ValueError("max_tokens and max_seqs must be >= 1")
        self.use_kernel = self.device.type == "cuda"
        tp_kw = self._init_tp(model, self.device, mesh, quant_collectives,
                              params)
        self._bucketer = _pages_bucketer(cache)
        spec_kw = ({"spec_tokens": self.spec_tokens} if self.spec_tokens
                   else {})
        self._fn = model.ragged_step_fn(cache.page_size, cache.num_pages,
                                        pool_layout=cache.pool_layout,
                                        kv_quant=cache.quantized, **spec_kw,
                                        **tp_kw)
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
        logits [S, V])`` on the device — or, with spec_tokens, ``(ints
        [S, 3], aug [S, V + 3])`` (model.ragged_step_fn) — and the caller
        fetches at most one of them."""
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
        self._count_collective(t)
        return ids, logits


# one CUDA graph capture at a time in the process: the in-process replicas
# of a fleet each capture their own loops on their own worker threads
_CAPTURE_LOCK = threading.Lock()


def refuse_cross_card_loop(device, mesh):
    """NotImplementedError for the captured decode loop on a mesh whose
    shards span several cards: one CUDA graph captures one card's stream,
    and a graph per card joined by cross-card events is not built.  On
    one card (every shard there) or on the CPU (no graph) the loop
    runs."""
    if (torch.device(device).type == "cuda" and mesh is not None
            and len(mesh.distinct_devices) > 1):
        raise NotImplementedError(
            "not supported by the PyTorch port yet: the captured decode "
            "loop (loop_steps > 1) on a mesh whose shards span several "
            "cards; put every shard on one card (tp_mesh(devices=["
            "'cuda:0'] * tp)) or use loop_steps=1")


class _LoopGraph:
    """One captured loop: its CUDA graph, the flat input buffer the
    graph reads, its output tensor, and the paged kernels' launches one
    replay makes (recorded at capture)."""

    __slots__ = ("graph", "flat", "out", "launches")

    def __init__(self, graph, flat, out, launches):
        self.graph = graph
        self.flat = flat
        self.out = out
        self.launches = launches


class LoopedRaggedStep(_TPOwner):
    """N ragged decode steps in ONE call and ONE host fetch — the
    host-free decode loop (model.ragged_loop_fn).

    Decode-only by construction: descriptor s owns packed rows
    ``[s*(1+K), s*(1+K) + len)``, so the token axis is ``max_seqs *
    (1 + spec_tokens)``.  The row axis is padded to `max_seqs` with dead
    rows (live 0: zero-length descriptors, sink writes, no draws) and the
    page-table axis to its pages bucket; the sixteen inputs travel as
    one flat int32 upload (float columns by their bits).
    `compile_count` counts the pages buckets touched.  The engine falls
    back to the single step at boundaries that are not decode-only.

    On the card each (pages bucket, pool storage) pair is captured once
    as a CUDA graph of the N masked iterations, and replaying it is the
    call: after an eager warm-up with every row dead (its only writes
    land in the sink page; it also builds and loads the kernel library
    outside the capture), the loop is captured on a side stream, and
    before each replay the inputs are copied into the graph's flat
    buffer.  The pools are written in place, so their addresses hold;
    new pool storage (``reset_pools`` after a failed step) has new
    addresses, and the graph is keyed by them, so a graph never replays
    over freed storage.  The capture runs in the thread-local capture
    mode, on this step's own stream and one capture of the process at a
    time, so a sibling engine stepping on another thread of the process
    (an in-process fleet replica) neither breaks nor joins it.  The
    kernel wrappers count launches in Python, which runs once, at
    capture: the capturing thread records its launches apart
    (``recording_launches``) and each replay adds them, so the counts
    stay the launches the device ran.  A failed capture or replay
    raises (after the pools are reset, as for any failed step).  On the
    CPU the same function runs eagerly."""

    def __init__(self, model, cache, metrics, max_seqs, loop_steps, device,
                 spec_tokens=0, max_stop_ids=8, max_stop_seqs=4,
                 max_stop_len=8, mesh=None, quant_collectives=False,
                 params=None):
        self._cache = cache
        self.device = torch.device(device)
        self.max_seqs = int(max_seqs)
        self.loop_steps = int(loop_steps)
        self.spec_tokens = int(spec_tokens)
        self.max_stop_ids = int(max_stop_ids)
        self.max_stop_seqs = int(max_stop_seqs)
        self.max_stop_len = max(int(max_stop_len), 1)
        if self.max_seqs < 1:
            raise ValueError("max_seqs must be >= 1")
        if self.loop_steps < 1:
            raise ValueError("loop_steps must be >= 1")
        self._kd = max(self.spec_tokens, 1)
        self.max_emit = self.loop_steps + self.spec_tokens
        self.use_graph = self.device.type == "cuda"
        refuse_cross_card_loop(self.device, mesh)
        tp_kw = self._init_tp(model, self.device, mesh, quant_collectives,
                              params)
        self._bucketer = _pages_bucketer(cache)
        self._fn = model.ragged_loop_fn(
            cache.page_size, cache.num_pages, pool_layout=cache.pool_layout,
            kv_quant=cache.quantized, spec_tokens=self.spec_tokens,
            loop_steps=self.loop_steps, max_stop_ids=self.max_stop_ids,
            max_stop_seqs=self.max_stop_seqs,
            max_stop_len=self.max_stop_len, **tp_kw)
        self._signatures = SignatureCache(DecodeCacheMetrics(metrics))
        self._graphs = {}     # (pages bucket, pool data_ptrs) -> _LoopGraph
        self._capture_stream = None
        # capture accounting, read by the smoke run
        self.captures = 0
        self.replays = 0
        self.capture_seconds = []
        self.last_dispatches = 0
        self.last_syncs = 0
        self.last_uploads = 0
        self.last_iters = 0
        self.last_rows_useful = 0
        self.last_rows_dispatched = 0

    @property
    def compile_count(self):
        """Distinct pages buckets touched (loop_steps and the stop caps
        are fixed at build: no other signature axis)."""
        return self._signatures.compile_count

    def cached_buckets(self):
        return self._signatures.cached_buckets()

    # ---------------------------- inputs ------------------------------
    def _fields(self, bucket_p):
        """(shape, is_float) of the sixteen inputs, in call order."""
        s, ms, ns, ls = (self.max_seqs, self.max_stop_ids,
                         self.max_stop_seqs, self.max_stop_len)
        f, i = True, False
        return [((s,), i), ((s,), i), ((s,), i), ((s, bucket_p), i),
                ((s,), f), ((s,), i), ((s,), f), ((s,), i), ((s,), i),
                ((s,), i), ((s, ms), i), ((s, ns, ls), i), ((s, ns), i),
                ((s, ls - 1), i), ((s, self._kd), i), ((s,), i)]

    def _views(self, flat, bucket_p):
        """The sixteen inputs as views of one flat int32 tensor."""
        views, off = [], 0
        for shape, is_float in self._fields(bucket_p):
            n = int(np.prod(shape))
            v = flat[off:off + n].view(shape)
            views.append(v.view(torch.float32) if is_float else v)
            off += n
        return views

    def _host_inputs(self, bucket_p, rows):
        """The flat int32 host array: `rows` (the sixteen real-row arrays,
        or None for an all-dead loop) padded with dead rows."""
        s = self.max_seqs
        fills = (0, 0, 0, 0, 0.0, 0, 1.0, 0, 0, 0, -1, -1, 0, -1, 0, 0)
        parts = []
        for i, ((shape, is_float), fill) in enumerate(
                zip(self._fields(bucket_p), fills)):
            a = np.full(shape, fill, np.float32 if is_float else np.int32)
            if rows is not None:
                real = np.asarray(rows[i])
                if real.size:
                    a[tuple(slice(0, n) for n in real.shape)] = real
            parts.append(a.view(np.int32).reshape(-1))
        return np.concatenate(parts)

    # -------------------------- the call ------------------------------
    def _groups(self, state):
        ll = self._cache.num_layers
        return [state[i * ll:(i + 1) * ll]
                for i in range(self._cache.n_state_groups)]

    def _graph_for(self, bucket_p):
        """The captured loop for this pages bucket over the cache's
        current pool storage (captured on first use)."""
        state = self._cache.take_pool_state()
        key = (bucket_p, tuple(p.data_ptr() for t in state
                               for p in (t if isinstance(t, list) else [t])))
        got = self._graphs.get(key)
        if got is None:
            got = self._graphs[key] = self._capture(bucket_p, state)
        return got

    def _capture(self, bucket_p, state):
        t0 = time.perf_counter()
        groups = self._groups(state)
        flat = torch.as_tensor(self._host_inputs(bucket_p, None),
                               device=self.device)
        args = self._views(flat, bucket_p)
        try:
            # eager warm-up, every row dead: builds and loads the kernel,
            # sets its shared-memory attribute, writes only the sink page
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._fn(self._params, *args, *groups)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # a sibling engine of this process (a fleet replica on its
            # own worker thread) may launch, allocate and sync its own
            # stream meanwhile: the capture is thread-local, on a stream
            # of this step's own, one capture of the process at a time,
            # and the launches THIS thread records are what a replay adds
            if self._capture_stream is None:
                self._capture_stream = torch.cuda.Stream(self.device)
            with _CAPTURE_LOCK, recording_launches() as launches, \
                    torch.cuda.graph(graph, stream=self._capture_stream,
                                     capture_error_mode="thread_local"):
                out = self._fn(self._params, *args, *groups)[0]
            torch.cuda.current_stream(self.device).synchronize()
        except BaseException:
            self._cache.reset_pools()
            raise
        self.captures += 1
        self.capture_seconds.append(time.perf_counter() - t0)
        return _LoopGraph(graph, flat, out, launches)

    def prewarm(self, pages_cols):
        """Touch the pages bucket a loop over `pages_cols` page-table
        columns lands in, dispatching nothing; on the card, also capture
        its graph.  True when the bucket is new."""
        bucket_p = self._bucketer.length_bucket(max(int(pages_cols), 1))
        new = self._signatures.touch(bucket_p)
        if self.use_graph:
            self._graph_for(bucket_p)
        return new

    def release(self):
        """Drop every captured graph (and the memory its pool holds)."""
        self._graphs.clear()

    def step(self, cur_tok, cur_pos, page_tables, temps, top_ks, top_ps,
             seeds, counters, remaining, stop_ids, stop_seqs,
             stop_seq_lens, tail, drafts, draft_lens):
        """One N-step loop for ``len(cur_tok)`` live rows: pad (dead rows,
        pages bucket), one upload, ONE call (a graph replay on the card),
        and the ONE host fetch of the ``[S, N+K+6]`` output.  Returns its
        real rows (model.ragged_loop_fn gives the columns)."""
        s_real = len(cur_tok)
        if s_real > self.max_seqs:
            raise ValueError(
                f"{s_real} loop rows > max_seqs={self.max_seqs}")
        page_tables = np.asarray(page_tables, np.int32)
        bucket_p = self._bucketer.length_bucket(
            max(page_tables.shape[1] if page_tables.size else 1, 1))
        live = np.ones((s_real,), np.int32)
        host = self._host_inputs(bucket_p, (
            cur_tok, cur_pos, live, page_tables, temps, top_ks, top_ps,
            seeds, counters, remaining, stop_ids, stop_seqs, stop_seq_lens,
            tail, drafts, draft_lens))
        self._signatures.touch(bucket_p)
        if self.use_graph:
            g = self._graph_for(bucket_p)
            try:
                g.flat.copy_(torch.from_numpy(host))
                g.graph.replay()
                out = g.out.cpu().numpy()      # the single host sync
            except BaseException:
                self._cache.reset_pools()
                raise
            add_launches(g.launches)
            self.replays += 1
        else:
            flat = torch.as_tensor(host, device=self.device)
            args = self._views(flat, bucket_p)
            out = _dispatch_in_place(
                self._cache,
                lambda *groups: self._fn(self._params, *args, *groups))
            out = out.cpu().numpy()            # the single host sync
        self.last_dispatches = 1
        self.last_syncs = 1
        self.last_uploads = 1
        self.last_iters = int(out[0, -1])
        self.last_rows_useful = s_real
        self.last_rows_dispatched = self.max_seqs
        # two all-reduces per layer per iteration over the packed axis, in
        # the iterations some row was active (the JAX loop's count)
        self._count_collective(self.max_seqs * (1 + self.spec_tokens),
                               max(self.last_iters, 0))
        return out[:s_real]
