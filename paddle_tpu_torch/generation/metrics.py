"""Generation metrics: ``generation.*`` counters/gauges in the profiler
StatRegistry.  Exposes the methods AdmissionQueue calls on its metrics
object (`set_queue_depth`, `count_rejected_busy`,
`count_rejected_deadline`), so the scheduler reuses the serving
AdmissionQueue unchanged.

Metric names (the ragged and legacy steps' subset of the JAX engine's,
same names):

- ``generation.requests_total``       accepted generation requests
- ``generation.rejected_busy``        admission rejections (queue full)
- ``generation.rejected_deadline``    deadline-expired rejections
- ``generation.queue_depth``          gauge: requests waiting
- ``generation.steps_total``          engine steps that sampled a token
- ``generation.prefill_tokens_total`` prompt tokens prefilled
- ``generation.tokens_total``         tokens generated (sampled)
- ``generation.finished_total``       sequences completed
- ``generation.preempted_total``      sequences preempted (pages reclaimed)
- ``generation.kv_bytes_moved``       KV bytes the step's writes move
                                      (O(tokens) on the device pools)
- ``generation.decode_dispatches_per_step``  gauge: step calls in the
                                      last step (1 on the ragged step; on
                                      the legacy chunked step one per
                                      chunk plus the decode's)
- ``generation.decode_host_syncs_per_step``  gauge: blocking device->host
                                      fetches in the last step (<= 1)
- ``generation.step_host_uploads``    gauge: host arrays uploaded to the
                                      device in the last step (the
                                      packed step inputs)
- ``generation.decode_compiles_total``  distinct decode signatures
                                      dispatched (pages buckets on the
                                      ragged step; (batch, pages, greedy)
                                      on the legacy fused decode)
- ``generation.decode_cache_hits`` / ``_misses``  signature cache
- ``generation.decode_compiles_prewarm``  fused-decode signatures first
                                      recorded by the mid-prefill
                                      pre-warm
- ``generation.prefill_compiles_total``  distinct prefill signatures
                                      dispatched ((batch, length) buckets
                                      of the one-shot prefill, pages
                                      buckets of the legacy chunk step)
- ``generation.prefill_cache_hits`` / ``_misses``  their signature cache
- ``generation.prefill_chunks_total``  prefill chunks packed into steps
- ``generation.step_rows_useful``     real token rows the steps computed
- ``generation.step_rows_dispatched``  row slots the steps carried (the
                                      fixed packed axis)
- ``generation.step_row_utilization``  gauge: last step's useful /
                                      dispatched rows (0..1)
- ``generation.padded_token_waste``   rows of masked dummy sequence work
                                      (0 on the ragged step by
                                      construction)
- ``generation.tokens_per_s``         gauge: decode throughput (EWMA)
- ``generation.slot_occupancy_pct``   gauge: active / decode slots
- ``generation.page_utilization_pct`` gauge: pool pages in use
- ``generation.prefix_cache_hit_tokens``  prompt tokens served from the
                                      prefix cache (aliased pages) at first
                                      admission instead of prefilled
- ``generation.prefix_cache_hit_rate``  gauge: cumulative hit tokens /
                                      prompt tokens looked up (0..1)
- ``generation.shared_pages``         gauge: physical pages aliased by
                                      more than one page table now
- ``generation.cow_copies``           copy-on-write page copies (first
                                      divergent append into a shared page)
- ``generation.prefix_evictions``     cached refcount-0 pages evicted to
                                      the free list under pool pressure
                                      (LRU, before any preemption)
- ``generation.prefix_pages_registered``  pages newly indexed: prompt
                                      pages at prefill completion, decode
                                      tail pages at retire
- ``generation.kernel_path``          gauge (string): ``"<mode>:cuda"`` or
                                      ``"<mode>:torch-reference"``, stamped
                                      at engine build
- ``generation.step_score_blocks``    [q_block, page_size] score blocks per
                                      head the CUDA kernel computes (its
                                      skip rule mirrored host-side);
                                      emitted only on the kernel path
- ``generation.step_score_blocks_untiled``  what an untiled kernel (full
                                      packed axis per live (descriptor,
                                      page) cell) would have computed, in
                                      the same units
- ``generation.kv_quant_dtype``       gauge (string): pool storage dtype
- ``generation.kv_scale_bytes``       int8 scale bytes in flight (writes)
                                      — a SUBSET of kv_bytes_moved, split
                                      out so the quantization overhead is
                                      visible
- ``generation.spec_mode``            gauge (string): the draft proposer
                                      ("off" / "ngram"), stamped at build
- ``generation.spec_proposed_tokens`` drafts packed into verify rows
- ``generation.spec_accepted_tokens`` drafts the model's argmax verified
- ``generation.spec_rewind_tokens``   rejected drafts truncated back out
- ``generation.spec_draft_rows``      speculating rows (the mean accepted
                                      length's denominator)
- ``generation.spec_acceptance_rate`` gauge: accepted / proposed, this
                                      engine's cumulative
- ``generation.loop_steps``           gauge: N of the host-free decode loop
                                      (1: the per-step path), stamped at
                                      build
- ``generation.decode_host_fetches_per_token``  gauge: host fetches per
                                      token on the loop path, cumulative
                                      (<= 1/N on a decode-only run)
- ``generation.loop_early_exits``     loops whose rows all finished before
                                      iteration N
- ``generation.loop_wasted_steps``    row-iterations a finished row sat
                                      through while others ran on
- ``generation.mesh_devices``         gauge: tensor-parallel degree of
                                      the engine's mesh (1 unsharded)
- ``generation.collective_bytes_per_step``  gauge: estimated all-reduce
                                      bytes of the last sharded dispatch
                                      (2 all-reduces per layer over the
                                      [rows, d_model] fp32 activation x
                                      the ring factor 2(N-1)/N, int8 and
                                      the scale scalars with quantized
                                      collectives; 0 unsharded)
- ``generation.collective_quantized``  gauge: 1 when the quantized ring
                                      carries the two per-layer
                                      all-reduces, 0 otherwise (a flag
                                      without a mesh, or at tp 1, reads
                                      0)

Every spec, loop and mesh stat is touched at engine build, so the schema
is complete from the first snapshot.
"""
import time

from ..profiler.monitor import StatRegistry

PREFIX = "generation."

REQUESTS_TOTAL = PREFIX + "requests_total"
REJECTED_BUSY = PREFIX + "rejected_busy"
REJECTED_DEADLINE = PREFIX + "rejected_deadline"
QUEUE_DEPTH = PREFIX + "queue_depth"
STEPS_TOTAL = PREFIX + "steps_total"
PREFILL_TOKENS_TOTAL = PREFIX + "prefill_tokens_total"
TOKENS_TOTAL = PREFIX + "tokens_total"
FINISHED_TOTAL = PREFIX + "finished_total"
PREEMPTED_TOTAL = PREFIX + "preempted_total"
KV_BYTES_MOVED = PREFIX + "kv_bytes_moved"
DECODE_DISPATCHES_PER_STEP = PREFIX + "decode_dispatches_per_step"
DECODE_HOST_SYNCS_PER_STEP = PREFIX + "decode_host_syncs_per_step"
STEP_HOST_UPLOADS = PREFIX + "step_host_uploads"
DECODE_COMPILES_TOTAL = PREFIX + "decode_compiles_total"
DECODE_CACHE_HITS = PREFIX + "decode_cache_hits"
DECODE_CACHE_MISSES = PREFIX + "decode_cache_misses"
DECODE_COMPILES_PREWARM = PREFIX + "decode_compiles_prewarm"
PREFILL_COMPILES_TOTAL = PREFIX + "prefill_compiles_total"
PREFILL_CACHE_HITS = PREFIX + "prefill_cache_hits"
PREFILL_CACHE_MISSES = PREFIX + "prefill_cache_misses"
PREFILL_CHUNKS_TOTAL = PREFIX + "prefill_chunks_total"
STEP_ROWS_USEFUL = PREFIX + "step_rows_useful"
STEP_ROWS_DISPATCHED = PREFIX + "step_rows_dispatched"
STEP_ROW_UTILIZATION = PREFIX + "step_row_utilization"
PADDED_TOKEN_WASTE = PREFIX + "padded_token_waste"
TOKENS_PER_S = PREFIX + "tokens_per_s"
SLOT_OCCUPANCY_PCT = PREFIX + "slot_occupancy_pct"
PAGE_UTILIZATION_PCT = PREFIX + "page_utilization_pct"
KERNEL_PATH = PREFIX + "kernel_path"
STEP_SCORE_BLOCKS = PREFIX + "step_score_blocks"
STEP_SCORE_BLOCKS_UNTILED = PREFIX + "step_score_blocks_untiled"
KV_QUANT_DTYPE = PREFIX + "kv_quant_dtype"
KV_SCALE_BYTES = PREFIX + "kv_scale_bytes"
SPEC_MODE = PREFIX + "spec_mode"
SPEC_PROPOSED_TOKENS = PREFIX + "spec_proposed_tokens"
SPEC_ACCEPTED_TOKENS = PREFIX + "spec_accepted_tokens"
SPEC_ACCEPTANCE_RATE = PREFIX + "spec_acceptance_rate"
SPEC_REWIND_TOKENS = PREFIX + "spec_rewind_tokens"
SPEC_DRAFT_ROWS = PREFIX + "spec_draft_rows"
PREFIX_CACHE_HIT_TOKENS = PREFIX + "prefix_cache_hit_tokens"
PREFIX_CACHE_HIT_RATE = PREFIX + "prefix_cache_hit_rate"
SHARED_PAGES = PREFIX + "shared_pages"
COW_COPIES = PREFIX + "cow_copies"
PREFIX_EVICTIONS = PREFIX + "prefix_evictions"
PREFIX_PAGES_REGISTERED = PREFIX + "prefix_pages_registered"
LOOP_STEPS = PREFIX + "loop_steps"
DECODE_HOST_FETCHES_PER_TOKEN = PREFIX + "decode_host_fetches_per_token"
LOOP_EARLY_EXITS = PREFIX + "loop_early_exits"
LOOP_WASTED_STEPS = PREFIX + "loop_wasted_steps"
MESH_DEVICES = PREFIX + "mesh_devices"
COLLECTIVE_BYTES_PER_STEP = PREFIX + "collective_bytes_per_step"
COLLECTIVE_QUANTIZED = PREFIX + "collective_quantized"


class GenerationMetrics:
    """Writes generation.* to the process StatRegistry (concurrent
    engines aggregate)."""

    _EWMA = 0.3  # tokens/s smoothing: jittery host steps, stable gauge

    def __init__(self, registry=None):
        self._reg = registry or StatRegistry.instance()
        self._rate = 0.0
        # per-engine accumulators of the acceptance and fetch-rate gauges
        self._spec_proposed_cum = 0
        self._spec_accepted_cum = 0
        self._loop_fetch_cum = 0
        self._loop_token_cum = 0
        self._prefix_hit_cum = 0
        self._prefix_lookup_cum = 0

    def _stat(self, name):
        return self._reg.get_stat(name)

    # --- AdmissionQueue metrics interface ---
    def set_queue_depth(self, depth):
        self._stat(QUEUE_DEPTH).set(int(depth))

    def count_rejected_busy(self):
        self._stat(REJECTED_BUSY).increase()

    def count_rejected_deadline(self, n=1):
        self._stat(REJECTED_DEADLINE).increase(n)

    # --- counters ---
    def count_request(self):
        self._stat(REQUESTS_TOTAL).increase()

    def count_prefill(self, tokens):
        self._stat(PREFILL_TOKENS_TOTAL).increase(int(tokens))

    def count_finished(self):
        self._stat(FINISHED_TOTAL).increase()

    def count_token(self):
        """One sampled-and-emitted token."""
        self._stat(TOKENS_TOTAL).increase()

    def count_preempted(self, n=1):
        self._stat(PREEMPTED_TOTAL).increase(n)

    def count_kv_bytes(self, n):
        if n:
            self._stat(KV_BYTES_MOVED).increase(int(n))

    def count_chunk(self):
        """One prefill chunk packed into a step."""
        self._stat(PREFILL_CHUNKS_TOTAL).increase()

    # --- prefix cache ---
    def count_prefix_lookup(self, hit_tokens, prompt_tokens):
        """One first-admission prefix lookup over `prompt_tokens` tokens,
        `hit_tokens` of them served by aliased pages (0: cold); keeps the
        cumulative hit-rate gauge."""
        if hit_tokens:
            self._stat(PREFIX_CACHE_HIT_TOKENS).increase(int(hit_tokens))
        self._prefix_hit_cum += int(hit_tokens)
        self._prefix_lookup_cum += int(prompt_tokens)
        if self._prefix_lookup_cum:
            self._stat(PREFIX_CACHE_HIT_RATE).set(
                round(self._prefix_hit_cum / self._prefix_lookup_cum, 3))

    def observe_shared_pages(self, n):
        """Gauge: physical pages aliased by more than one page table."""
        self._stat(SHARED_PAGES).set(int(n))

    def count_cow(self, n=1):
        # touch the stat even at 0 so every snapshot carries the key
        stat = self._stat(COW_COPIES)
        if n:
            stat.increase(int(n))

    def count_prefix_evictions(self, n=1):
        stat = self._stat(PREFIX_EVICTIONS)
        if n:
            stat.increase(int(n))

    def count_prefix_registered(self, n):
        """Pages newly indexed into the prefix trie."""
        stat = self._stat(PREFIX_PAGES_REGISTERED)
        if n:
            stat.increase(int(n))

    # --- signature cache (SignatureCache metrics interface via the
    # DecodeCacheMetrics adapter below) ---
    def count_decode_cache(self, hit):
        self._stat(DECODE_CACHE_HITS if hit
                   else DECODE_CACHE_MISSES).increase()

    def count_decode_compile(self):
        self._stat(DECODE_COMPILES_TOTAL).increase()

    def count_decode_prewarm(self):
        """One fused-decode signature first recorded by the pre-warm
        (it lands in decode_compiles_total too; this is its tag)."""
        self._stat(DECODE_COMPILES_PREWARM).increase()

    # --- prefill signature cache (SignatureCache metrics interface) ---
    def count_cache(self, hit):
        self._stat(PREFILL_CACHE_HITS if hit
                   else PREFILL_CACHE_MISSES).increase()

    def count_compile(self):
        self._stat(PREFILL_COMPILES_TOTAL).increase()

    # --- per-step observation ---
    def observe_decode_step(self, dispatches, host_syncs, uploads=0):
        """Per-step dispatch/sync/upload gauges."""
        self._stat(DECODE_DISPATCHES_PER_STEP).set(int(dispatches))
        self._stat(DECODE_HOST_SYNCS_PER_STEP).set(int(host_syncs))
        self._stat(STEP_HOST_UPLOADS).set(int(uploads))

    def count_step_extra_dispatches(self, n):
        """Add step calls the legacy chunked step made besides its decode
        call (one per packed chunk) to the per-step dispatch gauge the
        decode path just set."""
        stat = self._stat(DECODE_DISPATCHES_PER_STEP)
        stat.set(int(stat.get()) + int(n))

    def set_kernel_path(self, mode, use_kernel):
        """Gauge (string): ``"<mode>:cuda"`` / ``"<mode>:torch-reference"``,
        stamped once at engine build."""
        path = "cuda" if use_kernel else "torch-reference"
        self._stat(KERNEL_PATH).set(f"{mode}:{path}")

    def count_score_blocks(self, tiled, untiled):
        if untiled:
            self._stat(STEP_SCORE_BLOCKS).increase(int(tiled))
            self._stat(STEP_SCORE_BLOCKS_UNTILED).increase(int(untiled))

    def set_kv_quant_dtype(self, dtype_name):
        self._stat(KV_QUANT_DTYPE).set(str(dtype_name))

    def count_kv_scale_bytes(self, n):
        """int8 scale bytes drained from the cache each step (already in
        kv_bytes_moved).  Touches the stat even at 0, so an int8 engine's
        snapshot always carries the key."""
        stat = self._stat(KV_SCALE_BYTES)
        if n:
            stat.increase(int(n))

    def set_spec_mode(self, mode):
        """Gauge (string): the draft proposer ("off" / "ngram"), stamped
        at engine build; touches every spec counter so the schema is
        complete from the first snapshot."""
        self._stat(SPEC_MODE).set(str(mode))
        self._stat(SPEC_PROPOSED_TOKENS)
        self._stat(SPEC_ACCEPTED_TOKENS)
        self._stat(SPEC_REWIND_TOKENS)
        self._stat(SPEC_DRAFT_ROWS)
        self._stat(SPEC_ACCEPTANCE_RATE).set(0.0)

    def set_loop_steps(self, n):
        """Gauge: N of the host-free decode loop (1 = the per-step path),
        stamped at engine build; touches every loop counter too."""
        self._stat(LOOP_STEPS).set(int(n))
        self._stat(LOOP_EARLY_EXITS)
        self._stat(LOOP_WASTED_STEPS)
        self._stat(DECODE_HOST_FETCHES_PER_TOKEN).set(0.0)

    def set_mesh_devices(self, n):
        """Gauge: the engine's tensor-parallel degree (1 when unsharded),
        stamped at engine build so every snapshot carries the topology its
        numbers were measured on; touches the collective-bytes gauge at
        0, an unsharded engine's value."""
        self._stat(MESH_DEVICES).set(int(n))
        self._stat(COLLECTIVE_BYTES_PER_STEP).set(0)

    def observe_collective_bytes(self, n):
        """Gauge: estimated all-reduce bytes of the last sharded dispatch
        (fused._collective_bytes_estimate gives the formula); 0 on every
        unsharded path."""
        self._stat(COLLECTIVE_BYTES_PER_STEP).set(int(n))

    def set_collective_quantized(self, active):
        """Gauge: whether the quantized ring ACTUALLY carries the sharded
        step's all-reduces (the flag AND tp > 1), stamped at engine build
        like kernel_path, so a float32 fallback is visible."""
        self._stat(COLLECTIVE_QUANTIZED).set(1 if active else 0)

    def observe_loop(self, tokens, fetches, early_exit, wasted):
        """One decode loop retired: `tokens` emitted for `fetches` host
        fetches (1), `early_exit` when every row finished before
        iteration N, `wasted` the row-iterations finished rows sat
        through.  Maintains the cumulative fetches-per-token gauge."""
        self._loop_fetch_cum += int(fetches)
        self._loop_token_cum += int(tokens)
        if self._loop_token_cum:
            self._stat(DECODE_HOST_FETCHES_PER_TOKEN).set(
                round(self._loop_fetch_cum / self._loop_token_cum, 4))
        if early_exit:
            self._stat(LOOP_EARLY_EXITS).increase()
        if wasted:
            self._stat(LOOP_WASTED_STEPS).increase(int(wasted))

    def count_spec(self, proposed, accepted, rewound):
        """One speculating row's verify outcome: `proposed` drafts
        packed, `accepted` verified, `rewound` truncated back out.
        Maintains the cumulative acceptance-rate gauge and the draft-row
        count."""
        if proposed:
            self._stat(SPEC_PROPOSED_TOKENS).increase(int(proposed))
            self._stat(SPEC_DRAFT_ROWS).increase()
        if accepted:
            self._stat(SPEC_ACCEPTED_TOKENS).increase(int(accepted))
        if rewound:
            self._stat(SPEC_REWIND_TOKENS).increase(int(rewound))
        self._spec_proposed_cum += int(proposed)
        self._spec_accepted_cum += int(accepted)
        if self._spec_proposed_cum:
            self._stat(SPEC_ACCEPTANCE_RATE).set(
                round(self._spec_accepted_cum / self._spec_proposed_cum,
                      3))

    def observe_step_rows(self, useful, dispatched, waste):
        """Row accounting for one engine step: `useful` real token rows
        out of `dispatched` row slots, `waste` of them masked dummy
        work.  Touches every stat so the schema is complete from the
        first snapshot."""
        self._stat(STEP_ROWS_USEFUL).increase(int(useful))
        self._stat(STEP_ROWS_DISPATCHED).increase(int(dispatched))
        stat = self._stat(PADDED_TOKEN_WASTE)
        if waste:
            stat.increase(int(waste))
        if dispatched:
            self._stat(STEP_ROW_UTILIZATION).set(
                round(useful / dispatched, 3))

    def observe_step(self, tokens, step_seconds):
        """One step that sampled `tokens` tokens."""
        self._stat(STEPS_TOTAL).increase()
        if step_seconds > 0:
            inst = tokens / step_seconds
            self._rate = (inst if self._rate == 0.0 else
                          self._EWMA * inst + (1 - self._EWMA) * self._rate)
            self._stat(TOKENS_PER_S).set(round(self._rate, 1))

    def observe_occupancy(self, active, slots, page_utilization):
        if slots:
            self._stat(SLOT_OCCUPANCY_PCT).set(
                round(100.0 * active / slots, 1))
        self._stat(PAGE_UTILIZATION_PCT).set(
            round(100.0 * page_utilization, 1))

    # --- reads ---
    def snapshot(self):
        """All generation.* stats currently in the registry."""
        return {k: v for k, v in self._reg.stats().items()
                if k.startswith(PREFIX)}


class DecodeCacheMetrics:
    """Adapter giving the ragged step's SignatureCache the metrics
    interface it expects (`count_cache` / `count_compile`), landing the
    counts under generation.decode_*."""

    def __init__(self, generation_metrics):
        self._gm = generation_metrics

    def count_cache(self, hit):
        self._gm.count_decode_cache(hit)

    def count_compile(self):
        self._gm.count_decode_compile()


class StepTimer:
    """Tiny helper: `with StepTimer() as t: ...; t.seconds`."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False
