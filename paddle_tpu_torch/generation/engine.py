"""GenerationEngine: paged-KV continuous-batching decode on one of two
step modes.

    submit(prompt) -> AdmissionQueue -> scheduler slots -> STEPS
       <- GenerationHandle (stream)

- the RAGGED step (``step_mode="ragged"``, the default): each step packs
  the decode batch's rows AND prefill chunks into one call (scatter K/V
  into the page pools, ragged paged attention, logits, sample);
- the LEGACY step (``step_mode="legacy"``): each step runs one chunk call
  per packed prefill chunk (ChunkedPrefillStep: chunk-prefill attention)
  plus the whole decode batch, either as one fused call
  (``decode="fused"``, FusedDecodeStep: paged decode attention) or
  eagerly layer by layer (``decode="eager"``);
- with ``prefill_chunk_tokens=0`` either mode prefills each admitted
  prompt in one shot (``model.prefill_batch``, batched by length
  bucket), and only decode rides the step.

With ``prefix_cache`` on, full pages of every completed prompt (and, at
retire, of its generated tokens) are indexed by their token chain;
admission aliases the longest cached page run into a new sequence's page
table and its prefill resumes at the first unmatched token, so many
users of one system prompt pay its prefill once and hold one physical
copy.  Shared pages are read-only: the first divergent write copies the
page (copy-on-write, on the device), and refcount-0 runs stay resident as
an LRU cache evicted under pool pressure before any preemption.  The
ragged and legacy chunked steps resume at ``prefill_pos`` natively; the
one-shot modes run a warm suffix as one eager ``prefill_chunk`` call
through the chunk-prefill kernel.  ``export_prefix_pages`` and
``import_prefix_pages`` move a cached run between engines.

On the ragged step two options make a step retire more than one token
per sequence and per host round trip:

- ``spec_mode="ngram"``: speculative decoding.  A prompt-lookup proposer
  (speculation.py) drafts up to ``spec_tokens`` tokens per greedy row;
  the row packs as a ``1 + k`` descriptor, the step's epilogue verifies
  the drafts, and rejected drafts rewind through
  ``PagedKVCache.truncate``.  Greedy output is token-identical to plain
  decode on float pools.
- ``loop_steps=N > 1``: the host-free decode loop.  At a decode-only
  boundary, one call runs N decode steps with on-device sampling and
  stop matching (fused.LoopedRaggedStep, a CUDA graph on the card) and
  the host fetches once per N steps.  Other boundaries take the single
  step.

The engine owns the KV pages, the schedule, sampling and metrics; the
model implements the step functions (model.TinyCausalLM).  Greedy decode
through this engine is token-identical to naive full-recompute
generation: continuous batching, chunking and paging change the cost of
a token, never its value.

With ``kv_dtype="int8"`` the pools store int8 bytes with per-page
per-head float32 scales (quantized_kv.py): every write path quantizes,
every attention call dequantizes inside the kernel (or the plain
version's gathered view), on every step mode and decode path.

The engine runs on the card unless the config asks for the CPU: a
``GenerationConfig()`` resolves its device to ``"cuda"`` and building an
engine raises when CUDA is absent.  On the CPU every attention call
takes the kernel's plain PyTorch version.

Overload behaviour: a full queue raises ServerBusyError at submit,
lapsed deadlines resolve handles with DeadlineExceededError, and page
exhaustion preempts the youngest sequences (recompute-style) before
ever failing a request.
"""
import concurrent.futures
import math
import os
import queue
import threading
import time

import numpy as np
import torch

from ..device import resolve_device
from ..profiler import RecordEvent
from ..serving.admission import RequestTooLargeError, ServingError
from ..serving.bucketing import ShapeBucketer, SignatureCache
from .decode_attention import (chunk_prefill_attention,
                               paged_decode_attention)
from .fused import (ChunkedPrefillStep, FusedDecodeStep,
                    LoopedRaggedStep, RaggedStep, decode_batch_menu)
from .kv_cache import DeviceKVPool, OutOfPagesError
from .metrics import GenerationMetrics, StepTimer
from .sampling import (SampleStream, SamplingParams, sample_token,
                       sample_tokens_batch)
from .scheduler import (ContinuousBatchingScheduler, GenerationRequest,
                        SequenceState)
from .speculation import NgramProposer

# chunk size of chunked prefill (GenerationConfig.prefill_chunk_tokens=None)
DEFAULT_PREFILL_CHUNK_TOKENS = 64

_KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}


def _kv_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _KV_DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported kv_dtype {dtype!r}") from None


class GenerationConfig:
    """Engine knobs.

    device: where the weights, pools and steps live — None (the default)
        means "cuda"; pass "cpu" to run every step on the CPU with the
        kernels' plain versions.  Never a silent fallback: an engine on
        "cuda" without a card refuses to build.
    kv_dtype: pool storage dtype: float32 (default), bfloat16, or int8
        (per-page per-head scales beside the bytes; about 2x the resident
        sequences per pool byte of bfloat16, 4x of float32).
    pool_layout: "token" ([P, page_size, H, D]) or "kernel"
        ([H, P, page_size, D]); None = "token".
    step_mode: "ragged" (one mixed-batch call per step) or "legacy" (a
        chunk call per packed chunk plus the decode batch's call, or the
        eager decode); None = "ragged", or "legacy" when `decode` is set
        (a decode path names a legacy step).
    decode: the legacy step's decode — "fused" (one call per step) or
        "eager" (per-layer attend callbacks); None = "fused".  Rejected
        with step_mode="ragged", which has no separate decode call.
    prefill_chunk_tokens: chunk size of chunked prefill; None = 64; 0 =
        one-shot prefill of each admitted prompt (batched by length
        bucket, at most max_prefill_batch prompts per call).
    step_token_budget: the ragged step's fixed packed token axis (the
        legacy chunked step's pack room); None = prefill_chunk_tokens +
        max_decode_slots.  On the ragged step it must hold every decode
        slot plus, with chunking on, at least one prefill row.
    prefill_pack: pack several prompts' chunks into a step's leftover
        room (True) or one chunk per step (False).
    spec_mode: "ngram" turns on speculative decoding on the ragged step
        (see the module docstring); "off" or None disables it.  It needs
        the ragged step: with step_mode unset it resolves to "ragged",
        and step_mode="legacy" raises.
    spec_tokens: the draft cap per speculating row (default 4; >= 1 with
        spec_mode="ngram").  The auto step_token_budget grows by
        max_decode_slots * spec_tokens so a fully drafting batch still
        leaves the prefill chunk its room; an explicit budget clips
        drafts instead.
    loop_steps: N of the host-free decode loop; 1 (default) is the
        per-step path.  N > 1 needs the ragged step (with step_mode
        unset it resolves to "ragged"; "legacy" raises) and a model with
        ``ragged_loop_fn``.
    prefix_cache: refcounted copy-on-write page sharing across sequences
        (the module docstring).  It needs a prefill path that can resume
        mid-prompt: chunked prefill, or a model with ``prefill_chunk``
        for the one-shot modes.  None = auto: on when the engine runs on
        the card with chunked prefill on, off on the CPU (where the
        parity tests anchor on the cold path; warm against cold is
        tested on its own).

    A mesh, which the JAX engine takes, is accepted here and refused with
    NotImplementedError when the engine is built.
    """

    def __init__(self, max_decode_slots=8, num_pages=256, page_size=16,
                 queue_depth=64, default_timeout_ms=None,
                 default_max_new_tokens=16, kv_dtype=torch.float32,
                 max_prefill_batch=4, decode=None, pool_layout=None,
                 prefill_chunk_tokens=None, step_token_budget=None,
                 step_mode=None, prefill_pack=True, spec_mode=None,
                 spec_tokens=4, loop_steps=1, prefix_cache=None, mesh=None,
                 device=None):
        self.max_decode_slots = int(max_decode_slots)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.queue_depth = int(queue_depth)
        self.default_timeout_ms = default_timeout_ms
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.kv_dtype = _kv_dtype(kv_dtype)
        self.max_prefill_batch = int(max_prefill_batch)
        if self.max_prefill_batch < 1:
            raise ValueError("max_prefill_batch must be >= 1")
        if decode not in (None, "eager", "fused"):
            raise ValueError(
                f"decode must be 'eager', 'fused' or None (auto), got "
                f"{decode!r}")
        self.decode = decode
        if pool_layout not in (None, "token", "kernel"):
            raise ValueError(
                f"pool_layout must be 'token', 'kernel' or None, got "
                f"{pool_layout!r}")
        self.pool_layout = pool_layout or "token"
        if prefill_chunk_tokens is not None and int(prefill_chunk_tokens) < 0:
            raise ValueError(
                f"prefill_chunk_tokens must be >= 0 (0: one-shot prefill) "
                f"or None, got {prefill_chunk_tokens}")
        self.prefill_chunk_tokens = (DEFAULT_PREFILL_CHUNK_TOKENS
                                     if prefill_chunk_tokens is None
                                     else int(prefill_chunk_tokens))
        if step_token_budget is not None and int(step_token_budget) < 1:
            raise ValueError(
                f"step_token_budget must be >= 1 or None (auto), got "
                f"{step_token_budget}")
        self.step_token_budget = (None if step_token_budget is None
                                  else int(step_token_budget))
        if step_mode not in (None, "legacy", "ragged"):
            raise ValueError(
                f"step_mode must be 'legacy', 'ragged' or None (auto), "
                f"got {step_mode!r}")
        if step_mode == "ragged" and decode is not None:
            raise ValueError(
                "step_mode='ragged' replaces the decode dispatch path (one "
                "mixed-batch call serves decode AND prefill chunks); "
                f"decode={decode!r} makes no sense with it")
        self.step_mode = step_mode
        self.prefill_pack = bool(prefill_pack)
        if spec_mode not in (None, "off", "ngram"):
            raise ValueError(
                f"spec_mode must be 'ngram', 'off' or None, got "
                f"{spec_mode!r}")
        self.spec_mode = spec_mode or "off"
        self.spec_tokens = int(spec_tokens)
        # validated only with speculation on: spec_tokens=0 beside an
        # unset spec_mode means "disabled", not an error
        if self.spec_mode == "ngram" and self.spec_tokens < 1:
            raise ValueError(
                f"spec_tokens must be >= 1 with spec_mode='ngram', got "
                f"{spec_tokens}")
        if self.spec_mode == "ngram" and step_mode == "legacy":
            raise ValueError(
                "spec_mode='ngram' rides the ragged step's packed token "
                "axis (a speculating row is a [start, 1+k, kv_len] "
                "descriptor); step_mode='legacy' has no such axis")
        self.loop_steps = int(loop_steps)
        if self.loop_steps < 1:
            raise ValueError(
                f"loop_steps must be >= 1 (1 = the per-step path), got "
                f"{loop_steps}")
        if self.loop_steps > 1 and step_mode == "legacy":
            raise ValueError(
                "loop_steps > 1 is the host-free decode loop over the "
                "RAGGED step (N ragged iterations per call); "
                "step_mode='legacy' has no such call")
        if prefix_cache not in (None, True, False):
            raise ValueError(
                f"prefix_cache must be True, False or None (auto), got "
                f"{prefix_cache!r}")
        self.prefix_cache = prefix_cache
        self.mesh = mesh
        self.device = "cuda" if device is None else str(device)


def _refuse_unported(cfg):
    """NotImplementedError for the setting the port does not run yet — a
    mesh — never a silent switch to another path."""
    if cfg.mesh is not None:
        raise NotImplementedError(
            "not supported by the PyTorch port yet: mesh (it serves the "
            "ragged and legacy steps, prefix caching, speculative decoding "
            "and the host-free decode loop on float32, bfloat16 and int8 "
            "pools of one card)")


def _require(model, names, what):
    missing = [n for n in names if not hasattr(model, n)]
    if missing:
        raise ValueError(f"{what} needs a model implementing "
                         f"{', '.join(names)} ({type(model).__name__} "
                         f"lacks {', '.join(missing)})")


class _FifoLock:
    """The engine's step lock, handed out in arrival order.  The worker
    thread releases it at the end of a step and asks for it again at
    once; a plain lock lets it win that race step after step, so a
    thread waiting for the engine (a fleet's live import or handoff, a
    cancel, a drain) could wait tens of steps.  Here each waiter gets the
    lock at the next step boundary.  Not reentrant, like the lock it
    replaces."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._tickets = 0    # handed out
        self._serving = 0    # the ticket that holds the lock

    def acquire(self):
        with self._cond:
            ticket = self._tickets
            self._tickets += 1
            while ticket != self._serving:
                self._cond.wait()
        return True

    def release(self):
        with self._cond:
            self._serving += 1
            self._cond.notify_all()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()
        return False


class GenerationResult:
    """Final outcome of one request."""

    __slots__ = ("token_ids", "finish_reason", "prompt_len", "preemptions")

    def __init__(self, token_ids, finish_reason, prompt_len, preemptions):
        self.token_ids = list(token_ids)
        self.finish_reason = finish_reason  # "stop"|"length"|"cancelled"
        self.prompt_len = prompt_len
        self.preemptions = preemptions

    def __repr__(self):
        return (f"GenerationResult(tokens={self.token_ids}, "
                f"finish_reason={self.finish_reason!r})")


class GenerationHandle:
    """Per-request streaming future: `result(timeout)` blocks for the
    final GenerationResult; `tokens(timeout)` iterates token ids as they
    are sampled (raising the typed error on failure)."""

    _DONE = object()

    def __init__(self):
        self._fut = concurrent.futures.Future()
        self._events = queue.SimpleQueue()
        # time-to-first-token probes (monotonic seconds)
        self.submitted_s = None
        self.first_token_s = None
        # prompt tokens the prefix cache served at FIRST admission (0:
        # cold, None: not admitted yet)
        self.prefix_hit_tokens = None
        # delivered-token count: a fleet remigration reads it as the
        # replay-skip floor, so no ledger race can replay a token this
        # handle already streamed
        self.n_streamed = 0

    # --- engine side ---
    def _push_token(self, token):
        if self.first_token_s is None:
            self.first_token_s = time.monotonic()
        self.n_streamed += 1
        self._events.put(int(token))

    def _finish(self, result):
        if not self._fut.done():
            self._fut.set_result(result)
        self._events.put(self._DONE)

    def set_exception(self, exc):
        try:
            self._fut.set_exception(exc)
        except concurrent.futures.InvalidStateError:
            return
        self._events.put(self._DONE)

    # --- client side ---
    def done(self):
        return self._fut.done()

    def result(self, timeout=None):
        return self._fut.result(timeout)

    def exception(self, timeout=None):
        return self._fut.exception(timeout)

    def add_done_callback(self, fn):
        """Run ``fn(handle)`` once the request resolves, with a result or
        a typed failure (called at once if already done).  The fleet
        tier hangs its route confirmation here: prefix_hit_tokens is
        stamped at first admission, so a completed handle says whether a
        prefix-affinity bet paid."""
        self._fut.add_done_callback(lambda _f: fn(self))

    def tokens(self, timeout=None):
        """Yield token ids as they stream; `timeout` bounds the wait for
        EACH token (queue.Empty on a stall)."""
        while True:
            ev = self._events.get(timeout=timeout)
            if ev is self._DONE:
                break
            yield ev
        exc = self._fut.exception(timeout=0)
        if exc is not None:
            raise exc


class GenerationEngine:
    """Paged-KV continuous-batching engine over the ragged or the legacy
    step."""

    _IDLE_POLL_S = 0.02

    def __init__(self, model, config=None, metrics=None, start=True):
        self.model = model
        self.config = cfg = config or GenerationConfig()
        self.metrics = metrics or GenerationMetrics()
        _refuse_unported(cfg)
        self.device = resolve_device(cfg.device, "GenerationEngine")
        spec_on = cfg.spec_mode == "ngram"
        loop_on = cfg.loop_steps > 1
        # speculation and the loop ride the ragged step: asking for either
        # resolves an unset step mode to it, whatever `decode` says
        self.step_mode = cfg.step_mode or (
            "legacy" if cfg.decode and not (spec_on or loop_on)
            else "ragged")
        self.decode_mode = ("ragged" if self.step_mode == "ragged"
                            else cfg.decode or "fused")
        self.prefill_chunk_tokens = chunk = cfg.prefill_chunk_tokens
        self._check_model(model, chunk)
        self.cache = DeviceKVPool(
            model.num_layers, model.num_heads, model.head_dim,
            num_pages=cfg.num_pages, page_size=cfg.page_size,
            dtype=cfg.kv_dtype, pool_layout=cfg.pool_layout,
            device=self.device)
        # int8 pools count their scale bytes apart, per step
        self.kv_quant = bool(self.cache.quantized)
        self.scheduler = ContinuousBatchingScheduler(
            self.cache, num_slots=cfg.max_decode_slots,
            queue_depth=cfg.queue_depth, metrics=self.metrics)
        # prefix caching: a warm hit resumes prefill MID-prompt, which the
        # chunked steps do natively and the one-shot modes through the
        # model's eager prefill_chunk.  Auto: on on the card with
        # chunked prefill on, off on the CPU
        prefix = cfg.prefix_cache
        if prefix is None:
            prefix = self.device.type == "cuda" and bool(chunk)
        elif prefix and not (chunk or hasattr(model, "prefill_chunk")):
            raise ValueError(
                "prefix_cache=True needs a prefill path that can resume "
                "mid-prompt: chunked prefill (prefill_chunk_tokens) or "
                "a model implementing prefill_chunk — one-shot "
                f"model.prefill always starts at token 0 "
                f"({type(model).__name__})")
        self.prefix_cache_enabled = bool(prefix)
        self.scheduler.prefix_cache = self.prefix_cache_enabled
        slots = cfg.max_decode_slots
        # speculation sizes the auto packed axis for a fully drafting
        # batch (decode rows carry 1 + spec_tokens rows each), the chunk
        # keeping its own room; an explicit budget clips drafts instead
        self.spec_tokens = cfg.spec_tokens if spec_on else 0
        self.step_token_budget = (
            cfg.step_token_budget if cfg.step_token_budget is not None
            else chunk + slots + slots * self.spec_tokens)
        # the one-shot prefill's (batch, length) menu and its signature
        # count, under the prefill metric names
        self._bucketer = ShapeBucketer.for_prefill(
            decode_batch_menu(cfg.max_prefill_batch),
            cfg.num_pages * cfg.page_size,
            getattr(model, "max_positions", None))
        self._prefill_signatures = SignatureCache(self.metrics)
        self._ragged = self._fused = self._chunk_step = self._loop = None
        if self.step_mode == "ragged":
            # the budget IS the packed token axis: it must hold the full
            # decode batch plus, with chunking on, at least one prefill
            # row, or a full batch that never finished would starve
            # prompts forever
            need = slots + (1 if chunk else 0)
            if self.step_token_budget < need:
                raise ValueError(
                    f"step_token_budget={self.step_token_budget} < {need}: "
                    f"the ragged step's packed token axis must hold every "
                    f"decode slot"
                    + (" plus at least one prefill-chunk row" if chunk
                       else ""))
            self._ragged = RaggedStep(model, self.cache, self.metrics,
                                      max_tokens=self.step_token_budget,
                                      max_seqs=slots + 1, device=self.device,
                                      spec_tokens=self.spec_tokens)
        else:
            if self.decode_mode == "fused":
                self._fused = FusedDecodeStep(model, self.cache,
                                              self.metrics,
                                              decode_batch_menu(slots),
                                              self.device)
            if chunk:
                self._chunk_step = ChunkedPrefillStep(
                    model, self.cache, self.metrics, chunk, self.device)
        # the host-free loop, built beside the single step, which stays
        # the path of every boundary that is not decode-only
        if loop_on:
            self._loop = LoopedRaggedStep(
                model, self.cache, self.metrics, max_seqs=slots,
                loop_steps=cfg.loop_steps, device=self.device,
                spec_tokens=self.spec_tokens)
        self.loop_steps = cfg.loop_steps if loop_on else 1
        # the prompt-lookup proposer (None: speculation off)
        self._spec = NgramProposer() if spec_on else None
        # which attention implementation the steps run, stamped once so
        # a snapshot never hides the path its numbers came from
        self.metrics.set_kernel_path(self.decode_mode,
                                     self.device.type == "cuda")
        self.metrics.set_kv_quant_dtype(
            str(self.cache.dtype).replace("torch.", ""))
        # the spec and loop stamps touch every spec and loop stat, so the
        # schema is complete from the first snapshot
        self.metrics.set_spec_mode(cfg.spec_mode)
        self.metrics.set_loop_steps(self.loop_steps)
        self._lock = _FifoLock()  # one stepper at a time
        # step progress: bumped after every completed step(), with
        # `_in_step` set while a step holds the lock (a first-shape build
        # or a loop capture inside a step is progress, not a wedge).  A
        # subprocess replica's heartbeat carries both: work without
        # progress outside a step is the fleet's wedge signature
        self._step_seq = 0
        self._in_step = False
        # prefill/decode handoff: a prefill-class engine parks every
        # sequence the moment its prompt is consumed, exported as a
        # live-migration snapshot into _handoff_out, and `on_handoff` is
        # called after the step lock is released (the collector drains
        # take_handoffs(), so no router lock is taken under this lock)
        self._handoff = False
        self.on_handoff = None
        self._handoff_out = []
        self._closed = False
        self._stop = threading.Event()
        self._thread = None
        if start:
            self.start()

    def _check_model(self, model, chunk):
        """The protocol methods each configured path calls.  The eager
        decode and the one-shot prefill run on the model's own weights,
        so those must live on the engine's device."""
        legacy = self.step_mode == "legacy"
        if not legacy:
            _require(model, ("ragged_step_fn", "decode_params"),
                     "the ragged step")
            if self.config.loop_steps > 1:
                _require(model, ("ragged_loop_fn",),
                         f"loop_steps={self.config.loop_steps}")
        elif self.decode_mode == "fused":
            _require(model, ("decode_step_fn", "decode_params"),
                     "decode='fused'")
        else:
            _require(model, ("decode",), "decode='eager'")
        if legacy and chunk:
            _require(model, ("prefill_chunk_fn", "decode_params"),
                     "chunked prefill on the legacy step")
        if not chunk:
            _require(model, ("prefill_batch",),
                     "prefill_chunk_tokens=0")
        own_weights = not chunk or self.decode_mode == "eager"
        model_dev = getattr(model, "device", None)
        if own_weights and model_dev is not None \
                and torch.device(model_dev) != self.device:
            raise ValueError(
                f"the model's weights are on {model_dev} and the engine on "
                f"{self.device}: the eager decode and the one-shot prefill "
                f"run on the model's own weights")

    # --------------------------- client API -------------------------
    def submit(self, prompt, max_new_tokens=None, sampling=None,
               stop_tokens=(), timeout_ms=None, handle=None):
        """Enqueue one prompt; returns a GenerationHandle immediately.
        Raises ServerBusyError (queue full) / RequestTooLargeError
        (prompt can never fit) synchronously."""
        if self._closed:
            raise ServingError("generation engine is shut down")
        if max_new_tokens is None:
            max_new_tokens = self.config.default_max_new_tokens
        if sampling is None:
            sampling = SamplingParams()
        timeout_ms = (self.config.default_timeout_ms
                      if timeout_ms is None else timeout_ms)
        deadline = (None if timeout_ms is None
                    else time.monotonic() + float(timeout_ms) / 1e3)
        max_pos = getattr(self.model, "max_positions", None)
        if max_pos is not None and len(prompt) + max_new_tokens > max_pos:
            raise RequestTooLargeError(
                f"prompt of {len(prompt)} + max_new_tokens="
                f"{max_new_tokens} exceeds the model's max_positions="
                f"{max_pos}")
        if handle is None:
            handle = GenerationHandle()
        if handle.submitted_s is None:
            handle.submitted_s = time.monotonic()
        req = GenerationRequest(prompt, handle, sampling,
                                max_new_tokens=max_new_tokens,
                                stop_tokens=stop_tokens, deadline=deadline)
        self.scheduler.submit(req)
        self.metrics.count_request()
        return handle

    def generate(self, prompt, **kw):
        """Blocking convenience: submit + result."""
        return self.submit(prompt, **kw).result()

    # --------------------------- page service -----------------------
    def export_prefix_pages(self, tokens):
        """The longest fully cached page run matching a prefix of
        `tokens`, as ``{"tokens": covered tokens, "k": ..., "v": ...}``
        (plus ``"k_scale"``, ``"v_scale"`` for an int8 pool; host tensors
        in the canonical ``[L, n, page_size, H, D]`` layout) for another
        engine's import_prefix_pages; None when nothing is cached or the
        prefix cache is off.  Each export counts as demand in the
        eviction order."""
        with self._lock:
            if not self.prefix_cache_enabled:
                return None
            pages, matched = self.cache.match_prefix_full(tokens)
            if not pages:
                return None
            self.cache.note_fleet_demand(pages)
            out = self.cache.export_pages(pages)
            payload = {"tokens": [int(t) for t in tokens[:matched]],
                       "k": out[0], "v": out[1]}
            if len(out) == 4:   # int8: the grid travels with the bytes
                payload["k_scale"], payload["v_scale"] = out[2], out[3]
            return payload

    def import_prefix_pages(self, payload):
        """Adopt an exported prefix run into this engine's pool and
        prefix index (a read-only cached resident, copied on write like
        any locally registered run).  Returns the pages newly indexed: 0
        when skipped (cache off, pool pressure, or a payload this pool
        cannot take, such as int8 pages into a float pool): adoption is
        an optimization and never fails a request."""
        with self._lock:
            if not self.prefix_cache_enabled or payload is None:
                return 0
            try:
                return self.cache.import_prefix_run(
                    payload["tokens"], payload["k"], payload["v"],
                    payload.get("k_scale"), payload.get("v_scale"))
            except (OutOfPagesError, ValueError):
                # KVQuantMismatchError is a ValueError
                return 0

    def stats(self):
        """generation.* metrics snapshot + live cache stats."""
        snap = self.metrics.snapshot()
        snap.update({"cache." + k: v for k, v in self.cache.stats().items()})
        return snap

    # -------------------------- fleet hooks -------------------------
    # The fleet tier (serving/fleet.py) drains, migrates and hands off
    # through these.  Every one runs under the step lock: no token can
    # land on, and no page be evicted from, state in flight.  Snapshots
    # carry page bytes as host tensors (export_pages), never device
    # tensors, so they pickle across a process boundary as they are.

    def evacuate(self, include_active=False):
        """Extract unfinished work for a fleet drain: every request not
        yet placed (admission queue and the pending re-prefill line),
        plus with `include_active` every slot holder, retired here
        (slot and pages freed) WITHOUT resolving its handle.  Returns
        ``[(GenerationRequest, n_emitted)]``; the caller resubmits each
        (sampling is seeded per request, so a cold resubmit replays the
        identical stream and a relay handle skips the first `n_emitted`
        tokens).  Expired requests are reaped with the typed deadline
        error instead."""
        with self._lock:
            out = self.scheduler.take_pending()
            if include_active:
                for state in self.scheduler.active():
                    self.scheduler.retire(state)
                    if state.request.expired():
                        state.request.reject_expired()
                        self.metrics.count_rejected_deadline()
                        continue
                    out.append((state.request, state.n_generated))
            return out

    def evacuate_for_migration(self):
        """The live-migration drain: what evacuate() moves, but decode-
        phase residents leave as SEQUENCE SNAPSHOTS (page bytes and
        decode state) for ``import_sequence`` on a sibling.  Returns
        ``(cold, live)``: `cold` is evacuate()'s list (queued work and
        mid-prefill slot holders), `live` the snapshots, each carrying
        the client handle under "future".  Snapshots already parked for
        a prefill/decode handoff ride the live list unchanged."""
        with self._lock:
            cold = self.scheduler.take_pending()
            live, self._handoff_out = self._handoff_out, []
            for state in self.scheduler.active():
                if state.request.expired():
                    self.scheduler.retire(state)
                    state.request.reject_expired()
                    self.metrics.count_rejected_deadline()
                    continue
                if state.prefilling or not self.cache.has(state.seq_id):
                    self.scheduler.retire(state)
                    cold.append((state.request, state.n_generated))
                    continue
                live.append(self._export_sequence(state))
            return cold, live

    def _export_sequence(self, state):
        """Snapshot one decode-phase resident (page bytes first, then
        retire, which frees the pages): tokens so far, the generated
        count, the sampling stream ``(seed, counter)`` — the stream
        position of a stochastic request — and the cache length the
        pages cover.  The handle is not resolved: the importer keeps
        pushing into it."""
        req = state.request
        length = self.cache.seq_len(state.seq_id)
        out = self.cache.export_pages(self.cache.page_table(state.seq_id))
        # an int8 pool exports (k, v, k_scale, v_scale): the grid
        # travels with the bytes
        k, v = out[0], out[1]
        k_scale, v_scale = (out[2], out[3]) if len(out) == 4 \
            else (None, None)
        snap = {
            "prompt": list(req.prompt),
            "max_new_tokens": int(req.max_new_tokens),
            "stop_tokens": tuple(req.stop_tokens),
            "sampling": req.params,
            "deadline": req.deadline,
            "tokens": list(state.tokens),
            "n_generated": int(state.n_generated),
            "preemptions": int(state.preemptions),
            "rng": SampleStream(state.rng.seed, state.rng.counter),
            "cache_len": int(length),
            "k": k, "v": v,
            "k_scale": k_scale, "v_scale": v_scale,
            "future": req.future,
        }
        self.scheduler.retire(state)
        return snap

    def import_sequence(self, snap, handle=None):
        """Live-migration import: install a sibling's exported resident
        — its page bytes into this pool (in place), its SequenceState
        (tokens, sampling stream, counters) into a free slot — so the
        step loop resumes its decode with ZERO replayed tokens.  True
        when adopted; False when this engine cannot hold it now (no free
        slot, the pool too full even after eviction, or an incompatible
        payload such as int8 pages for a float pool): the caller falls
        back to a cold resubmit, which is always correct."""
        if handle is None:
            handle = snap.get("future")
        with self._lock:
            if self._closed or self.scheduler.free_slots() == 0:
                return False
            try:
                # KVQuantMismatchError (a ValueError) lands here too
                pages = self.cache.import_pages(
                    snap["k"], snap["v"], snap.get("k_scale"),
                    snap.get("v_scale"))
            except (OutOfPagesError, ValueError):
                return False
            seq_id = None
            attached = False
            try:
                req = GenerationRequest(
                    snap["prompt"], handle, snap["sampling"],
                    max_new_tokens=snap["max_new_tokens"],
                    stop_tokens=snap["stop_tokens"],
                    deadline=snap.get("deadline"))
                state = SequenceState(self.scheduler.next_seq_id(), req)
                seq_id = state.seq_id
                self.cache.allocate(seq_id)
                self.cache.adopt_imported(seq_id, pages, snap["cache_len"])
                attached = True
                rng = snap["rng"]
                state.tokens = list(snap["tokens"])
                state.n_generated = int(snap["n_generated"])
                state.preemptions = int(snap["preemptions"])
                state.rng = SampleStream(rng.seed, rng.counter)
                state.prefilling = False
                state.prefill_pos = int(snap["cache_len"])
                self.scheduler.place_imported(state)
            except Exception:   # noqa: BLE001 — a poisoned snapshot or a
                # failure mid-install must not leak the imported pages
                # or strand a half-built resident: give everything back
                # and refuse (the caller's cold ladder)
                self._recover_failed_import(seq_id, attached, pages)
                return False
            self.metrics.count_request()
            return True

    def _recover_failed_import(self, seq_id, attached, pages):
        """Roll back a failed import_sequence so the pool stays whole:
        free the sequence when its table holds the pages, else route
        the ownerless pages through a throwaway adopter so the free
        list gets every one back."""
        try:
            if attached and seq_id is not None:
                self.cache.free(seq_id)
                return
            if seq_id is not None and self.cache.has(seq_id):
                self.cache.free(seq_id)
            if pages:
                rid = ("__import_recovery__", id(pages))
                self.cache.allocate(rid)
                self.cache.adopt_imported(
                    rid, pages, len(pages) * self.cache.page_size)
                self.cache.free(rid)
        except Exception:   # noqa: BLE001 — recovery is best effort;
            pass            # never mask the refusal with a new error

    def drain_work(self, migrate=True, live=True, timeout=60.0):
        """The drain both transport halves run (InprocTransport.drain and
        the worker's evacuate op): evacuate unfinished work and shut the
        engine down.  migrate=False lets residents finish first —
        stepping the engine here when no worker thread runs — and
        evacuates those that outlive `timeout` (live snapshots when
        `live`, cold resubmits otherwise), so a drain always ends.
        Returns ``(cold, live_snaps)``."""
        if migrate:
            if live:
                cold, live_snaps = self.evacuate_for_migration()
            else:
                cold, live_snaps = self.evacuate(include_active=True), []
        else:
            cold, live_snaps = self.evacuate(include_active=False), []
            deadline = time.monotonic() + float(timeout)
            while self.scheduler.active() \
                    or self.scheduler.pending_count():
                if time.monotonic() > deadline:
                    if live:
                        c2, l2 = self.evacuate_for_migration()
                    else:
                        c2, l2 = self.evacuate(include_active=True), []
                    cold += c2
                    live_snaps += l2
                    break
                if self._thread is not None and self._thread.is_alive():
                    time.sleep(0.005)
                else:
                    self.step()   # stepped mode: the drain drives them
        # handoff snapshots still parked leave with everything else (a
        # prefill engine's residents land here by construction)
        with self._lock:
            parked, self._handoff_out = self._handoff_out, []
        for snap in parked:
            if live:
                live_snaps.append(snap)
            else:
                req = GenerationRequest(
                    snap["prompt"], snap["future"], snap["sampling"],
                    max_new_tokens=snap["max_new_tokens"],
                    stop_tokens=snap["stop_tokens"],
                    deadline=snap.get("deadline"))
                cold.append((req, int(snap["n_generated"])))
        self.shutdown()
        return cold, live_snaps

    def describe(self):
        """Static replica facts the router's capacity filter needs
        without an RPC (the transport ``describe`` contract)."""
        cfg = self.config
        return {
            "page_size": cfg.page_size,
            "num_pages": cfg.num_pages,
            "max_positions": getattr(self.model, "max_positions", None),
            "default_max_new_tokens": cfg.default_max_new_tokens,
            # the denominator of the autoscaler's decode occupancy
            "max_decode_slots": cfg.max_decode_slots,
            "pid": os.getpid(),
            "device": str(self.device),
        }

    def load_info(self):
        """Live load facts for the router's least-loaded rung (the
        transport ``load_info`` contract; a subprocess replica sends
        them on every heartbeat)."""
        sched = self.scheduler
        return {
            "queue_depth": sched.pending_count(),
            "active": len(sched.active()),
            "pages_in_use": self.cache.pages_in_use,
            "num_pages": self.cache.num_pages,
            # parked handoffs are unfinished work: a prefill replica
            # with uncollected snapshots must not read as idle
            "idle": not (sched.active() or sched.pending_count()
                         or self._handoff_out),
        }

    # ------------------------ P/D handoff seam ------------------------
    def enable_handoff(self):
        """Make this a PREFILL-class engine: every sequence is parked the
        moment its prompt is consumed (exported like a live migration)
        instead of decoding here.  The owner drains take_handoffs() and
        places each snapshot on a decode-class sibling through
        import_sequence; `on_handoff`, called after each step that
        parked something and outside the step lock, is the wakeup."""
        self._handoff = True

    def _sweep_handoffs_locked(self):
        """Park every prefill-complete resident (under the step lock, at
        the end of step()): ready once its prefill is done and its first
        token sampled, so n_generated is the importer's resume base."""
        parked = False
        for state in self.scheduler.active():
            if state.prefilling or state.n_generated < 1:
                continue
            if state.request.expired():
                continue   # the next step's deadline reaper owns it
            if not self.cache.has(state.seq_id):
                continue
            self._handoff_out.append(self._export_sequence(state))
            parked = True
        return parked

    def take_handoffs(self):
        """Drain the parked prefill-complete snapshots (each carries the
        client handle under "future" and page bytes: the pool pages were
        freed at export, so a parked snapshot never holds pages)."""
        with self._lock:
            out, self._handoff_out = self._handoff_out, []
        return out

    def handoffs_pending(self):
        return bool(self._handoff_out)

    def cancel(self, handle):
        """Cancel the request owned by `handle` wherever it lives —
        admission queue, pending re-prefill line, or a live slot (slot
        and pages freed) — and resolve it with
        ``finish_reason="cancelled"`` and the tokens already streamed.
        False when the handle owns nothing here."""
        with self._lock:
            for state in self.scheduler.active():
                if state.handle is handle:
                    self.scheduler.retire(state)
                    req = state.request
                    handle._finish(GenerationResult(
                        state.tokens[len(req.prompt):], "cancelled",
                        len(req.prompt), state.preemptions))
                    self.metrics.count_finished()
                    return True
            item = self.scheduler.cancel_pending(handle)
            if item is not None:
                if isinstance(item, SequenceState):   # preempted
                    handle._finish(GenerationResult(
                        item.tokens[len(item.request.prompt):],
                        "cancelled", len(item.request.prompt),
                        item.preemptions))
                else:   # still queued, nothing generated
                    handle._finish(GenerationResult(
                        [], "cancelled", len(item.prompt), 0))
                self.metrics.count_finished()
                return True
            for i, snap in enumerate(self._handoff_out):
                if snap["future"] is handle:
                    # parked for a handoff but not yet collected: the
                    # snapshot holds bytes, not pages — drop it
                    del self._handoff_out[i]
                    handle._finish(GenerationResult(
                        snap["tokens"][len(snap["prompt"]):],
                        "cancelled", len(snap["prompt"]),
                        snap["preemptions"]))
                    self.metrics.count_finished()
                    return True
        return False

    # --------------------------- stepping ---------------------------
    def step(self):
        """One scheduler step: admit, prefill, and one decode step for
        every decode-ready sequence — on the ragged step, or on the
        legacy step (chunked or one-shot prefill).  Returns the number of
        sequences that advanced (0 == idle).  Thread-safe; the background
        worker uses exactly this.  A prefill-class engine parks its
        prefill-complete sequences at the end of the step and calls
        `on_handoff` after releasing the lock."""
        parked = False
        with self._lock:
            self._in_step = True
            try:
                if self._ragged is not None:
                    out = self._step_ragged()
                elif self.prefill_chunk_tokens:
                    out = self._step_chunked()
                else:
                    out = self._step_one_shot()
            finally:
                self._in_step = False
            if self._handoff:
                parked = self._sweep_handoffs_locked()
        self._step_seq += 1
        if parked and self.on_handoff is not None:
            # outside the step lock: the collector may take router or
            # transport locks of its own
            self.on_handoff()
        return out

    @property
    def step_seq(self):
        """Completed-step counter: the wedge watchdog's progress stamp
        (frozen while the step loop is blocked or idle)."""
        return self._step_seq

    @property
    def in_step(self):
        """True while a step holds the step lock (real work, possibly a
        first-shape build or a loop capture)."""
        return self._in_step

    # ---------------------------- legacy step ------------------------
    def _step_one_shot(self):
        """One legacy step with one-shot prefill: admit and prefill (at
        most max_prefill_batch prompts, so queued prompts cannot starve
        the decode batch of a whole step), then one decode step."""
        admitted = self.scheduler.admit(limit=self.config.max_prefill_batch)
        self._prefill_admitted(admitted)
        self._reap_deadlines()
        active = self.scheduler.decode_ready()
        if not active:
            self._drain_kv_bytes()
            self._observe_occupancy()
            return 0
        with StepTimer() as timer:
            with RecordEvent("generation::decode_step"):
                active = self._ensure_step_capacity()
                if not active:
                    return 0
                self._decode_batch(active)
        self.metrics.observe_step(len(active), timer.seconds)
        self._observe_step_rows(len(active))
        self._drain_kv_bytes()
        self._observe_occupancy()
        return len(active)

    def _step_chunked(self):
        """One legacy chunked-prefill step: admit, a PACK of chunk calls
        (the oldest mid-prefill sequence's chunk first, then more
        prompts' chunks into the step token budget's leftover room — the
        ragged step's packing rule, one call per chunk here), plus the
        whole decode batch, every step.  The budget sizes the pack, never
        the oldest prompt's chunk: the head of the line always gets its
        whole chunk."""
        self.scheduler.admit(limit=self.config.max_prefill_batch)
        self._reap_deadlines()
        room = max(self.step_token_budget
                   - len(self.scheduler.decode_ready()),
                   self.prefill_chunk_tokens)
        pack = self.scheduler.plan_pack(
            self.prefill_chunk_tokens, room=room,
            max_seqs=None if self.config.prefill_pack else 1)
        advanced = 0
        chunk_u = chunk_d = chunk_calls = chunk_syncs = 0
        for state, n in pack:
            if state.slot is None or not state.prefilling:
                continue  # preempted by an earlier pack reservation
            if self._prefill_chunk_step(state, n):
                advanced += 1
                chunk_u += self._chunk_step.last_rows_useful
                chunk_d += self._chunk_step.last_rows_dispatched
                chunk_calls += 1
                if not state.prefilling:
                    chunk_syncs += 1  # final chunk: logits fetched
        decoding = self.scheduler.decode_ready()
        if decoding:
            with StepTimer() as timer:
                with RecordEvent("generation::decode_step"):
                    decoding = self._ensure_step_capacity()
                    if decoding:
                        self._decode_batch(decoding)
            if decoding:
                self.metrics.observe_step(len(decoding), timer.seconds)
                advanced += len(decoding)
        if chunk_calls:
            # the step issued a call per packed chunk besides the decode
            # call: the dispatch gauge says so; a chunk-only step is the
            # pack's calls and its final chunks' logits fetches
            if decoding:
                self.metrics.count_step_extra_dispatches(chunk_calls)
            else:
                self.metrics.observe_decode_step(chunk_calls, chunk_syncs,
                                                 2 * chunk_calls)
        self._observe_step_rows(len(decoding), chunk_u, chunk_d)
        self._drain_kv_bytes()
        self._observe_occupancy()
        return advanced

    def _observe_step_rows(self, decode_rows, chunk_useful=0,
                           chunk_dispatched=0):
        """The legacy step's row accounting: the decode call's useful and
        padded rows — the fused step's dummy rows are exactly the masked
        work padded_token_waste counts; the eager path pads nothing —
        plus the chunk calls' rows."""
        if self._fused is not None and decode_rows:
            useful = self._fused.last_rows_useful
            dispatched = self._fused.last_rows_dispatched
        else:
            useful = dispatched = decode_rows
        useful += chunk_useful
        dispatched += chunk_dispatched
        if dispatched:
            self.metrics.observe_step_rows(useful, dispatched,
                                           dispatched - useful)

    def _decode_batch(self, active):
        """One decode step (fused or eager) + sampling for `active`."""
        if self._fused is not None:
            all_greedy, out = self._decode_fused(active)
            if all_greedy:
                self._apply_tokens(active, out)
            else:
                self._apply_logits_batch(active, out)
        else:
            self._apply_logits_batch(active, self._decode(active))

    def _decode_inputs(self, active):
        """Reserve this step's token per sequence and batch the step
        inputs (page tables and lengths cannot change within the step:
        every page it touches was just reserved)."""
        seq_ids = [s.seq_id for s in active]
        tokens, positions = self._reserve_decode_rows(active)
        pt, lens = self.cache.gather_block_tables(seq_ids)
        return seq_ids, tokens, positions, pt, lens

    def _decode(self, active):
        """The eager decode: the model's per-layer attend callback writes
        the step's K/V into the pools and runs paged decode attention
        (the kernel on the card).  Two calls per layer, one host sync."""
        seq_ids, tokens, positions, pt, lens = self._decode_inputs(active)
        pt_dev = torch.as_tensor(pt, device=self.device)
        lens_dev = torch.as_tensor(lens, device=self.device)
        layout = self.cache.pool_layout

        def attend(layer, q, k_new, v_new):
            self.cache.write_decode_tokens(seq_ids, positions, layer,
                                           k_new, v_new)
            k_pool, v_pool = self.cache.layer_pools(layer)
            k_scale, v_scale = self.cache.layer_scales(layer)
            return paged_decode_attention(q, k_pool, v_pool, pt_dev,
                                          lens_dev, layout=layout,
                                          k_scale=k_scale, v_scale=v_scale)

        logits = self.model.decode(tokens, positions, attend)
        logits = logits.cpu().numpy()        # the [B, V] logits fetch
        # uploads: tables, lengths, tokens, positions, and each layer's
        # write targets (pages, rows)
        layers = self.cache.num_layers
        self.metrics.observe_decode_step(2 * layers, 1, 4 + 2 * layers)
        return logits

    def _decode_fused(self, active):
        """One fused call for the whole step: returns ``(all_greedy,
        out)`` where `out` is [B] token ids when every request is greedy
        (argmax ran on the device) else the [B, V] logits block."""
        _, tokens, positions, pt, lens = self._decode_inputs(active)
        all_greedy = all(s.request.params.greedy for s in active)
        out = self._fused.step(tokens, positions, pt, lens, all_greedy)
        # the scatter ran inside the call; keep the O(tokens) write bound
        # visible in kv_bytes_moved (comparable across paths)
        self.cache.count_fused_append(len(active))
        self.metrics.observe_decode_step(self._fused.last_dispatches,
                                         self._fused.last_syncs,
                                         self._fused.last_uploads)
        return all_greedy, out

    # -------------------------- one-shot prefill ---------------------
    def _prefill_admitted(self, states):
        """Prefill newly admitted sequences in one shot, batched: group
        by padded-length bucket, then one `prefill_batch` call per group
        of <= max_prefill_batch prompts.  WARM sequences (a prefix hit
        advanced prefill_pos at admission) cannot take the one-shot
        call, which starts at token 0: they take the suffix path."""
        for state in [s for s in states if s.prefill_pos > 0]:
            self._prefill_suffix(state)
        groups = {}
        for state in [s for s in states if s.prefill_pos == 0]:
            # the menu covers every sequence the pool and the model's
            # positions can hold, a preempted one's generated tokens too
            bucket = self._bucketer.length_bucket(len(state.tokens))
            groups.setdefault(bucket, []).append(state)
        size = self.config.max_prefill_batch
        for bucket in sorted(groups):
            group = groups[bucket]
            for i in range(0, len(group), size):
                self._prefill_group(group[i:i + size])

    def _prefill_group(self, states):
        """One batched prefill: reserve every span, pad the prompts to
        the (batch, length) bucket, one model call, write the K/V spans
        (padding positions land in the sink page), and sample each
        sequence's first token from its own row."""
        ready = []
        for state in states:
            try:
                start = self.cache.reserve(state.seq_id, len(state.tokens))
            except OutOfPagesError as e:
                # a lone sequence that outgrew the whole pool
                self.scheduler.retire(state)
                state.handle.set_exception(e)
                continue
            ready.append((state, start))
        if not ready:
            return
        with RecordEvent("generation::prefill"):
            tokens, lengths = self._bucketer.pad_token_batch(
                [state.tokens for state, _ in ready])
            b_real = len(ready)
            # padded batch rows prefill a 1-token dummy; their K/V and
            # logits are discarded
            lengths_padded = np.ones((tokens.shape[0],), np.int32)
            lengths_padded[:b_real] = lengths
            self._prefill_signatures.touch(tokens.shape)
            last_logits, k, v = self.model.prefill_batch(tokens,
                                                         lengths_padded)
            self.cache.write_prefill_batch(
                [state.seq_id for state, _ in ready],
                [start for _, start in ready], lengths, k[:b_real],
                v[:b_real])
        last_logits = last_logits[:b_real].cpu().numpy()   # one fetch
        for state, _ in ready:
            state.prefilling = False
            state.prefill_pos = len(state.tokens)
            self.metrics.count_prefill(len(state.tokens))
            self._register_prefix(state)
        # a prefill's last-position logits ARE the next-token logits
        self._apply_logits_batch([state for state, _ in ready],
                                 last_logits)

    def _prefill_suffix(self, state):
        """A warm one-shot prefill: positions [0, prefill_pos) are aliased
        cached pages (adopted at admission, zero bytes moved); only the
        suffix is computed, as one eager `prefill_chunk` call attending
        over the aliased prefix and the suffix through the page table.
        Its last-position logits are the next-token logits, as in a full
        prefill."""
        n = len(state.tokens) - state.prefill_pos
        try:
            # reserve may copy the clipped tail page on write (counted in
            # pages_needed); after it every written page is private
            start = self.cache.reserve(state.seq_id, n)
        except OutOfPagesError as e:
            self.scheduler.retire(state)
            state.handle.set_exception(e)
            return
        if start != state.prefill_pos:
            raise RuntimeError(
                f"cache length {start} diverged from the matched prefix "
                f"{state.prefill_pos} of sequence {state.seq_id}")
        with RecordEvent("generation::prefill"):
            logits_last = self._prefill_chunk_eager(
                state, state.tokens[start:], start)
        state.prefilling = False
        state.prefill_pos = len(state.tokens)
        self.metrics.count_prefill(n)
        self._register_prefix(state)
        self._on_logits(state, logits_last.cpu().numpy())

    def _prefill_chunk_eager(self, state, tokens, start):
        """The eager chunk path: the model projects the chunk, and the
        attend callback writes the layer's K/V span into the pools, then
        runs chunk-prefill attention over the sequence's page table (the
        hand-written kernel on the card, its plain version on the CPU).
        Returns the chunk's last-position logits on the device."""
        seq_id = state.seq_id
        n = len(tokens)
        layout = self.cache.pool_layout
        pt = torch.as_tensor(np.asarray(self.cache.page_table(seq_id),
                                        np.int32), device=self.device)

        def attend(layer, q, k_new, v_new):
            self.cache.write_prefill_tokens(seq_id, start, layer, k_new,
                                            v_new)
            k_pool, v_pool = self.cache.layer_pools(layer)
            k_scale, v_scale = self.cache.layer_scales(layer)
            return chunk_prefill_attention(q, k_pool, v_pool, pt, start,
                                           layout=layout, k_scale=k_scale,
                                           v_scale=v_scale)

        return self.model.prefill_chunk(np.asarray(tokens, np.int32), start,
                                        attend)

    def _register_prefix(self, state):
        """Index the completed prompt's full pages for future matches (a
        no-op with the prefix cache off).  At prefill COMPLETION, not
        retire, so concurrent requests sharing the prompt alias it while
        this sequence still decodes; only PROMPT tokens here, the decode
        tail at retire (_register_decode_tail)."""
        if self.prefix_cache_enabled:
            self.metrics.count_prefix_registered(self.cache.register_prefix(
                state.seq_id, state.tokens[:len(state.request.prompt)]))

    def _register_decode_tail(self, state):
        """At retire, extend the sequence's cached run over full pages of
        GENERATED tokens too: a multi-turn client re-sending prompt +
        answer + new text then hits into the answer.  register_prefix
        clips to full pages and to the cache length, so the newest
        sampled token (never written) is excluded."""
        if self.prefix_cache_enabled and self.cache.has(state.seq_id):
            self.metrics.count_prefix_registered(
                self.cache.register_prefix(state.seq_id, state.tokens))

    # -------------------------- chunked prefill ----------------------
    def _prefill_chunk_step(self, state, n):
        """ONE legacy prefill chunk for `state`: reserve `n` tokens
        (preempting youngest-others on page shortage), one
        ChunkedPrefillStep call, and on the FINAL chunk sample the first
        token from the chunk's last-position logits (the only chunk
        logits ever fetched).  Returns True when the chunk ran."""
        start = self._reserve_chunk(state, n)
        if start is None:
            return False
        with RecordEvent("generation::prefill"):
            logits_last = self._chunk_step.run(
                state.seq_id, state.tokens[start:start + n], start)
            # the scatter ran inside the call; count its O(tokens) bound
            self.cache.count_fused_append(n)
        state.prefill_pos += n
        self.metrics.count_prefill(n)
        self.metrics.count_chunk()
        self._prewarm_decode(state)
        if state.prefill_pos == len(state.tokens):
            state.prefilling = False
            self._register_prefix(state)
            self._on_logits(state, logits_last.cpu().numpy())
        return True

    def prewarm_decode(self, batch_rows, pages_cols, greedy=True):
        """Record the fused decode's (batch, pages, greedy) signature
        without dispatching anything (counted under
        decode_compiles_prewarm).  Returns True when the signature was
        new.  False on every other decode path, and past the bucket
        menu."""
        if self._fused is None:
            return False
        try:
            new = self._fused.prewarm(batch_rows, pages_cols, greedy)
        except RequestTooLargeError:
            return False
        if new:
            self.metrics.count_decode_prewarm()
        return new

    def _prewarm_decode(self, state):
        """While `state` is mid-prefill, record the fused decode
        signature its first decode step will land in — at most once per
        prefill."""
        if self._fused is None or state.prewarmed or not state.prefilling:
            return
        state.prewarmed = True
        decoding = self.scheduler.decode_ready()
        pages = [len(self.cache.page_table(s.seq_id)) for s in decoding]
        pages.append(math.ceil((len(state.tokens) + 1)
                               / self.cache.page_size))
        greedy = (state.request.params.greedy
                  and all(s.request.params.greedy for s in decoding))
        self.prewarm_decode(len(decoding) + 1, max(pages), greedy)

    # ---------------------------- ragged step ------------------------

    def _step_ragged(self):
        """One RAGGED mixed-batch step.  Plans and reserves the chunks
        FIRST (a reservation may preempt youngest decode sequences —
        they drop out of the decode batch — or a YOUNGER pack member),
        then the decode capacity check (which may preempt chunkers —
        their rows drop out of the pack).  With speculation, the drafts
        are planned after the chunk pack, into the room the pack leaves.
        With the loop, a decode-only boundary whose rows all fit the
        loop's caps runs the loop instead of the single step."""
        admitted = self.scheduler.admit(limit=self.config.max_prefill_batch)
        if not self.prefill_chunk_tokens:
            # no chunking: prompts take the one-shot prefill and only
            # decode rides the ragged step
            self._prefill_admitted(admitted)
        self._reap_deadlines()
        planned = []
        if self.prefill_chunk_tokens:
            room = (self.step_token_budget
                    - len(self.scheduler.decode_ready()))
            planned = self.scheduler.plan_pack(
                self.prefill_chunk_tokens, room=room,
                max_seqs=(self._ragged.max_seqs if self.config.prefill_pack
                          else 1))
        # drafts fill only the room the chunk pack leaves: a prompt's
        # time to first token is not theirs to spend
        spec_plan = {}
        if self._spec is not None:
            spec_plan = self.scheduler.plan_spec(
                self._spec, self.spec_tokens,
                room=(self.step_token_budget
                      - len(self.scheduler.decode_ready())
                      - sum(n for _, n in planned)))
        pack = []  # [(state, n, start)] — reserved, still-alive chunks
        for state, n in planned:
            if state.slot is None or not state.prefilling:
                continue  # preempted by an earlier pack reservation
            start = self._reserve_chunk(state, n)
            if start is not None:
                pack.append((state, n, start))
        decoding = self.scheduler.decode_ready()
        if decoding:
            decoding = self._ensure_step_capacity()
        pack = [(s, n, st) for s, n, st in pack
                if s.slot is not None and s.prefilling]
        if not decoding and not pack:
            self._drain_kv_bytes()
            self._observe_occupancy()
            return 0
        # the loop takes decode-only boundaries whose rows fit its caps; a
        # page shortfall inside _dispatch_loop rolls back and falls
        # through to the single step
        if (self._loop is not None and decoding and not pack
                and self._loop_ready(decoding)):
            with StepTimer() as timer:
                with RecordEvent("generation::loop_step"):
                    looped = self._dispatch_loop(decoding, spec_plan)
            if looped is not None:
                advanced, sampled = looped
                if sampled:
                    self.metrics.observe_step(sampled, timer.seconds)
                self._drain_kv_bytes()
                self._observe_occupancy()
                return advanced
        with StepTimer() as timer:
            with RecordEvent("generation::ragged_step"):
                advanced, sampled = self._dispatch_ragged(decoding, pack,
                                                          spec_plan)
        if sampled:
            self.metrics.observe_step(sampled, timer.seconds)
        self._drain_kv_bytes()
        self._observe_occupancy()
        return advanced

    def _dispatch_ragged(self, decoding, pack, spec_plan=None):
        """Pack, dispatch, sample: the decode batch's spans first (slot
        order: each committed token, then its drafts when it speculates),
        then each packed chunk's rows consecutively; descriptor i covers
        decode sequence i (len = 1 + drafts), descriptor B + j the pack's
        j-th chunk.  Returns ``(advanced, sampled)``, `sampled` counting
        the tokens emitted."""
        b = len(decoding)
        d_tokens, positions = self._reserve_decode_rows(decoding)
        # a drafting row's reservation grows past its decode token; the
        # capacity check vouched for one token per row only, so a row
        # whose drafts find no page just drops them — speculation never
        # preempts and never fails a request over pages
        spec_rows = {}
        for i, s in enumerate(decoding):
            drafts = (spec_plan or {}).get(s.seq_id)
            if not drafts:
                continue
            try:
                self.cache.reserve(s.seq_id, len(drafts))
            except OutOfPagesError:
                continue
            if self.prefix_cache_enabled:
                # the draft span's COW guard, as the decode rows' in
                # _reserve_decode_rows (reserve just privatized any shared
                # tail page)
                self.cache.check_span_writable(
                    s.seq_id, int(positions[i]) + 1, len(drafts))
            spec_rows[i] = drafts
        tokens, desc_ids, spans = [], [], []  # spans: (first position, rows)
        for i, s in enumerate(decoding):
            drafts = spec_rows.get(i, ())
            tokens.append(int(d_tokens[i]))
            tokens += drafts
            spans.append((int(positions[i]), 1 + len(drafts)))
            desc_ids.append(s.seq_id)
        for state, n, start in pack:
            # the in-step scatter must never land in a shared page
            self.cache.check_span_writable(state.seq_id, start, n)
            tokens += state.tokens[start:start + n]
            spans.append((start, n))
            desc_ids.append(state.seq_id)
        # kv_lens straight off the cache (a decode row's length includes
        # its reserved token, a chunk's its whole span); pt row j IS
        # descriptor j's table
        pt, kv_lens = self.cache.gather_block_tables(desc_ids)
        t_real = len(tokens)
        ps = self.cache.page_size
        lens = np.asarray([n for _, n in spans], np.int32)
        span_pos0 = np.asarray([start for start, _ in spans], np.int32)
        starts = np.zeros((len(spans),), np.int32)
        np.cumsum(lens[:-1], out=starts[1:])
        pos_all = (np.repeat(span_pos0, lens)
                   + np.arange(t_real, dtype=np.int32)
                   - np.repeat(starts, lens)).astype(np.int32)
        desc_of_row = np.repeat(np.arange(len(spans), dtype=np.int32), lens)
        pages = pt[desc_of_row, pos_all // ps]
        rows = pos_all % ps
        ids_dev, logits_dev = self._ragged.step(
            np.asarray(tokens, np.int32), pos_all, pages, rows, pt, starts,
            lens, kv_lens)
        self.cache.count_fused_append(t_real)
        finishing = []  # [(state, descriptor index)]
        for j, (state, n, start) in enumerate(pack):
            state.prefill_pos += n
            self.metrics.count_prefill(n)
            self.metrics.count_chunk()
            if state.prefill_pos == len(state.tokens):
                state.prefilling = False
                self._register_prefix(state)
                finishing.append((state, b + j))
        # samplers: every decode row, plus each chunk that just completed
        # its prompt (those logits ARE the first-token logits).  A
        # mid-prompt chunk-only step fetches nothing.
        if self._spec is not None:
            sampled, syncs = self._apply_ragged_spec(
                decoding, spec_rows, finishing, ids_dev, logits_dev)
        else:
            sampled, syncs = self._apply_ragged(decoding, finishing,
                                                ids_dev, logits_dev)
        self.metrics.observe_decode_step(self._ragged.last_dispatches,
                                         syncs, self._ragged.last_uploads)
        # zero padded_token_waste by construction: descriptors cover
        # exactly the packed rows; the fixed axis's inert slots are
        # reported by step_row_utilization
        self.metrics.observe_step_rows(self._ragged.last_rows_useful,
                                       self._ragged.last_rows_dispatched, 0)
        self.metrics.count_score_blocks(
            self._ragged.last_score_blocks,
            self._ragged.last_score_blocks_untiled)
        return b + len(pack), sampled

    def _apply_ragged(self, decoding, finishing, ids_dev, logits_dev):
        """The plain step's sampling: ONE fetch, the ids when every
        sampler is greedy, else the logits.  Returns ``(tokens sampled,
        syncs)``."""
        samplers = list(decoding) + [s for s, _ in finishing]
        if not samplers:
            return 0, 0
        rows_idx = list(range(len(decoding))) + [di for _, di in finishing]
        if all(s.request.params.greedy for s in samplers):
            ids_h = ids_dev.cpu().numpy()        # the single host sync
            self._apply_tokens(samplers, ids_h[rows_idx])
        else:
            logits_h = logits_dev.cpu().numpy()  # the single host sync
            self._apply_logits_batch(samplers, logits_h[rows_idx])
        return len(samplers), 1

    def _apply_ragged_spec(self, decoding, spec_rows, finishing, ints_dev,
                           aug_dev):
        """The speculative step's sampling, still ONE fetch: the [S, 3]
        ints (last-row argmax, accepted count, bonus) when every sampler
        is greedy, else the [S, V + 3] augmented logits.  Then per
        descriptor one of: the accepted drafts and the bonus (drafting
        rows), the last-row argmax (other greedy rows and finishing
        greedy chunks), or host sampling from the logits columns
        (stochastic rows, batched).  Returns ``(tokens emitted,
        syncs)``."""
        b = len(decoding)
        samplers = [(s, i) for i, s in enumerate(decoding)]
        samplers += list(finishing)
        if not samplers:
            return 0, 0
        vocab = int(self.model.vocab_size)
        if all(s.request.params.greedy for s, _ in samplers):
            ints = ints_dev.cpu().numpy()        # the single host sync
            logits_h = None
        else:
            aug = aug_dev.cpu().numpy()          # the single host sync
            logits_h = aug[:, :vocab]
            # the appended int columns are exact in float32
            ints = aug[:, vocab:].astype(np.int64)
        ids_col, acc_col, bonus_col = ints[:, 0], ints[:, 1], ints[:, 2]
        emitted = 0
        stoch = []   # (state, descriptor): one batched host sample
        for s, di in samplers:
            if not s.request.params.greedy:
                stoch.append((s, di))
                continue
            drafts = spec_rows.get(di) if di < b else None
            if drafts:
                emitted += self._apply_spec_row(
                    s, drafts, int(acc_col[di]), int(bonus_col[di]))
            elif s.n_generated >= s.request.max_new_tokens:
                self._finish(s, "length")
            else:
                self._apply_token(s, int(ids_col[di]))
                emitted += 1
        if stoch:
            self._apply_logits_batch([s for s, _ in stoch],
                                     logits_h[[di for _, di in stoch]])
            emitted += len(stoch)
        return emitted, 1

    def _apply_spec_row(self, state, drafts, accepted, bonus):
        """Retire one drafting row's verified tokens.  The cache is
        truncated FIRST, so the rejected tail leaves before any token
        streams (a stop or length finish in the loop below frees the
        pages wholesale and can never race the rewind) and a surviving
        row holds exactly ``len(tokens) - 1`` resident positions.  The
        accepted drafts and the bonus then stream one at a time through
        `_apply_token`, so stop tokens, stop sequences and max_new_tokens
        clip exactly where plain decode would.  Returns tokens
        emitted."""
        accepted = max(0, min(int(accepted), len(drafts)))
        rewound = len(drafts) - accepted
        if rewound:
            self.cache.truncate(state.seq_id,
                                self.cache.seq_len(state.seq_id) - rewound)
        self.metrics.count_spec(len(drafts), accepted, rewound)
        emitted = 0
        for tok in list(drafts[:accepted]) + [int(bonus)]:
            if state.slot is None:
                break   # a stop or length finish retired the row
            before = state.n_generated
            self._apply_token(state, int(tok))
            emitted += state.n_generated - before
        return emitted

    # ------------------------ host-free decode loop -------------------
    def _loop_ready(self, decoding):
        """Whether every row of this decode-only boundary fits the loop:
        a token left to generate, stop conditions within the loop's fixed
        caps (a row past them would lose its stops), and position
        headroom for the loop's whole write horizon.  One misfit sends
        the whole boundary down the single step."""
        lp = self._loop
        horizon = lp.loop_steps + lp.spec_tokens
        limit = int(self.model.max_positions) - 1
        for s in decoding:
            req = s.request
            p = req.params
            if (req.max_new_tokens - s.n_generated < 1
                    or len(req.stop_tokens) > lp.max_stop_ids
                    or len(p.stop_sequences) > lp.max_stop_seqs
                    or p.max_stop_len > lp.max_stop_len
                    or len(s.tokens) - 1 + horizon > limit):
                return False
        return True

    def _dispatch_loop(self, decoding, spec_plan):
        """One loop call: N decode iterations with on-device sampling and
        stop matching, ONE host fetch.  Reserves each row's whole write
        horizon first (N plus its drafts); a shortfall rolls every
        reservation back and returns None, and the caller takes the
        single step.  After the fetch each row truncates to its final
        position FIRST (resident == len(tokens) - 1, the decode
        invariant), then its tokens stream through `_apply_token` (the
        device ran the same gate order, so the re-check changes
        nothing), and its SampleStream counter takes the device's value.
        Returns ``(rows advanced, tokens emitted)``."""
        lp = self._loop
        n_steps, kk = lp.loop_steps, lp.spec_tokens
        b = len(decoding)
        drafts = np.zeros((b, max(kk, 1)), np.int32)
        dlens = np.zeros((b,), np.int32)
        for i, s in enumerate(decoding):
            d = list((spec_plan or {}).get(s.seq_id, ()))[:kk]
            drafts[i, :len(d)] = d
            dlens[i] = len(d)
        reserved = []   # rollback ledger: (seq_id, length before)
        for i, s in enumerate(decoding):
            need = n_steps + int(dlens[i])
            try:
                p0 = self.cache.reserve(s.seq_id, need)
            except OutOfPagesError:
                for sid, back in reserved:
                    self.cache.truncate(sid, back)
                return None
            reserved.append((s.seq_id, p0))
            if self.prefix_cache_enabled:
                # the COW guard over the whole horizon (reserve just
                # privatized any shared tail page)
                self.cache.check_span_writable(s.seq_id, p0, need)
        pt, _ = self.cache.gather_block_tables([s.seq_id for s in decoding])
        ms, ns, ls = lp.max_stop_ids, lp.max_stop_seqs, lp.max_stop_len
        cur_tok = np.asarray([s.tokens[-1] for s in decoding], np.int32)
        cur_pos = np.asarray([p0 for _, p0 in reserved], np.int32)
        temps = np.zeros((b,), np.float32)
        top_ks = np.zeros((b,), np.int32)
        top_ps = np.ones((b,), np.float32)
        seeds = np.zeros((b,), np.int32)
        counters = np.zeros((b,), np.int32)
        remaining = np.zeros((b,), np.int32)
        stop_ids = np.full((b, ms), -1, np.int32)
        stop_seqs = np.full((b, ns, ls), -1, np.int32)
        stop_seq_lens = np.zeros((b, ns), np.int32)
        tail = np.full((b, ls - 1), -1, np.int32)
        for i, s in enumerate(decoding):
            req = s.request
            p = req.params
            temps[i] = p.temperature
            top_ks[i] = p.top_k or 0
            top_ps[i] = 1.0 if p.top_p is None else p.top_p
            # uint32 stream state carried as the int32 of the same bits
            seeds[i] = np.uint32(s.rng.seed).view(np.int32)
            counters[i] = np.uint32(s.rng.counter).view(np.int32)
            remaining[i] = req.max_new_tokens - s.n_generated
            st = list(req.stop_tokens)
            stop_ids[i, :len(st)] = st
            for j, sq in enumerate(p.stop_sequences):
                stop_seqs[i, j, ls - len(sq):] = sq
                stop_seq_lens[i, j] = len(sq)
            take = min(s.n_generated, ls - 1)
            if take:
                tail[i, ls - 1 - take:] = s.tokens[len(s.tokens) - take:]
        res = lp.step(cur_tok, cur_pos, pt, temps, top_ks, top_ps, seeds,
                      counters, remaining, stop_ids, stop_seqs,
                      stop_seq_lens, tail, drafts, dlens)
        iters = lp.last_iters
        sampled = wasted = writes = 0
        for i, s in enumerate(decoding):
            row = res[i]
            ne, fin, fin_it, final_pos, ctr = (
                int(v) for v in row[n_steps + kk:n_steps + kk + 5])
            s.rng.counter = ctr & 0xFFFFFFFF
            emitted = [int(t) for t in row[:ne]]
            if dlens[i]:
                # the bonus differs from the draft it replaces, so the
                # emitted stream's common prefix with the drafts is the
                # accepted count (short only when a stop clips mid-draft)
                acc = 0
                for j in range(min(int(dlens[i]), len(emitted))):
                    if emitted[j] != int(drafts[i, j]):
                        break
                    acc += 1
                self.metrics.count_spec(int(dlens[i]), acc,
                                        int(dlens[i]) - acc)
            # iterations this row decoded in, against those it sat
            # finished while the batch ran on
            active_iters = (fin_it + 1) if fin else iters
            writes += active_iters + int(dlens[i])
            if fin:
                wasted += iters - active_iters
            self.cache.truncate(s.seq_id, final_pos)
            for tok in emitted:
                if s.slot is None:
                    break
                self._apply_token(s, tok)
            sampled += len(emitted)
            if s.slot is not None and fin == 1:
                # the device withheld the stop-completing token, as the
                # host gate does; the row finishes here
                self._finish(s, "stop")
        self.cache.count_fused_append(writes)
        self.metrics.observe_decode_step(lp.last_dispatches, lp.last_syncs,
                                         lp.last_uploads)
        self.metrics.observe_loop(sampled, lp.last_syncs, iters < n_steps,
                                  wasted)
        self.metrics.observe_step_rows(lp.last_rows_useful,
                                       lp.last_rows_dispatched, 0)
        return b, sampled

    def run_until_idle(self, max_steps=100000):
        """Drive step() until queue+slots drain (tests/benchmarks)."""
        steps = 0
        while self.scheduler.active() or self.scheduler.pending_count():
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"not idle after {max_steps} steps")
        return steps

    # --------------------------- internals --------------------------
    def _reserve_chunk(self, state, n):
        """Grow `state`'s reservation by its next `n` chunk tokens,
        preempting youngest-others on page shortage (never the chunker
        itself).  Returns the span start, or None after a typed failure
        retired the sequence (the pool cannot hold its prefix alone)."""
        while True:
            try:
                start = self.cache.reserve(state.seq_id, n)
                break
            except OutOfPagesError as e:
                victim = self.scheduler.preempt_youngest(exclude=state)
                if victim is not None:
                    self.metrics.count_preempted()
                    continue
                self.scheduler.retire(state)
                state.handle.set_exception(e)
                return None
        if start != state.prefill_pos:
            raise RuntimeError(
                f"cache length {start} diverged from prefill progress "
                f"{state.prefill_pos} of sequence {state.seq_id}")
        return start

    def _reap_deadlines(self):
        now = time.monotonic()
        for state in self.scheduler.active():
            if state.request.expired(now):
                self.scheduler.retire(state)
                state.request.reject_expired()
                self.metrics.count_rejected_deadline()

    def _ensure_step_capacity(self):
        """Reserve-ability check for one token per decode-ready sequence;
        preempts youngest-first, ONE victim at a time with the shortfall
        recomputed after each.  Returns the surviving decode batch."""
        while True:
            active = self.scheduler.decode_ready()
            if not active:
                return active
            need = sum(self.cache.pages_needed(s.seq_id, 1) for s in active)
            if need <= self.cache.available_pages:
                return active
            victim = self.scheduler.preempt_youngest()
            if victim is not None:
                self.metrics.count_preempted()
                continue
            # a lone sequence the pool cannot grow: typed failure
            lone = active[0]
            self.scheduler.retire(lone)
            lone.handle.set_exception(OutOfPagesError(
                f"sequence of {len(lone.tokens)} tokens needs another "
                f"page and the pool ({self.cache.num_pages} pages of "
                f"{self.cache.page_size}) has none free even with every "
                f"other sequence preempted"))

    def _reserve_decode_rows(self, active):
        """Reserve this step's token per decode sequence; returns (last
        tokens, positions).  With the prefix cache on, each row's write
        target is checked private (reserve just copied any shared tail
        page): an in-step scatter must never land in a shared page."""
        positions = np.asarray(
            [self.cache.reserve(s.seq_id, 1) for s in active], np.int32)
        if self.prefix_cache_enabled:
            for s, pos in zip(active, positions):
                self.cache.check_span_writable(s.seq_id, int(pos), 1)
        tokens = np.asarray([s.tokens[-1] for s in active], np.int32)
        return tokens, positions

    def _apply_token(self, state, token):
        """Stream one sampled token and retire on stop/length.  Stop
        conditions are checked BEFORE the token is appended: a stop token,
        or a token that would complete a stop sequence, is withheld."""
        req = state.request
        if token in req.stop_tokens:
            self._finish(state, "stop")
            return
        window = req.params.max_stop_len
        if window:
            take = min(state.n_generated, window - 1)
            tail = (state.tokens[len(state.tokens) - take:] if take
                    else []) + [token]
            for seq in req.params.stop_sequences:
                if len(tail) >= len(seq) \
                        and tuple(tail[len(tail) - len(seq):]) == seq:
                    self._finish(state, "stop")
                    return
        state.tokens.append(token)
        state.n_generated += 1
        state.handle._push_token(token)
        self.metrics.count_token()
        if state.n_generated >= req.max_new_tokens:
            self._finish(state, "length")

    def _on_logits(self, state, logits_row):
        """Sample `state`'s next token from one [V] host logits row and
        apply it (the per-row path of the one-shot and chunked
        prefills)."""
        req = state.request
        if state.n_generated >= req.max_new_tokens:
            self._finish(state, "length")
            return
        with RecordEvent("generation::sample"):
            token = sample_token(logits_row, req.params, state.rng)
        self._apply_token(state, token)

    def _apply_logits_batch(self, states, logits):
        """Sample + apply one token per row of a [B, V] host logits
        block (greedy rows share one argmax; stochastic rows draw from
        their own streams)."""
        live = []
        for i, state in enumerate(states):
            # length-finish before sampling (max_new_tokens == 0 lands
            # here straight from the final prefill chunk)
            if state.n_generated >= state.request.max_new_tokens:
                self._finish(state, "length")
            else:
                live.append((i, state))
        if not live:
            return
        with RecordEvent("generation::sample"):
            tokens = sample_tokens_batch(
                logits[[i for i, _ in live]],
                [s.request.params for _, s in live],
                [s.rng for _, s in live])
        for (_, state), token in zip(live, tokens):
            self._apply_token(state, token)

    def _apply_tokens(self, states, tokens):
        """Apply argmax token ids computed on the device."""
        for state, token in zip(states, tokens):
            if state.n_generated >= state.request.max_new_tokens:
                self._finish(state, "length")
                continue
            self._apply_token(state, int(token))

    def _finish(self, state, reason):
        self._register_decode_tail(state)
        self.scheduler.retire(state)
        req = state.request
        state.handle._finish(GenerationResult(
            state.tokens[len(req.prompt):], reason, len(req.prompt),
            state.preemptions))
        self.metrics.count_finished()

    def _drain_kv_bytes(self):
        """The cache's byte counters into generation.* once per step: the
        bytes moved (scales included), and for int8 pools the scale bytes
        apart."""
        self.metrics.count_kv_bytes(self.cache.take_bytes_moved())
        if self.kv_quant:
            self.metrics.count_kv_scale_bytes(self.cache.take_scale_bytes())

    def _observe_occupancy(self):
        self.metrics.observe_occupancy(
            len(self.scheduler.active()), self.scheduler.num_slots,
            self.cache.utilization())
        # the prefix cache's shared-page gauge and the cache's COW and
        # eviction counters, drained like the byte counters
        if self.prefix_cache_enabled:
            cow, evictions = self.cache.take_prefix_counters()
            self.metrics.count_cow(cow)
            self.metrics.count_prefix_evictions(evictions)
            self.metrics.observe_shared_pages(self.cache.shared_pages)

    # --------------------------- lifecycle --------------------------
    def start(self):
        """Start the background stepping worker (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._worker, name="generation-engine", daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                advanced = self.step()
            except Exception as e:  # noqa: BLE001 — a poisoned step must
                # not strand clients on a dead worker: the batch fails as
                # a unit and the loop keeps draining the queue
                with self._lock:
                    for state in self.scheduler.active():
                        self.scheduler.retire(state)
                        state.handle.set_exception(e)
                continue
            if advanced == 0 and not self.scheduler.pending_count():
                time.sleep(self._IDLE_POLL_S)

    def shutdown(self, timeout=5.0):
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        # under the step lock: a step outliving the join must finish
        # before its pages are freed
        with self._lock:
            for state in self.scheduler.active():
                self.scheduler.retire(state)
                state.handle.set_exception(ServingError(
                    "generation engine shut down mid-decode"))
            if self._loop is not None:
                self._loop.release()
        self.scheduler.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
