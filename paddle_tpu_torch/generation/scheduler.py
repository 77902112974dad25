"""Continuous-batching scheduler: prefill/decode split over fixed slots.

A fixed set of decode SLOTS; sequences join and leave every step:

    submit() -> AdmissionQueue -> [pending] -> slot: PREFILL -> DECODE
                 (bounded, typed busy/         (page capacity   -> retire:
                  deadline rejection)           gated)             free pages
                                   preempt (pages exhausted): pages freed,
                                   sequence re-queued for RE-PREFILL

Preemption is recompute-style: the victim's pages return to the pool and
its tokens-so-far become a new prefill when capacity returns.  Sampling
state is per request (a seeded counter stream), so a preempted sequence
resumes token-identically — preemption changes WHEN tokens are computed,
never WHICH.  With the prefix cache on, admission aliases the longest
cached page run of a sequence's tokens and its prefill resumes after it,
so a preempted sequence whose prompt pages stayed cached resumes warm.
"""
import collections
import math

from ..serving.admission import (AdmissionQueue, DeadlineExceededError,
                                 Request, RequestTooLargeError, ServingError)
from .kv_cache import OutOfPagesError, UnknownSequenceError


class GenerationRequest(Request):
    """One generation request riding the serving AdmissionQueue; `future`
    is the streaming GenerationHandle."""

    __slots__ = ("prompt", "max_new_tokens", "stop_tokens", "params")

    def __init__(self, prompt, handle, params, max_new_tokens=16,
                 stop_tokens=(), deadline=None):
        super().__init__(list(prompt), 1, handle, deadline=deadline)
        self.prompt = [int(t) for t in prompt]
        if not self.prompt:
            raise ValueError("prompt must contain at least one token")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 0:
            raise ValueError(
                f"max_new_tokens must be >= 0, got {max_new_tokens}")
        self.stop_tokens = frozenset(int(t) for t in stop_tokens)
        self.params = params


class SequenceState:
    """One sequence occupying a decode slot (or awaiting re-admission
    after preemption).  `tokens` is prompt + everything sampled so far.
    `prefilling` / `prefill_pos` track the prefill->decode transition:
    chunked prefill advances `prefill_pos` one chunk per step, and only
    sequences with `prefilling == False` join the decode batch.
    `prewarmed` marks that the legacy step already recorded the decode
    signature this prefill will land in (once per prefill)."""

    __slots__ = ("seq_id", "request", "tokens", "n_generated", "rng",
                 "slot", "preemptions", "prefilling", "prefill_pos",
                 "prewarmed")

    def __init__(self, seq_id, request):
        self.seq_id = seq_id
        self.request = request
        self.tokens = list(request.prompt)
        self.n_generated = 0
        self.rng = request.params.make_rng()
        self.slot = None
        self.preemptions = 0
        self.prefilling = True
        self.prefill_pos = 0
        self.prewarmed = False

    @property
    def handle(self):
        return self.request.future


class ContinuousBatchingScheduler:
    """Owns the admission queue, the decode slots and the page-capacity
    admission gate.  The engine drives it: admit() -> prefill work,
    decode_ready() -> the decode batch, retire()/preempt_youngest() on
    exit paths."""

    def __init__(self, cache, num_slots=8, queue_depth=64, metrics=None,
                 prefix_cache=False):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.cache = cache
        self.num_slots = int(num_slots)
        self.queue = AdmissionQueue(queue_depth, metrics=metrics)
        self._metrics = metrics
        # prefix caching: admission aliases the longest cached page run of
        # every placed sequence (the engine sets this once it has resolved
        # its policy: a warm hit resumes prefill mid-prompt)
        self.prefix_cache = bool(prefix_cache)
        self.slots = [None] * self.num_slots
        # polled-but-not-yet-placed work: new requests waiting for pages,
        # and preempted SequenceStates waiting to re-prefill (these take
        # priority — they already consumed steps)
        self._pending = collections.deque()
        self._next_seq = 0

    # ------------------------- submission ---------------------------
    def submit(self, request):
        """Bounded admission; raises ServerBusyError when full and
        RequestTooLargeError when the prompt can never fit the pool."""
        need = self._pages_for(len(request.prompt) + 1)
        if need > self.cache.num_pages:
            raise RequestTooLargeError(
                f"prompt of {len(request.prompt)} tokens needs {need} "
                f"pages; the pool only has {self.cache.num_pages}")
        self.queue.offer(request)

    def _pages_for(self, tokens):
        return math.ceil(tokens / self.cache.page_size)

    # ------------------------- admission ----------------------------
    def free_slots(self):
        return sum(1 for s in self.slots if s is None)

    def active(self):
        """Sequences currently holding decode slots, slot order."""
        return [s for s in self.slots if s is not None]

    def decode_ready(self):
        """Slot-holders whose prefill is complete — the decode batch."""
        return [s for s in self.slots
                if s is not None and not s.prefilling]

    def prefilling(self):
        """Slot-holders mid-prefill, oldest (smallest seq_id) first."""
        return sorted((s for s in self.slots
                       if s is not None and s.prefilling),
                      key=lambda s: s.seq_id)

    def plan_pack(self, chunk_tokens, room=None, max_seqs=None):
        """Prefill plan for one step: MULTIPLE prompts' chunks packed
        FIFO into `room` tokens.  The oldest mid-prefill sequence gets
        its next ``min(chunk_tokens, remaining prompt, room)`` tokens
        first, then the leftover room goes to the next prompts in FIFO
        order, each clipped the same way, until the room (None =
        unbounded), the descriptor budget `max_seqs`, or the prefilling
        line runs out.  Returns ``[(state, n), ...]``."""
        pack = []
        left = None if room is None else int(room)
        for cand in self.prefilling():
            if left is not None and left <= 0:
                break
            if max_seqs is not None and len(pack) >= max_seqs:
                break
            n = min(int(chunk_tokens), len(cand.tokens) - cand.prefill_pos)
            if left is not None:
                n = min(n, left)
            if n <= 0:
                continue
            pack.append((cand, n))
            if left is not None:
                left -= n
        return pack

    def plan_spec(self, proposer, spec_tokens, room=None):
        """Draft plan for one speculative ragged step: up to
        `spec_tokens` draft continuations per GREEDY decode-ready
        sequence, in slot order.  Returns ``{seq_id: [draft ids]}``;
        rows absent from the plan decode as without speculation.

        Three clips keep speculation a pure optimization:

        - stochastic rows never draft (the accept rule compares argmax
          with argmax; a sampled token has no draft to verify against);
        - a row drafts at most ``remaining - 1`` tokens (the step emits
          accepted + 1 tokens, and drafting past max_new_tokens would
          reserve positions the sequence can never hold);
        - `room` (the packed axis's leftover) bounds the TOTAL drafts in
          slot order, so drafts never push out a decode or chunk row.

        A proposer with a persistent per-sequence index (``propose_for``)
        first drops the indexes of sequences that are no longer live or
        waiting (``retain``)."""
        plan = {}
        left = None if room is None else int(room)
        propose_for = getattr(proposer, "propose_for", None)
        if propose_for is not None:
            live = {s.seq_id for s in self.active()}
            live.update(s.seq_id for s in self._pending
                        if isinstance(s, SequenceState))
            proposer.retain(live)
        for state in self.decode_ready():
            if left is not None and left <= 0:
                break
            if not state.request.params.greedy:
                continue
            remaining = state.request.max_new_tokens - state.n_generated
            k = min(int(spec_tokens), remaining - 1)
            if left is not None:
                k = min(k, left)
            if k <= 0:
                continue
            drafts = (propose_for(state.seq_id, state.tokens, k)
                      if propose_for is not None
                      else proposer.propose(state.tokens, k))
            if not drafts:
                continue
            plan[state.seq_id] = drafts
            if left is not None:
                left -= len(drafts)
        return plan

    def _place(self, state):
        for i, s in enumerate(self.slots):
            if s is None:
                state.slot = i
                self.slots[i] = state
                return
        raise AssertionError("no free slot (checked by caller)")

    def next_seq_id(self):
        """One sequence id outside the admission path: a live-migration
        import (engine.import_sequence) builds its SequenceState
        directly, bypassing the queue."""
        sid = self._next_seq
        self._next_seq += 1
        return sid

    def place_imported(self, state):
        """Seat a live-migrated SequenceState straight into a free slot
        (the caller checked free_slots() > 0 and installed its pages):
        migration moves a resident, it never queues one."""
        self._place(state)

    def admit(self, limit=None):
        """Move work into free slots while pages allow; returns the newly
        placed SequenceStates.  Head-of-line on capacity: admission stops
        at the first item that doesn't fit, preserving arrival order.
        `limit` caps admissions per call.

        With the prefix cache on, each placement first looks up the
        longest cached page run of the sequence's tokens and ALIASES it
        (adopt_prefix: zero bytes moved, prefill_pos advanced past the
        match), so the page need charges only the suffix, plus one
        copy-on-write page when the match was clipped mid-page.  The gate
        compares against available_pages (free + evictable cached runs)
        less the match's own evictable pages, which adoption pins: they
        cannot count both as aliased for free and as evictable.  A
        preempted sequence re-matches its own run on re-admission; only
        first admissions count as lookups."""
        admitted = []
        committed = 0  # pages promised to THIS call's earlier admits
        while self.free_slots() > 0 and (limit is None
                                         or len(admitted) < limit):
            item = self._pending.popleft() if self._pending else \
                self.queue.poll(timeout=0)
            if item is None:
                break
            if isinstance(item, SequenceState):
                state, req = item, item.request
            else:
                state, req = None, item
            if req.expired():
                req.reject_expired()
                if self._metrics is not None:
                    self._metrics.count_rejected_deadline()
                continue
            readmitted = state is not None
            token_list = state.tokens if state else req.prompt
            tokens = len(token_list)
            match_pages, match_tokens = (), 0
            if self.prefix_cache:
                match_pages, match_tokens = self.cache.match_prefix(
                    token_list)
            # +1: room for the first decode append after prefill; aliased
            # pages are free of charge, a clipped match owes its tail
            # page's copy-on-write
            need = self._pages_for(tokens + 1) - len(match_pages)
            if match_tokens % self.cache.page_size:
                need += 1
            avail = (self.cache.available_pages
                     - self.cache.evictable_pages_in(match_pages))
            if need > avail - committed \
                    and (self.active() or self._pending or admitted):
                # not enough pages now, but retiring sequences will free
                # some — wait in line rather than rejecting
                self._pending.appendleft(item)
                break
            committed += need
            if state is None:
                state = SequenceState(self._next_seq, req)
                self._next_seq += 1
            self.cache.allocate(state.seq_id)
            if match_tokens:
                # same-step adoption: the incref pins the matched pages
                # before any later reserve could evict them
                self.cache.adopt_prefix(state.seq_id, match_pages,
                                        match_tokens)
                state.prefill_pos = match_tokens
            handle = state.handle
            if getattr(handle, "prefix_hit_tokens", 0) is None:
                # the first admission stamps the handle
                handle.prefix_hit_tokens = match_tokens
            if self.prefix_cache and self._metrics is not None \
                    and not readmitted:
                # hits measure sharing ACROSS requests: a re-admission
                # re-matching its own run would inflate the rate
                self._metrics.count_prefix_lookup(match_tokens, tokens)
            self._place(state)
            admitted.append(state)
        return admitted

    # ------------------------- exit paths ---------------------------
    def retire(self, state):
        """Sequence left the batch (finished or failed): free its slot
        and every page it owns."""
        if state.slot is not None:
            self.slots[state.slot] = None
            state.slot = None
        if self.cache.has(state.seq_id):
            self.cache.free(state.seq_id)

    def preempt(self, state):
        """Recompute-preempt: free pages + slot, queue for re-prefill at
        the FRONT of the pending line.  The victim restarts its prefill
        from position 0, or past its cached run on a prefix hit."""
        self.retire(state)
        state.preemptions += 1
        state.prefilling = True
        state.prefill_pos = 0
        state.prewarmed = False
        self._pending.appendleft(state)

    def preempt_youngest(self, exclude=None):
        """Preempt the single youngest active sequence and return it —
        unless it is the only one, in which case return None: the lone
        sequence is never preempted.  `exclude` shields one sequence
        (the one whose prefill chunk needs the pages)."""
        active = [s for s in self.active() if s is not exclude]
        if not active or (exclude is None and len(active) < 2):
            return None
        victim = max(active, key=lambda s: s.seq_id)
        self.preempt(victim)
        return victim

    def pending_count(self):
        return len(self._pending) + len(self.queue)

    def take_pending(self):
        """Pull every item not yet placed — the pending line first
        (preempted sequences have seniority), then the admission queue
        in FIFO order — for a fleet drain (engine.evacuate).  Returns
        ``[(GenerationRequest, n_emitted)]``, `n_emitted` the tokens the
        request already streamed (nonzero only for preempted
        SequenceStates, whose pages were freed at preemption).  Expired
        requests are reaped with the typed deadline error, as a queue
        poll would."""
        out = []
        while self._pending:
            item = self._pending.popleft()
            if isinstance(item, SequenceState):
                if item.request.expired():
                    item.request.reject_expired()
                    if self._metrics is not None:
                        self._metrics.count_rejected_deadline()
                    continue
                out.append((item.request, item.n_generated))
            else:
                out.append((item, 0))
        while True:
            req = self.queue.poll(timeout=0)   # reaps expired itself
            if req is None:
                break
            out.append((req, 0))
        return out

    def cancel_pending(self, handle):
        """Remove the not-yet-placed item owned by `handle` WITHOUT
        resolving it (the engine's cancel path owns the resolution).
        Returns the removed item or None."""
        for i, item in enumerate(self._pending):
            owner = item.handle if isinstance(item, SequenceState) \
                else item.future
            if owner is handle:
                del self._pending[i]
                return item
        taken = self.queue.remove(lambda r: r.future is handle)
        return taken[0] if taken else None

    def close(self):
        """Reject everything still queued (typed shutdown error)."""
        self.queue.close()
        while self._pending:
            item = self._pending.popleft()
            fut = item.handle if isinstance(item, SequenceState) else \
                item.future
            if not fut.done():
                try:
                    fut.set_exception(ServingError(
                        "generation engine shut down with request queued"))
                except Exception:
                    pass


__all__ = [
    "ContinuousBatchingScheduler", "GenerationRequest", "SequenceState",
    "DeadlineExceededError", "OutOfPagesError", "UnknownSequenceError",
]
