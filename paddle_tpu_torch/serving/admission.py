"""Admission control: bounded queue, per-request deadlines, typed overload.

The overload contract (graceful degradation, not unbounded latency):

- a FULL queue rejects the submit synchronously with `ServerBusyError` —
  callers shed load immediately instead of piling onto a queue whose
  wait already exceeds any useful deadline;
- an EXPIRED request is rejected with `DeadlineExceededError` the moment
  any queue scan observes it — a request that cannot make its deadline
  never spends device time.
"""
import collections
import threading
import time


class ServingError(RuntimeError):
    """Base class for all serving runtime errors."""


class ServerBusyError(ServingError):
    """Admission queue full: the server is overloaded; retry with backoff."""


class DeadlineExceededError(ServingError, TimeoutError):
    """The request's deadline passed before a result could be produced.
    Subclasses TimeoutError so generic timeout handlers catch it."""


class RequestTooLargeError(ServingError):
    """A single request can never be scheduled; rejected at submit."""


class ReplicaTimeoutError(ServingError, TimeoutError):
    """A cross-replica RPC exceeded its bounded deadline (the peer is
    hung, wedged, or the channel is poisoned — not a client deadline,
    which is DeadlineExceededError).  Idempotent ops retry with backoff
    under a bounded attempt budget; non-idempotent ops fail fast into the
    fleet's remigration ladder."""


class Request:
    """One in-flight request."""

    __slots__ = ("args", "rows", "future", "deadline", "submit_t",
                 "bucket_key")

    def __init__(self, args, rows, future, deadline=None, bucket_key=None):
        self.args = args
        self.rows = int(rows)
        self.future = future        # concurrent.futures.Future-like
        self.deadline = deadline    # absolute time.monotonic() or None
        self.submit_t = time.monotonic()
        self.bucket_key = bucket_key

    def expired(self, now=None):
        return self.deadline is not None and \
            (now if now is not None else time.monotonic()) >= self.deadline

    def reject_expired(self):
        if self.future.done():
            return  # client cancelled; nothing to report
        waited_ms = (time.monotonic() - self.submit_t) * 1e3
        try:
            self.future.set_exception(DeadlineExceededError(
                f"request deadline exceeded after {waited_ms:.1f} ms "
                f"in queue"))
        except Exception:
            pass  # lost a cancel race: the future is already resolved


class AdmissionQueue:
    """Bounded FIFO with deadline-aware scans.

    `offer` never blocks: a full queue is an overload signal, surfaced as
    ServerBusyError.  `poll` drops expired requests on the way (resolving
    their futures with DeadlineExceededError) so a stale head can never
    delay a live request behind it.
    """

    def __init__(self, max_depth=64, metrics=None):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = int(max_depth)
        self._dq = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        self._metrics = metrics

    def __len__(self):
        with self._cond:
            return len(self._dq)

    def _gauge(self):
        if self._metrics is not None:
            self._metrics.set_queue_depth(len(self._dq))

    def offer(self, req):
        """Enqueue or raise ServerBusyError; never blocks the caller."""
        with self._cond:
            if self._closed:
                raise ServingError("serving queue is shut down")
            if len(self._dq) >= self.max_depth:
                if self._metrics is not None:
                    self._metrics.count_rejected_busy()
                raise ServerBusyError(
                    f"admission queue full ({self.max_depth} requests "
                    f"queued); server overloaded — retry with backoff")
            self._dq.append(req)
            self._gauge()
            self._cond.notify()

    def _reap_expired_locked(self):
        """Drop every expired request currently queued (any position —
        deadlines need not be FIFO-ordered)."""
        if not self._dq:
            return
        now = time.monotonic()
        live, dropped = [], []
        for r in self._dq:
            (dropped if r.expired(now) else live).append(r)
        if dropped:
            self._dq.clear()
            self._dq.extend(live)
            self._gauge()
        for r in dropped:
            r.reject_expired()
        if dropped and self._metrics is not None:
            self._metrics.count_rejected_deadline(len(dropped))

    def poll(self, timeout=None):
        """Next live request, or None on timeout/shutdown."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                self._reap_expired_locked()
                if self._dq:
                    req = self._dq.popleft()
                    self._gauge()
                    return req
                if self._closed:
                    return None
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining)

    def remove(self, pred):
        """Pull every queued request matching `pred(req)` WITHOUT
        resolving its future — the cancel path owns the resolution.
        Returns the removed requests in FIFO order."""
        with self._cond:
            taken = [r for r in self._dq if pred(r)]
            if taken:
                kept = [r for r in self._dq if not pred(r)]
                self._dq.clear()
                self._dq.extend(kept)
                self._gauge()
            return taken

    def close(self):
        """Shut down: wake pollers; every queued request is rejected."""
        with self._cond:
            self._closed = True
            pending = list(self._dq)
            self._dq.clear()
            self._gauge()
            self._cond.notify_all()
        for r in pending:
            if r.future.done():
                continue  # client cancelled while queued
            try:
                r.future.set_exception(ServingError(
                    "serving engine shut down with request queued"))
            except Exception:
                pass  # cancel race: never let one future strand the rest
