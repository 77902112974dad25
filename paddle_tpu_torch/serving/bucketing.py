"""Shape bucketing plus a per-signature cache.

- `ShapeBucketer` rounds every request up to the next (batch, length)
  bucket of a small fixed menu, so the set of shapes a step dispatches
  stays bounded;
- `SignatureCache` counts the distinct padded shape signatures
  dispatched.  PyTorch runs eagerly and has no ahead-of-time compile,
  so nothing is built per signature here; the cache keeps the counters
  (``compile_count == len(cached_buckets())``) that say how many
  distinct shapes the menu let through, which is also the set a later
  CUDA-graph capture would be keyed on.
"""
import threading

import numpy as np

from .admission import RequestTooLargeError
from .metrics import ServingMetrics


def _check_buckets(name, buckets):
    bs = tuple(int(b) for b in buckets)
    if not bs or any(b < 1 for b in bs) or list(bs) != sorted(set(bs)):
        raise ValueError(
            f"{name} must be strictly increasing positive ints, got "
            f"{buckets!r}")
    return bs


class ShapeBucketer:
    """Pads request shapes to a fixed bucket menu.

    batch_buckets: allowed padded batch sizes.
    length_buckets: optional allowed padded lengths; None disables
        length bucketing.
    """

    def __init__(self, batch_buckets=(1, 2, 4, 8), length_buckets=None,
                 pad_value=0):
        self.batch_buckets = _check_buckets("batch_buckets", batch_buckets)
        self.length_buckets = None if length_buckets is None else \
            _check_buckets("length_buckets", length_buckets)
        self.pad_value = pad_value

    @staticmethod
    def geometric_menu(limit, start=8):
        """A power-of-two bucket menu covering [1, limit]: (start,
        2*start, ..., first power >= limit).  log2(limit) buckets bound
        the signature count while wasting at most 2x padding."""
        limit = max(int(limit), 1)
        start = max(int(start), 1)
        menu = [start]
        while menu[-1] < limit:
            menu.append(menu[-1] * 2)
        return tuple(menu)

    @classmethod
    def for_prefill(cls, batch_buckets, max_tokens, max_positions=None):
        """The one-shot prefill's (batch, length) menu: `batch_buckets`,
        and a geometric length menu covering every admissible prompt up
        to ``min(max_tokens, max_positions)`` (the pool's tokens, capped
        so no padded bucket exceeds what the model can embed)."""
        limit = int(max_tokens)
        if max_positions is not None:
            limit = min(limit, int(max_positions))
        menu = [x for x in cls.geometric_menu(limit) if x < limit]
        return cls(batch_buckets=tuple(sorted(set(batch_buckets))),
                   length_buckets=tuple(menu) + (limit,))

    @property
    def max_batch(self):
        return self.batch_buckets[-1]

    def batch_bucket(self, rows):
        """Smallest batch bucket >= rows; typed rejection past the menu."""
        for b in self.batch_buckets:
            if rows <= b:
                return b
        raise RequestTooLargeError(
            f"request rows={rows} exceed the largest batch bucket "
            f"{self.batch_buckets[-1]}")

    def length_bucket(self, length):
        if self.length_buckets is None:
            return int(length)
        for b in self.length_buckets:
            if length <= b:
                return b
        raise RequestTooLargeError(
            f"sequence length {length} exceeds the largest length bucket "
            f"{self.length_buckets[-1]}")


    def pad_token_batch(self, seqs, dtype=np.int32):
        """Pad ragged token-id sequences into one bucketed batch: returns
        ``(tokens [batch_bucket, length_bucket], lengths [B])`` — the
        one-shot prefill's entry point."""
        if len(seqs) == 0:
            raise ValueError("pad_token_batch needs at least one sequence")
        lens = np.asarray([len(s) for s in seqs], np.int32)
        out = np.full((self.batch_bucket(len(seqs)),
                       self.length_bucket(int(lens.max()))),
                      self.pad_value, dtype)
        for i, s in enumerate(seqs):
            out[i, :len(s)] = s
        return out, lens


class SignatureCache:
    """Distinct shape signatures dispatched, with hit/miss counters.

    `metrics` takes `count_cache(hit)` and `count_compile()` (the
    serving or generation metrics objects); `touch(signature)` records
    one dispatch and returns True the first time a signature is seen."""

    def __init__(self, metrics=None):
        self._metrics = metrics or ServingMetrics()
        self._seen = set()
        self._lock = threading.Lock()
        self.compile_count = 0

    def touch(self, signature):
        with self._lock:
            new = signature not in self._seen
            if new:
                self._seen.add(signature)
                self.compile_count += 1
        self._metrics.count_cache(not new)
        if new:
            self._metrics.count_compile()
        return new

    def cached_buckets(self):
        with self._lock:
            return sorted(self._seen)
