"""Speculative decoding through the ragged step: the prompt-lookup
proposer and the accept rule.

A model-free PROPOSER guesses up to k draft continuations per greedy
decode row; the row packs as an ordinary ``[start, len = 1 + k, kv_len]``
ragged descriptor (a chunk-shaped row: the ragged kernel's per-row
causal masking already serves it), and the step's epilogue verifies
every draft in the SAME call: compare each row's argmax with the next
draft, count the accepted prefix, and emit the bonus token.  A draft is
only ever emitted when the model's own argmax equals it, and a verify
row at position p computes the logits a plain decode row at p would, so
greedy speculative decode is token-identical to plain decode on float
pools; on int8 pools a rejected draft's write can grow a page's scale
before the rewind (``PagedKVCache.truncate``), a regrounding the JAX
package pins rather than excludes.

- :class:`NgramProposer` / :class:`NgramIndex` — prompt lookup: match
  the sequence's current n-gram suffix against its own history and
  propose the continuation after the most recent earlier occurrence
  (the JAX package's proposer, the same proposals).
- :func:`verify_accept` — the accept rule, one body for numpy arrays
  (host replays in tests) and torch tensors (the step's epilogue, no
  host sync).
"""
import numpy as np
import torch


class NgramIndex:
    """Incremental per-sequence n-gram index: dict n-gram → its two
    most recent end positions, maintained in O(max_ngram) per appended
    token.

    The rescan proposer paid O(max_lookback * max_ngram) per row per
    step — the ONE host cost that grew with batch, and with the
    host-free decode loop the proposer runs at loop boundaries where
    several tokens land at once.  The index replaces the scan with a
    dict probe: `extend` records, for every n-gram size in
    [min_ngram, max_ngram], the gram ending at each new token;
    `lookup` probes the current suffix gram and reads its most recent
    earlier occurrence straight from the dict.

    Two end positions per gram suffice for exact rescan equivalence:
    the suffix's own occurrence is always the most recent entry
    (`last == len(tokens)`), so the candidate is `prev` in that case
    and `last` otherwise — precisely the rescan's "most recent
    occurrence strictly before the suffix".  The lookback window is
    honored at probe time (an occurrence that slid out of the window
    is rejected, and anything older is older still), so
    ``index.lookup == rescan`` token-for-token; the equivalence suite
    fuzzes that claim.

    Histories only append (speculative rewinds truncate KV positions,
    never the committed token list), so `extend` is a pure catch-up;
    a shrunken history (defensive) rebuilds from scratch.
    """

    __slots__ = ("max_ngram", "min_ngram", "max_lookback", "n", "_grams")

    def __init__(self, max_ngram, min_ngram, max_lookback):
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        self.max_lookback = int(max_lookback)
        self.n = 0            # tokens indexed so far
        self._grams = {}      # gram tuple -> (last_end, prev_end)

    def extend(self, tokens):
        """Index tokens[self.n:] — O(new_tokens * max_ngram)."""
        n = len(tokens)
        if n < self.n:
            self.n = 0
            self._grams.clear()
        for t in range(self.n, n):
            e = t + 1
            for g in range(self.min_ngram, self.max_ngram + 1):
                if e < g:
                    continue
                gram = tuple(tokens[e - g:e])
                cur = self._grams.get(gram)
                self._grams[gram] = (e, cur[0] if cur is not None
                                     else None)
        self.n = n

    def lookup(self, tokens, k):
        """Up to `k` draft ids continuing `tokens` (must be indexed
        through `extend` first), or ``[]`` on a miss — the rescan
        proposer's contract, O(max_ngram) dict probes."""
        k = int(k)
        n = len(tokens)
        if k <= 0 or n != self.n:
            return [] if k <= 0 else self._fresh_lookup(tokens, k)
        w0 = n - self.max_lookback
        for g in range(self.max_ngram, self.min_ngram - 1, -1):
            if n <= g:
                continue
            cur = self._grams.get(tuple(tokens[n - g:n]))
            if cur is None:
                continue
            last, prev = cur
            end = prev if last == n else last
            if end is None or end - g < w0:
                # no occurrence before the suffix, or the most recent
                # one slid out of the lookback window (older ones are
                # older still) — try a shorter gram
                continue
            return [int(t) for t in tokens[end:end + k]]
        return []

    def _fresh_lookup(self, tokens, k):
        self.extend(tokens)
        return self.lookup(tokens, k)


class NgramProposer:
    """Model-free prompt-lookup proposer (PLD): propose the historical
    continuation of the sequence's current n-gram suffix.

    For n-gram sizes ``max_ngram`` down to ``min_ngram``, take the last
    n tokens of the history, find the MOST RECENT earlier occurrence of
    that n-gram, and propose the up-to-k tokens that followed it.
    Longer suffixes are tried first (more context, higher acceptance);
    the most recent occurrence wins ties (recency tracks the local
    repetition structure speculation feeds on).  Returns ``[]`` on a
    miss — the row then decodes exactly as today.

    Pure host-side work on python ints: the proposer runs once per
    greedy decode row per step, over histories the scheduler already
    holds (the engine's token lists — already python ints); no device
    work, no model weights.  `max_lookback` bounds the scan to the
    most recent window of the history, so per-row proposer cost is
    O(max_lookback * max_ngram) whatever the context length — the
    repetition speculation feeds on is LOCAL (loops, code idiom,
    recent copies), and the overhead-bound workload must not pay a
    full-history rescan per token.
    """

    def __init__(self, max_ngram=3, min_ngram=1, max_lookback=512):
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        self.max_lookback = int(max_lookback)
        if not 1 <= self.min_ngram <= self.max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"[{min_ngram}, {max_ngram}]")
        if self.max_lookback <= self.max_ngram:
            raise ValueError(
                f"max_lookback={max_lookback} must exceed "
                f"max_ngram={max_ngram}")
        self._indexes = {}    # seq_id -> NgramIndex (propose_for)

    def _make_index(self):
        return NgramIndex(self.max_ngram, self.min_ngram,
                          self.max_lookback)

    def propose(self, tokens, k):
        """Up to `k` draft token ids continuing `tokens` (a list of
        ints, prompt + generated so far), or ``[]`` when no suffix
        match exists in the lookback window.  One-shot: builds a
        transient index (same cost class as the old rescan); steady
        callers use :meth:`propose_for`."""
        k = int(k)
        if k <= 0:
            return []
        idx = self._make_index()
        idx.extend(tokens)
        return idx.lookup(tokens, k)

    def propose_for(self, seq_id, tokens, k):
        """`propose` with a PERSISTENT per-sequence index: catch-up
        indexes only the tokens appended since the last call —
        O(new_tokens * max_ngram) instead of a per-step history rescan
        (the one host cost that grew with batch).  Token-identical to
        `propose` / the rescan; `retain` evicts finished sequences."""
        k = int(k)
        if k <= 0:
            return []
        idx = self._indexes.get(seq_id)
        if idx is None:
            idx = self._indexes[seq_id] = self._make_index()
        idx.extend(tokens)
        return idx.lookup(tokens, k)

    def retain(self, live_seq_ids):
        """Drop per-sequence indexes for ids not in `live_seq_ids`
        (finished/failed sequences; ids are engine-unique so a
        preempted-and-resumed sequence keeps its index)."""
        live = set(live_seq_ids)
        for sid in [s for s in self._indexes if s not in live]:
            del self._indexes[sid]

    def _propose_rescan(self, tokens, k):
        """The original lookback rescan, kept as the equivalence
        reference for the index (tests fuzz propose == _propose_rescan
        over random histories)."""
        k = int(k)
        if k <= 0:
            return []
        n = len(tokens)
        win = (tokens if n <= self.max_lookback
               else tokens[n - self.max_lookback:])
        m = len(win)
        for g in range(self.max_ngram, self.min_ngram - 1, -1):
            if m <= g:
                continue
            suffix = list(win[-g:])
            last = suffix[-1]
            # most recent occurrence strictly before the suffix itself
            # (i <= m - g - 1, so at least one continuation token
            # always exists after a match); the scalar pre-check on
            # the n-gram's last token rejects almost every candidate
            # position without allocating a slice
            for i in range(m - g - 1, -1, -1):
                if win[i + g - 1] == last and win[i:i + g] == suffix:
                    return [int(t) for t in win[i + g:i + g + k]]
        return []


class _NumpyOps:
    @staticmethod
    def i32(x):
        return np.asarray(x, np.int32)

    @staticmethod
    def arange(n, like):
        return np.arange(n, dtype=np.int32)

    @staticmethod
    def index(x, idx):
        return x[idx]

    @staticmethod
    def clip(x, lo, hi):
        return np.clip(x, lo, hi)

    @staticmethod
    def leading_count(match):
        return np.sum(np.cumprod(match.astype(np.int32), axis=1),
                      axis=1).astype(np.int32)

    @staticmethod
    def take_rows(x, idx):
        return np.take_along_axis(x, idx[:, None], axis=1)[:, 0]


class _TorchOps:
    @staticmethod
    def i32(x):
        return torch.as_tensor(x).to(torch.int32)

    @staticmethod
    def arange(n, like):
        return torch.arange(n, dtype=torch.int32, device=like.device)

    @staticmethod
    def index(x, idx):
        return x[idx.long()]

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def leading_count(match):
        return torch.sum(torch.cumprod(match.to(torch.int32), dim=1),
                         dim=1).to(torch.int32)

    @staticmethod
    def take_rows(x, idx):
        return torch.gather(x, 1, idx.long()[:, None])[:, 0]


def verify_accept(amax_rows, tokens, starts, lens, spec_tokens):
    """The accept rule over one packed step.

    amax_rows: [S, spec_tokens + 1] int — each descriptor's argmax at
        packed rows ``start .. start + spec_tokens`` (row start+j
        predicts the token at the next position).
    tokens: [T] int — the packed token axis (descriptor s's row start+j
        carries, for j >= 1, its j-th draft).
    starts/lens: [S] int descriptors (lens = 1 + k for a speculating
        row; other descriptors give values the engine ignores).
    spec_tokens: the static draft cap K.

    Returns ``(accepted [S], bonus [S])`` int32: `accepted` counts the
    leading drafts whose predecessor row's argmax equals them, `bonus`
    is ``amax_rows[s, accepted]``, the model's own token after the
    accepted prefix.  numpy arrays in, numpy out; torch tensors in,
    torch out on their device, with no host sync — one body for both."""
    m = _TorchOps if isinstance(amax_rows, torch.Tensor) else _NumpyOps
    kk = int(spec_tokens)
    amax_rows = m.i32(amax_rows)
    tokens = m.i32(tokens)
    starts = m.i32(starts)
    lens = m.i32(lens)
    t = tokens.shape[0]
    offs = m.arange(kk, amax_rows)[None, :]                     # [1, K]
    nxt = m.clip(starts[:, None] + offs + 1, 0, t - 1)
    valid = offs < (lens - 1)[:, None]
    match = valid & (amax_rows[:, :kk] == m.index(tokens, nxt))
    # leading-match count: cumprod zeroes everything after the first
    # mismatch, so the sum counts exactly the accepted prefix
    accepted = m.leading_count(match)
    return accepted, m.take_rows(amax_rows, accepted)


__all__ = ["NgramIndex", "NgramProposer", "verify_accept"]
