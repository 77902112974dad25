"""Token sampling: greedy, temperature, top-k, top-p — host and device
twins.

The host sampler (`sample_token` / `sample_tokens_batch`, numpy) serves
the per-step engine; `sample_tokens_device` (torch, no host sync) serves
the host-free decode loop on the device.  Randomness is a COUNTER-BASED hash stream, not a stateful generator:
each request carries a :class:`SampleStream` ``(seed, counter)`` and
draw ``i`` is ``uniform(seed, i)`` — a pure uint32 mix.  A given
(model, prompt, params) pair therefore replays the same tokens whatever
other sequences share its batch, which is what lets the continuous-
batching oracle demand token-identical output.  The arithmetic is the
JAX package's host sampler, bit for bit, so both engines draw the same
numbers from the same seed.  `hash_uniform_device` is the stream's
torch twin, bit-exact with the numpy one.

The selection math is the JAX package's formula (temperature, top-k,
softmax, top-p, CDF inversion) with one change: from the exponential on,
both twins compute in float64.  In float32 the sums and cumulative sums
differ between numpy (pairwise sums, a sequential cumsum), the CPU and
the card by about 1e-6 across a 50,304-token tail, and a draw that lands
in that band picks a neighbouring token: the float32 twins disagreed on
10 of 1,000 rows of ``chip_smoke.py``'s sampler check on the card (8% of
the draws of a temperature-only row).  In float64 they agree there, and
the port's host sampler still equals the JAX package's (float32) on
small vocabularies; on a large one the two differ on the draws that land
in that float32 band.
"""
import numpy as np
import torch

_GOLDEN = 0x9E3779B9          # 2**32 / golden ratio: counter stride
_U24 = np.float32(1.0 / (1 << 24))


def _mix32(x):
    """Integer finalizer (splitmix-style avalanche) over uint32 arrays.
    Inputs must be uint32 *arrays* (numpy 2 scalars raise on overflow
    where arrays wrap)."""
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def hash_uniform(seed, counter):
    """Uniform f32 draws in [0, 1) from (seed, counter) uint32 pairs,
    from the top 24 bits of the mixed word (exact in float32)."""
    seed = np.asarray(seed).astype(np.uint32)
    counter = np.asarray(counter).astype(np.uint32)
    x = _mix32(seed ^ (counter * np.uint32(_GOLDEN)))
    return (x >> np.uint32(8)).astype(np.float32) * _U24


_MASK32 = 0xFFFFFFFF


def _mulmod32(x, c):
    """``(x * c) mod 2**32`` for int64 tensors holding uint32 values and
    a uint32 constant `c`, in 16-bit halves of `c` so that no product
    passes 2**63 (CUDA has little uint32 arithmetic, and int64 products
    past 2**63 would rely on signed wrap-around)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _mix32_device(x):
    """`_mix32` over int64 tensors holding uint32 values, masked back to
    32 bits after every multiply."""
    x = _mulmod32(x ^ (x >> 16), 0x7FEB352D)
    x = _mulmod32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def hash_uniform_device(seed, counter):
    """`hash_uniform` on torch tensors of any integer dtype (int32 holding
    uint32 values, as the loop carries them, or int64), on any device:
    bit-exact with the numpy version.  Returns float32."""
    seed = seed.to(torch.int64) & _MASK32
    counter = counter.to(torch.int64) & _MASK32
    x = _mix32_device(seed ^ _mulmod32(counter, _GOLDEN))
    return (x >> 8).to(torch.float32) * float(_U24)


def _as_int32(x):
    """int64 tensor of uint32 values -> int32 holding the same 32 bits
    (how the JAX package's device loop carries seeds and counters)."""
    x = x & _MASK32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


class SampleStream:
    """Counter-based per-request RNG: two ints, pure draws."""

    __slots__ = ("seed", "counter")

    def __init__(self, seed, counter=0):
        self.seed = int(seed) & 0xFFFFFFFF
        self.counter = int(counter) & 0xFFFFFFFF

    def next_uniform(self):
        # length-1 arrays, not scalars: numpy wraps arrays silently
        u = float(hash_uniform(np.array([self.seed], np.uint32),
                               np.array([self.counter], np.uint32))[0])
        self.counter = (self.counter + 1) & 0xFFFFFFFF
        return u

    def __repr__(self):
        return f"SampleStream(seed={self.seed}, counter={self.counter})"

    def __eq__(self, other):
        return (isinstance(other, SampleStream)
                and (self.seed, self.counter)
                == (other.seed, other.counter))


class SamplingParams:
    """Per-request sampling knobs.

    temperature == 0 means greedy (argmax; top_k/top_p ignored).
    top_k: keep the k highest-probability tokens (None/0 disables).
    top_p: smallest prefix of the sorted distribution with cumulative
        probability >= top_p (nucleus; None/1.0 disables).
    seed: per-request RNG seed (None draws one from a fresh numpy
        generator — still recorded on the params so a run can be
        replayed).
    stop_sequences: multi-token stop conditions; the engine suffix-
        matches the generated stream and withholds the completing token.
    """

    __slots__ = ("temperature", "top_k", "top_p", "seed",
                 "stop_sequences", "max_stop_len")

    def __init__(self, temperature=0.0, top_k=None, top_p=None, seed=None,
                 stop_sequences=()):
        self.temperature = float(temperature)
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        self.top_k = None if not top_k else int(top_k)
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        self.top_p = None if top_p is None else float(top_p)
        if self.top_p is not None and not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        self.stop_sequences = tuple(
            tuple(int(t) for t in s) for s in stop_sequences)
        if any(not s for s in self.stop_sequences):
            raise ValueError("stop_sequences entries must be non-empty "
                             "token id sequences")
        self.max_stop_len = max((len(s) for s in self.stop_sequences),
                                default=0)
        if seed is None:
            seed = int(np.random.default_rng().integers(0, 2**31 - 1))
        self.seed = int(seed)

    @property
    def greedy(self):
        return self.temperature == 0.0

    def make_rng(self):
        return SampleStream(self.seed)


def _nucleus_probs(x, params):
    """Masked+renormalized float64 probabilities after temperature, top-k
    and top-p.  x: [V] float32 logits; the temperature and the top-k
    threshold in float32, the rest in float64."""
    v = x.shape[0]
    x = x / np.float32(params.temperature)
    k = params.top_k
    if k is not None and k < v:
        kth = np.sort(x)[v - k]
        x = np.where(x >= kth, x, -np.inf)
    e = np.exp((x - np.max(x)).astype(np.float64))
    p = e / np.sum(e)
    if params.top_p is not None and params.top_p < 1.0:
        tp = np.float64(np.float32(params.top_p))
        order = np.argsort(-p, kind="stable")
        csum = np.cumsum(p[order])
        # smallest prefix reaching top_p: ranks whose cumulative sum
        # strictly before them hasn't yet reached top_p
        keep_n = np.sum((csum < tp).astype(np.int32)) + 1
        keep = np.zeros(v, bool)
        keep[order[:int(keep_n)]] = True
        p = np.where(keep, p, 0.0)
        p = p / np.sum(p)
    return p


def _invert_cdf(p, u):
    """Token index for draw u under probs p: ``sum(cumsum(p) <= u)``,
    clipped to the last positive-probability index (the one float edge
    where the total mass rounds below the draw)."""
    v = p.shape[0]
    csum = np.cumsum(p)
    idx = np.sum((csum <= np.float64(u)).astype(np.int32))
    last = np.max(np.arange(v, dtype=np.int32) * (p > 0).astype(np.int32))
    return np.minimum(idx, last)


def sample_tokens_batch(logits, params_list, rngs):
    """One token id per row of a [B, V] logits block.  Greedy rows share
    ONE vectorized argmax; stochastic rows consume one draw each from
    their own :class:`SampleStream` — token-identical to the per-row
    path (numpy's first-max tie rule is the same either way)."""
    logits = np.asarray(logits)
    out = [None] * len(params_list)
    greedy_rows = [i for i, p in enumerate(params_list) if p.greedy]
    if greedy_rows:
        block = logits[greedy_rows].astype(np.float64)
        for i, t in zip(greedy_rows, np.argmax(block, axis=-1)):
            out[i] = int(t)
    for i, p in enumerate(params_list):
        if out[i] is None:
            out[i] = sample_token(logits[i], p, rngs[i])
    return out


def sample_token(logits, params, rng):
    """One token id from a [V] float logits row; stochastic rows consume
    exactly one draw from `rng`, greedy rows none."""
    if params.greedy:
        return int(np.argmax(np.asarray(logits, np.float64).reshape(-1)))
    x = np.asarray(logits, np.float32).reshape(-1)
    p = _nucleus_probs(x, params)
    u = np.float32(rng.next_uniform())
    return int(_invert_cdf(p, u))


def sample_tokens_device(logits, temps, top_ks, top_ps, seeds, counters):
    """Device twin of `sample_tokens_batch` over a [S, V] logits tensor,
    with no host sync (it runs inside the captured decode loop).

    temps: [S] float32 (0 -> greedy row); top_ks: [S] int (0 -> off);
    top_ps: [S] float32 (1.0 -> off); seeds/counters: [S] int32 holding
    uint32 values — each row's :class:`SampleStream`.  Returns
    ``(tokens [S] int32, counters_after [S] int32)``: stochastic rows
    consume exactly one draw (counter + 1), greedy rows none, the key
    sequence the host sampler consumes.  The host sampler's arithmetic:
    float32 up to the exponential, float64 from it on.  Top-p ranks by a
    STABLE argsort (numpy's and JAX's order among equal probabilities);
    greedy is the first maximum, as numpy's argmax."""
    logits = logits.to(torch.float32)
    s, v = logits.shape
    dev = logits.device
    temps = temps.to(torch.float32)
    greedy = temps <= 0.0
    # temperature 1.0 on greedy rows keeps the stochastic lane NaN-free
    x = logits / torch.where(greedy, torch.ones_like(temps), temps)[:, None]
    top_ks = top_ks.to(torch.int64)
    kidx = torch.clamp(torch.where((top_ks <= 0) | (top_ks >= v),
                                   torch.full_like(top_ks, v), top_ks),
                       1, v)
    xs = torch.sort(x, dim=-1).values                       # ascending
    kth = torch.gather(xs, 1, (v - kidx)[:, None])
    x = torch.where(x >= kth, x, torch.full_like(x, -torch.inf))
    e = torch.exp((x - torch.amax(x, dim=-1, keepdim=True)).double())
    p = e / torch.sum(e, dim=-1, keepdim=True)
    # top-p: the smallest prefix of the stable descending order whose
    # cumulative mass reaches top_p, scattered back to vocab order
    order = torch.argsort(-p, dim=-1, stable=True)
    csum = torch.cumsum(torch.gather(p, 1, order), dim=-1)
    top_ps = top_ps.to(torch.float32)
    tp = torch.where(top_ps < 1.0, top_ps,
                     torch.full_like(top_ps, 2.0)).double()[:, None]
    keep_n = torch.sum((csum < tp).to(torch.int64), dim=-1,
                       keepdim=True) + 1
    keep_sorted = torch.arange(v, device=dev)[None, :] < keep_n
    keep = torch.zeros((s, v), dtype=torch.bool, device=dev).scatter(
        1, order, keep_sorted)
    p = torch.where(keep, p, torch.zeros_like(p))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    # CDF inversion on the row's next draw, clipped to the last index of
    # positive probability
    u = hash_uniform_device(seeds, counters).double()[:, None]
    idx = torch.sum((torch.cumsum(p, dim=-1) <= u).to(torch.int64), dim=-1)
    last = torch.amax(torch.arange(v, device=dev)[None, :]
                      * (p > 0).to(torch.int64), dim=-1)
    stoch = torch.minimum(idx, last)
    tokens = torch.where(greedy, torch.argmax(logits, dim=-1), stoch)
    ctr = counters.to(torch.int64)
    counters_after = _as_int32(torch.where(greedy, ctr, ctr + 1))
    return tokens.to(torch.int32), counters_after
