"""TinyCausalLM: a small pre-LN causal transformer implementing the
generation engine's step protocols — the reference model for tests and
the chip smoke run.

Forward paths over the SAME weights:

- `prefill(tokens)` — dense causal attention over the whole prefix
  (full recompute); `greedy_reference` builds the no-cache oracle on it;
- `prefill_batch(tokens, lengths)` — the same dense causal prefill over
  a length-padded batch (the legacy step's one-shot prefill);
- `ragged_step_fn(...)` — one packed mixed-batch engine step: embed ->
  L x (scatter K/V into the page pools + ragged paged attention + MLP)
  -> logits at each descriptor's last row (with `spec_tokens`, plus the
  speculative verify epilogue);
- `ragged_loop_fn(...)` — N ragged decode steps in one call, with
  on-device sampling and stop matching: the host-free decode loop, on
  the same layer stack;
- `decode_step_fn(...)` — one legacy fused decode step: one token per
  sequence, paged decode attention;
- `prefill_chunk_fn(...)` — one legacy prefill chunk of one sequence,
  chunk-prefill attention;
- `decode(tokens, positions, attend)` — the eager decode step, with the
  engine's attend callback writing and reading the pools per layer;
- `prefill_chunk(tokens, start, attend)` — one eager prefill chunk of one
  sequence through the same kind of callback (a warm one-shot prefill's
  suffix).

With ``kv_quant=True`` the three step functions serve int8 pools: the
per-layer ``[P + 1, H]`` scale arrays ride the state chain right after the
pools (``..., k_pools, v_pools, k_scales, v_scales, ...``) and come back
after them, every write goes through `quantized_pool_write`, and attention
gets each layer's scales.

Weights are drawn from one ``np.random.default_rng(seed)`` in a fixed
order, the same draws as the JAX package's model, so the two packages'
models with one seed hold bitwise-equal weights.  They are drawn on the
host and placed on the model's device: the card unless the caller asks
for the CPU.
"""
import math

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from . import decode_attention
from .decode_attention import NEG_INF, dense_causal_reference
from .kv_cache import scatter_pool_update
from .quantized_kv import quantized_pool_write
from .sampling import sample_tokens_device
from .speculation import verify_accept

_BLOCK_KEYS = ("ln1_s", "ln1_b", "wq", "wk", "wv", "wo", "ln2_s", "ln2_b",
               "w1", "b1", "w2", "b2")


def _write_layer(li, k_pools, v_pools, scales, pages, rows, k, v, layout):
    """Write layer `li`'s K/V rows into its pools in place: a plain
    scatter, or with `scales` (the ``(k_scales, v_scales)`` lists of an
    int8 pool) the quantized write.  Returns ``(k_pool, v_pool, k_scale,
    v_scale)``, the scales None for a float pool."""
    if scales is None:
        return (scatter_pool_update(k_pools[li], pages, rows, k, layout),
                scatter_pool_update(v_pools[li], pages, rows, v, layout),
                None, None)
    kp, ks = quantized_pool_write(k_pools[li], scales[0][li], pages, rows,
                                  k, layout)
    vp, vs = quantized_pool_write(v_pools[li], scales[1][li], pages, rows,
                                  v, layout)
    return kp, vp, ks, vs


def _split_state(rest, kv_quant, n_tail):
    """A step function's ``*rest`` after the pools: ``(scales, tail)``
    where scales is ``(k_scales, v_scales)`` when kv_quant, else None, and
    tail the `n_tail` arguments after them."""
    if kv_quant:
        return tuple(rest[:2]), rest[2:2 + n_tail]
    return None, rest[:n_tail]


def _layer_norm(x, scale, bias, eps=1e-5):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def _frozen(array, device):
    return nn.Parameter(torch.as_tensor(np.array(array, np.float32),
                                        device=device),
                        requires_grad=False)


class _Block(nn.Module):
    def __init__(self, arrays, device):
        super().__init__()
        for key in _BLOCK_KEYS:
            setattr(self, key, _frozen(arrays[key], device))


def params_from_numpy(tree, device=None):
    """Load a ``decode_params()`` pytree of numpy arrays — the JAX
    model's, converted with ``np.asarray`` — as the port's params dict
    of float32 tensors on `device` (None: "cuda", which raises without a
    card)."""
    device = resolve_device(device, "params_from_numpy")

    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    return {
        "tok_emb": t(tree["tok_emb"]), "pos_emb": t(tree["pos_emb"]),
        "blocks": [{k: t(blk[k]) for k in _BLOCK_KEYS}
                   for blk in tree["blocks"]],
        "ln_f_s": t(tree["ln_f_s"]), "ln_f_b": t(tree["ln_f_b"]),
        "head": t(tree["head"]),
    }


class TinyCausalLM(nn.Module):
    """Pre-LN transformer decoder: emb -> [attn + MLP] x L -> LN -> head
    (ReLU MLP, no qkv bias, untied head).  Weights live on `device` —
    None means "cuda", which raises without a card; pass "cpu" to run on
    the CPU — and `prefill` / `greedy_reference` run there;
    `decode_params(device)` hands an engine its weights on its device."""

    def __init__(self, vocab_size=64, num_layers=2, num_heads=2,
                 head_dim=8, mlp_ratio=2, max_positions=512, seed=0,
                 device=None, _arrays=None):
        super().__init__()
        self.vocab_size = int(vocab_size)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.d_model = self.num_heads * self.head_dim
        self.max_positions = int(max_positions)
        self.seed = seed
        dev = resolve_device(device, "TinyCausalLM")
        arrays = _arrays if _arrays is not None else self._draw(mlp_ratio)
        self.tok_emb = _frozen(arrays["tok_emb"], dev)
        self.pos_emb = _frozen(arrays["pos_emb"], dev)
        self.blocks = nn.ModuleList(_Block(b, dev) for b in arrays["blocks"])
        self.ln_f_s = _frozen(arrays["ln_f_s"], dev)
        self.ln_f_b = _frozen(arrays["ln_f_b"], dev)
        self.head = _frozen(arrays["head"], dev)

    def _draw(self, mlp_ratio):
        """Every weight from one seeded generator, in the JAX model's
        order (embeddings, then per block wq wk wv wo w1 w2, then the
        head); norms start at ones/zeros."""
        rng = np.random.default_rng(self.seed)
        d = self.d_model

        def w(*shape, scale=None):
            scale = scale or 1.0 / math.sqrt(shape[0])
            return rng.standard_normal(shape, np.float32) * scale

        def ones(n):
            return np.ones((n,), np.float32)

        def zeros(n):
            return np.zeros((n,), np.float32)

        arrays = {"tok_emb": w(self.vocab_size, d, scale=0.5),
                  "pos_emb": w(self.max_positions, d, scale=0.1),
                  "blocks": []}
        for _ in range(self.num_layers):
            arrays["blocks"].append({
                "ln1_s": ones(d), "ln1_b": zeros(d),
                "wq": w(d, d), "wk": w(d, d), "wv": w(d, d), "wo": w(d, d),
                "ln2_s": ones(d), "ln2_b": zeros(d),
                "w1": w(d, mlp_ratio * d), "b1": zeros(mlp_ratio * d),
                "w2": w(mlp_ratio * d, d), "b2": zeros(d),
            })
        arrays["ln_f_s"] = ones(d)
        arrays["ln_f_b"] = zeros(d)
        arrays["head"] = w(d, self.vocab_size)
        return arrays

    @classmethod
    def from_numpy_params(cls, tree, num_heads, seed=None, device=None):
        """A model on `device` holding the weights of a ``decode_params()``
        pytree of numpy arrays (the JAX model's, converted).  `num_heads`
        splits d_model into heads (the weights alone do not say)."""
        arrays = {k: np.asarray(tree[k], np.float32)
                  for k in ("tok_emb", "pos_emb", "ln_f_s", "ln_f_b",
                            "head")}
        arrays["blocks"] = [{k: np.asarray(b[k], np.float32)
                             for k in _BLOCK_KEYS} for b in tree["blocks"]]
        vocab, d = arrays["tok_emb"].shape
        return cls(vocab_size=vocab, num_layers=len(arrays["blocks"]),
                   num_heads=num_heads, head_dim=d // int(num_heads),
                   max_positions=arrays["pos_emb"].shape[0], seed=seed,
                   device=device, _arrays=arrays)

    def __reduce__(self):
        """Pickle as the constructor's arguments plus the weights as numpy
        arrays: an unpickler (a replica's worker process) rebuilds the
        model on ITS device of the same type, and never unpickles device
        storage."""
        arrays = {k: getattr(self, k).detach().cpu().numpy()
                  for k in ("tok_emb", "pos_emb", "ln_f_s", "ln_f_b",
                            "head")}
        arrays["blocks"] = [{k: getattr(b, k).detach().cpu().numpy()
                             for k in _BLOCK_KEYS} for b in self.blocks]
        return (_rebuild_tiny_causal_lm,
                (self.num_heads, self.seed, self.device.type, arrays))

    @property
    def device(self):
        """Where the weights live."""
        return self.tok_emb.device

    # ----------------------- shared per-position math ----------------
    def _embed(self, params, tokens, positions):
        # loud failure where a gather past the table would clamp (JAX) or
        # trip a device assert (CUDA)
        if int(positions.max()) >= self.max_positions:
            raise ValueError(f"position {int(positions.max())} >= "
                             f"max_positions={self.max_positions}")
        return params["tok_emb"][tokens] + params["pos_emb"][positions]

    def _qkv(self, blk, x):
        """x: [N, d_model] -> q, k, v each [N, H, D]."""
        n = x.shape[0]
        h, dd = self.num_heads, self.head_dim
        return ((x @ blk["wq"]).reshape(n, h, dd),
                (x @ blk["wk"]).reshape(n, h, dd),
                (x @ blk["wv"]).reshape(n, h, dd))

    @staticmethod
    def _mlp(blk, x):
        hlay = torch.relu(x @ blk["w1"] + blk["b1"])
        return hlay @ blk["w2"] + blk["b2"]

    @staticmethod
    def _logits(params, x):
        return _layer_norm(x, params["ln_f_s"], params["ln_f_b"]) \
            @ params["head"]

    # -------------------------- parameters ----------------------------
    def decode_params(self, device=None):
        """The weights as a plain dict of tensors on `device` (default:
        where they live) — the `params` argument of the step function."""
        def t(p):
            p = p.detach()
            return p if device is None else p.to(device)

        return {
            "tok_emb": t(self.tok_emb), "pos_emb": t(self.pos_emb),
            "blocks": [{k: t(getattr(b, k)) for k in _BLOCK_KEYS}
                       for b in self.blocks],
            "ln_f_s": t(self.ln_f_s), "ln_f_b": t(self.ln_f_b),
            "head": t(self.head),
        }

    # ----------------------------- prefill ---------------------------
    @torch.no_grad()
    def prefill(self, tokens):
        """tokens: [T] ints.  Returns (last_logits [V], k [L, T, H, D],
        v [L, T, H, D]) on the weights' device."""
        params = self.decode_params()
        dev = params["tok_emb"].device
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                 device=dev)
        t = tokens.shape[0]
        x = self._embed(params, tokens, torch.arange(t, device=dev))
        ks, vs = [], []
        for blk in params["blocks"]:
            hn = _layer_norm(x, blk["ln1_s"], blk["ln1_b"])
            q, k, v = self._qkv(blk, hn)
            ks.append(k)
            vs.append(v)
            attn = dense_causal_reference(q, k, v)
            x = x + attn.reshape(t, self.d_model) @ blk["wo"]
            x = x + self._mlp(blk, _layer_norm(x, blk["ln2_s"],
                                               blk["ln2_b"]))
        logits = self._logits(params, x[t - 1:t])[0]
        return logits, torch.stack(ks), torch.stack(vs)

    # -------------------------- batched prefill -----------------------
    @torch.no_grad()
    def prefill_batch(self, tokens, lengths):
        """tokens: [B, T] ints, length-padded (pad ids are real vocab
        rows: their K/V and logits are discarded); lengths: [B] real
        token counts.  Returns (last_logits [B, V] at each row's
        ``lengths - 1``, k [B, L, T, H, D], v [B, L, T, H, D]) on the
        weights' device.  The attention is dense causal plain PyTorch:
        no kernel of the TPU package runs here either."""
        tokens = np.asarray(tokens)
        b, t = tokens.shape
        if t > self.max_positions:
            raise ValueError(
                f"padded length {t} > max_positions={self.max_positions}")
        params = self.decode_params()
        dev = params["tok_emb"].device
        tok = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        last_row = torch.as_tensor(np.asarray(lengths), dtype=torch.long,
                                   device=dev) - 1
        h, dd = self.num_heads, self.head_dim
        scale = 1.0 / math.sqrt(dd)
        x = params["tok_emb"][tok] + params["pos_emb"][:t][None]
        causal = (torch.arange(t, device=dev)[:, None]
                  >= torch.arange(t, device=dev)[None, :])
        ks, vs = [], []
        for blk in params["blocks"]:
            hn = _layer_norm(x, blk["ln1_s"], blk["ln1_b"])
            q = (hn @ blk["wq"]).reshape(b, t, h, dd)
            k = (hn @ blk["wk"]).reshape(b, t, h, dd)
            v = (hn @ blk["wv"]).reshape(b, t, h, dd)
            ks.append(k)
            vs.append(v)
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
            logits = torch.where(causal[None, None], logits,
                                 torch.full_like(logits, NEG_INF))
            weights = torch.softmax(logits, dim=-1)
            attn = torch.einsum("bhqk,bkhd->bqhd", weights, v)
            x = x + attn.reshape(b, t, self.d_model) @ blk["wo"]
            x = x + self._mlp(blk, _layer_norm(x, blk["ln2_s"],
                                               blk["ln2_b"]))
        last = x[torch.arange(b, device=dev), last_row]
        return (self._logits(params, last), torch.stack(ks, 1),
                torch.stack(vs, 1))

    # ------------------------- eager decode ---------------------------
    @torch.no_grad()
    def decode(self, tokens, positions, attend):
        """tokens, positions: [B] host ints.  ``attend(layer, q, k, v)``
        (each [B, H, D]) writes the step's K/V into the engine-owned
        pools and returns paged attention [B, H, D].  Returns logits
        [B, V] on the weights' device."""
        positions = np.asarray(positions)
        if positions.size and int(positions.max()) >= self.max_positions:
            raise ValueError(f"position {int(positions.max())} >= "
                             f"max_positions={self.max_positions}")
        params = self.decode_params()
        dev = params["tok_emb"].device
        tok = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                              device=dev)
        pos = torch.as_tensor(positions, dtype=torch.long, device=dev)
        b = tok.shape[0]
        x = params["tok_emb"][tok] + params["pos_emb"][pos]
        for li, blk in enumerate(params["blocks"]):
            hn = _layer_norm(x, blk["ln1_s"], blk["ln1_b"])
            q, k, v = self._qkv(blk, hn)
            attn = attend(li, q, k, v)
            x = x + attn.reshape(b, self.d_model) @ blk["wo"]
            x = x + self._mlp(blk, _layer_norm(x, blk["ln2_s"],
                                               blk["ln2_b"]))
        return self._logits(params, x)

    # -------------------------- eager chunk -----------------------------
    @torch.no_grad()
    def prefill_chunk(self, tokens, start, attend):
        """One prefill CHUNK on the eager path (mirrors `decode`): tokens
        [n] host ints are the prompt slice at positions ``start .. start +
        n - 1``.  Per layer, ``attend(layer, q, k, v)`` (each [n, H, D])
        writes the chunk's K/V into the engine-owned pools and returns
        causal attention over prefix and chunk [n, H, D].  Returns the
        chunk's LAST position logits [V] on the weights' device: for the
        final chunk, the next-token logits, as `prefill` gives them.  The
        engine's warm one-shot prefill resumes mid-prompt through it."""
        params = self.decode_params()
        dev = params["tok_emb"].device
        tok = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                              device=dev)
        n = tok.shape[0]
        x = self._embed(params, tok,
                        int(start) + torch.arange(n, device=dev))
        for li, blk in enumerate(params["blocks"]):
            hn = _layer_norm(x, blk["ln1_s"], blk["ln1_b"])
            q, k, v = self._qkv(blk, hn)
            attn = attend(li, q, k, v)
            x = x + attn.reshape(n, self.d_model) @ blk["wo"]
            x = x + self._mlp(blk, _layer_norm(x, blk["ln2_s"],
                                               blk["ln2_b"]))
        return self._logits(params, x[n - 1:n])[0]

    # -------------------------- fused decode --------------------------
    def decode_step_fn(self, page_size, num_pages, pool_layout="token",
                       greedy=False, kv_quant=False):
        """The legacy fused decode step the engine's FusedDecodeStep
        calls once per decode step::

            fn(params, tokens, positions, k_pools, v_pools, page_tables,
               lens) -> (out, k_pools, v_pools)

        (with kv_quant: ``fn(params, tokens, positions, k_pools, v_pools,
        k_scales, v_scales, page_tables, lens) -> (out, k_pools, v_pools,
        k_scales, v_scales)``)

        tokens/positions: [B] int (B = the padded batch bucket);
        page_tables: [B, MP] int32 padded with page 0; lens: [B] int32
        cached tokens INCLUDING the one being decoded.  ``lens == 0``
        marks a DUMMY padding row: it embeds its padding token at
        position 0, writes its K/V into the sink page ``num_pages`` and
        its attention row is exact zeros.  Each layer writes the pools
        IN PLACE (the returned lists hold the same tensors), then attends
        through the page tables.  `out` is logits [B, V], or argmax ids
        [B] int32 with greedy=True; it stays on the device.  The device
        of the tensors picks the attention implementation."""
        page_size = int(page_size)
        num_pages = int(num_pages)

        @torch.no_grad()
        def step(params, tokens, positions, k_pools, v_pools, *rest):
            scales, (page_tables, lens) = _split_state(rest, kv_quant, 2)
            b = tokens.shape[0]
            pos = positions.long()
            x = params["tok_emb"][tokens.long()] + params["pos_emb"][pos]
            rows_b = torch.arange(b, device=pos.device)
            pages = torch.where(lens > 0,
                                page_tables[rows_b, pos // page_size].long(),
                                num_pages)
            rows = pos % page_size
            for li, blk in enumerate(params["blocks"]):
                hn = _layer_norm(x, blk["ln1_s"], blk["ln1_b"])
                q, k, v = self._qkv(blk, hn)
                kp, vp, ks, vs = _write_layer(li, k_pools, v_pools, scales,
                                              pages, rows, k, v,
                                              pool_layout)
                attn = decode_attention.paged_decode_attention(
                    q, kp, vp, page_tables, lens, layout=pool_layout,
                    k_scale=ks, v_scale=vs)
                x = x + attn.reshape(b, self.d_model) @ blk["wo"]
                x = x + self._mlp(blk, _layer_norm(x, blk["ln2_s"],
                                                   blk["ln2_b"]))
            logits = self._logits(params, x)
            out = (torch.argmax(logits, dim=-1).to(torch.int32) if greedy
                   else logits)
            return (out, k_pools, v_pools, *(scales or ()))

        return step

    # ------------------------- chunked prefill ------------------------
    def prefill_chunk_fn(self, page_size, num_pages, pool_layout="token",
                         kv_quant=False):
        """The legacy chunked-prefill step the engine's
        ChunkedPrefillStep calls once per chunk::

            fn(params, tokens, start, length, k_pools, v_pools,
               page_table) -> (last_logits [V], k_pools, v_pools)

        (with kv_quant, the scales after the pools in and out, as
        `decode_step_fn`'s)

        tokens: [C] int, the chunk padded to the fixed chunk size;
        start: host int, the chunk's first position (the tokens already
        cached); length: host int, the real chunk tokens.  Rows >=
        length are chunk padding: they embed position 0, write the sink
        page ``num_pages``, and their attention and logits are
        discarded.  page_table: [MP] int32 for this sequence, padded
        with page 0.  Each layer writes the chunk's K/V into the pools
        IN PLACE, then attends over prefix and chunk through the page
        table.  The logits stay on the device."""
        page_size = int(page_size)
        num_pages = int(num_pages)

        @torch.no_grad()
        def step(params, tokens, start, length, k_pools, v_pools, *rest):
            scales, (page_table,) = _split_state(rest, kv_quant, 1)
            start, length = int(start), int(length)
            c = tokens.shape[0]
            idx = torch.arange(c, device=tokens.device)
            live = idx < length
            positions = torch.where(live, start + idx, 0)
            x = (params["tok_emb"][tokens.long()]
                 + params["pos_emb"][positions])
            slot = torch.clamp((start + idx) // page_size,
                               max=page_table.shape[0] - 1)
            pages = torch.where(live, page_table[slot].long(), num_pages)
            rows = (start + idx) % page_size
            for li, blk in enumerate(params["blocks"]):
                hn = _layer_norm(x, blk["ln1_s"], blk["ln1_b"])
                q, k, v = self._qkv(blk, hn)
                kp, vp, ks, vs = _write_layer(li, k_pools, v_pools, scales,
                                              pages, rows, k, v,
                                              pool_layout)
                attn = decode_attention.chunk_prefill_attention(
                    q, kp, vp, page_table, start, layout=pool_layout,
                    k_scale=ks, v_scale=vs)
                x = x + attn.reshape(c, self.d_model) @ blk["wo"]
                x = x + self._mlp(blk, _layer_norm(x, blk["ln2_s"],
                                                   blk["ln2_b"]))
            logits = self._logits(params, x[length - 1:length])[0]
            return (logits, k_pools, v_pools, *(scales or ()))

        return step

    # -------------------------- ragged step ---------------------------
    def _ragged_core_fn(self, pool_layout="token"):
        """The ragged layer stack over one packed token axis::

            core(params, tokens, positions, pages, rows, page_tables,
                 starts, lens, kv_lens, k_pools, v_pools, scales)
              -> x [T, d]

        (`scales`: ``(k_scales, v_scales)`` of an int8 pool, else None.)

        Each layer writes its K/V into the pools (and scales) IN PLACE,
        then attends through the page tables.  Inert slots embed token 0 at position 0 (in bounds by
        construction), write into the sink page, and belong to no
        descriptor, so their attention rows are exactly 0."""

        def core(params, tokens, positions, pages, rows, page_tables,
                 starts, lens, kv_lens, k_pools, v_pools, scales):
            t = tokens.shape[0]
            x = params["tok_emb"][tokens] + params["pos_emb"][positions]
            for li, blk in enumerate(params["blocks"]):
                hn = _layer_norm(x, blk["ln1_s"], blk["ln1_b"])
                q, k, v = self._qkv(blk, hn)
                kp, vp, ks, vs = _write_layer(li, k_pools, v_pools, scales,
                                              pages, rows, k, v,
                                              pool_layout)
                attn = decode_attention.ragged_paged_attention(
                    q, kp, vp, page_tables, starts, lens, kv_lens,
                    layout=pool_layout, k_scale=ks, v_scale=vs)
                x = x + attn.reshape(t, self.d_model) @ blk["wo"]
                x = x + self._mlp(blk, _layer_norm(x, blk["ln2_s"],
                                                   blk["ln2_b"]))
            return x

        return core

    def _head_window(self, params, x, starts, lens, kk):
        """The verify window and the sample rows through ONE head matmul:
        each descriptor's rows ``start .. start + kk`` and its last row
        ``start + len - 1`` (rows clipped into the packed axis) are
        gathered BEFORE the head, so its cost is O(S * kk), never O(T).
        Returns ``(amax_rows [S, kk + 1] int32, logits [S, V])``."""
        t = x.shape[0]
        s_n = starts.shape[0]
        st = starts.long()
        offs = torch.arange(kk + 1, device=x.device)
        vrows = torch.clamp(st[:, None] + offs[None, :], 0, t - 1)
        sample_rows = torch.clamp(st + lens.long() - 1, 0, t - 1)
        heads = self._logits(params, torch.cat(
            [x[vrows.reshape(-1)], x[sample_rows]], dim=0))
        amax_rows = torch.argmax(heads[:s_n * (kk + 1)], dim=-1).to(
            torch.int32).reshape(s_n, kk + 1)
        return amax_rows, heads[s_n * (kk + 1):]

    def ragged_step_fn(self, page_size, num_pages, pool_layout="token",
                       kv_quant=False, spec_tokens=0):
        """The mixed-batch RAGGED step function the engine's RaggedStep
        calls once per engine step::

            fn(params, tokens, positions, pages, rows, page_tables,
               starts, lens, kv_lens, k_pools, v_pools)
              -> ((token_ids [S], logits [S, V]), k_pools, v_pools)

        (with kv_quant, ``k_scales, v_scales`` after the pools in and out)

        tokens/positions/pages/rows: [T] int — the PACKED token axis and
        each row's scatter target (inert slots: sink page ``num_pages``,
        position 0).  page_tables: [S, MP] int32.  starts/lens/kv_lens:
        [S] int32 descriptors — descriptor s owns packed rows
        [starts[s], starts[s]+lens[s]) and has kv_lens[s] cached tokens
        after this step's writes; lens == 0 marks an unused descriptor.
        Logits are taken at each descriptor's LAST packed row (padding
        descriptors read row 0, which the engine never samples); the
        argmax ids and the logits both stay on the device, so the engine
        fetches only what its samplers need.  The device of the tensors
        picks the attention implementation.

        spec_tokens = K > 0 adds the speculative verify epilogue: a
        speculating row is an ordinary ``len = 1 + k`` descriptor (its
        committed token, then k drafts), and the epilogue gathers each
        descriptor's rows start..start+K and its sample row before the
        head (`_head_window`), takes their argmax and runs
        `verify_accept`.  The two outputs become

            ints [S, 3] int32     — (last-row argmax, accepted count,
                                     bonus token): the all-greedy fetch
            aug [S, V + 3]        — the last-row logits with the same
                                     three columns appended as floats
                                     (exact: ids and counts are far
                                     below 2**24): the mixed-batch fetch

        so the engine still fetches ONE array per step."""
        del page_size, num_pages   # pages/rows arrive host-computed
        core = self._ragged_core_fn(pool_layout)
        kk = int(spec_tokens)

        @torch.no_grad()
        def step(params, tokens, positions, pages, rows, page_tables,
                 starts, lens, kv_lens, k_pools, v_pools, *rest):
            scales, _ = _split_state(rest, kv_quant, 0)
            t = tokens.shape[0]
            x = core(params, tokens, positions, pages, rows, page_tables,
                     starts, lens, kv_lens, k_pools, v_pools, scales)
            if kk:
                amax_rows, logits = self._head_window(params, x, starts,
                                                      lens, kk)
                ids = torch.argmax(logits, dim=-1).to(torch.int32)
                accepted, bonus = verify_accept(amax_rows, tokens, starts,
                                                lens, kk)
                ints = torch.stack([ids, accepted, bonus], dim=1)
                aug = torch.cat([logits, ints.to(logits.dtype)], dim=1)
                return ((ints, aug), k_pools, v_pools, *(scales or ()))
            sample_rows = torch.clamp(starts.long() + lens.long() - 1,
                                      0, t - 1)
            logits = self._logits(params, x[sample_rows])
            ids = torch.argmax(logits, dim=-1).to(torch.int32)
            return ((ids, logits), k_pools, v_pools, *(scales or ()))

        return step

    # ------------------------ host-free decode loop --------------------
    def ragged_loop_fn(self, page_size, num_pages, pool_layout="token",
                       kv_quant=False, spec_tokens=0, loop_steps=2,
                       max_stop_ids=8, max_stop_seqs=4, max_stop_len=8):
        """The HOST-FREE DECODE LOOP: N ragged decode steps in one call
        (the engine's LoopedRaggedStep), with on-device sampling, stop
        matching and per-row done masks, and ONE output for the loop::

            fn(params, cur_tok, cur_pos, live, page_tables, temps,
               top_ks, top_ps, seeds, counters, remaining, stop_ids,
               stop_seqs, stop_seq_lens, tail, drafts, draft_lens,
               k_pools, v_pools[, k_scales, v_scales])
              -> (out [S, N + K + 6] int32, k_pools, v_pools[, scales])

        The inputs, their layout and the output columns are the JAX
        package's ``ragged_loop_fn``'s.  Decode-only: descriptor s owns
        packed rows ``[s*(1+K), s*(1+K) + len_s)`` (K = spec_tokens), so
        the packed axis is ``S * (1 + K)`` and the starts never move.
        Per row: cur_tok/cur_pos — the last committed token and its
        position (its K/V is written by the first iteration); live — 1
        for occupied rows; temps/top_ks/top_ps/seeds/counters — the
        sampling menu and the SampleStream state (int32 holding uint32);
        remaining — tokens still allowed; stop_ids [S, MS] (pad -1);
        stop_seqs [S, NS, LS] right-aligned (pad -1) with stop_seq_lens
        [S, NS]; tail [S, LS - 1] — the last generated tokens,
        right-aligned; drafts [S, max(K, 1)] / draft_lens — drafts
        verified at iteration 0 only.

        Each iteration runs the shared layer stack (`_ragged_core_fn`,
        the single step's own), the verify window and sample rows
        through one head (`_head_window`), `verify_accept`,
        `sample_tokens_device`, then for each of the up-to-(K+1)
        candidate tokens the engine's gate order: stop id, stop sequence
        (the completing token is withheld), append, length (that token
        is streamed).  Rows finish with code 1 (stop) or 2 (length).

        The N iterations are unrolled and masked, never branched on a
        device value, so the whole call holds no host sync and can be
        captured as one CUDA graph.  An iteration after every live row
        finished runs with every descriptor dead (len 0, writes to the
        sink page, no draws), so pools, counters and outputs equal the
        JAX loop's, which exits early instead; the `iters_run` column
        counts the iterations in which some row was still active (the
        JAX loop's count).

        Output columns per row: N + K emitted tokens (pad -1), n_emit,
        finish code, finish_iter (-1 if unfinished), final_pos (the
        position of the last committed token: the host's truncate
        target), counter_after, iters_run."""
        page_size = int(page_size)
        num_pages = int(num_pages)
        n_steps = int(loop_steps)
        kk = int(spec_tokens)
        kd = max(kk, 1)
        if n_steps < 1:
            raise ValueError(f"loop_steps must be >= 1, got {loop_steps}")
        max_emit = n_steps + kk
        core = self._ragged_core_fn(pool_layout)
        max_pos = self.max_positions
        i32 = torch.int32

        @torch.no_grad()
        def fn(params, cur_tok, cur_pos, live, page_tables, temps, top_ks,
               top_ps, seeds, counters, remaining, stop_ids, stop_seqs,
               stop_seq_lens, tail, drafts, draft_lens, k_pools, v_pools,
               *rest):
            scales, _ = _split_state(rest, kv_quant, 0)
            dev = cur_tok.device
            s = cur_tok.shape[0]
            cur_tok = cur_tok.to(i32)
            cur_pos = cur_pos.to(i32)
            counters = counters.to(i32)
            remaining = remaining.to(i32)
            tail = tail.to(i32)
            pt = page_tables.to(i32)
            offs = torch.arange(1 + kk, dtype=i32, device=dev)
            starts = torch.arange(s, dtype=i32, device=dev) * (1 + kk)
            greedy_row = temps <= 0.0
            live_row = live > 0
            row_ix = torch.arange(s, device=dev)
            zero = torch.zeros((s,), dtype=i32, device=dev)
            finish = zero.clone()
            finish_iter = torch.full((s,), -1, dtype=i32, device=dev)
            n_emit = zero.clone()
            emitted = torch.full((s, max_emit), -1, dtype=i32, device=dev)
            iters_run = torch.zeros((), dtype=i32, device=dev)
            for it in range(n_steps):
                act0 = live_row & (finish == 0)
                iters_run = iters_run + act0.any().to(i32)
                # iteration 0 verifies the host's drafts; later ones are
                # plain one-token rows (greedy streams do not depend on
                # the drafts, so this equals drafting every step)
                dlen = (torch.where(act0, draft_lens.to(i32), zero)
                        if it == 0 else zero)
                len_s = torch.where(act0, 1 + dlen, zero)
                valid = offs[None, :] < len_s[:, None]            # [S,1+K]
                tok_grid = (torch.cat([cur_tok[:, None],
                                       drafts[:, :kk].to(i32)], dim=1)
                            if kk else cur_tok[:, None])
                pos_grid = cur_pos[:, None] + offs[None, :]
                tokens_p = torch.where(valid, tok_grid, 0).reshape(-1)
                positions_p = torch.where(
                    valid, torch.clamp(pos_grid, 0, max_pos - 1),
                    0).reshape(-1)
                page_ix = torch.clamp(pos_grid // page_size, 0,
                                      pt.shape[1] - 1)
                pages_p = torch.where(
                    valid, torch.gather(pt, 1, page_ix.long()),
                    num_pages).reshape(-1)
                rows_p = torch.where(valid, pos_grid % page_size,
                                     0).reshape(-1)
                kv_lens = torch.where(act0, cur_pos + 1 + dlen, zero)
                x = core(params, tokens_p, positions_p, pages_p, rows_p, pt,
                         starts, len_s, kv_lens, k_pools, v_pools, scales)
                amax_rows, logits = self._head_window(params, x, starts,
                                                      len_s, kk)
                accepted, bonus = verify_accept(amax_rows, tokens_p, starts,
                                                len_s, kk)
                sampled, ctr_next = sample_tokens_device(
                    logits, temps, top_ks, top_ps, seeds, counters)
                counters = torch.where(act0, ctr_next, counters)
                final_tok = torch.where(greedy_row, bonus, sampled)
                # the accepted drafts, then the final token, through the
                # engine's gate order: stop id -> stop sequence (token
                # withheld) -> append -> length (token streamed)
                for j in range(kk + 1):
                    tok = (torch.where(j < accepted,
                                       drafts[:, min(j, kd - 1)].to(i32),
                                       final_tok) if kk else final_tok)
                    emit_ok = act0 & (finish == 0) & (j <= accepted)
                    hit_id = torch.any(tok[:, None] == stop_ids, dim=1)
                    cand = torch.cat([tail, tok[:, None]], dim=1)  # [S,LS]
                    seq_eq = ((stop_seqs == -1)
                              | (cand[:, None, :] == stop_seqs))
                    hit_seq = torch.any(torch.all(seq_eq, dim=2)
                                        & (stop_seq_lens > 0), dim=1)
                    stop_hit = emit_ok & (hit_id | hit_seq)
                    appended = emit_ok & ~stop_hit
                    col = torch.clamp(n_emit, 0, max_emit - 1).long()
                    emitted[row_ix, col] = torch.where(
                        appended, tok, emitted[row_ix, col])
                    n_emit = n_emit + appended.to(i32)
                    if tail.shape[1]:
                        tail = torch.where(
                            appended[:, None],
                            torch.cat([tail[:, 1:], tok[:, None]], dim=1),
                            tail)
                    cur_tok = torch.where(appended, tok, cur_tok)
                    cur_pos = torch.where(appended, cur_pos + 1, cur_pos)
                    remaining = remaining - appended.to(i32)
                    len_hit = appended & (remaining <= 0)
                    finish = torch.where(
                        stop_hit, 1, torch.where(len_hit, 2, finish))
                    done_now = (stop_hit | len_hit) & (finish_iter < 0)
                    finish_iter = torch.where(done_now, it, finish_iter)
            out = torch.cat(
                [emitted, n_emit[:, None], finish[:, None],
                 finish_iter[:, None], cur_pos[:, None], counters[:, None],
                 iters_run.expand(s)[:, None]], dim=1).to(i32)
            return (out, k_pools, v_pools, *(scales or ()))

        return fn

    # ------------------------ reference decode ------------------------
    def greedy_reference(self, prompt, max_new_tokens, stop_tokens=()):
        """Naive sequential generation, FULL recompute each step (the
        oracle the engine is measured against): re-runs prefill over the
        whole prefix for every token, no KV cache at all."""
        stop = frozenset(int(s) for s in stop_tokens)
        tokens = [int(t) for t in prompt]
        out = []
        for _ in range(max_new_tokens):
            logits, _, _ = self.prefill(tokens)
            nxt = int(torch.argmax(logits))
            if nxt in stop:
                break
            tokens.append(nxt)
            out.append(nxt)
        return out


def _rebuild_tiny_causal_lm(num_heads, seed, device, arrays):
    """The unpickler of TinyCausalLM.__reduce__."""
    return TinyCausalLM.from_numpy_params(arrays, num_heads, seed=seed,
                                          device=device)
