"""The int8 KV pools' acceptance contract against the fp32 oracle: token
agreement and bounded logit drift.

Token identity with a float32 run cannot hold for int8 pools, which
change values by construction.  The contract is this harness instead:

- ``greedy_token_agreement``: the float32 engine and the int8 engine on
  the same seeded prompts, scored by position-wise greedy agreement (the
  acceptance floor is >= 0.99);
- ``teacher_forced_logit_drift``: a float32 pool and an int8 pool driven
  through the SAME decode trajectory (teacher-forced on the float32
  greedy stream, so the comparison never walks off-distribution), with
  the max absolute next-token-logit gap as the drift.  Beside it stands
  the drift of the idealized single-rounding fake-quant of the same K/V
  (each page's rows rounded once against its abs-max), so a write path
  that rounds too often shows up as measured >> ideal.

Both are deterministic per (model seed, prompt seed).  The fake-quant is
this module's own copy of the symmetric quant-dequant forward math,
``clip(round(x / s * 127)) * s / 127`` with s floored at 1e-9.
"""
import numpy as np
import torch

from .decode_attention import (chunk_prefill_attention_reference,
                               paged_decode_attention_reference)
from .kv_cache import DeviceKVPool


def seeded_prompts(vocab_size, n_prompts=6, lo=5, hi=24, seed=1234):
    """The quality workload: deterministic ragged prompts."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab_size,
                         int(rng.integers(lo, hi))).tolist()
            for _ in range(n_prompts)]


def greedy_token_agreement(model, prompts, base_config, quant_config,
                           max_new_tokens=16):
    """Position-wise greedy agreement between two engine configs on the
    same prompts.  Returns ``{"agreement", "tokens_base", "tokens_quant",
    "positions"}``: agreement is matching positions over the LONGER
    stream's length, so a run that stops early scores its missing tail
    as disagreement; both configs cap at `max_new_tokens`."""
    from .engine import GenerationEngine

    streams = []
    for config in (base_config, quant_config):
        eng = GenerationEngine(model, config, start=False)
        try:
            handles = [eng.submit(p, max_new_tokens=max_new_tokens)
                       for p in prompts]
            eng.run_until_idle()
            streams.append([h.result(timeout=30).token_ids
                            for h in handles])
        finally:
            eng.shutdown()
    base, quant = streams
    match = total = 0
    for tb, tq in zip(base, quant):
        n = max(len(tb), len(tq))
        total += n
        match += sum(1 for a, b in zip(tb, tq) if a == b)
    return {
        "agreement": (match / total) if total else 1.0,
        "positions": total,
        "tokens_base": base,
        "tokens_quant": quant,
    }


def teacher_forced_logit_drift(model, prompts, quant_config, steps=8):
    """Max |logit_fp32 - logit_quant| along the float32 greedy trajectory.

    One float32 DeviceKVPool and one of `quant_config`'s dtype and layout,
    on the model's device, receive the SAME model-produced K/V (the int8
    pool rounds at storage); each of `steps` decode steps per prompt runs
    the same query against both, so the logit gap isolates what the
    quantized storage changed.  Returns ``{"max_drift", "mean_drift",
    "ideal_fake_quant_drift", "steps"}``."""
    cfg = quant_config
    dev = model.device

    def build(dtype):
        return DeviceKVPool(
            model.num_layers, model.num_heads, model.head_dim,
            num_pages=int(cfg.num_pages), page_size=int(cfg.page_size),
            dtype=dtype, pool_layout=cfg.pool_layout or "token",
            device=dev)

    drifts, ideal_drifts = [], []
    n_steps = 0
    for pi, prompt in enumerate(prompts):
        base = build(torch.float32)
        quant = build(cfg.kv_dtype)
        sid = ("qgate", pi)
        tokens = [int(t) for t in prompt]
        logits, k, v = model.prefill(np.asarray(tokens, np.int32))
        for c in (base, quant):
            c.allocate(sid)
            c.reserve(sid, len(tokens))
            c.write_prefill_batch([sid], [0], [len(tokens)], k[None],
                                  v[None])
        k, v = k.cpu().numpy(), v.cpu().numpy()
        kq, vq = _fake_quant_pages(k, v, quant.page_size)
        for _ in range(steps):
            nxt = int(torch.argmax(logits))
            tokens.append(nxt)
            pos = base.reserve(sid, 1)
            quant.reserve(sid, 1)
            outs = {}
            for tag, c in (("base", base), ("quant", quant)):
                pt, lens = c.gather_block_tables([sid])
                pt = torch.as_tensor(pt, device=dev)
                lens = torch.as_tensor(lens, device=dev)

                def attend(layer, q, k_new, v_new, c=c, pt=pt, lens=lens):
                    c.write_decode_tokens([sid], [pos], layer, k_new, v_new)
                    kp, vp = c.layer_pools(layer)
                    ks, vs = c.layer_scales(layer)
                    return paged_decode_attention_reference(
                        q, kp, vp, pt, lens, layout=c.pool_layout,
                        k_scale=ks, v_scale=vs)

                outs[tag] = model.decode([nxt], [pos], attend)[0]
            drifts.append(float(torch.max(torch.abs(outs["base"]
                                                    - outs["quant"]))))
            # the single-rounding floor on the SAME step: dense attention
            # over the exact vs the fake-quant prefix plus the exact new row
            ideal_drifts.append(_ideal_step_drift(model, tokens, pos, k, v,
                                                  kq, vq))
            logits = outs["base"]     # teacher-forced on the fp32 greedy
            k, v, kq, vq = _append_row(model, base, sid, pos, k, v,
                                       quant.page_size)
            n_steps += 1
    return {
        "max_drift": max(drifts) if drifts else 0.0,
        "mean_drift": float(np.mean(drifts)) if drifts else 0.0,
        "ideal_fake_quant_drift": max(ideal_drifts) if ideal_drifts
        else 0.0,
        "steps": n_steps,
    }


def _quant_dequant(x, scale, bits=8):
    """Symmetric fake-quant forward, float32: ``x + (q - x)`` with
    ``q = clip(round(x / s * qmax), -qmax, qmax) * s / qmax`` and s
    floored at 1e-9 (the straight-through form's forward value)."""
    qmax = np.float32(2 ** (bits - 1) - 1)
    scale = np.maximum(scale, np.float32(1e-9))
    q = np.clip(np.round(x / scale * qmax), -qmax, qmax) * scale / qmax
    return x + (q - x)


def _fake_quant_pages(k, v, page_size):
    """Fake-quant each [page, head] block of [L, T, H, D] K/V against its
    abs-max: the idealized single-rounding view."""
    def fq(x):
        x = np.asarray(x, np.float32)
        out = np.array(x)
        for p0 in range(0, x.shape[1], page_size):
            blk = x[:, p0:p0 + page_size]          # [L, n, H, D]
            scale = np.max(np.abs(blk), axis=(1, 3))[:, None, :, None]
            out[:, p0:p0 + page_size] = _quant_dequant(blk, scale)
        return out

    return fq(k), fq(v)


def _ideal_step_drift(model, tokens, pos, k, v, kq, vq):
    """One teacher-forced step against the fake-quant K/V: dense
    attention over the exact vs the fake-quant prefix (positions
    [0, pos)) plus the exact new row — the single-rounding drift."""
    dev = model.device

    def decode_with(kk, vv):
        def attend(layer, q, k_new, v_new):
            k_all = torch.cat([torch.as_tensor(kk[layer][:pos], device=dev),
                               k_new], dim=0)
            v_all = torch.cat([torch.as_tensor(vv[layer][:pos], device=dev),
                               v_new], dim=0)
            return chunk_prefill_attention_reference(q, k_all, v_all, pos)

        return model.decode([tokens[-1]], [pos], attend)[0]

    exact = decode_with(k, v)
    ideal = decode_with(kq, vq)
    return float(torch.max(torch.abs(exact - ideal)))


def _append_row(model, base, sid, pos, k, v, page_size):
    """Extend the exact K/V views with the row the float32 pool stored at
    `pos` (read back from the pool, so the views track it bitwise), and
    fake-quant them again."""
    page = base.page_table(sid)[pos // page_size]
    row = pos % page_size
    ks, vs = [], []
    for layer in range(model.num_layers):
        kp, vp = base.layer_pools(layer)
        if base.pool_layout == "kernel":
            kr, vr = kp[:, page, row], vp[:, page, row]
        else:
            kr, vr = kp[page, row], vp[page, row]
        ks.append(kr.cpu().numpy()[None])
        vs.append(vr.cpu().numpy()[None])
    k_new = np.concatenate([k, np.stack(ks)], axis=1)
    v_new = np.concatenate([v, np.stack(vs)], axis=1)
    kq, vq = _fake_quant_pages(k_new, v_new, page_size)
    return k_new, v_new, kq, vq


def kv_quality_report(model, base_config, quant_config, prompts=None,
                      max_new_tokens=16):
    """The one-call quality gate: agreement and drift on the seeded
    workload, as a flat dict."""
    if prompts is None:
        prompts = seeded_prompts(model.vocab_size)
    agree = greedy_token_agreement(model, prompts, base_config,
                                   quant_config,
                                   max_new_tokens=max_new_tokens)
    drift = teacher_forced_logit_drift(model, prompts, quant_config)
    return {
        "agreement": round(agree["agreement"], 4),
        "positions": agree["positions"],
        "max_logit_drift": round(drift["max_drift"], 6),
        "mean_logit_drift": round(drift["mean_drift"], 6),
        "ideal_fake_quant_drift": round(
            drift["ideal_fake_quant_drift"], 6),
        "drift_steps": drift["steps"],
    }
