"""Port parity: flash attention (``paddle_tpu_torch.ops.flash_attention``
and the gate in ``ops.attention``).

The port's plain versions (the CPU path of the CUDA kernels' wrappers)
against the JAX package's Pallas kernels in interpret mode
(``_flash_fwd_call``, ``_flash_bwd_call``, ``_flash``), on the same
seeded numpy inputs.  Tolerances: out and lse atol = rtol = 2e-5 in fp32
(dense vs online softmax, other summation orders); dq, dk, dv 5e-4, the
JAX package's own tolerance for its kernel's grads; bf16 2e-2 (bf16
outputs, and p rounded to bf16 against the running max on the TPU side
and the row max here).
"""
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu.ops.pallas.flash_attention  # noqa: F401
from paddle_tpu.ops.attention import (
    scaled_dot_product_attention as jax_sdpa)
from paddle_tpu_torch.ops import attention as pattn
from paddle_tpu_torch.ops import flash_attention as fa

J = sys.modules["paddle_tpu.ops.pallas.flash_attention"]
TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)

# (bh, heads, lq, lk, d, causal, mask)
CASES = {
    "plain": (4, 2, 64, 64, 32, False, False),
    "causal": (4, 2, 64, 64, 32, True, False),
    "key_mask_full_row": (4, 2, 32, 32, 16, False, True),
    "causal_key_mask": (4, 2, 32, 32, 16, True, True),
    "causal_lq8_lk64": (2, 1, 8, 64, 16, True, False),
    "causal_l48": (2, 1, 48, 48, 16, True, False),
    "multiblock_l1024": (2, 1, 1024, 1024, 16, True, False),
}


def _inputs(bh, heads, lq, lk, d, mask, seed=0):
    rng = np.random.default_rng(seed)
    qs = (rng.standard_normal((bh, lq, d)) / math.sqrt(d)).astype(np.float32)
    k, v = (rng.standard_normal((bh, lk, d)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((bh, lq, d)).astype(np.float32)
    km = None
    if mask:   # batch row 0 masks every key, the last row its last three
        km = np.zeros((bh // heads, 1, lk), np.float32)
        km[0] = -1e30
        km[-1, 0, -3:] = -1e30
    return qs, k, v, do, km


def _jax(qs, k, v, do, km, causal, heads, dtype=jnp.float32):
    jq, jk, jv, jdo = (jnp.asarray(x).astype(dtype) for x in (qs, k, v, do))
    jkm = (jnp.asarray(km) if km is not None
           else jnp.zeros((1, 1, k.shape[1]), jnp.float32))
    out, lse = J._flash_fwd_call(jq, jk, jv, jkm, causal, heads,
                                 km is not None)
    grads = J._flash_bwd_call(jq, jk, jv, jkm, out, lse, jdo, causal, heads,
                              km is not None)
    return [np.asarray(x, np.float32) for x in (out, lse[..., 0], *grads)]


def _port(qs, k, v, do, km, causal, heads, dtype=torch.float32):
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (qs, k, v, do))
    tkm = None if km is None else torch.from_numpy(km)
    out, lse = fa.flash_attention_fwd_kernel(tq, tk, tv, tkm, causal, heads)
    delta = (tdo.float() * out.float()).sum(-1)
    dk, dv = fa.flash_attention_bwd_dkdv_kernel(tq, tk, tv, tdo, lse, delta,
                                                tkm, causal, heads)
    dq = fa.flash_attention_bwd_dq_kernel(tq, tk, tv, tdo, lse, delta, tkm,
                                          causal, heads)
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == dtype
    return [x.float().numpy() for x in (out, lse, dq, dk, dv)]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_versions_match_the_pallas_kernels(case):
    bh, heads, lq, lk, d, causal, mask = CASES[case]
    args = _inputs(bh, heads, lq, lk, d, mask)
    want = _jax(*args, causal, heads)
    got = _port(*args, causal, heads)
    for name, g, w, tol in zip(("out", "lse", "dq", "dk", "dv"), got, want,
                               (TOL, TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        np.testing.assert_allclose(g, w, err_msg=name, **tol)
    if mask:   # batch row 0 sees no key: out 0, lse NEG_INF, no grads
        assert (got[0][:heads] == 0).all()
        assert (got[1][:heads] == fa.NEG_INF).all()
        assert (got[2][:heads] == 0).all()


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_inputs_match_the_pallas_kernels(causal):
    args = _inputs(2, 1, 32, 32, 16, False, seed=3)
    want = _jax(*args, causal, 1, jnp.bfloat16)
    got = _port(*args, causal, 1, torch.bfloat16)
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **BF16_TOL)


@pytest.mark.parametrize("mask", [False, True])
def test_autograd_function_matches_jax_grad_of_flash(mask):
    """`FlashAttention.apply` (CPU route) against ``jax.grad`` of the
    custom_vjp ``_flash``, through a weighted sum of the output."""
    qs, k, v, do, km = _inputs(4, 2, 40, 40, 16, mask, seed=5)
    jkm = jnp.asarray(km) if mask else jnp.zeros((1, 1, 40), jnp.float32)

    def loss(a, b, c):
        return (J._flash(a, b, c, jkm, True, 2, mask) * jnp.asarray(do)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (qs, k, v)))
    ts = [torch.tensor(x, requires_grad=True) for x in (qs, k, v)]
    out = fa.FlashAttention.apply(*ts, None if km is None
                                  else torch.from_numpy(km), True, 2)
    (out * torch.from_numpy(do)).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   **GRAD_TOL)


@pytest.mark.parametrize("mask_shape", [None, (2, 1, 1, 24), (1, 1, 1, 24)])
@pytest.mark.parametrize("lq", [24, 9])
def test_public_flash_matches_the_composite_with_grads(mask_shape, lq):
    """``flash_attention`` (scale folded into q, mask broadcast to the
    batch and its last Lk keys taken) against the composite path of the
    port's sdpa and the JAX package's, forward and q/k/v grads."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 3, lq, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 3, 24, 8)).astype(np.float32)
            for _ in range(2))
    mask = None
    if mask_shape is not None:
        mask = np.zeros(mask_shape, np.float32)
        mask[..., -4:] = -1e30
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    out = fa.flash_attention(*ts, tmask, causal=True)
    out.square().sum().backward()
    flash_grads = [t.grad.clone() for t in ts]
    for t in ts:
        t.grad = None
    ref, _ = pattn.scaled_dot_product_attention(*ts, attn_mask=tmask,
                                                is_causal=True)
    ref.square().sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               **TOL)
    for g, t in zip(flash_grads, ts):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), **GRAD_TOL)
    jout, _ = jax_sdpa(*map(jnp.asarray, (q, k, v)),
                       attn_mask=None if mask is None else jnp.asarray(mask),
                       is_causal=True, use_flash=False)
    np.testing.assert_allclose(ref.detach().numpy(),
                               np.asarray(jout._data), **TOL)


def test_mask_gate_matches_jax():
    shapes = [None, (2, 1, 1, 16), (1, 1, 1, 16), (2, 16), (2, 2, 1, 16),
              (2, 1, 4, 16), (16, 16)]
    for shape in shapes:
        mask = None if shape is None else np.zeros(shape, np.float32)
        want = J.mask_is_flash_compatible(mask)
        got = fa.mask_is_flash_compatible(
            None if mask is None else torch.from_numpy(mask))
        assert got == want, shape


def test_shape_gate_reads_head_dims_and_shared_memory_only():
    assert fa.shapes_fit_kernels(512, 512, 64)
    assert fa.shapes_fit_kernels(2000, 5000, 128)     # lengths are free
    assert fa.shapes_fit_kernels(48, 48, 1)
    assert not fa.shapes_fit_kernels(512, 512, 129)
    assert not fa.shapes_fit_kernels(0, 512, 64)
    assert fa.kernel_smem_bytes(128) <= fa.SMEM_PER_BLOCK
    # D 64: the backward (2 owned tiles of 64 rows of 64 floats, 2 x 2
    # walked tiles of 32, 2 x 2 rows of 32) outgrows the forward (one
    # owned Q tile, 2 x 2 walked K and V tiles, 2 key-mask rows of 32:
    # 4 * (64 * (64 + 4 * 32) + 2 * 32) = 49,408 bytes)
    assert fa.kernel_smem_bytes(64) == 4 * (64 * (2 * 64 + 4 * 32)
                                            + 4 * 32)
    # D 128: the backward is the largest, its rows 128 floats wide
    assert fa.kernel_smem_bytes(128) == 4 * (128 * (2 * 64 + 4 * 32)
                                             + 4 * 32)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds and the kernels' add-and-mask
    does: add half of the 13 dropped bits to the magnitude, then clear
    them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    """x as a TF32 MMA operand reads it: its 13 low bits ignored."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the backward kernels' tensor cores compute it: each
    operand split into big = tf32(x) and small = x - big (read truncated
    to TF32), and the three products small.big + big.small + big.big
    summed in fp32 (the products of two TF32 values are exact in
    fp32)."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32_truncated(a - ab), _tf32_truncated(b - bb)
    return as_ @ bb + ab @ bs + ab @ bb


def _mm_tf32(a, b):
    """One-pass TF32: both operands rounded once."""
    return _tf32(a) @ _tf32(b)


def _bwd_model(mm, qs, k, v, do, lse, delta, km, heads):
    """dq, dk, dv of the backward kernels' arithmetic with products
    through `mm` (causal, f32): S and dP, then p and dS, then dV = p^T.dO,
    dK = dS^T.qs, dQ = dS.k."""
    bh, lq, _ = qs.shape
    lk = k.shape[1]
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    s = mm(qs, t(k)) + km.reshape(km.shape[0], lk)[
        torch.arange(bh) // heads][:, None, :]
    visible = (torch.arange(lq)[:, None] + (lk - lq)
               >= torch.arange(lk)[None, :])
    s = torch.where(visible, s, torch.full_like(s, fa.NEG_INF))
    p = torch.where(s <= fa.NEG_INF / 2, torch.zeros_like(s),
                    torch.exp(s - lse[..., None]))
    ds = p * (mm(do, t(v)) - delta[..., None])
    return mm(ds, k), mm(t(ds), qs), mm(t(p), do)


def test_3xtf32_model_of_the_backward_kernels_keeps_fp32_parity(capsys):
    """The backward kernels' rounding scheme on the CPU: every product
    of dq, dk, dv through the 3xTF32 split stays within the card's
    FLASH_GRAD_TOL (1e-4) of the plain versions at BH 4, L 200, D 64,
    causal with the key mask.  One-pass TF32 (each operand rounded to
    10 mantissa bits once) misses it by two orders of magnitude at this
    case: max |diff| dq 1.3e-02, dk 1.9e-03, dv 1.9e-03 (the error of S
    moves every weight through the exponential), against the split's
    9.5e-06.  That is why the kernels split; the one-pass numbers are
    printed, not asserted, since they depend on the case."""
    qs, k, v, do, km = (None if x is None else torch.from_numpy(x)
                        for x in _inputs(4, 2, 200, 200, 64, True, seed=5))
    out, lse = fa.flash_attention_fwd_torch(qs, k, v, km, True, 2)
    delta = (do * out).sum(-1)
    dk_p, dv_p = fa.flash_attention_bwd_dkdv_torch(qs, k, v, do, lse,
                                                   delta, km, True, 2)
    dq_p = fa.flash_attention_bwd_dq_torch(qs, k, v, do, lse, delta, km,
                                           True, 2)
    want = (dq_p, dk_p, dv_p)
    split = _bwd_model(_mm_3xtf32, qs, k, v, do, lse, delta, km, 2)
    for name, got, w in zip(("dq", "dk", "dv"), split, want):
        torch.testing.assert_close(got, w, atol=1e-4, rtol=1e-4,
                                   msg=lambda m, n=name: f"{n}: {m}")
    one = _bwd_model(_mm_tf32, qs, k, v, do, lse, delta, km, 2)
    errs = {n: float((g - w).abs().max())
            for n, g, w in zip(("dq", "dk", "dv"), one, want)}
    worst = max(float((g - w).abs().max()) for g, w in zip(split, want))
    with capsys.disabled():
        print(f"\n  one-pass TF32 max|diff| {errs}; 3xTF32 {worst:.2e}")


def _fwd_model(mm, qs, k, v, km, heads, round_p=lambda p: p,
               sum_rounded=False):
    """out (f32), lse of the forward kernel's arithmetic (causal): the
    online softmax over tiles of WALKED keys, S and P.V through `mm`.
    Per tile: S with the key mask and NEG_INF above the diagonal, m_new =
    max(m, rowmax S), alpha = exp(m - m_new), p = exp(S - m_new) (0 where
    masked), l = alpha l + rowsum(p) of the f32 p, acc = alpha acc +
    round_p(p).V (with `sum_rounded`, l sums round_p(p) instead); then
    out = acc / l, lse = m + log l (NEG_INF, out 0, where l = 0)."""
    bh, lq, d = qs.shape
    lk = k.shape[1]
    qs, k, v = qs.float(), k.float(), v.float()
    kmr = km.reshape(km.shape[0], lk)[torch.arange(bh) // heads][:, None]
    rows = torch.arange(lq)[:, None] + (lk - lq)
    m = torch.full((bh, lq, 1), fa.NEG_INF)
    l = torch.zeros((bh, lq, 1))
    acc = torch.zeros((bh, lq, d))
    for k0 in range(0, lk, fa.WALKED):
        keys = torch.arange(k0, min(k0 + fa.WALKED, lk))
        s = mm(qs, k[:, keys].transpose(1, 2)) + kmr[..., keys]
        s = torch.where(rows >= keys[None, :], s,
                        torch.full_like(s, fa.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(s <= fa.NEG_INF / 2, torch.zeros_like(s),
                        torch.exp(s - m_new))
        l = l * alpha + (round_p(p) if sum_rounded else p).sum(
            -1, keepdim=True)
        acc = acc * alpha + mm(round_p(p), v[:, keys])
        m = m_new
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    lse = torch.where(l > 0, m + torch.log(safe_l),
                      torch.full_like(l, fa.NEG_INF))
    return acc / safe_l, lse[..., 0]


def test_3xtf32_model_of_the_forward_kernel_keeps_fp32_parity(capsys):
    """The forward kernel's arithmetic on the CPU (online softmax over
    tiles of 32 keys, S and P.V through the 3xTF32 split) keeps out and
    lse within the card's FLASH_TOL (2e-5) of the plain version at BH 4,
    L 200, D 64, causal with the key mask.  One-pass TF32's error is
    printed, not asserted, since it depends on the case."""
    qs, k, v, _, km = (None if x is None else torch.from_numpy(x)
                       for x in _inputs(4, 2, 200, 200, 64, True, seed=5))
    want = fa.flash_attention_fwd_torch(qs, k, v, km, True, 2)
    split = _fwd_model(_mm_3xtf32, qs, k, v, km, 2)
    for name, got, w in zip(("out", "lse"), split, want):
        torch.testing.assert_close(got, w, **TOL,
                                   msg=lambda m, n=name: f"{n}: {m}")
    assert (split[0][:2] == 0).all() and (split[1][:2] == fa.NEG_INF).all()
    one = _fwd_model(_mm_tf32, qs, k, v, km, 2)
    errs = {n: float((g - w).abs().max())
            for n, g, w in zip(("out", "lse"), one, want)}
    worst = max(float((g - w).abs().max()) for g, w in zip(split, want))
    with capsys.disabled():
        print(f"\n  forward: one-pass TF32 max|diff| {errs}; 3xTF32 "
              f"{worst:.2e}")


def test_bf16_model_of_the_forward_kernel_keeps_the_pallas_rule(capsys):
    """bf16 inputs: the forward kernel rounds p to bf16 before P.V and
    sums l from the unrounded f32 p, as the Pallas body does
    (``p.astype(v.dtype)``; ``jnp.sum(p)``).  The model of that rule
    (bf16 products are exact in f32) agrees with the Pallas kernel in
    interpret mode and with the plain version: out within 2e-2 (bf16
    outputs), lse within 2e-5, which a running sum of the rounded p
    misses (its error printed)."""
    qs, k, v, _, km = _inputs(4, 2, 200, 200, 64, True, seed=6)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in (qs, k, v))
    tkm = torch.from_numpy(km)
    jout, jlse = J._flash_fwd_call(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (qs, k, v)),
        jnp.asarray(km), True, 2, True)
    pallas = (torch.from_numpy(np.array(jout, np.float32)),
              torch.from_numpy(np.array(jlse, np.float32))[..., 0])
    plain = [x.float() for x in
             fa.flash_attention_fwd_torch(tq, tk, tv, tkm, True, 2)]

    def bf16(p):
        return p.to(torch.bfloat16).float()

    out, lse = _fwd_model(torch.matmul, tq, tk, tv, tkm, 2, round_p=bf16)
    for ref in (pallas, plain):
        torch.testing.assert_close(bf16(out), ref[0], **BF16_TOL)
        torch.testing.assert_close(lse, ref[1], **TOL)
    # l from the rounded p, as a kernel that summed the weights it
    # multiplied would have it
    _, lse_r = _fwd_model(torch.matmul, tq, tk, tv, tkm, 2, round_p=bf16,
                          sum_rounded=True)
    with capsys.disabled():
        print(f"\n  bf16 forward model: lse max|diff| vs Pallas "
              f"{float((lse - pallas[1]).abs().max()):.2e}; with l from "
              f"the rounded p {float((lse_r - pallas[1]).abs().max()):.2e}")


def test_sdpa_takes_flash_only_through_its_gate(monkeypatch):
    """use_flash=None is off; Lq == 1 always takes the composite (its
    causal mask is all visible); dropout, return_weights, a [B, H, Lq,
    Lk] mask or a head dim past the kernels' also take the composite."""
    calls = []
    real = pattn.flash_attention
    monkeypatch.setattr(pattn, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rng = np.random.default_rng(8)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32))

    q, k, v = t(1, 2, 6, 8), t(1, 2, 6, 8), t(1, 2, 6, 8)
    gen = torch.Generator().manual_seed(0)
    pattn.scaled_dot_product_attention(q, k, v, is_causal=True)
    pattn.scaled_dot_product_attention(q, k, v, is_causal=True,
                                       use_flash=True, dropout_p=0.1,
                                       generator=gen)
    pattn.scaled_dot_product_attention(q, k, v, use_flash=True,
                                       return_weights=True)
    pattn.scaled_dot_product_attention(q, k, v, t(1, 2, 6, 6),
                                       use_flash=True)
    big = t(1, 1, 4, 160)
    pattn.scaled_dot_product_attention(big, big, big, use_flash=True)
    assert calls == []
    pattn.scaled_dot_product_attention(q, k, v, is_causal=True,
                                       use_flash=True)
    assert calls == [1]
    # one decode row: the composite, causal ignored, as JAX does
    q1 = t(1, 2, 1, 8)
    out, _ = pattn.scaled_dot_product_attention(q1, k, v, is_causal=True,
                                                use_flash=True)
    assert calls == [1]
    jout, _ = jax_sdpa(*(jnp.asarray(x.numpy()) for x in (q1, k, v)),
                       is_causal=True, use_flash=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout._data), **TOL)


def test_attention_dropout_needs_a_generator():
    x = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="torch.Generator"):
        pattn.scaled_dot_product_attention(x, x, x, dropout_p=0.1)


def test_wrappers_refuse_shapes_no_version_takes():
    x = torch.zeros(2, 8, 4)
    with pytest.raises(ValueError, match="BH, Lq, D"):
        fa.flash_attention_fwd_kernel(x, torch.zeros(2, 8, 5), x)
    with pytest.raises(ValueError, match="key mask"):
        fa.flash_attention_fwd_kernel(x, x, x, torch.zeros(1, 1, 8),
                                      heads=1)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_attention_bwd_dq_kernel(x, x, x, x, torch.zeros(2, 7),
                                         torch.zeros(2, 8))
