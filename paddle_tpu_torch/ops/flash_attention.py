"""Flash attention for training: three hand-written CUDA kernels (the
forward, dK/dV and dQ), each with its wrapper and its plain PyTorch
version, the ``torch.autograd.Function`` that joins them, and the gates
``ops.attention`` asks before taking this path.

- `flash_attention_fwd_kernel` (plain: `flash_attention_fwd_torch`)
  replaces the Pallas ``_flash_fwd_call`` / ``_fwd_kernel``;
- `flash_attention_bwd_dkdv_kernel` (plain:
  `flash_attention_bwd_dkdv_torch`) replaces ``_bwd_dkdv_kernel``;
- `flash_attention_bwd_dq_kernel` (plain: `flash_attention_bwd_dq_torch`)
  replaces ``_bwd_dq_kernel``

(the TPU kernels live in ``paddle_tpu/ops/pallas/flash_attention.py``;
all three CUDA kernels in ``csrc/flash_attention.cu``, whose header gives
the design and what bounds them on an H100).

Layout as on the TPU: ``qs`` (q with the 1/sqrt(D) scale folded in), k
and v are [BH, L, D], float32 or bfloat16; ``km`` is None or an additive
key mask [Bm, 1, Lk] float32 whose row for flattened head ``bh`` is
``bh // heads``.  Query row i sees key j iff ``i + Lk - Lq >= j`` under
``causal`` (bottom-right alignment).  ``lse`` is [BH, Lq] float32: the
trailing 1 of the TPU's [BH, Lq, 1] was a Mosaic tiling artifact.  A
row that sees no key gets out 0 and lse NEG_INF.  With bfloat16 inputs
the softmax weights ``p`` and the score gradients ``dS`` are rounded to
bfloat16 before their products, as the Pallas bodies do
(``p.astype(v.dtype)``, ``ds.astype(q.dtype)``); everything else is f32.

Each wrapper is the one place its device is chosen: for CUDA tensors it
launches its kernel, counting each launch in its ``launches``
attribute, and raises on anything the kernel does not take or on a
refused launch; for CPU tensors, and only for those, it runs the plain
version.
"""
import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
OWNED, WALKED = 64, 32   # FB_M, FB_N: the owned and the walked tiles
MAX_HEAD_DIM = 128
SMEM_PER_BLOCK = 232448  # an H100 block's dynamic shared-memory ceiling
_LIB = "flash_attention"


# ------------------------------ gates -----------------------------------


def kernel_smem_bytes(d):
    """The largest dynamic shared memory the three kernels ask for at head
    dim `d` (fa_smem_fwd, fa_smem_bwd in the source), at fp32, the larger
    dtype: tile rows of d rounded up to 32, 64 or 128 floats.  Forward:
    the Q tile of OWNED rows, two buffers of the K and V tiles of WALKED
    rows and two buffers of the key-mask row of WALKED.  Backward: two
    owned tiles of OWNED rows, two buffers of two walked tiles of WALKED
    rows, and two buffers of two f32 rows of WALKED (lse and delta, or the
    key mask)."""
    width = 32 if d <= 32 else 64 if d <= 64 else 128
    fwd = width * (OWNED + 4 * WALKED) + 2 * WALKED
    bwd = width * (2 * OWNED + 4 * WALKED) + 4 * WALKED
    return 4 * max(fwd, bwd)


def shapes_fit_kernels(lq, lk, d):
    """Whether the port's flash kernels take these shapes: any lengths,
    head dims 1..MAX_HEAD_DIM, and tiles within one block's shared
    memory.  It reads shapes only, never the device: the port's
    counterpart of the TPU's VMEM gate ``shapes_are_flash_compatible``."""
    return (lq >= 1 and lk >= 1 and 1 <= d <= MAX_HEAD_DIM
            and kernel_smem_bytes(d) <= SMEM_PER_BLOCK)


def mask_is_flash_compatible(attn_mask):
    """True when the mask varies only along batch and key axes: None or
    4-D [B|1, 1, 1, Lk].  2-D masks are ambiguous under the sdp contract
    ([Lq, Lk] broadcast) — those take the composite path."""
    if attn_mask is None:
        return True
    shape = tuple(attn_mask.shape)
    return len(shape) == 4 and shape[1] == 1 and shape[2] == 1


# -------------------------- plain versions ------------------------------


def _scores(qs, k, km, causal, heads):
    """[BH, Lq, Lk] f32 scores with the key mask added and the causal
    mask (bottom-right) applied as NEG_INF."""
    bh, lq, _ = qs.shape
    lk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", qs.float(), k.float())
    if km is not None:
        rows = torch.arange(bh, device=qs.device) // heads
        s = s + km.float().reshape(km.shape[0], lk)[rows][:, None, :]
    if causal:
        visible = (torch.arange(lq, device=qs.device)[:, None] + (lk - lq)
                   >= torch.arange(lk, device=qs.device)[None, :])
        s = torch.where(visible, s, torch.full_like(s, NEG_INF))
    return s


def _weights(s, sub):
    """exp(s - sub), exactly 0 where s is masked (s <= NEG_INF / 2): a
    row whose every key is masked would otherwise weigh each key 1."""
    return torch.where(s <= NEG_INF / 2, torch.zeros_like(s),
                       torch.exp(s - sub))


def flash_attention_fwd_torch(qs, k, v, km=None, causal=False, heads=1):
    """Plain PyTorch flash forward over the whole [Lq, Lk] score matrix:
    returns ``(out, lse)``, out [BH, Lq, D] in qs's dtype, lse [BH, Lq]
    f32 (NEG_INF where a row sees no key, whose out is 0)."""
    s = _scores(qs, k, km, causal, heads)
    m = torch.clamp(s.amax(-1, keepdim=True), min=NEG_INF)
    p = _weights(s, m)
    l = p.sum(-1, keepdim=True)
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    out = (p.to(v.dtype).float() @ v.float()) / safe_l
    lse = torch.where(l > 0, m + torch.log(safe_l),
                      torch.full_like(l, NEG_INF))
    return out.to(qs.dtype), lse[..., 0]


def _probs_and_ds(qs, k, v, do, lse, delta, km, causal, heads):
    s = _scores(qs, k, km, causal, heads)
    p = _weights(s, lse[..., None])
    dp = do.float() @ v.float().transpose(1, 2)
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_dkdv_torch(qs, k, v, do, lse, delta, km=None,
                                   causal=False, heads=1):
    """Plain dK, dV: ``p = exp(s - lse)`` (masked keys 0), ``dV = pᵀ·dO``,
    ``dS = p∘(dO·vᵀ − delta)``, ``dK = dSᵀ·qs``; delta is [BH, Lq] f32
    ``rowsum(dO∘out)``.  Returns dk, dv in k's and v's dtypes."""
    p, ds = _probs_and_ds(qs, k, v, do, lse, delta, km, causal, heads)
    dv = p.to(do.dtype).float().transpose(1, 2) @ do.float()
    dk = ds.to(qs.dtype).float().transpose(1, 2) @ qs.float()
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_torch(qs, k, v, do, lse, delta, km=None,
                                 causal=False, heads=1):
    """Plain dQ (of the scaled qs): ``dQ = dS·k``, in qs's dtype."""
    _, ds = _probs_and_ds(qs, k, v, do, lse, delta, km, causal, heads)
    return (ds.to(k.dtype).float() @ k.float()).to(qs.dtype)


# ----------------------------- wrappers ---------------------------------


def _check_shapes(qs, k, v, km, heads, **rows):
    """Refuse, on every device, shapes no version takes: q/k/v not [BH,
    L, D] of one BH and D, k and v of different shapes, a key mask that
    is not [Bm, 1, Lk] with a row for every head, or `rows` tensors (dO
    [BH, Lq, D], lse and delta [BH, Lq]) of other shapes."""
    if qs.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != qs.shape[0] or k.shape[2] != qs.shape[2]:
        raise ValueError(f"flash attention takes qs [BH, Lq, D] and k, v "
                         f"[BH, Lk, D]: got {tuple(qs.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, lq, d = qs.shape
    if km is not None and (km.dim() != 3 or km.shape[1] != 1
                           or km.shape[2] != k.shape[1] or heads < 1
                           or (bh - 1) // heads >= km.shape[0]):
        raise ValueError(f"key mask must be [Bm, 1, Lk] with a row for "
                         f"each of {bh} // {heads} heads: got "
                         f"{tuple(km.shape)}")
    want = {"do": (bh, lq, d), "lse": (bh, lq), "delta": (bh, lq)}
    for name, x in rows.items():
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(x.shape)}")


def _check_kernel_args(qs, k, v, km, **rows):
    """Refuse what the CUDA kernels do not take: tensors off qs's device
    or not contiguous, q/k/v (and dO) not all float32 or all bfloat16,
    head dims past MAX_HEAD_DIM, BH past the kernels' 65535, or a key
    mask, lse or delta not float32."""
    dev = qs.device
    named = {"qs": qs, "k": k, "v": v, **rows}
    if km is not None:
        named["km"] = km
    for name, x in named.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, qs on {dev}: the "
                             f"kernel takes tensors on one device")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if qs.dtype not in (torch.float32, torch.bfloat16) or any(
            x.dtype != qs.dtype for x in (k, v, rows.get("do", qs))):
        raise ValueError(f"qs, k, v and dO must all be float32 or all "
                         f"bfloat16, got {qs.dtype}, {k.dtype}, {v.dtype}")
    for name in ("km", "lse", "delta"):
        if name in named and named[name].dtype != torch.float32:
            raise ValueError(f"{name} must be float32")
    bh, _, d = qs.shape
    if not 1 <= d <= MAX_HEAD_DIM or bh > 65535:
        raise ValueError(f"the kernels take head_dim 1..{MAX_HEAD_DIM} and "
                         f"BH <= 65535, got {d} and {bh}")


def _launch(entry, qs, k, v, km, causal, heads, *rest):
    """``entry(qs, k, v, km, heads, causal, bf16, *rest, BH, Lq, Lk, D,
    stream)`` on the current stream, raising on a refused launch."""
    lib = _load()
    bh, lq, d = qs.shape
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    rc = getattr(lib, entry)(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if km is None else km.data_ptr(), int(heads), int(causal),
        int(qs.dtype == torch.bfloat16), *[x.data_ptr() for x in rest],
        bh, lq, k.shape[1], d, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc} "
                           f"({lib.fa_error_string(rc).decode()})")


def _device_route(qs):
    if qs.device.type == "cpu":
        return False
    if qs.device.type != "cuda":
        raise ValueError(f"no kernel for device {qs.device}")
    return True


def flash_attention_fwd_kernel(qs, k, v, km=None, causal=False, heads=1):
    """The forward kernel's wrapper: same contract as
    `flash_attention_fwd_torch`."""
    _check_shapes(qs, k, v, km, heads)
    if not _device_route(qs):
        return flash_attention_fwd_torch(qs, k, v, km, causal, heads)
    _check_kernel_args(qs, k, v, km)
    out = torch.empty_like(qs)
    lse = torch.empty(qs.shape[:2], dtype=torch.float32, device=qs.device)
    if qs.numel() == 0:
        return out, lse
    _launch("fa_flash_fwd", qs, k, v, km, causal, heads, out, lse)
    flash_attention_fwd_kernel.launches += 1
    return out, lse


flash_attention_fwd_kernel.launches = 0


def flash_attention_bwd_dkdv_kernel(qs, k, v, do, lse, delta, km=None,
                                    causal=False, heads=1):
    """The dK/dV kernel's wrapper: same contract as
    `flash_attention_bwd_dkdv_torch`."""
    _check_shapes(qs, k, v, km, heads, do=do, lse=lse, delta=delta)
    if not _device_route(qs):
        return flash_attention_bwd_dkdv_torch(qs, k, v, do, lse, delta, km,
                                              causal, heads)
    _check_kernel_args(qs, k, v, km, do=do, lse=lse, delta=delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if k.numel() == 0:
        return dk, dv
    _launch("fa_flash_bwd_dkdv", qs, k, v, km, causal, heads, do, lse, delta,
            dk, dv)
    flash_attention_bwd_dkdv_kernel.launches += 1
    return dk, dv


flash_attention_bwd_dkdv_kernel.launches = 0


def flash_attention_bwd_dq_kernel(qs, k, v, do, lse, delta, km=None,
                                  causal=False, heads=1):
    """The dQ kernel's wrapper: same contract as
    `flash_attention_bwd_dq_torch`."""
    _check_shapes(qs, k, v, km, heads, do=do, lse=lse, delta=delta)
    if not _device_route(qs):
        return flash_attention_bwd_dq_torch(qs, k, v, do, lse, delta, km,
                                            causal, heads)
    _check_kernel_args(qs, k, v, km, do=do, lse=lse, delta=delta)
    dq = torch.empty_like(qs)
    if qs.numel() == 0:
        return dq
    _launch("fa_flash_bwd_dq", qs, k, v, km, causal, heads, do, lse, delta,
            dq)
    flash_attention_bwd_dq_kernel.launches += 1
    return dq


flash_attention_bwd_dq_kernel.launches = 0

# each entry point's pointer arguments between the common (qs, k, v, km,
# heads, causal, bf16) head and the (BH, Lq, Lk, D, stream) tail
_ENTRIES = {"fa_flash_fwd": 2, "fa_flash_bwd_dkdv": 5, "fa_flash_bwd_dq": 4}


def _load():
    first = not _build.loaded(_LIB)
    lib = _build.load(_LIB)
    if first:
        p, i = ctypes.c_void_p, ctypes.c_int
        for entry, n_ptr in _ENTRIES.items():
            fn = getattr(lib, entry)
            fn.argtypes = [p, p, p, p, i, i, i, *([p] * n_ptr), i, i, i, i, p]
            fn.restype = i
        lib.fa_error_string.argtypes = [i]
        lib.fa_error_string.restype = ctypes.c_char_p
    return lib


# ------------------------- autograd and entry ---------------------------


class FlashAttention(torch.autograd.Function):
    """The TPU's ``custom_vjp`` ``_flash``: forward through the forward
    kernel, backward through delta = rowsum(dO∘out) (f32, a torch op),
    then the dK/dV and dQ kernels.  ``apply(qs, k, v, km, causal,
    heads)``; km gets no gradient."""

    @staticmethod
    def forward(ctx, qs, k, v, km, causal, heads):
        out, lse = flash_attention_fwd_kernel(qs, k, v, km, causal, heads)
        ctx.save_for_backward(qs, k, v, km, out, lse)
        ctx.causal, ctx.heads = causal, heads
        return out

    @staticmethod
    def backward(ctx, do):
        qs, k, v, km, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(-1)
        dk, dv = flash_attention_bwd_dkdv_kernel(
            qs, k, v, do, lse, delta, km, ctx.causal, ctx.heads)
        dq = flash_attention_bwd_dq_kernel(
            qs, k, v, do, lse, delta, km, ctx.causal, ctx.heads)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, attn_mask=None, causal=False):
    """q, k, v: [B, H, L, D].  attn_mask: None or an additive mask whose
    non-trivial axes are batch and key ([B, 1, 1, Lk] / [1, 1, 1, Lk];
    richer masks take the composite path, see `mask_is_flash_compatible`).
    The scale is folded into q before the kernels, so autograd gives dq
    its scale through the fold."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    qs = (q * (1.0 / math.sqrt(d))).reshape(b * h, lq, d).contiguous()
    kf = k.reshape(b * h, lk, d).contiguous()
    vf = v.reshape(b * h, lk, d).contiguous()
    km = None
    if attn_mask is not None:
        km = attn_mask.broadcast_to((b,) + tuple(attn_mask.shape[1:]))
        km = km.reshape(b, -1)[:, -lk:].float().reshape(b, 1, lk)
        km = km.contiguous()
    out = FlashAttention.apply(qs, kf, vf, km, causal, h)
    return out.reshape(b, h, lq, d)
