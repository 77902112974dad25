"""Functions of ``paddle_tpu/ops/nn_extra.py``: the 3-D and 1-D
transposed convolutions, the 3-D pools (with ``ceil_mode`` and the max
pool's argmax mask), the 1-D and 3-D adaptive pools, `fold`, sampling
grids (`affine_grid`, `grid_sample`), `bilinear`, `temporal_shift`,
`dropout3d`, `spectral_norm_apply`, the layer losses (`ctc_loss`,
`hsigmoid_loss`, `dice_loss`, `log_loss`, `npair_loss`), `gather_tree`
(the beam-search backtrace), `celu` and `pairwise_distance`, with the
JAX package's arithmetic.  Its ``unfold`` is not the functional
namespace's (that one is ``nn_ops.unfold``) and is not ported."""
import math

import numpy as np
import torch
import torch.nn.functional as tF

from ..amp.auto_cast import cast_inputs
from .nn_ops import (_AVG_POOL, _adaptive, _biased, _conv, _conv_transpose,
                     _explicit_pads, _flat, _keep_mask, _output_size_padding,
                     _refuse_mask, _softplus, _transpose_string,
                     _window_pool, conv2d_transpose)

NEG = -1e30  # ctc_loss's minus infinity, as in the JAX function


def _triple(v):
    """An int repeated three times, a list as it is (JAX's `_triple`)."""
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def gather_tree(ids, parents):
    """Full beams from per-step choices: `ids` and `parents` [T, batch,
    beam] (a parent is the beam index, within its batch row, that a
    step's choice extends), walked backwards from each final beam on
    the device; [T, batch, beam] tokens."""
    beams = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1], -1)
    toks = []
    for t in range(ids.shape[0] - 1, -1, -1):
        toks.append(torch.gather(ids[t], 1, beams))
        beams = torch.gather(parents[t], 1, beams)
    return torch.stack(toks[::-1])


def celu(x, alpha=1.0, name=None):
    x, = cast_inputs("celu", x)
    return torch.clamp(x, min=0.0) + torch.clamp(
        alpha * (torch.exp(x / alpha) - 1.0), max=0.0)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """``||x - y + epsilon||_p`` over the last axis."""
    x, y = cast_inputs("pairwise_distance", x, y)
    return torch.linalg.vector_norm(x - y + epsilon, ord=p, dim=-1,
                                    keepdim=keepdim)


# ------------------------------ convolutions ------------------------------

def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    """3-D convolution of NCDHW input, weight [out, in / groups, kd, kh,
    kw]; `padding` an int, three per-axis values or "SAME"/"VALID".
    `data_format` is unused: the JAX function reads NCDHW whatever it
    says."""
    s, d = _triple(stride), _triple(dilation)
    if isinstance(padding, str):
        pads = _explicit_pads(padding, x.shape[2:], weight.shape[2:], s, d)
    else:
        p = _triple(padding)
        pads = [(p[0], p[0]), (p[1], p[1]), (p[2], p[2])]
    x, weight = cast_inputs("conv3d", x, weight)
    return _biased(_conv(x, weight, None, s, pads, d, groups, 3), bias,
                   "conv3d_bias", (1, -1, 1, 1, 1))


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCDHW", output_size=None, name=None):
    """3-D transposed convolution of NCDHW input, weight [in, out /
    groups, kd, kh, kw]: `padding` an int, three per-axis values, or
    "SAME"/"VALID" as `conv2d_transpose`'s; `output_padding` and
    `output_size` as there.  `data_format` is unused, as in JAX."""
    s, d = _triple(stride), _triple(dilation)
    opad = _triple(output_padding)
    k = tuple(weight.shape[2:])
    if isinstance(padding, str):
        pads, opad = _transpose_string(padding, k, s, d, opad,
                                       "conv3d_transpose")
    else:
        pads = [(p, p) for p in _triple(padding)]
    if output_size is not None:
        opad = _output_size_padding(x, k, s, pads, d, output_size)
    x, weight = cast_inputs("conv3d_transpose", x, weight)
    out = _conv_transpose(x, weight, s, pads, d, groups, opad, 3)
    return _biased(out, bias, "conv3d_transpose_bias", (1, -1, 1, 1, 1))


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCL", output_size=None, name=None):
    """1-D transposed convolution of NCL input, weight [in, out / groups,
    k], as the JAX function computes it: `conv2d_transpose` of [N, C, L,
    1] with (value, 0) stride, padding and output padding.  An int
    `padding` or a list of one; `data_format` is unused."""
    st = (stride, 1) if isinstance(stride, int) else tuple(stride) + (1,)
    pd = (padding, 0) if isinstance(padding, int) \
        else tuple(padding) + (0,)
    opd = (output_padding, 0) if isinstance(output_padding, int) \
        else tuple(output_padding) + (0,)
    osz = None if output_size is None else list(output_size) + [1]
    dil = (dilation, 1) if isinstance(dilation, int) \
        else tuple(dilation) + (1,)
    return conv2d_transpose(x.unsqueeze(3), weight.unsqueeze(3), bias=bias,
                            stride=st, padding=pd, output_padding=opd,
                            output_size=osz, dilation=dil,
                            groups=groups).squeeze(3)


# --------------------------------- pools ----------------------------------

def _ceil_extra(sizes, k, s, p, ceil_mode):
    """The hi-side padding that keeps a last partial window under
    `ceil_mode`: ``ceil((L + 2p - k) / s) + 1`` outputs."""
    if not ceil_mode:
        return [0] * len(k)
    return [max((-(-(n + 2 * pp - kk) // ss)) * ss + kk - (n + 2 * pp), 0)
            for n, kk, ss, pp in zip(sizes, k, s, p)]


def _pool3d(x, kind, kernel_size, stride, padding, exclusive=True,
            ceil_mode=False, divisor_override=None):
    """``ops/nn_extra.py::_pool3d``: max (padding -inf) or mean over NCDHW
    windows; a mean divides by `divisor_override`, else by its count of
    values that are not padding when `exclusive` and any padding (the
    ceil mode's too) is nonzero, else by the window's size."""
    k = _triple(kernel_size)
    s = _triple(stride) if stride is not None else k
    p = _triple(padding)
    extra = _ceil_extra(x.shape[2:], k, s, p, ceil_mode)
    pads = [(pp, pp + e) for pp, e in zip(p, extra)]
    x, = cast_inputs("pool3d_" + kind, x)
    if kind == "avg" and divisor_override is not None:
        return (_AVG_POOL[3](tF.pad(x, _flat(pads)), k, s,
                             divisor_override=1) / float(divisor_override))
    return _window_pool(x, kind, k, s, pads, exclusive and any(
        pp != (0, 0) for pp in pads))


def _windows(t, k, s):
    """[N, C, od, oh, ow, kd kh kw]: every window of NCDHW `t`."""
    for axis, (kk, ss) in enumerate(zip(k, s)):
        t = t.unfold(2 + axis, kk, ss)
    return t.reshape(t.shape[:5] + (-1,))


def _max_pool3d_index(x, kernel_size, stride, padding, ceil_mode):
    """The mask of `max_pool3d`: the flattened D H W index of each
    window's first largest value (int32), the padding -inf (index -1)."""
    k, s, p = _triple(kernel_size), _triple(stride), _triple(padding)
    n, c, d, h, w = x.shape
    extra = _ceil_extra((d, h, w), k, s, p, ceil_mode)
    flat = _flat([(pp, pp + e) for pp, e in zip(p, extra)])
    idx = torch.arange(d * h * w, dtype=torch.float32,
                       device=x.device).reshape(1, 1, d, h, w).expand(
        x.shape)
    vp = tF.pad(x.detach(), flat, value=-math.inf)
    ip = tF.pad(idx, flat, value=-1.0)
    arg = _windows(vp, k, s).argmax(-1, keepdim=True)
    return _windows(ip, k, s).gather(-1, arg)[..., 0].to(torch.int32)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    """Max over NCDHW windows, the padding -inf; `ceil_mode` keeps a last
    partial window; `return_mask` also returns each window's argmax
    (`_max_pool3d_index`)."""
    out = _pool3d(x, "max", kernel_size, stride, padding,
                  ceil_mode=ceil_mode)
    if return_mask:
        return out, _max_pool3d_index(
            x, kernel_size, stride if stride is not None else kernel_size,
            padding, ceil_mode)
    return out


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool3d(x, "avg", kernel_size, stride, padding, exclusive,
                   ceil_mode=ceil_mode, divisor_override=divisor_override)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, "avg", output_size, 3)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    _refuse_mask(return_mask)
    return _adaptive(x, "max", output_size, 3)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, "avg", output_size, 1)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    _refuse_mask(return_mask)
    return _adaptive(x, "max", output_size, 1)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the adjoint of `unfold`: [N, C kh kw, L] to [N, C, H, W],
    overlapping windows summed; `paddings` one or two even values."""
    def pair(v):
        return tuple(int(a) for a in v) if isinstance(v, (list, tuple)) \
            else (int(v),) * 2

    x, = cast_inputs("fold", x)
    return tF.fold(x, pair(output_sizes), pair(kernel_sizes),
                   dilation=pair(dilations), padding=pair(paddings),
                   stride=pair(strides))


# ----------------------------- sampling grids -----------------------------

def affine_grid(theta, out_shape, align_corners=True, name=None):
    """[N, H, W, 2] sample points (x, y) of the [N, 2, 3] affine maps
    `theta` over an H x W grid in [-1, 1] (pixel corners with
    `align_corners`, else centres)."""
    theta, = cast_inputs("affine_grid", theta)
    n = theta.shape[0]
    h, w = int(out_shape[-2]), int(out_shape[-1])
    dev = theta.device
    if align_corners:
        ys = torch.linspace(-1, 1, h, device=dev)
        xs = torch.linspace(-1, 1, w, device=dev)
    else:
        ys = (torch.arange(h, device=dev) + 0.5) / h * 2 - 1
        xs = (torch.arange(w, device=dev) + 0.5) / w * 2 - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(-1, 3)
    return torch.einsum("hk,nok->nho", base.to(theta.dtype),
                        theta).reshape(n, h, w, 2)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """NCHW `x` sampled at `grid` [N, Ho, Wo, 2] of (x, y) in [-1, 1]:
    bilinear, or nearest by C rounding (half away from zero); a tap
    outside the input reads 0 with ``padding_mode="zeros"``, else the
    border."""
    x, grid = cast_inputs("grid_sample", x, grid)
    n, _, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx, fy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
    else:
        fx, fy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2
    idx_n = torch.arange(n, device=x.device).reshape(n, 1, 1)

    def gather(yy, xx):
        yi = torch.clamp(yy, 0, h - 1).long()
        xi = torch.clamp(xx, 0, w - 1).long()
        vals = x[idx_n, :, yi, xi]
        if padding_mode == "zeros":
            inb = ((yy >= 0) & (yy <= h - 1) & (xx >= 0)
                   & (xx <= w - 1))[..., None]
            vals = torch.where(inb, vals, torch.zeros_like(vals))
        return vals

    if mode == "nearest":
        def r(f):
            return torch.sign(f) * torch.floor(torch.abs(f) + 0.5)

        out = gather(r(fy), r(fx))
    else:
        x0, y0 = torch.floor(fx), torch.floor(fy)
        wx, wy = fx - x0, fy - y0
        out = (gather(y0, x0) * ((1 - wx) * (1 - wy))[..., None]
               + gather(y0, x0 + 1) * (wx * (1 - wy))[..., None]
               + gather(y0 + 1, x0) * ((1 - wx) * wy)[..., None]
               + gather(y0 + 1, x0 + 1) * (wx * wy)[..., None])
    return out.permute(0, 3, 1, 2)


# ---------------------------------- misc ----------------------------------

def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[n, o] = x1[n] weight[o] x2[n] + bias``, weight [out, in1,
    in2]."""
    x1, x2, weight = cast_inputs("bilinear", x1, x2, weight)
    out = torch.einsum("ni,oij,nj->no", x1, weight, x2)
    if bias is None:
        return out
    bias, = cast_inputs("bilinear_bias", bias)
    return out + bias


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    """[N T, C, H, W]: the first ``C shift_ratio`` channels shifted one
    segment back in time, the next as many one forward, zeros shifted
    in."""
    x, = cast_inputs("temporal_shift", x)
    nt, c, h, w = x.shape
    v5 = x.reshape(nt // seg_num, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    fwd = torch.cat([v5[:, 1:, :c1], torch.zeros_like(v5[:, :1, :c1])], 1)
    bwd = torch.cat([torch.zeros_like(v5[:, :1, c1:c2]),
                     v5[:, :-1, c1:c2]], 1)
    return torch.cat([fwd, bwd, v5[:, :, c2:]], 2).reshape(nt, c, h, w)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None, *,
              generator=None):
    """Whole D H W volumes of each channel kept with probability 1 - p
    (divided by it) or zeroed; the mask draws from `generator`."""
    if not training or p == 0.0:
        return x
    keep = _keep_mask(x, 1 - p, (x.shape[0], x.shape[1], 1, 1, 1),
                      generator)
    return torch.where(keep, x / (1 - p), torch.zeros_like(x))


def spectral_sigma(weight, dim, iters, eps, u=None, v=None):
    """The largest singular value of `weight` as a matrix [its `dim`
    axis, the rest], ``u W v`` after `iters` power-iteration steps from
    `u` (uniform if None; `v` is read only when `iters` is 0); the
    gradient flows through the iteration."""
    wm = torch.movedim(weight, dim, 0).reshape(weight.shape[dim], -1)
    if u is None:
        u = torch.ones(wm.shape[0], dtype=weight.dtype,
                       device=weight.device) / np.sqrt(wm.shape[0])
    for _ in range(iters):
        v = wm.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = wm @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    return u @ wm @ v


def spectral_norm_apply(weight, n_power_iterations=1, eps=1e-12, dim=0):
    """`weight` over its largest singular value, estimated by power
    iteration (at least one) from a uniform start."""
    weight, = cast_inputs("spectral_norm", weight)
    return weight / spectral_sigma(weight, dim, max(n_power_iterations, 1),
                                   eps)


# --------------------------------- losses ---------------------------------

def dice_loss(input, label, epsilon=1e-5, name=None):
    """Mean over rows of ``1 - (2 |p ∩ y| + eps) / (|p| + |y| + eps)``, y
    the one-hot of `label` [..., 1]."""
    input, = cast_inputs("dice_loss", input)
    y1 = tF.one_hot(label.squeeze(-1).long(), input.shape[-1]).to(
        input.dtype)
    inter = torch.sum(input * y1, dim=-1)
    union = torch.sum(input, dim=-1) + torch.sum(y1, dim=-1)
    return torch.mean(1 - (2 * inter + epsilon) / (union + epsilon))


def log_loss(input, label, epsilon=1e-4, name=None):
    input, label = cast_inputs("log_loss", input, label)
    return (-label * torch.log(input + epsilon)
            - (1 - label) * torch.log(1 - input + epsilon))


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Cross entropy of ``anchor @ positive.T`` against rows spread over
    the same-label columns, plus ``l2_reg / 4`` of both embeddings' mean
    squared norms."""
    anchor, positive = cast_inputs("npair_loss", anchor, positive)
    logits = anchor @ positive.T
    same = (labels.reshape(-1, 1) == labels.reshape(1, -1)).to(anchor.dtype)
    tgt = same / torch.sum(same, dim=1, keepdim=True)
    xent = torch.mean(torch.sum(-tgt * torch.log_softmax(logits, dim=1),
                                dim=1))
    reg = l2_reg * (torch.mean(torch.sum(anchor * anchor, dim=1))
                    + torch.mean(torch.sum(positive * positive, dim=1))
                    ) * 0.25
    return xent + reg


def _as_long(v, device):
    return torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                           else v, device=device).long()


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC by the forward algorithm in log space, as the JAX function
    computes it: `log_probs` are logits [B, T, C] (or [T, B, C]), put
    through ``log_softmax`` here; minus infinity is -1e30; alpha starts
    at t = 0 and holds once past each input length; a label length of 0
    reads alpha's first entry twice.  `norm_by_times` divides each loss
    by its input length, ``"mean"`` averages each loss over its label
    length, ``"sum"`` adds them, else the [B] losses."""
    lp, = cast_inputs("ctc_loss", log_probs)
    dev = lp.device
    lab = _as_long(labels, dev)
    ilen, llen = _as_long(input_lengths, dev), _as_long(label_lengths, dev)
    if lp.dim() == 3 and lp.shape[0] != lab.shape[0]:
        lp = lp.transpose(0, 1)
    b, t_max, _ = lp.shape
    span = 2 * lab.shape[1] + 1
    lp = torch.log_softmax(lp, dim=-1)
    ext = torch.full((b, span), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = lab
    same = torch.zeros((b, span), dtype=torch.bool, device=dev)
    same[:, 2:] = ext[:, 2:] == ext[:, :-2]
    emit = torch.gather(lp, 2, ext[:, None, :].expand(b, t_max, span))
    neg = torch.full((b, 1), NEG, dtype=lp.dtype, device=dev)
    alpha = torch.cat([emit[:, 0, :1], torch.where(
        llen[:, None] > 0, emit[:, 0, 1:2], neg),
        neg.expand(b, span - 2)], dim=1)
    for t in range(1, t_max):
        shift1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        shift2 = torch.cat([neg, neg, alpha[:, :-2]], dim=1)
        shift2 = torch.where(same, neg, shift2)
        merged = torch.logaddexp(torch.logaddexp(alpha, shift1), shift2)
        alpha = torch.where((t < ilen)[:, None], merged + emit[:, t], alpha)
    end = (2 * llen)[:, None]
    losses = -torch.logaddexp(alpha.gather(1, end), alpha.gather(
        1, torch.clamp(end - 1, min=0)))[:, 0]
    if norm_by_times:
        losses = losses / torch.clamp(ilen.to(losses.dtype), min=1)
    if reduction == "mean":
        return torch.mean(losses / torch.clamp(llen, min=1))
    if reduction == "sum":
        return torch.sum(losses)
    return losses


def _tree_tables(num_classes):
    """Each class's path of internal nodes and its left/right codes in
    the complete binary tree of `num_classes` leaves (heap order), padded
    with a mask."""
    paths, codes = [], []
    for c in range(num_classes):
        node, path, code = c + num_classes - 1, [], []
        while node > 0:
            parent = (node - 1) // 2
            code.append(1.0 if node == 2 * parent + 2 else 0.0)
            path.append(parent)
            node = parent
        paths.append(path[::-1])
        codes.append(code[::-1])
    width = max(len(p) for p in paths)
    pt = np.zeros((num_classes, width), np.int64)
    ct = np.zeros((num_classes, width), np.float32)
    mask = np.zeros((num_classes, width), np.float32)
    for c in range(num_classes):
        pt[c, :len(paths[c])] = paths[c]
        ct[c, :len(codes[c])] = codes[c]
        mask[c, :len(paths[c])] = 1.0
    return pt, ct, mask


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the default complete tree: the mean over
    rows of the binary cross entropies along each label's path, logits
    ``input @ weight.T`` [B, num_classes - 1].  `bias`, `path_table`
    and `path_code` are unused, as in the JAX function."""
    input, weight = cast_inputs("hsigmoid_loss", input, weight)
    pt, ct, mask = (torch.from_numpy(a).to(input.device)
                    for a in _tree_tables(num_classes))
    logits = input @ weight.T
    y = label.reshape(-1).long()
    sel = logits[torch.arange(input.shape[0], device=input.device)[:, None],
                 pt[y]]
    per = (_softplus(sel) - ct[y] * sel) * mask[y]
    return torch.mean(torch.sum(per, dim=1))


__all__ = ["adaptive_avg_pool1d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool3d", "affine_grid",
           "avg_pool3d", "bilinear", "celu", "conv1d_transpose", "conv3d",
           "conv3d_transpose", "ctc_loss", "dice_loss", "dropout3d", "fold",
           "gather_tree", "hsigmoid_loss", "log_loss", "max_pool3d",
           "npair_loss", "pairwise_distance", "spectral_norm_apply",
           "temporal_shift"]
