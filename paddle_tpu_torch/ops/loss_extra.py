"""The loss, norm and metric long tail of ``paddle_tpu/ops/loss_extra.py``.

The differentiable losses and norms are tensor expressions whose
gradients are autograd's.  The metric ops (`edit_distance`, `ctc_align`,
`positive_negative_pair`, `chunk_eval`) read their inputs back to the
host and run numpy loops, as the JAX package does (the reference runs
them on the CPU too); their outputs go back on the inputs' device, with
no gradient.  `mean_iou` stays on the device."""
import numpy as np
import torch

from ..amp.auto_cast import cast_inputs


def _softplus(x):
    """``log(1 + e^x)`` as ``max(x, 0) + log1p(e^-|x|)``."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def huber_loss(input, label, delta=1.0, name=None):
    """``r² / 2`` where ``|r| <= delta``, else ``delta (|r| - delta /
    2)``, of ``r = label - input``."""
    x, y = cast_inputs("huber_loss", input, label)
    r = y - x
    a = torch.abs(r)
    return torch.where(a <= delta, 0.5 * r * r, delta * (a - 0.5 * delta))


def rank_loss(label, left, right, name=None):
    """RankNet's pairwise loss ``log(1 + e^o) - label o``, ``o = left -
    right``."""
    label, left, right = cast_inputs("rank_loss", label, left, right)
    o = left - right
    return _softplus(o) - label * o


def bpr_loss(input, label, name=None):
    """Bayesian personalized ranking [N, 1]: the mean over the other
    classes j of ``log(1 + e^(x_j - x_label))``."""
    x, = cast_inputs("bpr_loss", input)
    n, c = x.shape
    pos = torch.gather(x, 1, label.reshape(n, 1).long())
    per = _softplus(x - pos)
    mask = 1.0 - torch.nn.functional.one_hot(label.reshape(-1).long(),
                                             c).to(x.dtype)
    return torch.sum(per * mask, dim=1, keepdim=True) / (c - 1)


def modified_huber_loss(input, label, name=None):
    """Of ``z = (2 label - 1) input``: ``-4 z`` below -1, ``(1 - z)²``
    below 1, else 0."""
    x, y = cast_inputs("modified_huber_loss", input, label)
    z = (2.0 * y - 1.0) * x
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    return torch.where(z < -1.0, -4.0 * z,
                       torch.where(z < 1.0, torch.square(1.0 - z), zero))


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0, name=None):
    """The CTR distillation loss of the input clipped to the bounds, by
    the label's four codes: below -1 no teacher and no click, below 0 a
    click, below 1 the teacher's score `label` and no click, else the
    score ``label - 1`` and a click."""
    x, label = cast_inputs("teacher_student_sigmoid_loss", input, label)
    xs = torch.clamp(x, soft_max_lower_bound, soft_max_up_bound)
    sp = _softplus(xs)
    return torch.where(
        label < -1.0, sp,
        torch.where(label < 0.0, sp - xs,
                    torch.where(label < 1.0, 2.0 * sp - xs * label,
                                2.0 * sp - xs - xs * (label - 1.0))))


def center_loss(input, label, centers, alpha=0.1, update_centers=True,
                name=None):
    """``|x - c_label|² / 2`` [N, 1] and the centres after the
    reference's running update ``c -= alpha sum(c_y - x) / (1 +
    count(y))`` over each class's rows (a new tensor with no gradient;
    `centers` is not changed), or `centers` itself without
    `update_centers`."""
    x, c = cast_inputs("center_loss", input, centers)
    lbl = label.reshape(-1).long().to(x.device)
    diff = x - c[lbl]
    loss = 0.5 * torch.sum(torch.square(diff), dim=1, keepdim=True)
    if not update_centers:
        return loss, centers
    with torch.no_grad():
        x, c = input.detach(), centers.detach()
        cnt = torch.zeros(c.shape[0], dtype=x.dtype, device=x.device
                          ).index_add(0, lbl, torch.ones_like(lbl, dtype=x.dtype))
        acc = torch.zeros_like(c).index_add(0, lbl, c[lbl] - x)
        return loss, c - alpha * acc / (1.0 + cnt)[:, None]


def squared_l2_distance(x, y, name=None):
    """Row-wise ``|x - y|²`` over every dim but the first."""
    x, y = cast_inputs("squared_l2_distance", x, y)
    sub = x - y
    return torch.sum(torch.square(sub), dim=tuple(range(1, sub.dim())))


def squared_l2_norm(x, name=None):
    """``sum(x²)`` as a [1] tensor."""
    x, = cast_inputs("squared_l2_norm", x)
    return torch.sum(torch.square(x)).reshape(1)


def l1_norm(x, name=None):
    """``sum(|x|)`` as a [1] tensor."""
    x, = cast_inputs("l1_norm", x)
    return torch.sum(torch.abs(x)).reshape(1)


def clip_by_norm(x, max_norm, name=None):
    """`x` scaled by ``max_norm / |x|`` where its L2 norm exceeds
    `max_norm` (the norm floored at 1e-12)."""
    x, = cast_inputs("clip_by_norm", x)
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12),
                        torch.ones((), dtype=x.dtype, device=x.device))
    return x * scale


def cos_sim(x, y, name=None):
    """Row-wise cosine similarity [N, 1] of `x` [N, D] and `y` [N, D], or
    `y` [1, D] broadcast over the rows of `x`; the norms' product floored
    at 1e-12."""
    x, y = cast_inputs("cos_sim", x, y)
    if y.shape[0] == 1 and x.shape[0] != 1:
        y = y.expand(x.shape)
    xn = torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=1, keepdim=True))
    prod = torch.sum(x * y, dim=1, keepdim=True)
    return prod / torch.clamp(xn * yn, min=1e-12)


def mean_iou(pred, label, num_classes, name=None):
    """Segmentation mean IoU over `num_classes` of the integer `pred` and
    `label`: the mean over classes with a non-empty union of
    intersection / union (float32 scalar), and per class the wrong and
    correct predictions (int32).  An id past the classes counts nowhere
    (JAX's scatter drops it), a negative one from the end."""
    p = pred.reshape(-1).long()
    lbl = label.reshape(-1).long().to(p.device)

    def count(ids):
        # a negative id counts from the end, as JAX's index does
        ids = torch.where(ids < 0, ids + num_classes, ids)
        keep = (ids >= 0) & (ids < num_classes)
        return torch.zeros(num_classes, dtype=torch.float32,
                           device=p.device).index_add(
            0, torch.where(keep, ids, 0), keep.to(torch.float32))

    inter = count(torch.where(p == lbl, p, num_classes))
    union = count(p) + count(lbl) - inter
    valid = union > 0
    iou = torch.where(valid, inter / torch.clamp(union, min=1.0), 0.0)
    miou = torch.sum(iou) / torch.clamp(torch.sum(valid.float()), min=1.0)
    return miou, (count(p) - inter).int(), inter.int()


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _device_of(*vs):
    for v in vs:
        if isinstance(v, torch.Tensor):
            return v.device
    from ..device import resolve_device

    return resolve_device(None, "a metric op")


def _lengths(length, n, full):
    return (_host(length).reshape(-1) if length is not None
            else np.full((n,), full, np.int64))


def _levenshtein(a, b):
    la, lb = len(a), len(b)
    if la == 0:
        return lb
    if lb == 0:
        return la
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[lb]


def edit_distance(input, label, input_length=None, label_length=None,
                  normalized=True, name=None):
    """The Levenshtein distance of each row pair of the ids `input` and
    `label` [B, T] over their lengths (divided by the label's length,
    floored at 1, when `normalized`): [B, 1] float32, and the count of
    pairs [1] int64."""
    dev = _device_of(input, label)
    inp, lbl = _host(input), _host(label)
    in_len = _lengths(input_length, inp.shape[0], inp.shape[1])
    lb_len = _lengths(label_length, lbl.shape[0], lbl.shape[1])
    out = np.zeros((inp.shape[0], 1), np.float32)
    for i in range(inp.shape[0]):
        a = list(inp[i, :int(in_len[i])])
        b = list(lbl[i, :int(lb_len[i])])
        d = float(_levenshtein(a, b))
        out[i, 0] = d / max(len(b), 1) if normalized else d
    return (torch.as_tensor(out, device=dev),
            torch.tensor([inp.shape[0]], dtype=torch.int64, device=dev))


def ctc_align(input, blank=0, merge_repeated=True, padding_value=0,
              input_length=None, name=None):
    """CTC's best-path decode of the ids `input` [B, T]: repeats merged
    (with `merge_repeated`), then blanks dropped, left-aligned and
    padded with `padding_value`; and the lengths [B, 1] int64."""
    dev = _device_of(input)
    inp = _host(input)
    B, T = inp.shape
    in_len = _lengths(input_length, B, T)
    out = np.full((B, T), padding_value, inp.dtype)
    out_len = np.zeros((B, 1), np.int64)
    for i in range(B):
        prev, k = None, 0
        for t in range(int(in_len[i])):
            tok = inp[i, t]
            if merge_repeated and prev is not None and tok == prev:
                continue
            prev = tok
            if tok != blank:
                out[i, k] = tok
                k += 1
        out_len[i, 0] = k
    return torch.as_tensor(out, device=dev), torch.as_tensor(out_len,
                                                             device=dev)


def positive_negative_pair(score, label, query_id, name=None):
    """Within each query, the pairs of differently labelled rows whose
    scores order them as their labels do (positive), the other way
    (negative) and at equal scores (neutral): three [1] float32."""
    dev = _device_of(score, label, query_id)
    s = _host(score).reshape(-1)
    lbl = _host(label).reshape(-1)
    q = _host(query_id).reshape(-1)
    pos = neg = neu = 0.0
    for qid in np.unique(q):
        idx = np.where(q == qid)[0]
        for a in range(len(idx)):
            for b in range(a + 1, len(idx)):
                i, j = idx[a], idx[b]
                if lbl[i] == lbl[j]:
                    continue
                ds, dl = s[i] - s[j], lbl[i] - lbl[j]
                if ds == 0:
                    neu += 1
                elif (ds > 0) == (dl > 0):
                    pos += 1
                else:
                    neg += 1
    return tuple(torch.tensor([v], dtype=torch.float32, device=dev)
                 for v in (pos, neg, neu))


def _extract_chunks(tags, scheme, num_chunk_types, excluded=()):
    """The (type, begin, end) chunks of an integer tag sequence under
    `scheme` ("IOB": tag = type · 2 + {B 0, I 1}; "IOE" type · 2 + {I 0,
    E 1}; "IOBES" type · 4 + {B, I, E, S}; "plain" tag = type), the tag
    ``num_chunk_types`` x tags-a-type and any negative one outside every
    chunk."""
    chunks = []
    n_tag = {"plain": 1, "IOB": 2, "IOE": 2, "IOBES": 4}[scheme]
    outside = num_chunk_types * n_tag
    start = cur_type = None

    def flush(end):
        nonlocal start, cur_type
        if start is not None and cur_type not in excluded:
            chunks.append((cur_type, start, end))
        start, cur_type = None, None

    for i, t in enumerate(tags):
        t = int(t)
        if t >= outside or t < 0:
            flush(i)
            continue
        ctype, pos = divmod(t, n_tag)
        if scheme == "plain":
            if cur_type != ctype:
                flush(i)
                start, cur_type = i, ctype
        elif scheme == "IOB":
            if pos == 0 or cur_type != ctype:
                flush(i)
                start, cur_type = i, ctype
        elif scheme == "IOE":
            if cur_type != ctype:
                flush(i)
                start, cur_type = i, ctype
            if pos == 1:
                flush(i + 1)
        elif pos == 0:                          # IOBES: B
            flush(i)
            start, cur_type = i, ctype
        elif pos in (1, 2):                     # I, E
            if cur_type != ctype:
                flush(i)
                start, cur_type = i, ctype
            if pos == 2:
                flush(i + 1)
        else:                                   # S
            flush(i)
            if ctype not in excluded:
                chunks.append((ctype, i, i + 1))
    flush(len(tags))
    return set(chunks)


def chunk_eval(input, label, chunk_scheme="IOB", num_chunk_types=1,
               excluded_chunk_types=None, seq_length=None, name=None):
    """Chunking precision, recall and F1 ([1] float32 each) and the
    counts of inferred, labelled and correct chunks ([1] int64 each) of
    the tag rows `input` and `label` [B, T] (or [T]) over `seq_length`."""
    dev = _device_of(input, label)
    excluded = tuple(excluded_chunk_types or ())
    inf, lab = _host(input), _host(label)
    if inf.ndim == 1:
        inf, lab = inf[None, :], lab[None, :]
    B, T = inf.shape
    lens = _lengths(seq_length, B, T)
    n_inf = n_lab = n_cor = 0
    for i in range(B):
        ci = _extract_chunks(inf[i, :int(lens[i])], chunk_scheme,
                             num_chunk_types, excluded)
        cl = _extract_chunks(lab[i, :int(lens[i])], chunk_scheme,
                             num_chunk_types, excluded)
        n_inf += len(ci)
        n_lab += len(cl)
        n_cor += len(ci & cl)
    prec = n_cor / n_inf if n_inf else 0.0
    rec = n_cor / n_lab if n_lab else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return tuple(torch.tensor([v], dtype=dt, device=dev) for v, dt in (
        (prec, torch.float32), (rec, torch.float32), (f1, torch.float32),
        (n_inf, torch.int64), (n_lab, torch.int64), (n_cor, torch.int64)))


__all__ = ["bpr_loss", "center_loss", "chunk_eval", "clip_by_norm",
           "cos_sim", "ctc_align", "edit_distance", "huber_loss", "l1_norm",
           "mean_iou", "modified_huber_loss", "positive_negative_pair",
           "rank_loss", "squared_l2_distance", "squared_l2_norm",
           "teacher_student_sigmoid_loss"]
