"""Paged attention over the KV page pools: three hand-written CUDA
kernels, each with its wrapper and its plain PyTorch version, and the
host mirrors of the kernels' work split and of the JAX package's
score-block metric.

- `ragged_paged_attention_kernel` (plain: `ragged_paged_attention_torch`),
  ``csrc/ragged_paged_attention.cu``, replaces the Pallas
  ``ragged_paged_attention_kernel``;
- `paged_decode_attention_kernel` (plain: `paged_decode_attention_torch`),
  ``csrc/paged_decode_attention.cu``, replaces the Pallas
  ``paged_decode_attention_kernel``;
- `chunk_prefill_attention_kernel` (plain:
  `chunk_prefill_attention_torch`), ``csrc/chunk_prefill_attention.cu``,
  replaces the Pallas ``chunk_prefill_attention_kernel``

(the TPU kernels live in ``paddle_tpu/ops/pallas/paged_attention.py``).
Each source file's header gives its design and what bounds it on an
H100.

- Each wrapper is the one place its device is chosen
  (``generation.decode_attention`` exports them under the JAX names): it
  launches the kernel for CUDA tensors, counting each launch in its
  ``launches`` attribute and, by pool dtype, in ``launches_by_dtype``,
  and raises on anything the kernel does not take; for CPU tensors, and
  only for those, it runs the plain version.
- Pools are float32, bfloat16 or int8.  An int8 pool comes with its
  ``k_scale`` / ``v_scale`` ``[P, H]`` float32 per-page per-head scales
  and only an int8 pool does (`_require_scales`, on every device): the
  kernels dequantize each staged page block, the plain versions their
  gathered view, both as ``int8 * (scale * (1/127))``.  No path
  dequantizes a pool.
- The plain versions are the gather-and-mask constructions of the JAX
  references, on any device.
- The three kernels run one split walk (``csrc/paged_attention_common.cuh``):
  `ragged_work_items`, `chunk_work_items` and `decode_work_items` list
  on the host the (tile, split) items each runs per head, and the
  ``*_grid_blocks`` functions their grids; `ragged_score_blocks` counts
  the [8, page_size] score blocks of the JAX package's
  ``generation.step_score_blocks`` metric.
"""
import collections
import contextlib
import ctypes
import math
import threading

import torch

from . import _build

NEG_INF = -1e30

# query rows of the JAX ragged kernel's tile: the unit of the
# ``generation.step_score_blocks`` metric (`ragged_score_blocks`)
RAGGED_Q_BLOCK = 8
# the CUDA ragged kernel's work split (RPA_QB, RPA_SPLIT_KEYS in its
# source): rows of a multi-row tile, least keys of a split
RAGGED_TILE_ROWS = 16
RAGGED_SPLIT_KEYS = 64
MAX_HEAD_DIM = 128
MAX_PAGE_SIZE = 64
# int8 dequant factor 1/127 in float32, bit-equal to
# generation.quantized_kv.INV_QMAX (a literal here: ops never imports the
# generation package)
INV_QMAX = 0.007874015718698502
# the kernels' pool dtype codes
_KV_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_RAGGED_LIB = "ragged_paged_attention"
_DECODE_LIB = "paged_decode_attention"
_CHUNK_LIB = "chunk_prefill_attention"


def _require_scales(pool, k_scale, v_scale):
    """An int8 pool comes with both its scale arrays, and only an int8
    pool does: raw int8 codes read as values, or float values multiplied
    by scale/127, are both finite and plausible-looking corruption, so a
    caller that forgot, half-threaded or wrongly threaded the cache's
    layer_scales() fails here (ValueError) instead of mis-attending."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(
            "k_scale and v_scale must be passed together — got one "
            "without the other (thread BOTH of the cache's layer_scales() "
            "arrays)")
    if k_scale is None and pool.dtype == torch.int8:
        raise ValueError(
            "int8 KV pool passed to paged attention without "
            "k_scale/v_scale — thread the cache's layer_scales() through")
    if k_scale is not None and pool.dtype != torch.int8:
        raise ValueError(
            f"k_scale/v_scale passed with a {pool.dtype} pool — scales "
            f"belong to int8 pools only (float values would be silently "
            f"multiplied by scale/127)")


def _gather_pool(pool, pt, b, h, d, layout, dtype, scale=None):
    """A [B, Kmax, H, D] view of each row of page table `pt` ([B, MP]),
    gathered from either pool layout and cast to `dtype` (bf16 pools are
    upcast on the gathered view, never the pool).  `scale` ([P, H], int8
    pools only) dequantizes the gathered int8 view with the kernels'
    expression ``value * (scale * (1/127))``."""
    if layout == "kernel":
        # pool [H, P, ps, D] -> [H, B, MP, ps, D] -> [B, MP, ps, H, D]
        g = pool[:, pt].permute(1, 2, 3, 0, 4)
    else:
        # pool [P, ps, H, D] -> [B, MP, ps, H, D]
        g = pool[pt]
    if scale is not None:
        # scale[pt]: [B, MP, H] -> broadcast over page rows and D
        g = g.to(dtype) * (scale[pt] * INV_QMAX)[:, :, None, :, None]
    return g.reshape(b, -1, h, d).to(dtype)


def ragged_paged_attention_torch(q, k_pool, v_pool, page_tables, starts,
                                 lens, kv_lens, scale=None, layout="token",
                                 k_scale=None, v_scale=None):
    """Plain PyTorch ragged paged attention.

    q: [T, H, D] packed query rows; descriptor s owns rows
        ``[starts[s], starts[s] + lens[s])`` (lens 0: unused).
    k_pool, v_pool: one layer's pool, [P, page_size, H, D] (token layout)
        or [H, P, page_size, D] (layout="kernel").
    page_tables: [S, max_pages] int; starts/lens/kv_lens: [S] int.
    k_scale, v_scale: [P, H] float32 scales of int8 pools, else None.
    Row r of descriptor s sits at position ``kv_lens[s] - lens[s] +
    (r - starts[s])`` and attends keys ``[0, position]``.
    Returns [T, H, D]; rows owned by no descriptor are exactly 0.

    Masked keys get NEG_INF, so ``exp(NEG_INF - m)`` is exactly 0, and
    weights are zeroed after the softmax where not visible (rows a
    descriptor does not own softmax over an all-masked row)."""
    _require_scales(k_pool, k_scale, v_scale)
    t, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dev = q.device
    pt = page_tables.to(dev, torch.long)
    starts = starts.to(dev, torch.long)
    lens = lens.to(dev, torch.long)
    kv_lens = kv_lens.to(dev, torch.long)
    s_n = pt.shape[0]
    k = _gather_pool(k_pool, pt, s_n, h, d, layout, q.dtype, k_scale)
    v = _gather_pool(v_pool, pt, s_n, h, d, layout, q.dtype, v_scale)
    kmax = k.shape[1]
    logits = torch.einsum("thd,skhd->sthk", q, k) * scale
    row = torch.arange(t, device=dev)[None, :]                   # [1, T]
    mine = (row >= starts[:, None]) & (row < (starts + lens)[:, None])
    qpos = (kv_lens - lens)[:, None] + (row - starts[:, None])
    col = torch.arange(kmax, device=dev)[None, None, :]          # [1,1,K]
    visible = (mine[:, :, None] & (col <= qpos[:, :, None]))[:, :, None, :]
    logits = torch.where(visible, logits, torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1)
    weights = torch.where(visible, weights, torch.zeros_like(weights))
    # each packed row is owned by at most one descriptor: summing over the
    # descriptor axis selects its one live contribution
    return torch.einsum("sthk,skhd->thd", weights, v)


def paged_decode_attention_torch(q, k_pool, v_pool, page_tables, seq_lens,
                                 scale=None, layout="token", k_scale=None,
                                 v_scale=None):
    """Plain PyTorch paged decode attention: one query row per sequence.

    q: [B, H, D]; k_pool, v_pool: one layer's pool in either layout (int8
    with its [P, H] k_scale/v_scale); page_tables: [B, max_pages] int
    (padding: page 0); seq_lens: [B] int.
    Sequence b attends to its first ``seq_lens[b]`` keys.  Returns
    [B, H, D]; a sequence of length 0 gets exact zeros (its softmax over
    an all-masked row is zeroed after the fact)."""
    _require_scales(k_pool, k_scale, v_scale)
    b, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dev = q.device
    pt = page_tables.to(dev, torch.long)
    lens = seq_lens.to(dev, torch.long)
    k = _gather_pool(k_pool, pt, b, h, d, layout, q.dtype, k_scale)
    v = _gather_pool(v_pool, pt, b, h, d, layout, q.dtype, v_scale)
    logits = torch.einsum("bhd,bkhd->bhk", q, k) * scale
    live = (torch.arange(k.shape[1], device=dev)[None, :]
            < lens[:, None])[:, None, :]                         # [B,1,K]
    logits = torch.where(live, logits, torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1)
    weights = torch.where((lens > 0)[:, None, None], weights,
                          torch.zeros_like(weights))
    return torch.einsum("bhk,bkhd->bhd", weights, v)


def chunk_prefill_attention_dense(q, k, v, start, scale=None):
    """Causal attention of ONE prefill chunk over keys in position order.

    q: [n, H, D], row i at position ``start + i``; k, v: [K, H, D], the
    prefix in rows [0, start) and the chunk's own keys after it (K may
    exceed start + n: rows past a query's position are masked and
    contribute exactly 0).  bf16 keys are upcast to q's dtype first.
    Returns [n, H, D]."""
    k = k.to(q.dtype)
    v = v.to(q.dtype)
    n, _, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("qhd,khd->hqk", q, k) * scale
    visible = (torch.arange(k.shape[0], device=q.device)[None, :]
               <= (start + torch.arange(n, device=q.device))[:, None])
    logits = torch.where(visible[None], logits,
                         torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("hqk,khd->qhd", weights, v)


def chunk_prefill_attention_torch(q, k_pool, v_pool, page_table, start,
                                  scale=None, layout="token", k_scale=None,
                                  v_scale=None):
    """Plain PyTorch chunked-prefill attention for ONE sequence, whose
    chunk K/V were already scattered into the pools: q [n, H, D] (row i
    at position ``start + i``), page_table [max_pages] int (padding: page
    0), `start` an int; int8 pools with their [P, H] k_scale/v_scale.
    Every key is read through the page table.  Returns [n, H, D]."""
    _require_scales(k_pool, k_scale, v_scale)
    n, h, d = q.shape
    pt = page_table.to(q.device, torch.long)[None]
    k = _gather_pool(k_pool, pt, 1, h, d, layout, q.dtype, k_scale)[0]
    v = _gather_pool(v_pool, pt, 1, h, d, layout, q.dtype, v_scale)[0]
    return chunk_prefill_attention_dense(q, k, v, int(start), scale=scale)


def _pool_strides(pool, layout):
    """(page, row, head) element strides of a pool in either layout."""
    if layout == "kernel":
        s_head, s_page, s_row, _ = pool.stride()
    else:
        s_page, s_row, s_head, _ = pool.stride()
    return s_page, s_row, s_head


def _check_kernel_args(q, k_pool, v_pool, layout, k_scale=None,
                       v_scale=None, **int_args):
    """Refuse what the CUDA kernels do not take: tensors off q's device
    or not contiguous, q not float32 [rows, H, D], pools not one 4-D
    shape of float32, bfloat16 or int8 matching q's heads and head_dim,
    an int8 pool's scales not float32 [pool pages, H], head_dim past
    MAX_HEAD_DIM or page_size past MAX_PAGE_SIZE, or index tensors
    (`int_args`) not int32.  Returns the page size."""
    dev = q.device
    scales = {} if k_scale is None else {"k_scale": k_scale,
                                         "v_scale": v_scale}
    named = {"q": q, "k_pool": k_pool, "v_pool": v_pool, **scales,
             **int_args}
    for name, x in named.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}: the "
                             f"kernel takes tensors on one device")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype != torch.float32 or q.dim() != 3:
        raise ValueError(f"q must be float32 [rows, H, D], got {q.dtype} "
                         f"{tuple(q.shape)}")
    if k_pool.dtype not in _KV_DTYPE_CODES or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"pools must both be float32, bfloat16 or int8, "
                         f"got {k_pool.dtype} and {v_pool.dtype}")
    if k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools must share one 4-D shape, got "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    _, h, d = q.shape
    if layout == "kernel":
        ph, n_pages, page_size, pd = k_pool.shape
    else:
        n_pages, page_size, ph, pd = k_pool.shape
    if (ph, pd) != (h, d):
        raise ValueError(f"pool heads/head_dim {(ph, pd)} != q's {(h, d)}")
    for name, x in scales.items():
        if x.dtype != torch.float32 or x.shape != (n_pages, h):
            raise ValueError(f"{name} must be float32 [{n_pages}, {h}] (one "
                             f"scale per pool page and head), got "
                             f"{x.dtype} {tuple(x.shape)}")
    if d > MAX_HEAD_DIM or page_size > MAX_PAGE_SIZE:
        raise ValueError(f"the kernel takes head_dim <= {MAX_HEAD_DIM} and "
                         f"page_size <= {MAX_PAGE_SIZE}, got {d} and "
                         f"{page_size}")
    for name, x in int_args.items():
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32")
    return page_size


def _check_descriptors(page_tables, starts, lens, kv_lens):
    s_n = page_tables.shape[0]
    if page_tables.dim() != 2 or any(
            x.shape != (s_n,) for x in (starts, lens, kv_lens)):
        raise ValueError(
            f"ragged descriptors must be [S]-shaped with a [S, MP] page "
            f"table: page_tables {tuple(page_tables.shape)}, starts "
            f"{tuple(starts.shape)}, lens {tuple(lens.shape)}, kv_lens "
            f"{tuple(kv_lens.shape)}")


def _launch(wrapper, lib_name, entry, q, k_pool, v_pool, layout, page_size,
            *mid, scale, k_scale, v_scale):
    """Launch one kernel on the current stream: ``entry(q, k_pool,
    v_pool, kv_dtype, k_scale, v_scale, s_page, s_row, s_head, *mid,
    page_size, scale, stream)`` (the scale pointers NULL unless int8),
    raising on a refused launch; then count it on `wrapper`."""
    lib = _load(lib_name)
    s_page, s_row, s_head = _pool_strides(k_pool, layout)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = getattr(lib, entry)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        _KV_DTYPE_CODES[k_pool.dtype],
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        s_page, s_row, s_head, *mid, page_size, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"{lib_name} launch failed: CUDA error {rc} "
                           f"({lib.pa_error_string(rc).decode()})")
    _count(wrapper, str(k_pool.dtype).replace("torch.", ""))


# several engines of one process (a fleet's in-process replicas) launch
# from their own worker threads: the counts move under one lock, and a
# thread recording its launches (a CUDA graph capture) counts apart
_COUNT_LOCK = threading.Lock()
_RECORDING = threading.local()


def _count(wrapper, dtype_name, n=1):
    rec = getattr(_RECORDING, "counts", None)
    if rec is not None:
        entry = rec.setdefault(wrapper, [0, {}])
        entry[0] += n
        entry[1][dtype_name] = entry[1].get(dtype_name, 0) + n
        return
    with _COUNT_LOCK:
        wrapper.launches += n
        wrapper.launches_by_dtype[dtype_name] += n


@contextlib.contextmanager
def recording_launches():
    """Count the paged kernels' launches made by THIS thread apart from
    the global counts, into the yielded ``{wrapper: [n, {dtype: n}]}``:
    a CUDA graph capture launches nothing, and its recorded launches are
    what each replay adds (``add_launches``), whatever other threads
    launch meanwhile."""
    prev = getattr(_RECORDING, "counts", None)
    _RECORDING.counts = rec = {}
    try:
        yield rec
    finally:
        _RECORDING.counts = prev


def add_launches(recorded):
    """Add a ``recording_launches`` record to the global counts (one
    replay of a captured graph)."""
    for wrapper, (_, by_dtype) in recorded.items():
        for dtype_name, n in by_dtype.items():
            _count(wrapper, dtype_name, n)


def _counted(wrapper):
    """Give `wrapper` its launch counts: ``launches`` in all and
    ``launches_by_dtype`` per pool dtype, so an f32 launch cannot stand in
    for an int8 one."""
    wrapper.launches = 0
    wrapper.launches_by_dtype = {
        str(t).replace("torch.", ""): 0 for t in _KV_DTYPE_CODES}
    return wrapper


@_counted
def ragged_paged_attention_kernel(q, k_pool, v_pool, page_tables, starts,
                                  lens, kv_lens, scale=None,
                                  layout="token", k_scale=None,
                                  v_scale=None):
    """The ragged kernel's wrapper: same contract as the plain version.

    CUDA tensors launch the CUDA kernel (building it on first use) on the
    current stream, with the output zero-filled here so rows no
    descriptor owns stay exactly 0; a refused launch raises.  CPU tensors
    run the plain version.  Anything else raises."""
    _check_descriptors(page_tables, starts, lens, kv_lens)
    _require_scales(k_pool, k_scale, v_scale)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return ragged_paged_attention_torch(
            q, k_pool, v_pool, page_tables, starts, lens, kv_lens,
            scale=scale, layout=layout, k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    page_size = _check_kernel_args(q, k_pool, v_pool, layout, k_scale,
                                   v_scale, page_tables=page_tables,
                                   starts=starts, lens=lens,
                                   kv_lens=kv_lens)
    t, h, d = q.shape
    s_n, max_pages = page_tables.shape
    out = torch.zeros_like(q)
    ws, counters = _split_scratch(q, max_pages, page_size)
    _launch(ragged_paged_attention_kernel, _RAGGED_LIB,
            "rpa_ragged_paged_attention", q, k_pool, v_pool, layout,
            page_size, page_tables.data_ptr(), max_pages, starts.data_ptr(),
            lens.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
            ws.data_ptr(), counters.data_ptr(), t, s_n, h, d, scale=scale,
            k_scale=k_scale, v_scale=v_scale)
    return out


def _split_scratch(q, max_pages, page_size):
    """The split walk's workspace and arrival counters for q's rows [*, H,
    D], sized from shapes alone (no device value is read): the split
    partials (acc, m, l) as ``[rows, H, max splits, D + 2 rounded up to
    16 bytes]`` float32, and one int32 counter per (row, head), zero (the
    kernels leave them zero)."""
    rows, h, d = q.shape
    ms = ragged_max_splits(max_pages, page_size)
    record = -(-(d + 2) // 4) * 4
    ws = torch.empty(rows * h * ms * record, dtype=torch.float32,
                     device=q.device)
    counters = torch.zeros(rows * h, dtype=torch.int32, device=q.device)
    return ws, counters


@_counted
def paged_decode_attention_kernel(q, k_pool, v_pool, page_tables, seq_lens,
                                  scale=None, layout="token", k_scale=None,
                                  v_scale=None):
    """The paged decode kernel's wrapper: same contract as
    `paged_decode_attention_torch`.  CUDA tensors launch the CUDA kernel
    (built on first use) on the current stream; every output row is
    written (length-0 sequences as exact zeros).  CPU tensors run the
    plain version.  Anything else raises."""
    if page_tables.dim() != 2 or seq_lens.shape != (page_tables.shape[0],) \
            or q.shape[0] != page_tables.shape[0]:
        raise ValueError(
            f"paged decode takes q [B, H, D], page_tables [B, MP] and "
            f"seq_lens [B]: got {tuple(q.shape)}, "
            f"{tuple(page_tables.shape)}, {tuple(seq_lens.shape)}")
    _require_scales(k_pool, k_scale, v_scale)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_decode_attention_torch(
            q, k_pool, v_pool, page_tables, seq_lens, scale=scale,
            layout=layout, k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    page_size = _check_kernel_args(q, k_pool, v_pool, layout, k_scale,
                                   v_scale, page_tables=page_tables,
                                   seq_lens=seq_lens)
    b, h, d = q.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    max_pages = page_tables.shape[1]
    ws, counters = _split_scratch(q, max_pages, page_size)
    _launch(paged_decode_attention_kernel, _DECODE_LIB,
            "pda_paged_decode_attention", q, k_pool, v_pool, layout,
            page_size, page_tables.data_ptr(), max_pages,
            seq_lens.data_ptr(), out.data_ptr(), ws.data_ptr(),
            counters.data_ptr(), b, h, d, scale=scale, k_scale=k_scale,
            v_scale=v_scale)
    return out


@_counted
def chunk_prefill_attention_kernel(q, k_pool, v_pool, page_table, start,
                                   scale=None, layout="token", k_scale=None,
                                   v_scale=None):
    """The chunk-prefill kernel's wrapper: same contract as
    `chunk_prefill_attention_torch`; `start` is a host int, passed to the
    kernel by value.  CUDA tensors launch the CUDA kernel (built on first
    use) on the current stream; CPU tensors run the plain version.
    Anything else raises."""
    start = int(start)
    if page_table.dim() != 1 or page_table.shape[0] < 1 or start < 0:
        raise ValueError(
            f"chunk prefill takes a [max_pages >= 1] page table and a "
            f"start >= 0: got {tuple(page_table.shape)} and {start}")
    _require_scales(k_pool, k_scale, v_scale)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return chunk_prefill_attention_torch(
            q, k_pool, v_pool, page_table, start, scale=scale,
            layout=layout, k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    page_size = _check_kernel_args(q, k_pool, v_pool, layout, k_scale,
                                   v_scale, page_table=page_table)
    n, h, d = q.shape
    out = torch.empty_like(q)
    if n == 0:
        return out
    max_pages = page_table.shape[0]
    ws, counters = _split_scratch(q, max_pages, page_size)
    _launch(chunk_prefill_attention_kernel, _CHUNK_LIB,
            "cpa_chunk_prefill_attention", q, k_pool, v_pool, layout,
            page_size, page_table.data_ptr(), max_pages, start,
            out.data_ptr(), ws.data_ptr(), counters.data_ptr(), n, h, d,
            scale=scale, k_scale=k_scale, v_scale=v_scale)
    return out


# each library's entry point: its ctypes argument types after the common
# (q, k_pool, v_pool, kv_dtype, k_scale, v_scale, s_page, s_row, s_head)
# head, before the common (page_size, scale, stream) tail
_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {
    _RAGGED_LIB: ("rpa_ragged_paged_attention",
                  [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I]),
    _DECODE_LIB: ("pda_paged_decode_attention",
                  [_P, _I, _P, _P, _P, _P, _I, _I, _I]),
    _CHUNK_LIB: ("cpa_chunk_prefill_attention",
                 [_P, _I, _I, _P, _P, _P, _I, _I, _I]),
}


def _load(name):
    first = not _build.loaded(name)
    lib = _build.load(name)
    if first:
        entry, mid = _ENTRIES[name]
        ll = ctypes.c_longlong
        fn = getattr(lib, entry)
        fn.argtypes = [_P, _P, _P, _I, _P, _P, ll, ll, ll, *mid, _I,
                       ctypes.c_float, _P]
        fn.restype = _I
        lib.pa_error_string.argtypes = [_I]
        lib.pa_error_string.restype = ctypes.c_char_p
    return lib


def ragged_split_pages(page_size):
    """Pages of one split of the CUDA ragged kernel: whole pages, at
    least RAGGED_SPLIT_KEYS keys."""
    return -(-RAGGED_SPLIT_KEYS // int(page_size))


def ragged_max_splits(max_pages, page_size):
    """Most splits a tile's walk of `max_pages` pages is cut into."""
    return -(-int(max_pages) // ragged_split_pages(page_size))


def ragged_grid_blocks(n_rows, n_desc, n_heads, max_pages, page_size):
    """The CUDA ragged kernel's grid: an upper bound on its items from
    shapes alone (tiles: at most one per row, and at most
    ceil(T / RAGGED_TILE_ROWS) + S), times the heads.  Blocks past the
    live items exit at once."""
    t = int(n_rows)
    tiles = min(t, -(-t // RAGGED_TILE_ROWS) + int(n_desc))
    return tiles * ragged_max_splits(max_pages, page_size) * int(n_heads)


RaggedItem = collections.namedtuple(
    "RaggedItem", "desc row0 n_rows qpos0 split n_splits page_lo page_hi")


def ragged_tile_splits(length, kv_len, tile, page_size, max_pages):
    """Splits of tile `tile` (rows ``[16 tile, 16 tile + 16)`` of
    `length`) of a sequence whose `length` rows end at its `kv_len`-th
    key: its keys up to its last row's position (at most `max_pages`
    pages) in `ragged_split_pages` pages a split; 0 when no row of the
    tile sees a key.  The host mirror of the kernels' ``rpa_tile_splits``."""
    off = int(tile) * RAGGED_TILE_ROWS
    length, kv_len, ps = int(length), int(kv_len), int(page_size)
    qlast = kv_len - length + off + min(RAGGED_TILE_ROWS, length - off) - 1
    if qlast < 0:
        return 0
    return -(-min(qlast // ps + 1, int(max_pages)) // ragged_split_pages(ps))


def _tile_items(desc, row0, length, kv_len, tile, page_size, max_pages):
    """The items of one tile in split order, its rows at ``row0 + 16
    tile`` on q's row axis."""
    ps, sp = int(page_size), ragged_split_pages(page_size)
    off = int(tile) * RAGGED_TILE_ROWS
    rows = min(RAGGED_TILE_ROWS, length - off)
    qpos0 = kv_len - length + off
    n_splits = ragged_tile_splits(length, kv_len, tile, ps, max_pages)
    pages = min((qpos0 + rows - 1) // ps + 1, int(max_pages))
    return [RaggedItem(desc, row0 + off, rows, qpos0, k, n_splits, k * sp,
                       min((k + 1) * sp, pages)) for k in range(n_splits)]


def ragged_work_items(starts, lens, kv_lens, page_size, max_pages, n_rows):
    """Host mirror of the CUDA ragged kernel's work split: the items it
    runs for each head, in its order.  Not used on the serving path.

    Descriptor s is cut into RAGGED_TILE_ROWS-row tiles from its first
    row (a one-row tile is a decode row); a tile walks pages ``0 ..
    qpos_last // page_size`` (at most `max_pages`), where qpos_last is
    the position of its last row, cut into splits of
    `ragged_split_pages` pages (`ragged_tile_splits`).  Each item is a
    `RaggedItem`: packed rows ``[row0, row0 + n_rows)`` at positions
    ``qpos0, qpos0 + 1, ...``, split `split` of the tile's `n_splits`,
    over the descriptor's page table entries ``[page_lo, page_hi)``.
    Tiles whose rows see no key (len 0, or every position negative) have
    no item.  The items of multi-row tiles come first (they take
    longest), then those of one-row tiles, each class in descriptor, tile
    and split order.  `n_rows` (T) only checks that every item's rows lie
    on the packed axis."""
    multi, one = [], []
    for s, (st, ln, kv) in enumerate(zip(starts, lens, kv_lens)):
        st, ln, kv = int(st), int(ln), int(kv)
        for t in range(-(-max(ln, 0) // RAGGED_TILE_ROWS)):
            items = _tile_items(s, st, ln, kv, t, page_size, max_pages)
            if items and not (0 <= items[0].row0 and items[0].row0
                              + items[0].n_rows <= int(n_rows)):
                raise ValueError(f"descriptor {s} owns rows past the "
                                 f"packed axis of {n_rows}")
            (one if items and items[0].n_rows == 1 else multi).extend(items)
    return multi + one


def chunk_work_items(n, start, page_size, max_pages):
    """Host mirror of the CUDA chunk-prefill kernel's items for each head:
    the ragged kernel's items of one descriptor (``lens = [n]``,
    ``kv_lens = [start + n]``, rows from 0), its tiles from the last (the
    most splits) to the first, each in split order.  Item i of the list
    is the one block i of a head runs.  Not used on the serving path."""
    n, start = int(n), int(start)
    return [it for t in reversed(range(-(-n // RAGGED_TILE_ROWS)))
            for it in _tile_items(0, 0, n, start + n, t, page_size,
                                  max_pages)]


def chunk_grid_blocks(n, start, n_heads, page_size, max_pages):
    """The CUDA chunk-prefill kernel's grid: exactly its items (every
    tile's splits, counted on the host from `n` and `start`) times the
    heads."""
    n, start = int(n), int(start)
    return int(n_heads) * sum(
        ragged_tile_splits(n, start + n, t, page_size, max_pages)
        for t in range(-(-n // RAGGED_TILE_ROWS)))


def decode_work_items(seq_lens, page_size, max_pages):
    """Host mirror of the CUDA paged-decode kernel's live items for each
    head: the ragged kernel's items of one-row descriptors (row b over
    ``seq_lens[b]`` keys, at position ``seq_lens[b] - 1``), in row and
    split order.  A row that sees no key has none.  Not used on the
    serving path."""
    return [it for b, kv in enumerate(seq_lens)
            for it in _tile_items(b, b, 1, int(kv), 0, page_size,
                                  max_pages)]


def decode_grid_blocks(n_rows, n_heads, max_pages, page_size):
    """The CUDA paged-decode kernel's grid, from shapes alone (the host
    reads no seq_len): every row's most splits times the heads.  Blocks
    past their row's splits exit at once."""
    return (int(n_rows) * ragged_max_splits(max_pages, page_size)
            * int(n_heads))


def ragged_score_blocks(starts, lens, kv_lens, page_size, n_pages, n_rows,
                        q_block=RAGGED_Q_BLOCK):
    """The score blocks of the JAX package's ``generation.step_score_blocks``
    metric (``paddle_tpu/ops/pallas/paged_attention.py::ragged_score_blocks``),
    a FLOP proxy in units of the JAX ragged kernel's [q_block, page_size]
    tile; the CUDA kernel's own work split is `ragged_work_items`.

    Returns ``(tiled, untiled)``: the [q_block, page_size] score blocks
    per head for these descriptors — each descriptor is cut into
    q_block-row tiles counted from ITS first row, and a tile visits pages
    ``0 .. qpos_max // page_size`` where qpos_max is the position of its
    last row — and, in the same units, what an untiled kernel (the full
    packed axis of `n_rows` rows per live (descriptor, page) cell) would
    compute."""
    import numpy as np

    qb = max(1, min(int(q_block), int(n_rows)))
    n_tiles = -(-int(n_rows) // qb)
    ps = int(page_size)
    starts = np.asarray(starts, np.int64)
    lens = np.asarray(lens, np.int64)
    kv_lens = np.asarray(kv_lens, np.int64)
    live = (lens > 0) & (kv_lens > 0)
    pages_live = np.minimum(-(-kv_lens // ps), int(n_pages))
    untiled = int((n_tiles * pages_live)[live].sum())
    tiled = 0
    tile = int(q_block)
    for ln, kv in zip(lens[live], kv_lens[live]):
        off = np.arange(0, ln, tile)                   # tile row offsets
        last = np.minimum(off + tile, ln) - 1
        qpos_max = kv - ln + last
        pages = np.minimum(qpos_max // ps + 1, int(n_pages))
        tiled += int(pages[qpos_max >= 0].sum())
    return tiled, untiled
