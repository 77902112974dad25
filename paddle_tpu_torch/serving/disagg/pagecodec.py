"""Page-payload codec: the data plane's wire format.

The page service's export schema (engine.export_prefix_pages) ships
``{"tokens", "k", "v"[, "k_scale", "v_scale"]}`` with K/V pools shaped
``[L, n, page_size, H, D]`` — raw int8+scales (quantized pools) or raw
bf16/fp32 planes.  On a real network those bytes dominate cross-host
adoption and P/D handoff cost, so this module turns a payload into a
versioned, self-describing wire frame:

- level "raw": byte-exact passthrough (the A/B baseline, and the
  negotiated floor every fleet member supports).
- level "delta": per-page delta filter along the TOKEN axis (uint8
  wraparound subtraction of consecutive token rows — adjacent
  positions' K/V are strongly correlated, so deltas concentrate near
  zero) followed by zlib entropy coding.  Decode inverts with a
  modular cumulative sum: the roundtrip is BITWISE exact for every
  dtype, bfloat16 included: every array is read and written through a
  ``uint8`` view of its host tensor, and its dtype travels by name
  (``"float32"``, ``"bfloat16"``, ``"int8"``).

Every encoded array records its own filter/codec, and an array whose
compressed form is not smaller than raw falls back to raw passthrough
per array — "delta" never inflates adversarial (incompressible) pages
beyond the frame overhead.

Version negotiation: the fetch request carries the importer's codec
version and accepted levels; the holder encodes at the best mutually
supported level and stamps the frame with ``pv``.  A frame from the
future (unknown version, filter or codec) decodes to a TYPED
PageCodecError — a heterogeneous fleet mid-upgrade degrades to the
cold-prefill ladder, never to corrupt pages.
"""
import math
import zlib

import numpy as np
import torch

from ..admission import ServingError

# wire version this build speaks; decoders accept exactly these
VERSION = 1
SUPPORTED_VERSIONS = (1,)
# codec levels, best-first: negotiation picks the first requested
# level this build supports
LEVEL_DELTA = "delta"
LEVEL_RAW = "raw"
SUPPORTED_LEVELS = (LEVEL_DELTA, LEVEL_RAW)

_ZLIB_LEVEL = 6
_ARRAY_FIELDS = ("k", "v", "k_scale", "v_scale")


class PageCodecError(ServingError):
    """A page frame this build cannot decode (unknown version/level/
    filter) or a level negotiation with no common ground — TYPED so
    adoption degrades to the cold-prefill ladder, never corrupts."""


def negotiate(version, levels):
    """Holder-side handshake: pick the best mutually supported codec
    level for an importer speaking `version` and accepting `levels`
    (best-first).  Raises PageCodecError when there is no common
    ground — the typed refusal heterogeneous fleets degrade on."""
    if version not in SUPPORTED_VERSIONS:
        raise PageCodecError(
            f"pagecodec version {version!r} not supported "
            f"(this build speaks {SUPPORTED_VERSIONS})")
    for lv in levels:
        if lv in SUPPORTED_LEVELS:
            return lv
    raise PageCodecError(
        f"no common codec level: importer accepts {list(levels)!r}, "
        f"this build offers {list(SUPPORTED_LEVELS)}")


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8,
           "uint8": torch.uint8, "int32": torch.int32,
           "int64": torch.int64}


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _as_tensor(arr):
    """A contiguous host tensor of `arr` (a tensor or a numpy array)."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(arr))
    return t.detach().cpu().contiguous()


def _byte_view(t):
    """The bytes of contiguous host tensor `t` as a flat uint8 tensor."""
    flat = t.reshape(-1)
    if flat.dtype == torch.uint8:
        return flat
    if flat.numel() == 0:
        return torch.empty(0, dtype=torch.uint8)
    return flat.view(torch.uint8)


def _token_rows_shape(shape):
    """[pages, rows, -1] with the delta axis (axis 1) running along
    in-page token positions.  Pool planes are [L, n, page_size, H, D]
    (rows = page_size); anything else (scales, odd shapes) deltas along
    its leading axis."""
    if len(shape) == 5:
        return (shape[0] * shape[1], shape[2], -1)
    return (1, shape[0] if shape else 1, -1)


def _encode_array(arr, level):
    t = _as_tensor(arr)
    raw = _byte_view(t)
    blob = {"shape": tuple(t.shape), "dtype": _dtype_name(t.dtype),
            "filter": "raw", "codec": "raw",
            "data": raw.numpy().tobytes()}
    if level == LEVEL_DELTA and t.numel():
        rows = raw.reshape(*_token_rows_shape(tuple(t.shape)))
        d = rows.clone()   # uint8 arithmetic wraps modulo 256
        d[:, 1:, :] -= rows[:, :-1, :]
        packed = zlib.compress(d.numpy().tobytes(), _ZLIB_LEVEL)
        if len(packed) < len(blob["data"]):
            blob.update(filter="delta", codec="zlib", data=packed)
    return blob


def _decode_array(blob):
    for field in ("shape", "dtype", "filter", "codec", "data"):
        if field not in blob:
            raise PageCodecError(f"page frame array missing {field!r}")
    if blob["codec"] == "zlib":
        raw = zlib.decompress(blob["data"])
    elif blob["codec"] == "raw":
        raw = blob["data"]
    else:
        raise PageCodecError(
            f"unknown entropy codec {blob['codec']!r}")
    dtype = _DTYPES.get(_dtype_name(blob["dtype"]))
    if dtype is None:
        raise PageCodecError(f"unknown page dtype {blob['dtype']!r}")
    shape = tuple(int(x) for x in blob["shape"])
    expect = math.prod(shape) * dtype.itemsize
    if len(raw) != expect:
        raise PageCodecError(
            f"page frame length {len(raw)} != expected {expect} for "
            f"shape {shape} dtype {blob['dtype']}")
    b = torch.frombuffer(bytearray(raw), dtype=torch.uint8) if raw \
        else torch.empty(0, dtype=torch.uint8)
    if blob["filter"] == "delta":
        # inverse filter: modular cumulative sum along the token axis
        rows = b.reshape(*_token_rows_shape(shape)).to(torch.int64)
        b = (rows.cumsum(dim=1) & 0xFF).to(torch.uint8).reshape(-1)
    elif blob["filter"] != "raw":
        raise PageCodecError(f"unknown filter {blob['filter']!r}")
    if dtype == torch.uint8:
        return b.reshape(shape)
    if b.numel() == 0:
        return torch.empty(shape, dtype=dtype)
    return b.view(dtype).reshape(shape)


def encode_payload(payload, level=LEVEL_DELTA):
    """Encode one export payload into a versioned wire frame.  `level`
    must be a SUPPORTED_LEVELS member (run negotiate() first)."""
    if level not in SUPPORTED_LEVELS:
        raise PageCodecError(f"unknown codec level {level!r}")
    enc = {"pv": VERSION, "level": level,
           "tokens": [int(t) for t in payload["tokens"]]}
    for field in _ARRAY_FIELDS:
        if field in payload:
            enc[field] = _encode_array(payload[field], level)
    return enc


def decode_payload(enc):
    """Decode a wire frame back into the export payload — bitwise
    identical arrays, dtypes included.  Raises PageCodecError for
    frames from an unknown version (or damaged self-description):
    heterogeneous fleets degrade typed, never silently."""
    if not isinstance(enc, dict) or "pv" not in enc:
        raise PageCodecError("not a page frame (no version tag)")
    if enc["pv"] not in SUPPORTED_VERSIONS:
        raise PageCodecError(
            f"page frame version {enc['pv']!r} not supported "
            f"(this build speaks {SUPPORTED_VERSIONS})")
    payload = {"tokens": [int(t) for t in enc.get("tokens", ())]}
    for field in _ARRAY_FIELDS:
        if field in enc:
            payload[field] = _decode_array(enc[field])
    return payload


def wire_bytes(enc):
    """Page bytes actually on the wire for an encoded frame (array
    data only — framing/tokens overhead is O(1) and excluded so the
    compression-ratio arithmetic stays exact)."""
    return sum(len(enc[f]["data"]) for f in _ARRAY_FIELDS if f in enc)


def raw_bytes(enc):
    """What the same frame would weigh uncompressed (the int8+scales
    baseline the compression ratio is measured against)."""
    total = 0
    for f in _ARRAY_FIELDS:
        if f in enc:
            blob = enc[f]
            total += (math.prod(int(x) for x in blob["shape"])
                      * _DTYPES[_dtype_name(blob["dtype"])].itemsize)
    return total


def payload_nbytes(payload):
    """Raw byte weight of an UNENCODED export payload (the relay
    path's wire cost accounting)."""
    return sum(_as_tensor(payload[f]).numel()
               * _as_tensor(payload[f]).element_size()
               for f in _ARRAY_FIELDS if payload.get(f) is not None)


__all__ = [
    "VERSION", "SUPPORTED_VERSIONS", "LEVEL_DELTA", "LEVEL_RAW",
    "SUPPORTED_LEVELS", "PageCodecError", "negotiate",
    "encode_payload", "decode_payload", "wire_bytes", "raw_bytes",
    "payload_nbytes",
]
