"""Dtype names (``paddle_tpu/core/dtype.py``): a user dtype, given as a
paddle-style name, a numpy dtype or a ``torch.dtype``, as the
``torch.dtype`` the port computes in."""
import numpy as np
import torch

_NAME2DTYPE = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "complex64": torch.complex64, "complex128": torch.complex128,
}


def convert_dtype(dtype):
    """A user dtype (a name, a numpy dtype or a torch dtype) as a
    ``torch.dtype``; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _NAME2DTYPE:
        raise ValueError(f"Unknown dtype name: {dtype!r}")
    return _NAME2DTYPE[name]


def dtype_name(dtype):
    return str(dtype).removeprefix("torch.")
