"""`save` and `load` (``paddle_tpu/framework.py``): a pickle of nested
dicts, lists and tuples whose tensors are numpy arrays, the JAX
package's format, so a ``.pdparams`` or ``.pdopt`` written by either
package loads in the other.  A bfloat16 tensor is stored as an
``ml_dtypes.bfloat16`` array, as the JAX package stores one."""
import os
import pickle

import numpy as np
import torch

from .device import resolve_device


def _bf16_dtype():
    try:
        import ml_dtypes
    except ImportError as e:
        raise NotImplementedError(
            "saving or loading a bfloat16 tensor needs ml_dtypes, the "
            "dtype the JAX package's checkpoints use") from e
    return np.dtype(ml_dtypes.bfloat16)


def _to_saveable(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_bf16_dtype())
        return t.numpy().copy()
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def save(obj, path, protocol=4):
    """Pickle `obj` to `path` (its directory made as needed), every
    tensor in it as a numpy array."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


def _from_saved(obj, device):
    if isinstance(obj, np.ndarray):
        if obj.dtype.name == "bfloat16":
            t = torch.from_numpy(obj.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.require(obj, requirements="C"))
        return t.to(device)
    if isinstance(obj, dict):
        return {k: _from_saved(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saved(v, device) for v in obj)
    return obj


def load(path, device=None, **configs):
    """What `save` wrote to `path` (or the JAX package's ``paddle.save``),
    every numpy array as a tensor on `device` (None means the card, and
    raises without one)."""
    dev = resolve_device(device, "load")
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _from_saved(obj, dev)
