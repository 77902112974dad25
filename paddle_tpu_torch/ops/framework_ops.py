"""The selected-rows functions of ``paddle_tpu/ops/framework_ops.py``,
over sparse COO gradients (``core.indexed_slices``); the rest of that
module is not ported yet."""
import torch

from ..core.indexed_slices import coalesce


def _check(x, who):
    if not (isinstance(x, torch.Tensor) and x.is_sparse):
        raise TypeError(f"{who} expects a sparse row gradient (a sparse COO "
                        f"tensor)")


def merge_selected_rows(x, name=None):
    """`x` with its duplicate rows summed, ids sorted
    (merge_selected_rows_op)."""
    _check(x, "merge_selected_rows")
    ids, rows = coalesce(x)
    return torch.sparse_coo_tensor(ids[None], rows, tuple(x.shape),
                                   is_coalesced=True, check_invariants=False)


def get_tensor_from_selected_rows(x, name=None):
    """`x` as a dense tensor (get_tensor_from_selected_rows_op)."""
    _check(x, "get_tensor_from_selected_rows")
    return x.to_dense()


__all__ = ["get_tensor_from_selected_rows", "merge_selected_rows"]
