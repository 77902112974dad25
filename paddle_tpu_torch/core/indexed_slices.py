"""Sparse row gradients (``paddle_tpu/core/indexed_slices.py``, the
reference's SelectedRows) as torch's sparse COO tensors.

``Embedding(sparse=True)`` gives its [V, D] weight a COO gradient of one
row per lookup, in lookup order and uncoalesced, as JAX's
``IndexedSlices`` before `coalesce`.  Autograd's accumulation into
``.grad`` follows JAX's ``IndexedSlices.__add__``: sparse plus sparse
concatenates the rows, sparse plus dense is dense.  The eager optimizer
step updates only the rows a sparse gradient names
(``optimizer.Optimizer.step``)."""
import torch


def indexed_slices(indices, values, dense_shape):
    """The [dense_shape] COO tensor of the rows `values` at the row ids
    `indices`, in their order, duplicates kept (uncoalesced)."""
    dense_shape = tuple(dense_shape)
    return torch.sparse_coo_tensor(
        indices.reshape(1, -1).long(),
        values.reshape((-1,) + dense_shape[1:]), dense_shape,
        check_invariants=False)


def coalesce(grad):
    """The sorted unique row ids of the COO tensor `grad` and their rows,
    duplicates summed (the reference's MergeAdd): ``unique`` then an
    index add, as JAX's ``jnp.unique`` and ``segment_sum``.  (torch's own
    ``coalesce`` sums each id's duplicates in one CUDA thread: on a batch
    of padded reviews, whose padding id repeats thousands of times, it
    took 2.14 ms of a 6.65 ms step on an NVIDIA H100 80GB HBM3 at
    700 W.)"""
    ids, rows = grad._indices()[0], grad._values()
    uniq, inverse = torch.unique(ids, sorted=True, return_inverse=True)
    summed = torch.zeros((uniq.numel(),) + tuple(rows.shape[1:]),
                         dtype=rows.dtype, device=rows.device)
    return uniq, summed.index_add_(0, inverse, rows)
