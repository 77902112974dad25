"""Datasets (``paddle_tpu/io/dataset.py``).  A `TensorDataset` holds
numpy arrays or torch tensors, indexed row by row; `random_split`
draws its permutation from numpy's global generator, as the JAX
package does, so one ``np.random.seed`` gives one split in both."""
import bisect

import numpy as np


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Row `idx` of each of `tensors` (numpy arrays or torch tensors of
    one length)."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            out.extend(sample if isinstance(sample, (list, tuple))
                       else [sample])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        di = bisect.bisect_right(self.cum, idx)
        prev = self.cum[di - 1] if di else 0
        return self.datasets[di][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    assert sum(lengths) == len(dataset)
    perm = np.random.permutation(len(dataset))
    out = []
    off = 0
    for ln in lengths:
        out.append(Subset(dataset, perm[off: off + ln].tolist()))
        off += ln
    return out
