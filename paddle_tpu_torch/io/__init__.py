"""Datasets, samplers and the DataLoader (``paddle_tpu/io/``).  The
sharded checkpoints (``sharded_ckpt.py``, written through orbax) and
the native file feed (``file_feed.py``) are not ported."""
from .dataloader import DataLoader, default_collate_fn, get_worker_info
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, WeightedRandomSampler)

__all__ = ["BatchSampler", "ChainDataset", "ComposeDataset", "ConcatDataset",
           "DataLoader", "Dataset", "DistributedBatchSampler",
           "IterableDataset", "RandomSampler", "Sampler", "SequenceSampler",
           "Subset", "TensorDataset", "WeightedRandomSampler",
           "default_collate_fn", "get_worker_info", "random_split"]
