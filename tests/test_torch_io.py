"""Port parity: ``paddle_tpu_torch.io`` (datasets, samplers, DataLoader).

Each sampler, `random_split` and each dataset against the JAX
package's from the same numpy seed: the same indices in the same order.
Each loader mode (one process with its prefetch thread, two forked
workers, an iterable dataset, a given batch sampler, dict samples,
shuffled with ``drop_last``) against the JAX loader over the same data
and seed: every batch bitwise equal, in the same order (float arrays
float32 in both; integer ones keep their width in the port, where JAX
without x64 narrows int64 to int32: values equal).  Workers: their
`get_worker_info`, an exception raised in one, one that dies and a
`timeout`, each raised in the main process.  Datasets stay small and
each worker test carries a `timeout`."""
import os

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets)
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu.io as jio
from paddle_tpu_torch import io as pio

N = 22


def _arrays():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((N, 3)).astype(np.float32),
            rng.integers(0, 10, (N, 1)).astype(np.int64))


def _draw(make, seed=7):
    np.random.seed(seed)
    return [list(b) if isinstance(b, (list, tuple)) else b for b in make()]


SAMPLERS = {
    "sequence": lambda io, ds: io.SequenceSampler(ds),
    "random": lambda io, ds: io.RandomSampler(ds),
    "random_replacement": lambda io, ds: io.RandomSampler(
        ds, replacement=True, num_samples=15),
    "random_num_samples": lambda io, ds: io.RandomSampler(ds,
                                                          num_samples=9),
    "weighted": lambda io, ds: io.WeightedRandomSampler(
        np.linspace(0.1, 2.0, N), 12),
    "weighted_no_replacement": lambda io, ds: io.WeightedRandomSampler(
        np.linspace(0.1, 2.0, N), 8, replacement=False),
    "batch": lambda io, ds: io.BatchSampler(ds, batch_size=4),
    "batch_shuffle_drop_last": lambda io, ds: io.BatchSampler(
        ds, shuffle=True, batch_size=5, drop_last=True),
    "distributed_rank1_of3": lambda io, ds: io.DistributedBatchSampler(
        ds, batch_size=3, num_replicas=3, rank=1),
    "distributed_shuffle_rank0_of2": lambda io, ds: io.DistributedBatchSampler(
        ds, batch_size=4, num_replicas=2, rank=0, shuffle=True),
}


@pytest.mark.parametrize("kind", sorted(SAMPLERS))
def test_sampler_order_matches_jax(kind):
    x, y = _arrays()
    jaxs = SAMPLERS[kind](jio, jio.TensorDataset([x, y]))
    port = SAMPLERS[kind](pio, pio.TensorDataset([x, y]))
    for epoch in range(2):
        if hasattr(jaxs, "set_epoch"):
            jaxs.set_epoch(epoch)
            port.set_epoch(epoch)
        assert _draw(lambda: port, seed=epoch) == \
            _draw(lambda: jaxs, seed=epoch)
    assert len(port) == len(jaxs)


def test_distributed_sampler_reads_the_ports_rank_and_world_size():
    from paddle_tpu_torch.parallel import env

    s = pio.DistributedBatchSampler(list(range(N)), batch_size=4)
    assert (s.local_rank, s.nranks) == (env.get_rank(), env.get_world_size())


def _as_list(ds):
    return [tuple(np.asarray(v).tolist() for v in (s if isinstance(
        s, tuple) else (s,))) for s in (ds if not hasattr(ds, "__len__")
                                        else (ds[i] for i in range(len(ds))))]


def test_datasets_and_random_split_match_jax():
    x, y = _arrays()
    jt, pt = jio.TensorDataset([x, y]), pio.TensorDataset([x, y])
    assert len(pt) == len(jt) == N
    assert _as_list(pt) == _as_list(jt)
    tx = pio.TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])
    assert _as_list(tx) == _as_list(jt)
    for make in (lambda io, a, b: io.ComposeDataset([a, b]),
                 lambda io, a, b: io.dataset.ConcatDataset([a, b]),
                 lambda io, a, b: io.Subset(a, [3, 1, 4, 1, 5])):
        assert _as_list(make(pio, pt, pio.TensorDataset([y]))) == \
            _as_list(make(jio, jt, jio.TensorDataset([y])))

    class Count(pio.IterableDataset):
        def __init__(self, n):
            self.n = n

        def __iter__(self):
            return iter(range(self.n))

    assert [i for i in pio.ChainDataset([Count(3), Count(2)])] == \
        [0, 1, 2, 0, 1]
    with pytest.raises(RuntimeError):
        Count(2)[0]
    np.random.seed(3)
    jparts = jio.random_split(jt, [10, 12])
    np.random.seed(3)
    pparts = pio.random_split(pt, [10, 12])
    assert [p.indices for p in pparts] == [p.indices for p in jparts]


class Squares:
    """A map-style dataset of (x, x², label) rows, defined for both
    packages' base classes."""

    def __len__(self):
        return N

    def __getitem__(self, i):
        return (np.array([i, i + 0.5], np.float64),
                np.array([i * i], np.float32), i % 3)


class DictRows:
    def __len__(self):
        return N

    def __getitem__(self, i):
        return {"x": np.full(2, i, np.float32), "id": i}


def _iterable(io):
    class Stream(io.IterableDataset):
        def __iter__(self):
            for i in range(N):
                yield np.array([i, -i], np.float32), i

    return Stream()


LOADERS = {
    "single": lambda io, ds, **kw: io.DataLoader(ds, batch_size=4, **kw),
    "workers": lambda io, ds, **kw: io.DataLoader(
        ds, batch_size=4, num_workers=2, timeout=60, **kw),
    "shuffle_drop_last": lambda io, ds, **kw: io.DataLoader(
        ds, batch_size=5, shuffle=True, drop_last=True, **kw),
    "workers_shuffle": lambda io, ds, **kw: io.DataLoader(
        ds, batch_size=3, shuffle=True, num_workers=2, timeout=60, **kw),
    "batch_sampler": lambda io, ds, **kw: io.DataLoader(
        ds, batch_sampler=io.DistributedBatchSampler(
            ds, batch_size=3, num_replicas=2, rank=1, shuffle=True), **kw),
    "iterable": lambda io, ds, **kw: io.DataLoader(_iterable(io),
                                                   batch_size=4, **kw),
    "iterable_drop_last": lambda io, ds, **kw: io.DataLoader(
        _iterable(io), batch_size=4, drop_last=True, **kw),
    "dict": lambda io, ds, **kw: io.DataLoader(ds, batch_size=6, **kw),
}


def _host(batch):
    if isinstance(batch, dict):
        return {k: _host(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return [_host(v) for v in batch]
    if isinstance(batch, torch.Tensor):
        return batch.numpy()
    return np.asarray(batch.numpy())


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    else:
        assert np.array_equal(a, b), (a, b)
        if a.dtype.kind == "f":
            assert a.dtype == b.dtype == np.float32


@pytest.mark.parametrize("mode", sorted(LOADERS))
def test_loader_batches_match_jax_bitwise(mode):
    data = DictRows() if mode == "dict" else Squares()
    jl = LOADERS[mode](jio, data)
    pl = LOADERS[mode](pio, _PortData(data), places="cpu")
    want = _draw(lambda: [_host(b) for b in jl], seed=5)
    got = _draw(lambda: [_host(b) for b in pl], seed=5)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _same(g, w)


def _PortData(data):
    # the port's loader takes any object with __len__/__getitem__, as
    # the JAX loader does; wrap to prove it does not need the JAX base
    class Wrapped(pio.Dataset):
        def __len__(self):
            return len(data)

        def __getitem__(self, i):
            return data[i]

    return Wrapped()


def test_loader_tensors_land_on_places():
    x, y = _arrays()
    ld = pio.DataLoader(pio.TensorDataset([x, y]), batch_size=8,
                        places="cpu")
    xb, yb = next(iter(ld))
    assert xb.device.type == "cpu" and xb.dtype == torch.float32
    assert yb.dtype == torch.int64 and len(ld) == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs CUDA"):
            pio.DataLoader(pio.TensorDataset([x, y]))
    with pytest.raises(NotImplementedError, match="worker_init_fn"):
        pio.DataLoader(pio.TensorDataset([x, y]), places="cpu",
                       worker_init_fn=print)


class WorkerIds(pio.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        info = pio.get_worker_info()
        return np.array([info.id, info.num_workers, os.getpid()])


class Failing(pio.Dataset):
    def __init__(self, how):
        self.how = how

    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            if self.how == "raise":
                raise ValueError("bad sample 5")
            if self.how == "die":
                os._exit(7)
            if self.how == "stall":
                import time

                time.sleep(30)
        return np.float32(i)


def test_workers_report_their_info():
    assert pio.get_worker_info() is None
    ld = pio.DataLoader(WorkerIds(), batch_size=2, num_workers=2,
                        places="cpu", timeout=60)
    rows = torch.cat(list(ld)).numpy()
    # batches go round robin: batch i to worker i % 2
    assert rows[:, 0].tolist() == [0, 0, 1, 1, 0, 0, 1, 1]
    assert set(rows[:, 1].tolist()) == {2}
    assert os.getpid() not in set(rows[:, 2].tolist())


@pytest.mark.parametrize("how,error,match", [
    ("raise", ValueError, "bad sample 5"),
    ("die", RuntimeError, "exited unexpectedly"),
    ("stall", RuntimeError, "timed out")])
def test_worker_failures_raise_in_the_main_process(how, error, match):
    ld = pio.DataLoader(Failing(how), batch_size=2, num_workers=2,
                        places="cpu", timeout=2)
    with pytest.raises(error, match=match):
        list(ld)
    single = pio.DataLoader(Failing("raise"), batch_size=2, places="cpu")
    with pytest.raises(ValueError, match="bad sample 5"):
        list(single)
