"""DataLoader (``paddle_tpu/io/dataloader.py``): a map-style dataset
through a batch sampler, or an iterable dataset in slices; batches
collated to numpy, then turned into tensors on the loader's device.

- ``num_workers=0``: a prefetch thread collates up to
  `prefetch_factor` batches ahead (the JAX package's Python-queue
  path; its native C++ queue is not ported).
- ``num_workers > 0``: forked worker processes (`_worker_loop`) load and
  collate batches to numpy, round robin, and the main process yields
  them in sampler order.  Forked, as the JAX package's are, so a dataset
  or collate function need not pickle; a worker never touches CUDA (a
  child forked from a process that has initialised CUDA cannot use it)
  nor starts a thread.  A worker
  that dies, or (with `timeout` > 0) a batch that does not come within
  `timeout` seconds, raises in the main process; the loader never goes
  on without its workers.
- `places` is the device the batches go to: None means the card, and
  raises without one.  Float64 arrays become float32, as the JAX
  package's ``to_tensor`` makes them; integer arrays keep their width
  (the JAX package, without x64, narrows int64 to int32)."""
import itertools
import multiprocessing as mp
import pickle
import queue
import threading
import time

import numpy as np
import torch

from ..device import resolve_device
from .dataset import IterableDataset
from .sampler import BatchSampler

# how often the main process looks at its workers while it waits
_POLL_S = 0.5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def default_collate_fn(batch):
    """Stack a list of samples field by field into numpy arrays: lists
    and tuples by position, dicts by key, arrays, tensors and numbers by
    ``np.stack`` / ``np.asarray``; anything else stays the list."""
    sample = batch[0]
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn([b[i] for b in batch])
                for i in range(len(sample))]
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, (torch.Tensor, np.ndarray)):
        return np.stack([_np(b) for b in batch])
    if isinstance(sample, (int, float, np.number)):
        return np.asarray(batch)
    return batch


class WorkerInfo:
    """`get_worker_info`'s answer inside a worker process."""

    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    """The current worker's `WorkerInfo` inside a DataLoader worker
    process; None in the main process."""
    return _worker_info


def collate_np(samples, collate_fn):
    """`collate_fn` over `samples`, every tensor in the result as a numpy
    array."""
    def to_np(x):
        if isinstance(x, torch.Tensor):
            return _np(x)
        if isinstance(x, (list, tuple)):
            return type(x)(to_np(v) for v in x)
        if isinstance(x, dict):
            return {k: to_np(v) for k, v in x.items()}
        return x

    return to_np(collate_fn(samples))


def _picklable(e):
    try:
        pickle.dumps(e)
        return e
    except Exception:
        return RuntimeError(f"DataLoader worker failed: {e!r}")


def _worker_loop(dataset, index_queue, data_queue, collate_fn,
                 worker_id=0, num_workers=1):
    global _worker_info
    _worker_info = WorkerInfo(worker_id, num_workers, dataset)
    while True:
        item = index_queue.get()
        if item is None:
            break
        seq, indices = item
        try:
            samples = [dataset[i] for i in indices]
            data_queue.put((seq, collate_np(samples, collate_fn)))
        except Exception as e:  # the main process raises it
            data_queue.put((seq, _picklable(e)))


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        if worker_init_fn is not None:
            raise NotImplementedError(
                "worker_init_fn is not ported (the JAX loader never calls "
                "it)")
        self.dataset = dataset
        if isinstance(places, (list, tuple)):
            places = places[0]
        self.device = resolve_device(places, "DataLoader")
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.return_list = return_list
        self.timeout = timeout
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle,
                batch_size=batch_size if batch_size else 1,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("length of IterableDataset loader is unknown")
        return len(self.batch_sampler)

    def __iter__(self):
        if self._iterable_mode:
            yield from self._iter_iterable()
        elif self.num_workers == 0:
            yield from self._iter_single()
        else:
            yield from self._iter_multiprocess()

    def _to_tensors(self, batch):
        def conv(x):
            if isinstance(x, np.ndarray):
                if x.dtype == np.float64:
                    x = x.astype(np.float32)
                return torch.from_numpy(np.require(x, requirements="C")).to(
                    self.device)
            if isinstance(x, (list, tuple)):
                return type(x)(conv(v) for v in x)
            if isinstance(x, dict):
                return {k: conv(v) for k, v in x.items()}
            return x

        return conv(batch)

    def _iter_iterable(self):
        it = iter(self.dataset)
        while True:
            samples = list(itertools.islice(it, self.batch_size))
            if not samples:
                return
            if len(samples) < self.batch_size and self.drop_last:
                return
            yield self._to_tensors(collate_np(samples, self.collate_fn))

    def _iter_single(self):
        """A producer thread collates batches into a queue of
        `prefetch_factor`; its exception is raised here.  The sampler is
        read lazily, so an endless batch sampler works."""
        batch_iter = iter(self.batch_sampler)
        q = queue.Queue(maxsize=self.prefetch_factor)
        stop = object()
        closed = threading.Event()

        def put(item):
            while not closed.is_set():
                try:
                    q.put(item, timeout=_POLL_S)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for indices in batch_iter:
                    samples = [self.dataset[i] for i in indices]
                    if not put(collate_np(samples, self.collate_fn)):
                        return
            except Exception as e:
                put(e)
            put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    return
                if isinstance(item, Exception):
                    raise item
                yield self._to_tensors(item)
        finally:
            closed.set()
            t.join(timeout=5)

    def _next_result(self, data_queue, workers):
        """The next (seq, payload) from the workers; RuntimeError when a
        worker has died or `timeout` seconds pass without one."""
        waited = 0.0
        while True:
            try:
                return data_queue.get(timeout=_POLL_S)
            except queue.Empty:
                waited += _POLL_S
            dead = [w for w in workers if not w.is_alive()]
            if dead:
                raise RuntimeError(
                    "DataLoader worker(s) exited unexpectedly: " + ", ".join(
                        f"pid {w.pid} exit code {w.exitcode}" for w in dead))
            if self.timeout and waited >= self.timeout:
                raise RuntimeError(f"DataLoader timed out: no batch from "
                                   f"its workers in {self.timeout} s")

    def _iter_multiprocess(self):
        ctx = mp.get_context("fork")
        index_queues = []
        data_queue = ctx.Queue()
        workers = []
        for wid in range(self.num_workers):
            iq = ctx.Queue()
            w = ctx.Process(target=_worker_loop,
                            args=(self.dataset, iq, data_queue,
                                  self.collate_fn, wid, self.num_workers),
                            daemon=True)
            w.start()
            workers.append(w)
            index_queues.append(iq)

        batch_iter = iter(self.batch_sampler)  # lazy: endless samplers work
        state = {"next_dispatch": 0, "exhausted": False}
        buffered = {}
        next_yield = 0

        def dispatch():
            if state["exhausted"]:
                return False
            try:
                indices = next(batch_iter)
            except StopIteration:
                state["exhausted"] = True
                return False
            i = state["next_dispatch"]
            index_queues[i % self.num_workers].put((i, indices))
            state["next_dispatch"] = i + 1
            return True

        try:
            # keep prefetch_factor batches in flight per worker
            limit = self.num_workers * self.prefetch_factor
            while (state["next_dispatch"] - next_yield) < limit and dispatch():
                pass
            while not (state["exhausted"]
                       and next_yield == state["next_dispatch"]):
                while next_yield not in buffered:
                    seq, payload = self._next_result(data_queue, workers)
                    if isinstance(payload, Exception):
                        raise payload
                    buffered[seq] = payload
                    dispatch()
                yield self._to_tensors(buffered.pop(next_yield))
                next_yield += 1
        finally:
            for iq in index_queues:
                iq.put(None)
            deadline = time.monotonic() + 1.0
            for w in workers:
                w.join(timeout=max(deadline - time.monotonic(), 0.0))
                if w.is_alive():
                    w.terminate()
                    w.join()
