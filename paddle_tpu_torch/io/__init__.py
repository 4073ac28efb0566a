"""Data pipeline: the port's own copy of ``paddle_tpu/io/__init__.py``
(reference: python/paddle/io/ + fluid/dataloader/ - worker loop
worker.py:255, the double-buffer prefetch of
operators/reader/buffered_reader.cc).

Datasets, samplers and collation are the JAX package's, in numpy, so one
seeded pipeline gives both packages the same batches in the same order
(``RandomSampler`` draws from numpy's global stream).  Python worker
processes produce numpy batches over a multiprocessing queue; a
background thread then stages each batch on the device ahead of
consumption: on the card it pins the host arrays and copies them on a
side CUDA stream, and the consumer's stream waits on that copy's event
(the counterpart of the JAX prefetcher's ``jax.device_put``).  Batches
come out as tensors (float64 as float32, as JAX without x64).

The JAX package's native shared-memory transport (``io/native.py``,
chosen by ``FLAGS_dataloader_use_native``) is not ported: with that flag
set, a loader with worker processes raises ``UnimplementedError`` rather
than quietly taking the queue.
"""
from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
import threading
from typing import Any, Iterable, List, Optional, Sequence

import numpy as np

from ..framework.errors import UnimplementedError, enforce
from ..framework.flags import get_flag
from ..utils.tree import tree_map

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "Subset", "ChainDataset", "random_split", "Sampler", "SequenceSampler",
    "RandomSampler", "BatchSampler", "DistributedBatchSampler",
    "WeightedRandomSampler", "DataLoader", "default_collate_fn",
    "WorkerInfo", "get_worker_info",
]


# ---------------------------------------------------------------------------
# Datasets (reference: python/paddle/io/dataset.py)
# ---------------------------------------------------------------------------
class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise TypeError("IterableDataset is not indexable")

    def __len__(self):
        raise TypeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        arrs = [np.asarray(t) for t in tensors]
        enforce(all(a.shape[0] == arrs[0].shape[0] for a in arrs),
                "all tensors must share dim 0")
        self.tensors = arrs

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, tuple) else (item,))
        return tuple(out)

    def __len__(self):
        return min(len(d) for d in self.datasets)


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    enforce(sum(lengths) == len(dataset), "lengths must sum to dataset size")
    perm = np.random.permutation(len(dataset))
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n].tolist()))
        off += n
    return out


# ---------------------------------------------------------------------------
# Samplers (reference: python/paddle/io/sampler.py, batch_sampler.py)
# ---------------------------------------------------------------------------
class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    """Draw indices with the given per-sample weights (reference
    fluid/dataloader WeightedRandomSampler)."""

    def __init__(self, weights, num_samples: int, replacement: bool = True):
        super().__init__()
        self.weights = np.asarray(weights, np.float64)
        enforce(np.all(self.weights >= 0), "weights must be non-negative")
        enforce(self.weights.sum() > 0, "weights must not all be zero")
        enforce(num_samples > 0, "num_samples must be positive")
        self.num_samples = num_samples
        self.replacement = replacement
        enforce(replacement
                or num_samples <= int(np.count_nonzero(self.weights)),
                "cannot draw more samples than nonzero weights without "
                "replacement")

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle: bool = False,
                 batch_size: int = 1, drop_last: bool = False):
        enforce((dataset is None) != (sampler is None),
                "provide exactly one of dataset/sampler")
        if sampler is None:
            sampler = RandomSampler(dataset) if shuffle else SequenceSampler(dataset)
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Reference: python/paddle/io/dataloader/batch_sampler.py
    DistributedBatchSampler — shards sample indices across data-parallel
    ranks (epoch-seeded shuffle so every rank permutes identically)."""

    def __init__(self, dataset, batch_size: int, num_replicas: Optional[int] = None,
                 rank: Optional[int] = None, shuffle: bool = False,
                 drop_last: bool = False):
        from .. import distributed as dist
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else dist.get_world_size()
        self.local_rank = rank if rank is not None else dist.get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: self.total_size - n]  # pad to even shards
        indices = indices[self.local_rank: self.total_size: self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


# ---------------------------------------------------------------------------
# Collate
# ---------------------------------------------------------------------------
def default_collate_fn(batch: List[Any]):
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    return np.asarray(batch)


# ---------------------------------------------------------------------------
# Worker process loop (reference: fluid/dataloader/worker.py:255 _worker_loop)
# ---------------------------------------------------------------------------
class WorkerInfo:
    """Reference fluid/dataloader/worker.py WorkerInfo: available inside
    dataset code running in a DataLoader worker via get_worker_info()."""

    def __init__(self, id: int, num_workers: int, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info: Optional[WorkerInfo] = None


def get_worker_info() -> Optional[WorkerInfo]:
    """None in the main process; the WorkerInfo inside a worker
    (reference paddle.io.get_worker_info)."""
    return _worker_info


def _worker_loop(dataset, index_queue, result_queue, collate_fn, worker_id,
                 worker_init_fn, num_workers: int = 1):
    """The python mp.Queue carries the collated numpy batches (the JAX
    package's native shared-memory ``ring`` is not ported)."""
    global _worker_info
    _worker_info = WorkerInfo(worker_id, num_workers, dataset)
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    np.random.seed((np.random.SeedSequence().entropy + worker_id) % (2**31))
    while True:
        item = index_queue.get()
        if item is None:
            break
        batch_id, indices = item
        try:
            samples = [dataset[i] for i in indices]
            batch = collate_fn(samples)
            result_queue.put((batch_id, batch, None))
        except Exception as e:  # propagate across the process boundary
            result_queue.put((batch_id, None, repr(e)))


class DataLoader:
    """Reference: paddle.io.DataLoader (fluid/reader.py).

    num_workers=0: synchronous in-process loading.
    num_workers>0: worker subprocesses (index queue -> result queue),
    batches re-ordered by id, ``prefetch_factor`` batches in flight per
    worker.  With ``to_device`` a prefetch thread stages each batch on
    ``places`` (default ``cuda``; the CPU only when asked) while the
    consumer works on the previous one; ``to_device=False`` yields the
    collated numpy batches.
    """

    def __init__(self, dataset, feed_list=None, places=None,
                 batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, batch_sampler=None,
                 num_workers: int = 0, collate_fn=None,
                 use_shared_memory=True, prefetch_factor: int = 2,
                 worker_init_fn=None, to_device: bool = True,
                 return_list=True):
        self.dataset = dataset
        self.num_workers = num_workers
        self.collate_fn = collate_fn or default_collate_fn
        self.prefetch_factor = max(prefetch_factor, 1)
        self.worker_init_fn = worker_init_fn
        self.to_device = to_device
        self.use_shared_memory = use_shared_memory
        if to_device:
            from ..device import resolve_device
            if isinstance(places, (list, tuple)):
                places = places[0] if places else None
            self.device = resolve_device(places)
        else:
            self.device = None
        if num_workers > 0 and use_shared_memory and _native_requested():
            raise UnimplementedError(
                "FLAGS_dataloader_use_native asks for the native "
                "shared-memory transport, which the port does not have; "
                "unset it (or pass use_shared_memory=False) to carry "
                "batches over the worker queue")
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset=dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    # -- iteration ---------------------------------------------------------
    def __iter__(self):
        if self._iterable_mode:
            gen = self._iter_iterable()
        elif self.num_workers == 0:
            gen = self._iter_single()
        else:
            gen = self._iter_multiprocess()
        if self.to_device:
            gen = _DevicePrefetcher(gen, self.device)
        return gen

    def _iter_iterable(self):
        # an IterableDataset runs in-process (num_workers is a map-style
        # knob here); the canonical get_worker_info() sharding pattern
        # sees a single-worker view: one shard is the stream
        global _worker_info
        prev = _worker_info
        _worker_info = WorkerInfo(0, 1, self.dataset)
        try:
            batch = []
            for sample in self.dataset:
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
        finally:
            _worker_info = prev

    def _iter_single(self):
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])

    def _iter_multiprocess(self):
        ctx = mp.get_context("fork")
        index_queue = ctx.Queue()
        result_queue = ctx.Queue()
        workers = []
        for wid in range(self.num_workers):
            w = ctx.Process(
                target=_worker_loop,
                args=(self.dataset, index_queue, result_queue,
                      self.collate_fn, wid, self.worker_init_fn,
                      self.num_workers),
                daemon=True)
            w.start()
            workers.append(w)

        def shutdown():
            for _ in workers:
                try:
                    index_queue.put(None)
                except Exception:  # noqa: swallow - best-effort shutdown
                    pass
            for w in workers:
                w.join(timeout=1.0)
                if w.is_alive():
                    w.terminate()

        try:
            sampler_iter = enumerate(iter(self.batch_sampler))
            in_flight = {}
            reorder = {}
            next_out = 0
            # prime
            for _ in range(self.prefetch_factor * self.num_workers):
                try:
                    bid, indices = next(sampler_iter)
                except StopIteration:
                    break
                index_queue.put((bid, indices))
                in_flight[bid] = True
            while in_flight:
                bid, batch, err = result_queue.get()
                if err is not None:
                    raise RuntimeError(f"DataLoader worker failed: {err}")
                del in_flight[bid]
                reorder[bid] = batch
                try:
                    nbid, indices = next(sampler_iter)
                    index_queue.put((nbid, indices))
                    in_flight[nbid] = True
                except StopIteration:
                    pass
                while next_out in reorder:
                    yield reorder.pop(next_out)
                    next_out += 1
        finally:
            shutdown()


def _native_requested() -> bool:
    """The ``dataloader_use_native`` flag (``set_flags``, else the
    ``FLAGS_dataloader_use_native`` environment variable)."""
    return bool(get_flag("dataloader_use_native"))


def _as_tensor(a):
    """A numpy array as a CPU tensor (float64 as float32, as JAX without
    x64); an array torch cannot hold, or anything else, as it is."""
    import torch
    if not isinstance(a, np.ndarray) or a.dtype.kind not in "biuf":
        return a
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    try:
        return torch.from_numpy(np.ascontiguousarray(a))
    except TypeError:   # a dtype torch has no tensor for (uint16 ...)
        return a


class _DevicePrefetcher:
    """Host -> device double buffering (the buffered_reader.cc analog):
    keeps up to ``depth`` batches already staged while the consumer works
    on the previous one.  On the card each array is pinned and copied on a
    side stream; ``__next__`` makes the consumer's current stream wait on
    that copy's event and marks the tensors as used by it."""

    def __init__(self, gen: Iterable, device, depth: int = 2):
        self._gen = iter(gen)
        self._device = device
        self._queue: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        import torch
        cuda = self._device.type == "cuda"
        stream = torch.cuda.Stream(self._device) if cuda else None
        try:
            for batch in self._gen:
                host = tree_map(_as_tensor, batch)
                if not cuda:
                    self._queue.put((host, None))
                    continue
                with torch.cuda.stream(stream):
                    staged = tree_map(
                        lambda t: t.pin_memory().to(self._device,
                                                    non_blocking=True)
                        if torch.is_tensor(t) else t, host)
                    event = torch.cuda.Event()
                    event.record(stream)
                self._queue.put((staged, event))
        except Exception as e:
            self._queue.put(e)
            return
        self._queue.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._done:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        staged, event = item
        if event is not None:
            import torch
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            tree_map(lambda t: t.record_stream(current)
                 if torch.is_tensor(t) else t, staged)
        return staged


class ChainDataset(IterableDataset):
    """Chain iterable datasets back to back (reference ChainDataset)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for ds in self.datasets:
            yield from ds
