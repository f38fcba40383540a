"""paddle_tpu_torch.io — datasets, samplers and DataLoader (counterpart of
paddle_tpu/io).

The samplers draw from numpy's global random state, as the reference's
do, so under one ``np.random.seed`` both packages yield the same index
lists; each also takes an explicit ``generator`` (a
``numpy.random.RandomState``). Batches are collated to numpy and become
CPU tensors; ``num_workers > 0`` forks a pool of worker processes that
index and collate with numpy only (a worker must never touch CUDA: the
parent has usually initialised it, and a forked child cannot use it),
returned in batch order. With ``use_buffer_reader`` (the default) the
loader double-buffers onto its device (``places``, default the first
card): the next batch is copied from pinned memory on a side stream
while the current one computes, and the consuming stream waits for that
copy (and records its use of the tensors) before the batch is handed
out. The reference's native row gather for a `TensorDataset` is not
ported: the port gathers with numpy (its fallback path).
"""

from __future__ import annotations

import itertools
import math
import multiprocessing as mp
import queue
import threading
import traceback

import numpy as np
import torch

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "Subset", "random_split", "Sampler",
           "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
           "BatchSampler", "DistributedBatchSampler", "default_collate_fn",
           "get_worker_info", "DataLoader"]


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


def _host(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class TensorDataset(Dataset):
    def __init__(self, tensors):
        # host numpy copies: samples must be fork-safe (loader workers)
        self.tensors = [_host(t) for t in tensors]

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, tuple):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        return itertools.chain(*self.datasets)


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def _rng(generator):
    return np.random if generator is None else generator


def random_split(dataset, lengths, generator=None):
    total = len(dataset)
    if sum(lengths) != total:
        raise ValueError("sum of input lengths must equal dataset length")
    perm = _rng(generator).permutation(total)
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n].tolist()))
        offset += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = _rng(self.generator)
        if self.replacement:
            return iter(rng.randint(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True,
                 generator=None):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement
        self.generator = generator

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = _rng(self.generator).choice(
            len(self.weights), self.num_samples, replace=self.replacement,
            p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        if sampler is None:
            sampler = RandomSampler(dataset) if shuffle else \
                SequenceSampler(dataset)
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
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards the dataset over data-parallel ranks: rank r takes every
    ``num_replicas``-th index from r, the list padded to a multiple of
    the ranks; with ``shuffle`` the order is a permutation seeded by the
    epoch (`set_epoch`). Without ``num_replicas`` / ``rank`` they come
    from ``torch.distributed`` when it is initialised, else 1 / 0."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        dist = torch.distributed
        up = dist.is_available() and dist.is_initialized()
        if num_replicas is None:
            num_replicas = dist.get_world_size() if up else 1
        if rank is None:
            rank = dist.get_rank() if up else 0
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.epoch).shuffle(indices)
        indices = np.concatenate([indices, indices[: self.total_size - n]])
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices.tolist():
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

    def set_epoch(self, epoch):
        self.epoch = epoch


def _numpy_collate(batch):
    """Collate to numpy (the worker-side form: no tensors)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return np.stack([_host(s) for s in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, float, np.number)):
        return np.asarray(batch)
    if isinstance(sample, (list, tuple)):
        return [_numpy_collate(list(fields)) for fields in zip(*batch)]
    if isinstance(sample, dict):
        return {k: _numpy_collate([d[k] for d in batch]) for k in sample}
    return batch


def _to_tensor_tree(item):
    if isinstance(item, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(item))
    if isinstance(item, (list, tuple)):
        return [_to_tensor_tree(v) for v in item]
    if isinstance(item, dict):
        return {k: _to_tensor_tree(v) for k, v in item.items()}
    return item


def default_collate_fn(batch):
    """Stack a list of samples field by field into CPU tensors."""
    return _to_tensor_tree(_numpy_collate(batch))


class WorkerInfo:
    def __init__(self, id, num_workers, dataset, seed):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


_worker_info: WorkerInfo | None = None


def get_worker_info():
    """Inside a loader worker: its (id, num_workers, dataset, seed); None
    in the main process."""
    return _worker_info


class _ExcInfo:
    def __init__(self, exc):
        self.type_name = type(exc).__name__
        self.tb = traceback.format_exc()


def _reject_tensors(obj, where):
    """A worker returns numpy only: tensors (which may be CUDA tensors,
    unusable in a forked child of a process that initialised CUDA) are
    refused."""
    if isinstance(obj, torch.Tensor):
        raise RuntimeError(
            f"{where} produced a torch Tensor inside a loader worker; "
            "return numpy when num_workers > 0 — a forked child of a "
            "process that initialised CUDA cannot use it")
    if isinstance(obj, (list, tuple)):
        for v in obj:
            _reject_tensors(v, where)
    elif isinstance(obj, dict):
        for v in obj.values():
            _reject_tensors(v, where)


def _worker_loop(dataset, index_queue, result_queue, collate_fn, init_fn,
                 worker_id, num_workers, base_seed):
    """Pull index lists, collate to numpy, push (batch_id, data)."""
    global _worker_info
    _worker_info = WorkerInfo(worker_id, num_workers, dataset,
                              base_seed + worker_id)
    np.random.seed(base_seed + worker_id)
    if init_fn is not None:
        init_fn(worker_id)
    while True:
        job = index_queue.get()
        if job is None:
            return
        batch_id, idxs = job
        try:
            samples = [dataset[i] for i in idxs]
            for s in samples:
                _reject_tensors(s, "dataset __getitem__")
            data = collate_fn(samples)
            _reject_tensors(data, "collate_fn")
            result_queue.put((batch_id, ("ok", data)))
        except Exception as e:  # noqa: BLE001 — forwarded to the parent
            result_queue.put((batch_id, ("err", _ExcInfo(e))))


class _MultiprocessIter:
    """A forked worker pool with ordered batch reassembly."""

    def __init__(self, loader):
        self.loader = loader
        self.num_workers = loader.num_workers
        self.timeout = loader.timeout or None
        ctx = mp.get_context("fork")
        self.result_queue = ctx.Queue()
        self.index_queues = []
        self.workers = []
        # a fresh base seed per iterator (epoch): reseeding alike every
        # epoch would repeat augmentations
        epoch = loader._epoch_count
        loader._epoch_count += 1
        base_seed = (int(torch.initial_seed()) * 1000003 + epoch * 7919) \
            & 0x7FFFFFFF
        for w in range(self.num_workers):
            iq = ctx.Queue()
            p = ctx.Process(
                target=_worker_loop,
                args=(loader.dataset, iq, self.result_queue,
                      loader._worker_collate_fn, loader.worker_init_fn, w,
                      self.num_workers, base_seed),
                daemon=True)
            p.start()
            self.index_queues.append(iq)
            self.workers.append(p)
        self._next_send = 0
        self._next_recv = 0
        self._reorder = {}
        self._batches = iter(loader.batch_sampler)
        self._exhausted = False
        self._shutdown_done = False
        for _ in range(max(2, loader.prefetch_factor * self.num_workers)):
            self._dispatch_one()

    def _dispatch_one(self):
        if self._exhausted:
            return
        try:
            idxs = next(self._batches)
        except StopIteration:
            self._exhausted = True
            return
        self.index_queues[self._next_send % self.num_workers].put(
            (self._next_send, idxs))
        self._next_send += 1

    def __iter__(self):
        return self

    def __next__(self):
        if self._next_recv >= self._next_send and self._exhausted:
            self._shutdown()
            raise StopIteration
        waited = 0.0
        while self._next_recv not in self._reorder:
            try:
                batch_id, payload = self.result_queue.get(timeout=5.0)
            except queue.Empty:
                waited += 5.0
                dead = [i for i, p in enumerate(self.workers)
                        if not p.is_alive()]
                if dead:
                    self._shutdown()
                    raise RuntimeError(
                        f"DataLoader workers died: ranks {dead}")
                if self.timeout and waited >= self.timeout:
                    self._shutdown()
                    raise RuntimeError(
                        f"DataLoader timed out after {self.timeout}s")
                continue
            self._reorder[batch_id] = payload
        status, data = self._reorder.pop(self._next_recv)
        self._next_recv += 1
        self._dispatch_one()
        if status == "err":
            self._shutdown()
            raise RuntimeError(
                f"DataLoader worker raised {data.type_name}:\n{data.tb}")
        return _to_tensor_tree(data)

    def _shutdown(self):
        if self._shutdown_done:
            return
        self._shutdown_done = True
        for iq in self.index_queues:
            try:
                iq.put(None)
            except (OSError, ValueError):
                pass
        for p in self.workers:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self.result_queue.close()

    def __del__(self):
        try:
            self._shutdown()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def _tree_map(fn, batch):
    if isinstance(batch, torch.Tensor):
        return fn(batch)
    if isinstance(batch, (list, tuple)):
        return [_tree_map(fn, b) for b in batch]
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    return batch


def _device_prefetch(iterator, device):
    """Double-buffered copies onto `device`: batch N+1 is copied from
    pinned memory on a side stream while batch N computes; before a
    batch is handed out, the consuming stream waits for its copy and
    records its use of the tensors (so their memory is not reused under
    it). On a CPU device the batches pass through as they are."""
    if device.type != "cuda":
        yield from iterator
        return
    side = torch.cuda.Stream(device)

    def put(batch):
        with torch.cuda.stream(side):
            out = _tree_map(lambda t: t.pin_memory().to(
                device, non_blocking=True), batch)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def ready(item):
        batch, done = item
        cur = torch.cuda.current_stream(device)
        cur.wait_event(done)
        _tree_map(lambda t: t.record_stream(cur), batch)
        return batch

    prev = None
    for batch in iterator:
        cur = put(batch)
        if prev is not None:
            yield ready(prev)
        prev = cur
    if prev is not None:
        yield ready(prev)


class DataLoader:
    """Batches of `dataset` (collated CPU tensors, double-buffered onto
    ``places`` when ``use_buffer_reader``), from the main process or
    from ``num_workers`` forked workers."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.places = places
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        # the worker-side collate stays numpy; a user collate_fn runs in
        # the worker as it is
        self._worker_collate_fn = collate_fn or _numpy_collate
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.use_buffer_reader = use_buffer_reader
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self._epoch_count = 0
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        elif not self._iterable_mode and batch_size is not None:
            self.batch_size = batch_size
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
        else:
            self.batch_size = batch_size
            self.batch_sampler = None
        self.drop_last = drop_last

    def __len__(self):
        if self._iterable_mode:
            raise RuntimeError("IterableDataset has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _device(self):
        from .. import resolve_device

        places = self.places
        if isinstance(places, (list, tuple)):
            places = places[0]
        return resolve_device(places)

    def _iter_batches(self):
        if self._iterable_mode:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch or (len(batch) < self.batch_size
                                 and self.drop_last):
                    return
                yield self.collate_fn(batch)
        elif self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.dataset[i]
        else:
            for idxs in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idxs])

    def __iter__(self):
        workers = bool(self.num_workers and self.num_workers > 0)
        if workers and self._iterable_mode:
            # an iterable dataset keeps the thread prefetcher (each fork
            # would re-iterate the same stream)
            it = self._prefetch_iter()
        elif workers and self.batch_sampler is not None:
            it = iter(_MultiprocessIter(self))
        else:
            it = self._iter_batches()
        if self.use_buffer_reader:
            return _device_prefetch(it, self._device())
        return it

    def _prefetch_iter(self):
        """A producer thread assembling the next batches; its exceptions
        re-raise in the consumer."""
        q = queue.Queue(maxsize=max(2, self.prefetch_factor *
                                    self.num_workers))
        sentinel = object()
        error = []

        def producer():
            try:
                for b in self._iter_batches():
                    q.put(b)
            except BaseException as e:  # noqa: BLE001 — forwarded below
                error.append(e)
            finally:
                q.put(sentinel)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item
