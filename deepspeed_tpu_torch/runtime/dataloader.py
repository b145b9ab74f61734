"""Data loading.

Counterpart of ``deepspeed_tpu/runtime/dataloader.py`` (``RepeatingLoader``
and ``DeepSpeedDataLoader``): the loader yields global batches of numpy
arrays (a dict, tuple or list of them, as the samples are), and the engine
moves them to its device.  The sample order for a seed and an epoch is the
JAX package's, ``np.random.default_rng(seed + epoch)``; each process takes
its ``process_index``-strided slice of every global batch (world size 1
here); ``num_workers`` > 1 fetches a batch's samples through a thread
pool, whose ``map`` keeps their order.

Not ported yet: ``DevicePrefetchIterator`` and ``PrefetchingDataLoader``,
the async input pipeline (ROADMAP A17).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def _world():
    """(number of processes, this process's index) of torch.distributed,
    or (1, 0)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def numpy_collate(samples):
    """Stack samples leaf by leaf: dicts by key, tuples and lists by
    position, arrays and scalars with ``np.stack``."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: numpy_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(numpy_collate([s[i] for s in samples])
                            for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


class RepeatingLoader:
    """Wraps an iterable, restarting it at StopIteration."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __len__(self):
        return len(self.loader)

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


class DeepSpeedDataLoader:
    """Batches an indexable dataset into numpy batches.

    ``dataset``: a sequence of samples (arrays, or dicts / tuples of
    them); ``collate_fn`` replaces :func:`numpy_collate`;
    ``num_workers`` > 1 fetches each batch's samples through a thread pool
    (the reference's ``num_local_io_workers``), in index order, so the
    worker count never changes the batches."""

    def __init__(self, dataset, batch_size, collate_fn=None, seed=0,
                 shuffle=True, drop_last=True, num_processes=None,
                 process_index=None, num_workers=0):
        world, rank = _world()
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or numpy_collate
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_processes = (num_processes if num_processes is not None
                              else world)
        self.process_index = (process_index if process_index is not None
                              else rank)
        self.num_workers = int(num_workers or 0)
        self._pool = None
        self.epoch = 0
        if batch_size % self.num_processes:
            raise ValueError(f"global batch {batch_size} must divide across "
                             f"{self.num_processes} processes")
        self.local_batch = batch_size // self.num_processes

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _fetch(self, indices):
        if self.num_workers > 1 and len(indices) > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.num_workers,
                    thread_name_prefix="ds-io-worker")
            samples = list(self._pool.map(self.dataset.__getitem__,
                                          [int(i) for i in indices]))
        else:
            samples = [self.dataset[int(i)] for i in indices]
        return self.collate_fn(samples)

    def close(self):
        """Stop the fetch pool's threads."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        for start in range(0, n - self.batch_size + 1 if self.drop_last
                           else n, self.batch_size):
            idx = order[start:start + self.batch_size]
            local = idx[self.process_index::self.num_processes]
            yield self._fetch(local)
        self.epoch += 1
