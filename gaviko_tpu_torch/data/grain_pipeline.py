"""``data.loader: grain``: ``Loader``'s batch stream on PyTorch's own runtime.

Port of ``gaviko_tpu/data/grain_pipeline.py``. The JAX package runs the
stream on grain's dataset runtime; ``import grain`` imports JAX, and the
card's machine has neither, so the port runs the same stream the PyTorch
way. ``GrainLoader`` keeps ``Loader``'s epoch, batch and seed logic (the
same shuffle of each epoch, sample ``i`` drawing from
``RandomState((epoch_seed * 1_000_003 + i) % 2**31)``, pad rows labelled
-100, ``n_valid`` the batch's real rows, ``shard`` a data shard's rows of each
batch), so it yields the same ``(inputs, labels, n_valid)`` as ``Loader``
and as the JAX package's ``GrainLoader``:

- ``processes == 0``: ``num_workers`` threads assemble whole batches, up to
  ``max(num_workers, prefetch)`` of them ahead of the consumer, delivered
  in order;
- ``processes > 0``: one ``torch.utils.data.DataLoader`` for the loader's
  life, ``num_workers=processes`` *spawned* processes (a fork of a process
  holding threads or JAX can deadlock) kept across epochs
  (``persistent_workers``). Its sampler yields each epoch's
  ``(epoch seed, batch indices)``; a worker assembles that batch, loading
  its samples on ``num_workers // processes`` threads. Delivery is in order,
  with a ``timeout`` on every batch, so a hung worker raises instead of
  stalling the run. Every transform must pickle (module-level functions or
  ``functools.partial``, as in ``data/transforms.py``). ``close()`` stops
  the workers; so does dropping the loader.

Select with ``data.loader: grain`` (+ ``data.grain_processes``);
``pick_loader`` in ``data/pipeline.py`` dispatches.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import itertools
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch.utils.data

from gaviko_tpu_torch.data.pipeline import Loader, VolumeDataset, assemble_batch

Key = Tuple[int, np.ndarray]  # (epoch seed, dataset indices of one batch)


class BatchAssembler(torch.utils.data.Dataset):
    """Item ``(epoch_seed, bidx)``: that batch (``assemble_batch``), its
    samples loaded on ``threads`` threads, ``shard`` its rows of the batch.
    Picklable, for the process workers; each process makes its own thread
    pool."""

    def __init__(self, ds: VolumeDataset, batch_size: int, pad_to_batch: bool,
                 threads: int = 1, shard: Tuple[int, int] = (0, 1)):
        self.shard = tuple(shard)
        self.ds = ds
        self.batch_size = batch_size
        self.pad_to_batch = pad_to_batch
        self.threads = threads
        self._pool = None

    def __getstate__(self):
        return {**self.__dict__, "_pool": None}

    def __getitem__(self, key: Key):
        epoch_seed, bidx = key
        map_fn = map
        if self.threads > 1:
            if self._pool is None:
                self._pool = cf.ThreadPoolExecutor(max_workers=self.threads)
            map_fn = self._pool.map
        return assemble_batch(self.ds, bidx, self.batch_size, self.pad_to_batch,
                              epoch_seed, map_fn, self.shard)


class EpochKeys(torch.utils.data.Sampler):
    """The current epoch's batch keys, set before each epoch in the main
    process (where a ``DataLoader`` iterates its sampler)."""

    def __init__(self):
        self.keys: List[Key] = []

    def __iter__(self):
        return iter(self.keys)

    def __len__(self) -> int:
        return len(self.keys)


def _as_is(item):
    """The DataLoader's collate: the assembled batch, numpy arrays kept."""
    return item


class GrainLoader(Loader):
    """Drop-in for ``Loader``, with ``processes`` (0: threads; > 0: that
    many spawned worker processes) and ``timeout`` (seconds a process
    worker may take for one batch, its start included)."""

    def __init__(self, *args, processes: int = 0, timeout: float = 600.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.processes = int(processes)
        self.timeout = float(timeout)
        self._keys = EpochKeys()
        self._workers: Optional[torch.utils.data.DataLoader] = None

    def __iter__(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray], int]]:
        batches = self._batches()
        self._epoch += 1
        # The epoch's augmentation seed, as Loader's: seed + epoch + 1.
        keys = [(self.seed + self._epoch, b) for b in batches]
        if self.processes > 0:
            return self._processes(keys)
        return self._threads(keys)

    def close(self) -> None:
        """Stop the process workers (a later epoch starts new ones)."""
        self._workers = None

    def _threads(self, keys: List[Key]):
        assemble = BatchAssembler(self.ds, self.batch_size, self.pad_to_batch,
                                  shard=self.shard)
        pool = cf.ThreadPoolExecutor(max_workers=self.num_workers)
        todo = iter(keys)
        ahead = collections.deque(
            pool.submit(assemble.__getitem__, k)
            for k in itertools.islice(todo, max(self.num_workers, self.prefetch, 1)))
        try:
            while ahead:
                item = ahead.popleft().result()  # a load error raises here
                nxt = next(todo, None)
                if nxt is not None:
                    ahead.append(pool.submit(assemble.__getitem__, nxt))
                yield item
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    def _processes(self, keys: List[Key]):
        if self._workers is None:
            assemble = BatchAssembler(self.ds, self.batch_size, self.pad_to_batch,
                                      max(1, self.num_workers // self.processes), self.shard)
            # Its own generator: the workers' base seeds (unused here) are not
            # drawn from torch's global RNG.
            self._workers = torch.utils.data.DataLoader(
                assemble, batch_size=None, sampler=self._keys,
                num_workers=self.processes, collate_fn=_as_is,
                multiprocessing_context="spawn", timeout=self.timeout,
                prefetch_factor=max(self.prefetch, 1), persistent_workers=True,
                in_order=True, generator=torch.Generator())
        self._keys.keys = keys
        # The workers start at the first epoch; each later one sends them its
        # keys (an abandoned epoch's leftover batches are dropped).
        return iter(self._workers)
