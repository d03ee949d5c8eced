"""Host-side data pipeline: npz volumes -> prefetched host batches.

Port of ``gaviko_tpu/data/pipeline.py`` (the reference's torch DataLoader +
torchio workers, src/data/dataset.py, src/train.py:65-78, as a thread-pooled
numpy loader). Contract preserved:

- CSV columns ``mri_path, kl_grade, subset``; subset splits train / val /
  test. The CSV is read with the ``csv`` module into a list of row dicts
  (a "frame"), since the card's machine has no pandas;
- each .npz holds key ``data`` shaped (D, H, W); a channel dim is
  prepended;
- folder inference scans ``*.npz`` (ref: inference.py:141-158).

The batch order and every augmentation draw are the JAX package's: the
shuffle of epoch E is ``RandomState(seed + E)`` and sample ``i`` of it draws
from ``RandomState(((seed + E + 1) * 1_000_003 + i) % 2**31)``, so both
packages yield the same batches from the same files. ``data.loader: grain``
selects the same stream on PyTorch's runtime (``data/grain_pipeline.py``).
``shard=(i, n)`` (a ``train.parallel`` run: the rank's index on the mesh's
data axis and its size) loads only rows [i * B / n, (i + 1) * B / n) of
every global batch, pad rows included, while ``n_valid`` stays the global
batch's count of real rows, as the JAX package's multi-host loader does.
"""

from __future__ import annotations

import concurrent.futures as cf
import csv
import functools
import os
import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

Frame = List[Dict[str, str]]  # CSV rows, column -> text


@dataclass
class VolumeDataset:
    paths: List[str]
    labels: Optional[np.ndarray]  # None for prediction datasets
    transform: Callable[..., np.ndarray]
    train: bool = False

    def __len__(self) -> int:
        return len(self.paths)

    def load(self, i: int, rng: Optional[np.random.RandomState] = None) -> np.ndarray:
        with np.load(self.paths[i]) as z:
            vol = z["data"]
        vol = np.expand_dims(np.asarray(vol, dtype=np.float32), 0)  # (1, D, H, W)
        if self.train:
            return self.transform(vol, rng or np.random.RandomState())
        return self.transform(vol)


def read_csv(path: str) -> Frame:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def split_dataframe(df: Frame, subset: str) -> Frame:
    return [row for row in df if row["subset"] == subset]


def dataset_from_dataframe(df: Frame, transform, train: bool,
                           image_folder: Optional[str] = None) -> VolumeDataset:
    paths = [os.path.join(image_folder, row["mri_path"]) if image_folder else row["mri_path"]
             for row in df]
    labels = None
    if df and "kl_grade" in df[0]:
        labels = np.asarray([int(row["kl_grade"]) for row in df])
    return VolumeDataset(paths=paths, labels=labels, transform=transform, train=train)


def scan_folder(image_folder: str) -> Frame:
    """Folder scan -> frame of ``mri_path`` rows (ref: inference.py:141-158),
    in ``os.listdir`` order as the JAX package takes it."""
    return [{"mri_path": os.path.join(image_folder, f)}
            for f in os.listdir(image_folder) if f.endswith(".npz")]


def check_shard(shard: Tuple[int, int], batch_size: int, pad_to_batch: bool) -> None:
    """A sharded loader needs whole batches split evenly over the shards."""
    i, n = shard
    if not 0 <= i < n:
        raise ValueError(f"shard {shard}: index outside [0, {n})")
    if n > 1 and (not pad_to_batch or batch_size % n):
        raise ValueError(f"a loader sharded {n} ways needs pad_to_batch=True and a batch "
                         f"size divisible by {n}; got batch_size {batch_size}, "
                         f"pad_to_batch {pad_to_batch}")


def assemble_batch(ds: VolumeDataset, bidx, batch_size: int, pad_to_batch: bool,
                   epoch_seed: int, map_fn=map, shard: Tuple[int, int] = (0, 1)
                   ) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
    """One batch of the stream: the volumes of dataset indices ``bidx``
    (loaded through ``map_fn``), sample ``i`` drawing from
    ``RandomState((epoch_seed * 1_000_003 + i) % 2**31)``; with
    ``pad_to_batch`` zero volumes labelled -100 (the losses' ignore_index)
    fill the batch. ``shard=(i, n)`` keeps rows [i * B / n, (i + 1) * B / n)
    of the (padded) batch. Returns (inputs, labels | None, n_valid), n_valid
    the whole batch's real rows."""
    pi, pc = shard
    if pc > 1:
        per = batch_size // pc
        rows = range(pi * per, (pi + 1) * per)
    else:
        rows = range(batch_size if pad_to_batch else len(bidx))
    idxs = [int(bidx[r]) for r in rows if r < len(bidx)]
    rngs = [np.random.RandomState((epoch_seed * 1_000_003 + i) % (2 ** 31)) for i in idxs]
    vols = list(map_fn(ds.load, idxs, rngs))
    n_valid = min(len(bidx), batch_size)
    n_pad = len(rows) - len(vols)
    if n_pad:
        # A shard of pad rows only takes its shape from the batch's first sample.
        template = vols[0] if vols else ds.load(int(bidx[0]), np.random.RandomState(0))
        vols = vols + [np.zeros_like(template)] * n_pad
    inputs = np.stack(vols)
    labels = None
    if ds.labels is not None:
        labels = np.asarray(ds.labels[idxs], dtype=np.int32)
        if n_pad:
            labels = np.concatenate([labels, np.full(n_pad, -100, np.int32)])
    return inputs, labels, n_valid


class Loader:
    """Batched loader with worker threads + background prefetch of the next
    batches. Yields (inputs [B,1,D,H,W] float32, labels [B] int32 | None,
    n_valid).

    The final partial batch is yielded as-is (like torch DataLoader
    drop_last=False), or with ``pad_to_batch=True`` zero-padded to the batch
    size with labels -100 (the losses' ignore_index) on the pad rows;
    ``n_valid`` counts the real rows. ``shard=(i, n)``: this data shard's
    rows of every batch (:func:`assemble_batch`).
    """

    def __init__(self, ds: VolumeDataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 8, seed: int = 0, prefetch: int = 2,
                 pad_to_batch: bool = False, shard: Tuple[int, int] = (0, 1)):
        check_shard(shard, batch_size, pad_to_batch)
        self.shard = tuple(shard)
        self.ds = ds
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.pad_to_batch = pad_to_batch
        self._epoch = 0
        self._skip_next = 0

    def __len__(self) -> int:
        return (len(self.ds) + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle / augmentation RNG epoch (torch's
        ``DistributedSampler.set_epoch`` analog), so a run resumed at epoch
        E replays the stream the uninterrupted run would have seen."""
        self._epoch = int(epoch)

    def skip_batches(self, k: int) -> None:
        """Drop the first ``k`` batches of the NEXT epoch only (mid-epoch
        preemption resume). The per-sample augmentation RNG is keyed by
        (epoch seed, dataset index), so the remaining batches are the ones
        the full epoch would have yielded."""
        self._skip_next = int(k)

    def _batches(self) -> List[np.ndarray]:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        out = [idx[i:i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self._skip_next:
            out = out[self._skip_next:]
            self._skip_next = 0
        return out

    def __iter__(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray], int]]:
        batches = self._batches()
        self._epoch += 1
        # The JAX package's producer reads the epoch after this increment:
        # the augmentation seed of epoch E is seed + E + 1 (its shuffle's is
        # seed + E).
        epoch_seed = self.seed + self._epoch
        pool = cf.ThreadPoolExecutor(max_workers=self.num_workers)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def assemble(bidx):
            return assemble_batch(self.ds, bidx, self.batch_size, self.pad_to_batch,
                                  epoch_seed, pool.map, self.shard)

        def put(item) -> bool:
            # Never block forever on a full queue: a consumer that abandons
            # the iterator sets `stop` and drains nothing more.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # An exception here (a corrupt or missing .npz) reaches the
            # consumer, so an epoch never ends early without a word.
            try:
                for b in batches:
                    if stop.is_set() or not put(assemble(b)):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised in __iter__
                put(e)
            else:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False)


def pick_loader(config: dict):
    """Loader engine from ``data.loader``: "native" (the default, the
    threaded loader above) or "grain" (the same stream on PyTorch's runtime,
    ``data/grain_pipeline.py``), whose ``data.grain_processes`` > 0 selects
    process workers. Returns a callable with Loader's signature."""
    kind = config.get("data", {}).get("loader", "native")
    if kind == "native":
        return Loader
    if kind == "grain":
        from gaviko_tpu_torch.data.grain_pipeline import GrainLoader

        procs = int(config.get("data", {}).get("grain_processes", 0))
        return functools.partial(GrainLoader, processes=procs)
    raise ValueError(f"Unknown data.loader: {kind!r} (native | grain)")
