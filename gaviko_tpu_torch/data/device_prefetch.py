"""Host -> device transfer pipelining: stage the NEXT batch on the device
while the current step computes.

Port of ``gaviko_tpu/data/device_prefetch.py`` (``train.h2d_prefetch``,
default on). A background thread takes each host batch from the loader,
copies it into pinned memory and uploads it with ``non_blocking=True`` on a
side CUDA stream, then records an event there. The consumer makes the
compute stream wait on that event (a device-side wait, no host sync) and
``record_stream``-s the tensors on the compute stream, so the caching
allocator does not hand their memory out again while the step still reads
them. While step N computes, batch N+1 is decoding (the loader's threads)
and uploading (this thread). On the CPU the thread just wraps the arrays.

Reference analog: torch DataLoader workers + pin_memory overlap host decode
with the step, and async H2D copies overlap transfer (ref: src/train.py:75-77,
296-299).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional, Tuple

import numpy as np
import torch


def stage_batch(inputs: np.ndarray, labels: Optional[np.ndarray], device: torch.device,
                stream: Optional["torch.cuda.Stream"] = None) -> Tuple:
    """(inputs f32, labels int64 | None, event | None) on ``device``: pinned
    non-blocking copies on ``stream`` (CUDA), the event recorded after them."""
    x = torch.from_numpy(np.ascontiguousarray(inputs, dtype=np.float32))
    y = None if labels is None else torch.from_numpy(np.asarray(labels, dtype=np.int64))
    if device.type != "cuda":
        return x.to(device), None if y is None else y.to(device), None
    with torch.cuda.stream(stream):
        x = x.pin_memory().to(device, non_blocking=True)
        if y is not None:
            y = y.pin_memory().to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return x, y, event


def wait_staged(x: torch.Tensor, y: Optional[torch.Tensor], event) -> None:
    """Order the current stream after a batch's upload, and tell the
    allocator that the current stream uses its tensors."""
    if event is None:
        return
    current = torch.cuda.current_stream(x.device)
    current.wait_event(event)
    x.record_stream(current)
    if y is not None:
        y.record_stream(current)


class DevicePrefetcher:
    """Wrap a Loader; yield (inputs, labels, n_valid) already on ``device``.

    Every other attribute (len, set_epoch, skip_batches, ...) delegates to
    the wrapped loader. ``depth`` bounds the staged batches resident on the
    device beyond the one in use."""

    def __init__(self, loader, device, depth: int = 1):
        self._loader = loader
        self._device = torch.device(device)
        self._depth = max(1, int(depth))

    def __getattr__(self, name):
        return getattr(self._loader, name)

    def __len__(self):
        return len(self._loader)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self._depth)
        stop = threading.Event()
        sentinel = object()
        stream = torch.cuda.Stream(self._device) if self._device.type == "cuda" else None

        def put(item) -> bool:
            # A consumer that abandons the iterator (preemption, an error)
            # sets `stop` and drains nothing more; never block forever.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            src = iter(self._loader)
            try:
                for inputs, labels, n_valid in src:
                    if stop.is_set() or not put(
                            (*stage_batch(inputs, labels, self._device, stream), n_valid)):
                        break
            except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
                put(e)
            finally:
                put(sentinel)
                close = getattr(src, "close", None)
                if close is not None:
                    close()

        t = threading.Thread(target=worker, daemon=True, name="gaviko-h2d-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                x, y, event, n_valid = item
                wait_staged(x, y, event)
                yield x, y, n_valid
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=10.0)
