"""Host -> device prefetch pipeline. Port of
``fcn8s_tensorflow_tpu/data/prefetch.py``.

A background thread runs the host pipeline (decode, label ids, batch
padding: whatever the wrapped iterator does) and wraps each batch in host
tensors, pinned when the target is a CUDA device (the span
``fcn8s.prefetch.h2d`` on that thread, under a profiler that traces every
thread). The consumer copies them to the device with ``non_blocking=True``
on its current stream, so the copy of batch N+1 queues behind the compute
of batch N instead of blocking the host, and the copy is ordered with the
step that reads it.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..utils.profiling import annotate


def host_tensors(batch: tuple, pin: bool) -> tuple:
    """A tuple of numpy arrays as CPU tensors (pinned if ``pin``)."""
    out = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch)
    return tuple(t.pin_memory() for t in out) if pin else out


def to_device(batch: tuple, device: torch.device) -> tuple:
    """Copy host tensors to ``device``; asynchronous for pinned ones."""
    return tuple(t.to(device, non_blocking=True) for t in batch)


class DevicePrefetcher:
    """Wrap an iterator of tuples of numpy arrays; yields tuples of tensors
    on ``device``, with up to ``depth`` batches prepared ahead by a worker
    thread. ``close()`` stops and joins the worker."""

    _SENTINEL = object()

    def __init__(self, iterator, device, depth: int = 2):
        self._iterator = iterator
        self._device = torch.device(device)
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        pin = self._device.type == "cuda"
        try:
            for batch in self._iterator:
                if self._stop.is_set():
                    return
                with annotate("fcn8s.prefetch.h2d"):  # the H2D's pinned staging
                    item = host_tensors(batch, pin)
                self._queue.put(item)
        except Exception as exc:  # surfaced in the consumer thread
            self._err = exc
        finally:
            self._queue.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return to_device(item, self._device)

    def close(self):
        """Stop the worker and join it, so a successor can take over the
        underlying iterator. Safe to call more than once. The wait is
        bounded: a source blocked on I/O cannot be interrupted, and the
        thread is a daemon."""
        self._stop.set()
        deadline = 50
        while self._thread.is_alive() and deadline > 0:
            try:  # drain, so a worker blocked on a full queue wakes up
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)
            deadline -= 1
