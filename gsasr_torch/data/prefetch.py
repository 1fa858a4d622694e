"""Background-thread batch prefetching (counterpart of
`gsasr_tpu/data/prefetch.py`), in the idiom of the reference's
`CUDAPrefetcher` (`basicsr/data/prefetch_dataloader.py:61-123`).

A worker thread takes each host batch (a dict of numpy arrays) from the
wrapped iterator, puts its arrays in pinned host memory and copies them to
the card with `non_blocking=True` on a side CUDA stream, then records an
event there. The consumer's stream waits on that event before it uses the
batch, and each tensor is marked with `record_stream`, so the caching
allocator does not reuse its memory while the consumer's stream may still
read it. The copies of upcoming batches thus overlap the running step. With
a CPU device the worker only converts the arrays to tensors.

Pipeline errors propagate: an exception raised inside the worker is queued
and re-raised in the consumer, so a decode or copy failure fails the train
loop loudly instead of reading as a quiet end of epoch.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


class DevicePrefetcher:
    """Wraps a host-batch iterator; yields the batches as tensors on
    `device` (default: the CUDA card)."""

    def __init__(self, batch_iter: Iterator, device=None, depth: int = 2):
        from gsasr_torch import resolve_device

        self._iter = batch_iter
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _copy(self, batch):
        """(tensors, event): the batch's arrays as tensors, on the card
        through pinned memory on the side stream, or on the CPU."""
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if self._stream is None:
            return host, None
        with torch.cuda.stream(self._stream):
            out = {k: t.pin_memory().to(self.device, non_blocking=True)
                   for k, t in host.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _worker(self):
        try:
            for batch in self._iter:
                if self._stop.is_set():
                    break
                self._put(self._copy(batch))
        except BaseException as e:  # re-raised in __iter__
            self._put(e)
        finally:
            self._put(self._done)

    def _put(self, item):
        # Bounded put that gives up when close() drains concurrently, so the
        # worker never blocks forever on a full queue after an early exit.
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def close(self):
        """Stop the worker and release the wrapped generator (call when
        leaving the epoch loop early, e.g. at total_iter)."""
        self._stop.set()
        while True:  # drain so the worker's pending put unblocks
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5)
        close = getattr(self._iter, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._done:
                return
            if isinstance(item, BaseException):
                raise item
            batch, event = item
            if event is not None:
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(event)
                for t in batch.values():
                    t.record_stream(consumer)
            yield batch
