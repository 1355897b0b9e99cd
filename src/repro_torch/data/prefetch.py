"""Host->device prefetch: the paper's out-of-core preload on CUDA streams.

cuMF (§4.4 'Out-of-core computation') plans partitions ahead of time, then
uses CPU threads + CUDA streams to preload the next q-batch while the
current one computes, hiding load time "except for the first load".  The
:class:`Prefetcher` does the same: a worker thread runs ``depth`` items
ahead of the consumer; for each item it applies ``put`` (the caller's host
transform) and uploads every numpy array in the result to the device.

On the card the upload overlaps compute:

- each array is copied into a **pinned** staging buffer, then to the card
  with ``non_blocking=True`` on a **side stream** the prefetcher owns, and
  an event is recorded after the item's last copy;
- ``__next__`` makes the consumer's current stream wait on that event
  (no host block), and marks every uploaded tensor with
  ``record_stream(consumer)`` so the caching allocator does not hand its
  memory to a later upload while the consumer's kernels still read it;
- staging buffers form a ring of ``depth + 2`` slots (queued, held by the
  worker, consumed: the ``buffers = depth + 2`` the planner prices); a slot
  is refilled only after the event of its previous copy has completed.

On ``device="cpu"`` (which the caller names explicitly, as the tests do)
arrays become CPU tensors (copies) and no stream is involved.

Lifecycle: a consumer that abandons iteration early (break, exception, a
wave driver resuming past the end of a half) must call ``close()`` — or use
the prefetcher as a context manager — otherwise the worker thread would sit
blocked forever on a full queue.  ``close()`` wakes a blocked worker, drains
the queue, and joins the thread; it is idempotent and safe after normal
exhaustion.  An exception in the worker is re-raised in the consumer.

Observability (``tracer=`` / ``registry=``): the worker records one
``prefetch_load`` span per item around ``put`` and the upload's enqueue
(host copies into pinned memory included; the device copy itself runs
asynchronously on the side stream), and the consumer records one
``prefetch`` span per ``__next__`` around the queue wait — the time the
consumer stalled on streaming.  The registry counts ``prefetch/items`` and
samples ``prefetch/queue_depth`` at each hand-off.
"""
from __future__ import annotations

import itertools
import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.backend import DeviceLike, resolve_device
from repro_torch.obs.trace import phase

_POLL_S = 0.05


class _Loaded:
    """One uploaded item: the tree, the tensors it holds on the card and
    the event after their copies (None on the CPU)."""

    __slots__ = ("tree", "tensors", "event")

    def __init__(self, tree, tensors, event):
        self.tree = tree
        self.tensors = tensors
        self.event = event


class Prefetcher:
    def __init__(self, it: Iterator, *, depth: int = 2,
                 put: Optional[Callable] = None,
                 device: DeviceLike = None,
                 tracer=None, registry=None):
        if depth < 1:
            raise ValueError(f"depth={depth} must be >= 1")
        self._dev = resolve_device(device)       # raises without a card
        self._cuda = self._dev.type == "cuda"
        if self._cuda and self._dev.index is None:
            # the worker's set_device needs an index
            self._dev = torch.device("cuda", torch.cuda.current_device())
        self._it = it
        self._put = put
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop = threading.Event()
        self._tracer = tracer
        self._registry = registry
        if self._cuda:
            self._stream = torch.cuda.Stream(device=self._dev)
            self._consumer = torch.cuda.current_stream(self._dev)
            # staging ring: per slot, pinned byte buffers by leaf position,
            # and the event of the slot's last copies
            self._pinned: list[list[torch.Tensor]] = [[] for _ in range(depth + 2)]
            self._slot_events: list[Optional[torch.cuda.Event]] = [None] * (depth + 2)
            self._n_loaded = 0
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="prefetch-worker")
        self._thread.start()

    # -- upload ---------------------------------------------------------
    def _stage(self, slot: int, pos: int, arr: np.ndarray) -> torch.Tensor:
        """``arr`` copied into pinned buffer ``pos`` of ``slot`` (grown on
        demand), viewed with its dtype and shape."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        nbytes = src.numel() * src.element_size()
        bufs = self._pinned[slot]
        if pos == len(bufs):
            bufs.append(torch.empty(0, dtype=torch.uint8, pin_memory=True))
        if bufs[pos].numel() < nbytes:
            bufs[pos] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        staged = bufs[pos][:nbytes].view(src.dtype).view(src.shape)
        staged.copy_(src)
        return staged

    def _upload(self, tree) -> _Loaded:
        tensors: list[torch.Tensor] = []
        if not self._cuda:
            def to_dev(a):
                t = torch.from_numpy(np.array(a))
                tensors.append(t)
                return t
            return _Loaded(_map_arrays(tree, to_dev), tensors, None)
        slot = self._n_loaded % len(self._pinned)
        self._n_loaded += 1
        ev = self._slot_events[slot]
        if ev is not None:
            ev.synchronize()               # the slot's previous copies are done
        pos = itertools.count()

        def to_dev(a):
            staged = self._stage(slot, next(pos), a)
            t = torch.empty(staged.shape, dtype=staged.dtype, device=self._dev)
            t.copy_(staged, non_blocking=True)
            tensors.append(t)
            return t

        with torch.cuda.stream(self._stream):
            out = _map_arrays(tree, to_dev)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        self._slot_events[slot] = ev
        return _Loaded(out, tensors, ev)

    # -- worker ---------------------------------------------------------
    def _offer(self, item) -> bool:
        """put() that a concurrent close() can interrupt; False if stopped."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            if self._cuda:
                torch.cuda.set_device(self._dev)
            for item in self._it:
                if self._stop.is_set():
                    return
                with phase("prefetch.load", cat="prefetch_load",
                           tracer=self._tracer, registry=self._registry):
                    host = self._put(item) if self._put is not None else item
                    loaded = self._upload(host)
                if not self._offer(loaded):
                    return
        except BaseException as e:                # re-raised by __next__
            self._offer(e)
            return
        self._offer(self._done)

    def close(self):
        """Stop the worker, drain queued items, join the thread (idempotent)."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get_nowait()     # unblock a worker stuck in _offer
            except queue.Empty:
                pass
            self._thread.join(timeout=_POLL_S)

    @property
    def closed(self) -> bool:
        return self._stop.is_set() and not self._thread.is_alive()

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        with phase("prefetch.wait", cat="prefetch",
                   tracer=self._tracer, registry=self._registry):
            item = self._q.get()
        if self._registry is not None:
            self._registry.gauge("prefetch/queue_depth").set(
                self._q.qsize())
            if not (item is self._done or isinstance(item, BaseException)):
                self._registry.counter("prefetch/items").inc()
        if item is self._done:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        if item.event is not None:
            self._consumer.wait_event(item.event)
            for t in item.tensors:
                t.record_stream(self._consumer)
        return item.tree


def _map_arrays(tree, fn):
    """``tree`` with every numpy array replaced by ``fn(array)``; tuples,
    lists and dicts are walked, any other leaf is kept."""
    if isinstance(tree, np.ndarray):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_arrays(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_map_arrays(v, fn) for v in tree)
    return tree
