"""Host-side batch prefetching and device staging (port of
``instant_nvr_tpu/datasets/prefetch.py``).

:class:`Prefetcher` runs ``producer(i)`` for each index on ``workers``
threads (numpy, scipy, zlib and the native library release the
interpreter lock on the heavy work) and applies the ``device_put`` hook in
index order on one stager thread, at most ``depth`` items ahead of the
consumer.  Staging stays on one thread: the train loop's device cache of
frame and static tensors relies on one writer, and the batch order must
follow ``indices``.

:class:`DeviceStager` is that hook for a CUDA device: it copies an item's
tensors from pinned host memory with ``non_blocking=True`` on a side
stream, so the copies of the next batches overlap the current step.  A
copy issued on another stream from another thread is not ordered before
the step that reads it, so the stager records an event on its stream after
the copies, and :meth:`DeviceStager.ready` makes the consumer's stream wait
on that event and marks every tensor as used on the consumer's stream
(``record_stream``): the caching allocator then does not hand a cached
frame tensor's memory to the side stream while a step still reads it.

Counters (always on, one ``perf_counter_ns`` pair an item, counted by the
consumer as it takes the items): ``Prefetcher.built`` items and
``build_s`` their worker seconds in the producer, ``wait_s`` consumer
seconds blocked on the queue; ``DeviceStager.bytes``
copied to the device.  The spans (``utils/telemetry.py``, while a profiler
records on the consumer's thread): ``prefetch.wait`` and ``stage.ready``
on the consumer, and the workers' ``item.build`` and the stager's
``item.stage``, each timed on its own thread, carried through the queue
with the item and recorded by the consumer when it takes the item; the
unit of each is the item's feed position.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator, NamedTuple, Optional

import numpy as np
import torch

from ..utils import telemetry


class Prefetcher:
    """Runs ``producer(i)`` for i in ``indices`` across ``workers`` threads,
    applies ``device_put`` in order on one stager thread, depth-bounded."""

    def __init__(self, producer: Callable[[int], dict], indices,
                 depth: int = 8, device_put: Optional[Callable] = None,
                 workers: int = 1):
        self.producer = producer
        self.indices = list(indices)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.device_put = device_put
        self.depth = depth
        self._err = None
        self._stop = False
        self._threads = []
        self.built = 0
        self.build_s = 0.0
        self.wait_s = 0.0
        self._workers = max(1, int(workers))
        if self._workers == 1:
            self.thread = threading.Thread(target=self._run_serial, daemon=True)
            self.thread.start()
        else:
            self._cv = threading.Condition()
            self._claim = 0         # next index position a worker may take
            self._next = 0          # next position the stager will emit
            self._ready: dict = {}  # pos -> produced item
            for _ in range(self._workers):
                th = threading.Thread(target=self._produce_loop, daemon=True)
                th.start()
                self._threads.append(th)
            self.thread = threading.Thread(target=self._stage_loop, daemon=True)
            self.thread.start()
        self._threads.append(self.thread)

    # ---- one worker: produce and stage in turn
    def _run_serial(self):
        try:
            for i in self.indices:
                if self._stop:
                    return
                self.q.put(self._stage(*self._build(i)))
        except BaseException as e:  # surface worker errors to the consumer
            self._err = e
        finally:
            self.q.put(None)

    # ---- several workers: parallel produce, ordered single-thread stage
    def _produce_loop(self):
        n = len(self.indices)
        while True:
            with self._cv:
                # never run more than depth positions ahead of the stager
                while (self._claim - self._next >= self.depth
                       and self._err is None and not self._stop):
                    self._cv.wait()
                if self._err is not None or self._stop or self._claim >= n:
                    return
                pos = self._claim
                self._claim += 1
            try:
                built = self._build(self.indices[pos])
            except BaseException as e:
                with self._cv:
                    if self._err is None:
                        self._err = e
                    self._cv.notify_all()
                return
            with self._cv:
                self._ready[pos] = built
                self._cv.notify_all()

    def _stage_loop(self):
        n = len(self.indices)
        try:
            while self._next < n and not self._stop:
                with self._cv:
                    while (self._next not in self._ready
                           and self._err is None and not self._stop):
                        self._cv.wait()
                    if self._err is not None or self._stop:
                        break
                    built = self._ready.pop(self._next)
                self.q.put(self._stage(*built))
                with self._cv:
                    self._next += 1
                    self._cv.notify_all()
        except BaseException as e:
            with self._cv:
                if self._err is None:
                    self._err = e
                self._cv.notify_all()
        finally:
            self.q.put(None)

    def _build(self, i):
        """(item, its build's (start ns, end ns, thread))."""
        t0 = time.perf_counter_ns()
        item = self.producer(i)
        return item, (t0, time.perf_counter_ns(), threading.current_thread().name)

    def _stage(self, item, build):
        """What the queue carries: (item after ``device_put``, the build's
        timing, the staging's or None)."""
        if self.device_put is None:
            return item, build, None
        t0 = time.perf_counter_ns()
        item = self.device_put(item)
        return item, build, (t0, time.perf_counter_ns(), threading.current_thread().name)

    def __iter__(self) -> Iterator[dict]:
        pos = 0
        while True:
            t0 = time.perf_counter_ns()
            with telemetry.span("prefetch.wait", pos):
                got = self.q.get()
            self.wait_s += (time.perf_counter_ns() - t0) / 1e9
            if got is None:
                if self._err is not None:
                    raise self._err
                return
            item, build, stage = got
            self.built += 1
            self.build_s += (build[1] - build[0]) / 1e9
            telemetry.record("item.build", build[0], build[1], pos, build[2])
            if stage is not None:
                telemetry.record("item.stage", stage[0], stage[1], pos, stage[2])
            pos += 1
            yield item

    def close(self, timeout: float = 10.0) -> None:
        """Stop every thread and drop the queued batches (idempotent).  Call
        it from the consumer's ``finally``: a consumer that stops early
        otherwise leaves threads blocked on ``q.put`` holding up to
        ``depth`` batches."""
        self._stop = True
        if hasattr(self, "_cv"):
            with self._cv:
                self._cv.notify_all()
        # a thread blocked on a full queue needs its put() to complete
        # before it can see _stop
        deadline = time.monotonic() + timeout
        while (any(th.is_alive() for th in self._threads)
               and time.monotonic() < deadline):
            try:
                self.q.get(timeout=0.05)
            except queue.Empty:
                pass
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        if hasattr(self, "_ready"):
            self._ready.clear()


class Staged(NamedTuple):
    """One staged item: the host item, its device tensors and the event
    that follows their copies (None off CUDA)."""
    item: dict
    batch: Dict[str, torch.Tensor]
    copied: Optional[torch.cuda.Event]


class DeviceStager:
    """The ``device_put`` hook: ``stager(item) -> Staged`` with
    ``build(item, put)`` making the device batch, where ``put(array)`` is
    the copy to ``device``; :meth:`ready` (on the consumer's thread) gives
    back (item, batch) once the consumer's stream is ordered after the
    copies."""

    def __init__(self, device: torch.device,
                 build: Callable[[dict, Callable], Dict[str, torch.Tensor]]):
        self.device = device
        self.build = build
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.bytes = 0

    def put(self, v) -> torch.Tensor:
        t = torch.from_numpy(np.asarray(v, order="C"))
        self.bytes += t.numel() * t.element_size()
        if self.stream is None:
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def __call__(self, item: dict) -> Staged:
        if self.stream is None:
            return Staged(item, self.build(item, self.put), None)
        with torch.cuda.stream(self.stream):
            batch = self.build(item, self.put)
            copied = torch.cuda.Event()
            copied.record(self.stream)
        return Staged(item, batch, copied)

    def ready(self, staged: Staged):
        """(item, batch) with the current stream waiting on the copies."""
        if staged.copied is not None:
            with telemetry.span("stage.ready"):
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(staged.copied)
                for t in staged.batch.values():
                    t.record_stream(stream)
        return staged.item, staged.batch
