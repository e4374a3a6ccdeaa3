"""Async serving front-end: arrival-window request coalescing.
A copy of ``repro.serving.frontend``.  The frontend's thread runs all of
the router's work, the CUDA work included: torch's grad mode, current stream
and current device are thread-local, so the port's model steps carry
their own ``torch.no_grad``.

Accepts concurrently arriving requests (any thread), coalesces them into
``route_batch()`` pipeline batches by arrival window, and completes each
request's future independently as its batch finishes — the serving-side
half of the continuous-batching stack: the front-end forms pipeline
batches from wall-clock arrival patterns, and the fleet scheduler
underneath admits their prompts into in-flight decode slots.

    fe = AsyncFrontend(router, window_ms=15, max_batch=32)
    fut = fe.submit(request)          # returns immediately
    resp, outcome = fut.result()      # blocks this caller only
    fe.close()

Batching policy: the driver thread blocks until one request arrives, then
keeps collecting until the arrival window closes or ``max_batch`` is hit,
and dispatches the batch through the staged pipeline.  A window never
delays a lone request by more than ``window_ms``; under load the window
fills long before it closes, so throughput batching and tail latency are
both bounded.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.core.observability import METRICS
from repro_torch.core.types import Request, RouterOverloadError


@dataclass
class FrontendStats:
    requests: int = 0
    batches: int = 0
    # recent sizes only — a long-lived server must not grow this forever
    batch_sizes: "deque[int]" = field(
        default_factory=lambda: deque(maxlen=64))

    @property
    def mean_batch(self) -> float:
        return self.requests / max(1, self.batches)


class AsyncFrontend:
    def __init__(self, router, *, window_ms: float = 15.0,
                 max_batch: int = 32, max_depth: int = 256):
        self.router = router
        self.window_s = window_ms / 1e3
        self.max_batch = max_batch
        # pending-queue bound: an unbounded arrival queue just converts
        # overload into unbounded memory growth and unbounded latency —
        # beyond this depth submits fail fast with a typed overload error
        self.max_depth = max_depth
        self.stats = FrontendStats()
        self._q: "queue.Queue[Optional[Tuple[Request, Future]]]" = \
            queue.Queue()
        self._closed = False
        self._state_lock = threading.Lock()   # orders submit() vs close()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="vsr-frontend")
        self._thread.start()

    def submit(self, req: Request) -> Future:
        """Enqueue a request; the returned future resolves to the
        ``(Response, RoutingOutcome)`` pair when its batch completes."""
        # the closed-check and the enqueue are one atomic step: a submit
        # racing close() either lands BEFORE the shutdown sentinel (and
        # is drained) or raises — its future can never be left dangling
        with self._state_lock:
            if self._closed:
                raise RuntimeError("frontend is closed")
            depth = self._q.qsize()
            if depth >= self.max_depth:
                # retry-after hint: how long the backlog takes to drain at
                # one max_batch per arrival window (floor 50ms)
                retry = max(0.05,
                            depth / max(1, self.max_batch) * self.window_s)
                METRICS.inc("admission_rejected_total", reason="queue_full")
                raise RouterOverloadError(
                    f"frontend queue full ({depth} pending)",
                    retry_after_s=retry)
            fut: Future = Future()
            self._q.put((req, fut))
            return fut

    @property
    def queue_depth(self) -> int:
        """Pending (not yet batched) requests — an overload probe input."""
        return self._q.qsize()

    def reload_policy(self, name: str, dsl_text: str):
        """Zero-downtime policy swap through the serving layer: the new
        program compiles on the CALLER's thread and swaps atomically in
        the router's PolicyRegistry while the driver thread keeps
        dispatching.  Batches already in flight finish on the program
        they resolved at batch start; every queued future completes.  A
        compile error raises here and leaves the old policy serving."""
        return self.router.policies.reload(name, dsl_text)

    def close(self, *, timeout: Optional[float] = 30.0):
        """Drain queued work and stop the driver thread."""
        with self._state_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._thread.join(timeout=timeout)

    # -- driver -------------------------------------------------------------

    def _collect(self) -> Optional[List[Tuple[Request, Future]]]:
        """Block for the first arrival, then coalesce until the window
        closes or the batch fills.  Returns None on shutdown."""
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.perf_counter() + self.window_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:            # propagate shutdown after this batch
                self._q.put(None)
                break
            batch.append(item)
        return batch

    def _loop(self):
        while True:
            batch = self._collect()
            if batch is None:
                return
            self.stats.requests += len(batch)
            self.stats.batches += 1
            self.stats.batch_sizes.append(len(batch))
            METRICS.observe("frontend_batch_size", len(batch))
            try:
                pairs = self.router.route_batch([r for r, _ in batch])
            except Exception as e:      # route_batch shouldn't raise; belt
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            # a router that returns a short (or long) list must not leave
            # the unmatched futures hanging forever — deliver what can be
            # matched positionally, fail the rest loudly
            if len(pairs) != len(batch):
                METRICS.inc("frontend_batch_mismatch_total")
                err = RuntimeError(
                    f"route_batch returned {len(pairs)} responses for "
                    f"{len(batch)} requests")
                for (_, fut), pair in zip(batch, pairs):
                    fut.set_result(pair)
                for _, fut in batch[len(pairs):]:
                    if not fut.done():
                        fut.set_exception(err)
                continue
            for (_, fut), pair in zip(batch, pairs):
                fut.set_result(pair)
