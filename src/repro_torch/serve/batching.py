"""Latency-bounded request micro-batching (DESIGN.md §10), the
counterpart of `repro.serve.batching`: host threading, ported as it is.

Per-request scoring pays one full dispatch (host pad, transfer, program
launch, readback) per candidate set — at high arrival rates the device
sits idle between launches while requests queue behind Python dispatch
overhead. `MicroBatcher` coalesces concurrent requests into ONE batched
program call: a single worker thread waits on a condition variable,
flushes when `max_batch` requests have accumulated OR `max_delay_ms` has
elapsed since the oldest queued request (whichever comes first — the
delay bound caps the latency cost of coalescing at low rates), and runs
`Scorer.score_batch` once for the whole flush. The queue is bounded
(`max_queue`): `submit()` blocks when it is full, the same structural
backpressure discipline as the streaming layer's read-ahead
(`data.rowblocks._ReadAhead` bounds in-flight blocks the same way) — an
overloaded service slows its callers down instead of buffering without
limit.

Every flush scores with ONE `(version, w)` snapshot taken at launch
time, so each `Response` carries the exact weight version that produced
it — a hot-swap lands between flushes, never inside one.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import NamedTuple

import numpy as np

from .scorer import Scorer


class Response(NamedTuple):
    """One scored request: host float32 scores (n,), the top-k slices
    (empty arrays for scores-only submissions), and the single weight
    version that produced every number in this response."""

    scores: np.ndarray
    values: np.ndarray
    indices: np.ndarray
    version: int


class _Pending:
    __slots__ = ('X', 'n', 'k', 'event', 'response', 'error')

    def __init__(self, X, n, k):
        self.X, self.n, self.k = X, n, k
        self.event = threading.Event()
        self.response = None
        self.error = None


class ServeFuture:
    """Handle for a submitted request; `result(timeout)` blocks until the
    worker has flushed the batch containing it."""

    def __init__(self, pending: _Pending):
        self._p = pending

    def result(self, timeout: 'float | None' = None) -> Response:
        if not self._p.event.wait(timeout):
            raise TimeoutError('request not served within '
                               f'{timeout}s')
        if self._p.error is not None:
            raise self._p.error
        return self._p.response

    def done(self) -> bool:
        return self._p.event.is_set()


class MicroBatcher:
    """Coalesces concurrent scoring requests into single device launches.

    Args:
      scorer: the `Scorer` whose `score_batch` runs each flush.
      max_batch: flush as soon as this many requests are queued
        (default 32; also the per-launch batch cap).
      max_delay_ms: flush at latest this long after the OLDEST queued
        request arrived (default 2.0) — the coalescing window, and the
        worst-case queueing latency added at low arrival rates.
      max_queue: bound on queued-but-unflushed requests (default 256);
        `submit` blocks while the queue is full (backpressure).
      adaptive_delay: when True, the flush window tightens at low
        arrival rates: an EWMA of inter-arrival gaps (updated per
        submit, samples clamped to 4x the window so idle spells recover
        fast) shrinks the effective window to
        max(0, max_delay - gap_ewma). Sparse traffic — gaps at or past
        the window, where waiting cannot coalesce anything — flushes
        immediately and recovers the per-request p50 the fixed window
        taxes; dense traffic (gaps << window) keeps the full coalescing
        window and its throughput amortization (EXPERIMENTS §Serving,
        the low-rate rows). Default False: the fixed-window behavior.

    `submit(X, k=None)` returns a `ServeFuture`; `scores`/`top_k` are
    blocking conveniences over it. `close()` flushes everything already
    queued, then stops the worker; later submits raise. Usable as a
    context manager.
    """

    def __init__(self, scorer: Scorer, *, max_batch: int = 32,
                 max_delay_ms: float = 2.0, max_queue: int = 256,
                 adaptive_delay: bool = False):
        if not (isinstance(max_batch, int) and max_batch >= 1):
            raise ValueError(f'max_batch must be a positive int; got '
                             f'{max_batch!r}')
        if not (isinstance(max_delay_ms, (int, float))
                and max_delay_ms >= 0):
            raise ValueError('max_delay_ms must be a non-negative '
                             f'number; got {max_delay_ms!r}')
        if not (isinstance(max_queue, int) and max_queue >= max_batch):
            raise ValueError('max_queue must be an int >= max_batch; '
                             f'got {max_queue!r}')
        self._scorer = scorer
        self._max_batch = max_batch
        self._max_delay = float(max_delay_ms) / 1e3
        self._max_queue = max_queue
        self._adaptive = bool(adaptive_delay)
        self._gap_ewma: 'float | None' = None   # seconds between arrivals
        self._last_arrival: 'float | None' = None
        self._cond = threading.Condition()
        self._queue: 'deque[tuple[_Pending, float]]' = deque()
        self._closed = False
        self.n_requests = 0
        self.n_batches = 0
        self._worker = threading.Thread(target=self._run,
                                        name='repro-torch-serve-microbatch',
                                        daemon=True)
        self._worker.start()

    # -- producer side -----------------------------------------------------

    def submit(self, X, k: 'int | None' = None) -> ServeFuture:
        """Enqueue one candidate set; validation runs HERE so malformed
        input raises in the calling thread with a clear error, never
        inside the worker. Blocks while the queue is at `max_queue`."""
        X, n, k = self._scorer._validate_request(X, k)
        req = _Pending(X, n, k)
        with self._cond:
            while len(self._queue) >= self._max_queue and not self._closed:
                self._cond.wait()
            if self._closed:
                raise RuntimeError('MicroBatcher is closed')
            now = time.monotonic()
            if self._adaptive:
                if self._last_arrival is not None:
                    # Clamp the sample so one idle spell doesn't poison
                    # the estimate for many subsequent arrivals — 4x the
                    # window already means "flush immediately".
                    gap = min(now - self._last_arrival,
                              4.0 * self._max_delay)
                    self._gap_ewma = (gap if self._gap_ewma is None else
                                      0.7 * self._gap_ewma + 0.3 * gap)
                self._last_arrival = now
            self._queue.append((req, now))
            self.n_requests += 1
            self._cond.notify_all()
        return ServeFuture(req)

    def scores(self, X, timeout: 'float | None' = 30.0) -> np.ndarray:
        return self.submit(X).result(timeout).scores

    def top_k(self, X, k: int, timeout: 'float | None' = 30.0):
        r = self.submit(X, k).result(timeout)
        return r.values, r.indices

    @property
    def max_batch(self) -> int:
        return self._max_batch

    @property
    def mean_batch(self) -> float:
        """Mean coalesced launch size so far (1.0 = no amortization)."""
        return self.n_requests / self.n_batches if self.n_batches else 0.0

    def _effective_delay(self) -> float:
        """The flush window in effect right now (seconds). Fixed-window
        batchers return max_delay; adaptive ones shrink it by the
        observed inter-arrival EWMA. Call under `self._cond`."""
        if not self._adaptive or self._gap_ewma is None:
            return self._max_delay
        return max(0.0, self._max_delay - self._gap_ewma)

    @property
    def effective_delay_ms(self) -> float:
        """Current effective coalescing window, for introspection."""
        with self._cond:
            return self._effective_delay() * 1e3

    def close(self):
        """Flush already-queued requests, then stop the worker."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker side -------------------------------------------------------

    def _run(self):
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue:
                    return      # closed and drained
                # Coalescing window: the OLDEST request's enqueue time
                # anchors the deadline, so a request never waits more
                # than the window regardless of when the worker freed
                # up. Recomputed each wait turn: adaptive batchers can
                # tighten (or relax) the window as arrivals come in.
                while (len(self._queue) < self._max_batch
                       and not self._closed):
                    deadline = self._queue[0][1] + self._effective_delay()
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cond.wait(left)
                batch = [self._queue.popleft()[0]
                         for _ in range(min(self._max_batch,
                                            len(self._queue)))]
                self._cond.notify_all()     # wake blocked submitters
            try:
                self._execute(batch)
            except Exception as e:          # worker must survive any batch
                for req in batch:
                    req.error = e
                    req.event.set()

    def _execute(self, batch):
        self.n_batches += 1
        version, s, v, idx = self._scorer.score_batch(
            [(r.X, r.n, r.k) for r in batch])
        for i, req in enumerate(batch):
            req.response = Response(scores=s[i, :req.n],
                                    values=v[i, :req.k],
                                    indices=idx[i, :req.k],
                                    version=version)
            req.event.set()
