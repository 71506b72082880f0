"""`RankingService`: the assembled serving stack (DESIGN.md §10), the
counterpart of `repro.serve.service`.

One object wiring the three layers together — a `WeightStore` (versioned
atomic weight slots), a `Scorer` (bucketed programs on the card) and,
optionally, a `MicroBatcher` (latency-bounded request coalescing) — so
callers get the production shape in one line:

    svc = RankingService(est)               # est: fitted RankSVM
    vals, idx = svc.top_k(X_candidates, 10)
    svc.swap_weights(new_est)               # atomic, non-blocking

`chip_smoke.py`'s serve phase drives it on the card.
"""

from __future__ import annotations

import numpy as np

from .batching import MicroBatcher, ServeFuture
from .scorer import MIN_BUCKET, Scorer
from .weights import WeightStore


class RankingService:
    """Low-latency scoring service around a trained weight vector.

    Args:
      weights: 1-D weight array, fitted `RankSVM`, or `PathPoint`.
      micro_batch: run requests through the coalescing queue (default
        True). False serves every call as its own device launch — the
        baseline the benchmark compares against.
      max_batch / max_delay_ms / max_queue: `MicroBatcher` knobs
        (defaults 32 / 2.0 / 256).
      adaptive_delay: `MicroBatcher` knob (default False) — tighten the
        coalescing window at low arrival rates (an EWMA of inter-arrival
        gaps shrinks the effective flush delay), recovering the
        per-request p50 where there is nothing to coalesce while keeping
        the full window under dense traffic.
      min_bucket / donate: `Scorer` knobs (defaults 64 / 'auto').
      device: where the weights live and scoring runs (default 'cuda').

    `scores`/`top_k` block for their result (through the queue when
    micro-batching, direct otherwise); `submit` exposes the async handle;
    `rank_grouped` is always direct (a multi-query request is already a
    batch). `swap_weights` installs a new model atomically — in-flight
    launches finish on the version they started with.
    """

    def __init__(self, weights, *, micro_batch: bool = True,
                 max_batch: int = 32, max_delay_ms: float = 2.0,
                 max_queue: int = 256, adaptive_delay: bool = False,
                 min_bucket: int = MIN_BUCKET,
                 donate: 'bool | str' = 'auto', device=None):
        self.store = (weights if isinstance(weights, WeightStore)
                      else WeightStore(weights, device=device))
        self.scorer = Scorer(self.store, min_bucket=min_bucket,
                             donate=donate)
        self.batcher = (MicroBatcher(self.scorer, max_batch=max_batch,
                                     max_delay_ms=max_delay_ms,
                                     max_queue=max_queue,
                                     adaptive_delay=adaptive_delay)
                        if micro_batch else None)

    # -- serving -----------------------------------------------------------

    def scores(self, X, timeout: 'float | None' = 30.0) -> np.ndarray:
        if self.batcher is not None:
            return self.batcher.scores(X, timeout)
        return self.scorer.scores(X)

    def top_k(self, X, k: int, timeout: 'float | None' = 30.0):
        if self.batcher is not None:
            return self.batcher.top_k(X, k, timeout)
        return self.scorer.top_k(X, k)

    def submit(self, X, k: 'int | None' = None) -> ServeFuture:
        """Async handle into the micro-batching queue (requires
        `micro_batch=True`)."""
        if self.batcher is None:
            raise RuntimeError('submit() needs micro_batch=True; '
                               'per-request mode is synchronous')
        return self.batcher.submit(X, k)

    def rank_grouped(self, X, groups) -> np.ndarray:
        return self.scorer.rank_grouped(X, groups)

    def warmup(self, max_candidates: int, *, ks=(1,),
               grouped: bool = False) -> int:
        """Build and run once the full serving program grid for candidate
        sets up to `max_candidates` rows and the top-k values in `ks` —
        including every coalesced batch-bucket when micro-batching (see
        `Scorer.warm`). Call once before taking traffic: afterwards
        steady-state serving makes no new program. Returns the program
        count."""
        return self.scorer.warm(
            max_candidates, ks=ks, grouped=grouped,
            max_batch=self.batcher.max_batch if self.batcher else None)

    # -- operations --------------------------------------------------------

    def swap_weights(self, weights) -> int:
        """Atomically install a new model (see `WeightStore.swap`);
        returns the new version."""
        return self.store.swap(weights)

    @property
    def version(self) -> int:
        return self.store.version

    def stats(self) -> dict:
        """Serving counters: requests, coalesced launches, mean launch
        size, program count (stable = no new program in steady
        state)."""
        out = {'n_programs': self.scorer.n_programs,
               'version': self.store.version}
        if self.batcher is not None:
            out.update(n_requests=self.batcher.n_requests,
                       n_batches=self.batcher.n_batches,
                       mean_batch=self.batcher.mean_batch)
        return out

    def close(self):
        if self.batcher is not None:
            self.batcher.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
