"""The serving layer: what consumes a trained weight vector under traffic
(DESIGN.md §10), the counterpart of `repro.serve`:

  `WeightStore`     versioned weight slots, atomic hot-swap
  `Scorer`          bucketed scoring on the card: flat scores, top-k with
                    the stable argsort's tie rule, per-query ranking
  `MicroBatcher`    latency-bounded request coalescing (flush on
                    max_batch or max_delay_ms, bounded queue)
  `RankingService`  the assembled stack; `RankSVM.scores`/`.top_k` are
                    thin wrappers over a `Scorer` of the fitted estimator
"""

from .batching import MicroBatcher, Response, ServeFuture
from .scorer import Scorer, bucket_for
from .service import RankingService
from .weights import WeightStore

__all__ = [
    'MicroBatcher', 'RankingService', 'Response', 'Scorer',
    'ServeFuture', 'WeightStore', 'bucket_for',
]
