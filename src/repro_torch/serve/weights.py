"""Versioned weight slots with atomic hot-swap (DESIGN.md §10).

The counterpart of `repro.serve.weights`. A ranking service must pick up
a newly trained weight vector (a `RankSVM.path()` selection, a retrained
model) without blocking traffic and without mixing two models in one
response. `WeightStore` holds the current `(version, w)` pair as one
immutable tuple: readers take it once per launch (`get()`, an atomic
tuple read under CPython), and `swap()` prepares the new vector off the
hot path (float32 cast, copy to the store's device, a wait until the copy
is done) before it replaces the tuple under a lock. In-flight launches
keep the snapshot they started with, so every response comes from
exactly one weight version.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..kernels.platform import resolve_device


def _prepare_weights(w, device: torch.device) -> torch.Tensor:
    """Validate and stage a weight vector for serving: 1-D, finite,
    float32, resident on `device` before anyone can read it."""
    if hasattr(w, 'w_'):            # fitted RankSVM estimator
        w = w.w_
    if hasattr(w, 'w') and not isinstance(w, (np.ndarray, torch.Tensor)):
        w = w.w                     # PathPoint from RankSVM.path()
    if w is None:
        raise ValueError('weights are None — fit the estimator first')
    if torch.is_tensor(w):
        w = w.detach().cpu().numpy()
    w = np.asarray(w, np.float32)
    if w.ndim != 1 or w.size == 0:
        raise ValueError('weights must be a non-empty 1-D vector; got '
                         f'shape {w.shape}')
    if not np.all(np.isfinite(w)):
        raise ValueError('weights contain non-finite entries')
    wd = torch.as_tensor(w, device=device)
    if wd.is_cuda:
        torch.cuda.current_stream(device).synchronize()
    return wd


class WeightStore:
    """Atomic versioned weight slot for the serving hot path.

    Args:
      weights: the initial model: a 1-D array-like, a fitted `RankSVM`
        (its `w_`), or a `PathPoint` from `RankSVM.path()`.
      device: where the weights live and the scorers run (default
        'cuda'; `kernels.platform.resolve_device`).

    `get()` returns the current `(version, w)` snapshot, w a float32
    tensor on the store's device; use both halves of the same call for
    one launch, so that a concurrent `swap()` cannot split it across
    versions. Versions start at 0 and grow by 1 per swap.
    """

    def __init__(self, weights, *, device=None):
        self.device = resolve_device(device)
        wd = _prepare_weights(weights, self.device)
        self._lock = threading.Lock()
        self._slot = (0, wd)

    @property
    def version(self) -> int:
        return self._slot[0]

    @property
    def n_features(self) -> int:
        return int(self._slot[1].shape[0])

    def get(self):
        """The current `(version, w)`: one atomic snapshot."""
        return self._slot

    def swap(self, weights) -> int:
        """Install new weights; returns the new version.

        Validation, the cast and the copy to the device (waited for) come
        before the tuple is replaced, so a concurrent `get()` sees the
        old slot or the new one, whole, and never waits on a copy. A
        change of the feature width is rejected: a serving process scores
        candidates of one width."""
        wd = _prepare_weights(weights, self.device)
        with self._lock:
            version, cur = self._slot
            if wd.shape != cur.shape:
                raise ValueError(
                    f'weight shape {tuple(wd.shape)} does not match the '
                    f'served model {tuple(cur.shape)}; a new feature space '
                    'needs a new service')
            self._slot = (version + 1, wd)
            return version + 1
