"""Bucketed batched scoring on the card: padded shapes, top-k with the
stable argsort's tie rule (DESIGN.md §10), the counterpart of
`repro.serve.scorer`.

Serving traffic brings candidate sets of any size. The reference jits
one program per shape and rounds every size up to a power-of-two
**bucket** so that steady traffic compiles nothing new. The port keeps
the same grid: rows are padded to the bucket (padding masked to -inf
after the product, so it never enters a top-k) and k to a power of two
within it, and each (kind, bucket dims) gets one program, a torch
function over tensors of exactly those shapes. A program records the
input signatures it ran with; after `warm` over the traffic's range no
program is added and none sees a new signature
(`program_cache_sizes`, every entry 1), the counterpart of the
reference's saturated jit cache.

Entry points, each reading one atomic `(version, w)` snapshot from a
`WeightStore` per launch:

  `scores(X)`            X @ w for one candidate set
  `top_k(X, k)`          best-k (values, indices); ties break lowest
                         index first, equal to
                         `np.argsort(-s, kind='stable')[:k]` of the same
                         scores, bit for bit
  `rank_grouped(X, g)`   one permutation ordering rows by (group asc,
                         score desc, index asc)
  `score_batch`          the micro-batcher's coalesced launch: B requests
                         padded to a (B_bucket, m_bucket, d) slab, one
                         batched product and a stable top-k per row

Scores are float32 products in full float32 (`full_f32`: TF32 would
round the scores and reorder ranks). `torch.topk` does not promise
that equal values come lowest index first, so top-k is a stable
descending sort of the bucket cut at the k bucket.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.platform import full_f32
from .weights import WeightStore

# Smallest candidate bucket: sets below 64 rows share one program.
MIN_BUCKET = 64

# Group id of padded rows in `rank_grouped`: after every real int32 id,
# so padding ends the permutation and slicing [:n] removes exactly it.
_PAD_GROUP = np.int32(np.iinfo(np.int32).max)


def bucket_for(n: int, min_bucket: int = MIN_BUCKET) -> int:
    """Smallest power of two >= n (at least `min_bucket`): the padded
    size a set of n candidates is scored at. Traffic over [1, N] takes
    at most log2(N / min_bucket) + 1 buckets per entry point."""
    if n < 1:
        raise ValueError(f'bucket_for needs n >= 1; got {n}')
    return max(int(min_bucket), 1 << (int(n) - 1).bit_length())


class _Program:
    """One serving program: a torch function for one (kind, bucket
    dims), and the input signatures (shapes and dtypes) it has run with.
    More than one signature would be what a recompile is to a jitted
    program."""

    def __init__(self, fn):
        self.fn = fn
        self.signatures = set()

    def __call__(self, *args):
        self.signatures.add(tuple(
            (tuple(a.shape), a.dtype) if torch.is_tensor(a) else type(a)
            for a in args))
        with full_f32():
            return self.fn(*args)


def _stable_top(s: torch.Tensor, kb: int):
    """The kb largest entries of each row of s and their indices, ties
    lowest index first: a stable descending sort, cut."""
    v, i = torch.sort(s, dim=-1, descending=True, stable=True)
    return v[..., :kb], i[..., :kb]


class Scorer:
    """Bucketed scorer over a `WeightStore` snapshot.

    Args:
      weights: a `WeightStore`, or anything it accepts (1-D array, fitted
        `RankSVM`, `PathPoint`), wrapped in a new store on `device`.
      min_bucket: smallest candidate bucket (default 64).
      donate: accepted for the reference's signature ('auto', True or
        False). Donating the padded slab lets XLA reuse its buffer for
        the output; in the port every call copies its padded slab into a
        device tensor of its own, which the program frees when it
        returns, so there is nothing left to donate and the flag changes
        nothing. No device buffer is shared between calls.
      device: the store's device when `weights` is not a store (default
        'cuda').

    Thread safety: the entry points may be called concurrently. Each
    call snapshots `(version, w)` once and owns its padded tensors; the
    program dict is filled by the GIL-atomic get-or-set idiom (a lost
    race builds the same program twice, harmlessly).
    """

    def __init__(self, weights, *, min_bucket: int = MIN_BUCKET,
                 donate: 'bool | str' = 'auto', device=None):
        self.store = (weights if isinstance(weights, WeightStore)
                      else WeightStore(weights, device=device))
        if not (isinstance(min_bucket, int) and min_bucket >= 1):
            raise ValueError(f'min_bucket must be a positive int; got '
                             f'{min_bucket!r}')
        self.min_bucket = int(min_bucket)
        self.donate = donate
        self._programs: dict = {}

    # -- public hot path ---------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.store.device

    @property
    def n_features(self) -> int:
        return self.store.n_features

    def scores(self, X) -> np.ndarray:
        """X @ w for one candidate set X of shape (n, d); returns (n,)
        float32 host scores."""
        Xp, n = self._pad(X)
        _, w = self.store.get()
        s = self._program('scores', Xp.shape[0])(Xp, w, n)
        return s[:n].cpu().numpy()

    def top_k(self, X, k: int):
        """The best k of one candidate set: `(values, indices)`, ties
        broken lowest index first, equal to ranking the same scores by
        `np.argsort(-s, kind='stable')[:k]`. k is clamped to the
        candidate count."""
        Xp, n = self._pad(X)
        k = self._validate_k(k, n)
        kb = self._k_bucket(k, Xp.shape[0])
        _, w = self.store.get()
        v, i = self._program('topk', Xp.shape[0], kb)(Xp, w, n)
        return v[:k].cpu().numpy(), i[:k].cpu().numpy()

    def rank_grouped(self, X, groups) -> np.ndarray:
        """Per-query ranking: one permutation of [0, n) ordering rows by
        (group id asc, score desc, original index asc), so each query's
        candidates come out contiguous and ranked. Group ids are int32
        labels; rows of one group need not be contiguous."""
        Xp, n = self._pad(X)
        g = np.asarray(groups.detach().cpu() if torch.is_tensor(groups)
                       else groups)
        if g.shape != (n,):
            raise ValueError(f'groups must align with the {n} candidate '
                             f'rows; got shape {g.shape}')
        if g.size and not np.all(np.isfinite(g.astype(np.float64))):
            raise ValueError('groups contain non-finite entries')
        gp = np.full(Xp.shape[0], _PAD_GROUP, np.int32)
        gp[:n] = g.astype(np.int32)
        _, w = self.store.get()
        order = self._program('grouped', Xp.shape[0])(
            Xp, w, n, torch.from_numpy(gp).to(self.device))
        return order[:n].cpu().numpy()

    def score_batch(self, requests):
        """The micro-batcher's coalesced launch: `requests` is a list of
        `(X, n, k)` with X validated float32 (n, d). Returns `(version,
        scores, values, indices)`: version is the one weight snapshot of
        the whole batch; the arrays are the padded (B_bucket,
        m_bucket[, k_bucket]) outputs, rows [i, :n_i] and [i, :k_i]
        valid."""
        if not requests:
            raise ValueError('score_batch needs at least one request')
        d = self.n_features
        mb = bucket_for(max(n for _, n, _ in requests), self.min_bucket)
        kb = self._k_bucket(max(max(k for _, _, k in requests), 1), mb)
        bb = 1 << (len(requests) - 1).bit_length()
        Xp = np.zeros((bb, mb, d), np.float32)
        n_valid = np.zeros(bb, np.int64)
        for i, (X, n, _) in enumerate(requests):
            Xp[i, :n] = X
            n_valid[i] = n
        version, w = self.store.get()
        s, v, idx = self._program('batch', bb, mb, kb)(
            self._to_device(Xp), w, torch.from_numpy(n_valid).to(
                self.device))
        return (version, s.cpu().numpy(), v.cpu().numpy(),
                idx.cpu().numpy())

    def warm(self, max_candidates: int, *, ks=(1,),
             max_batch: 'int | None' = None, grouped: bool = False):
        """Build and run once every program that traffic up to
        `max_candidates` rows per request takes: each candidate bucket,
        the k buckets of `ks` (`_k_buckets`: k clamps to a request's
        candidate count, so the smallest bucket also takes the smaller
        k buckets; the reference's warm leaves those to the traffic),
        the grouped ranking when `grouped`, and, when `max_batch` is
        given, each batch bucket of the micro-batcher's coalesced launch.
        Afterwards traffic of 1 to `max_candidates` rows and a k of `ks`
        adds no program. Returns the program count."""
        d = self.n_features
        w = self.store.get()[1]
        dev = self.device
        mbs, mb = [], self.min_bucket
        top = bucket_for(int(max_candidates), self.min_bucket)
        while mb <= top:
            mbs.append(mb)
            mb *= 2
        for mb in mbs:
            Xp = torch.zeros((mb, d), dtype=torch.float32, device=dev)
            self._program('scores', mb)(Xp, w, 1)
            for kb in self._k_buckets(ks, mb):
                self._program('topk', mb, kb)(Xp, w, 1)
            if grouped:
                gp = torch.full((mb,), int(_PAD_GROUP), dtype=torch.int32,
                                device=dev)
                self._program('grouped', mb)(Xp, w, 1, gp)
            if max_batch:
                bb = 1
                while bb <= (1 << (int(max_batch) - 1).bit_length()):
                    for kb in self._k_buckets(ks, mb):
                        self._program('batch', bb, mb, kb)(
                            torch.zeros((bb, mb, d), dtype=torch.float32,
                                        device=dev), w,
                            torch.zeros((bb,), dtype=torch.int64,
                                        device=dev))
                    bb *= 2
        return self.n_programs

    # -- introspection (tests, chip_smoke.py) ------------------------------

    @property
    def n_programs(self) -> int:
        """Program count: stable after `warm`."""
        return len(self._programs)

    def program_cache_sizes(self) -> dict:
        """Input signatures each program has run with; every entry stays
        1 in steady state."""
        return {key: len(fn.signatures)
                for key, fn in list(self._programs.items())}

    # -- internals ---------------------------------------------------------

    def _validate_request(self, X, k):
        """Shared request validation (the micro-batcher calls it in the
        submitting thread, so bad input raises at the call site): X to
        float32 (n, d) on the host, n >= 1, d the served width; k clamped
        to n (None -> 0: scores only)."""
        if torch.is_tensor(X):
            X = X.detach().cpu().numpy()
        X = np.ascontiguousarray(np.asarray(X, np.float32))
        if X.ndim != 2:
            raise ValueError('candidate set must be a 2-D (n_candidates, '
                             f'n_features) matrix; got shape {X.shape}')
        n, d = X.shape
        if n == 0:
            raise ValueError('empty candidate set: nothing to score '
                             '(n_candidates == 0)')
        if d != self.n_features:
            raise ValueError(f'candidate features have width {d}; the '
                             f'served model scores {self.n_features}')
        k = 0 if k is None else self._validate_k(k, n)
        return X, n, k

    @staticmethod
    def _validate_k(k, n: int) -> int:
        if not (isinstance(k, (int, np.integer))
                and not isinstance(k, bool)) or k < 1:
            raise ValueError(f'k must be a positive integer; got {k!r}')
        return min(int(k), n)

    def _k_bucket(self, k: int, m_bucket: int) -> int:
        """k rounded up to a power of two, at most the candidate bucket:
        different k share programs, and the cut back to k is free."""
        return min(1 << (int(k) - 1).bit_length(), m_bucket)

    def _k_buckets(self, ks, m_bucket: int) -> list:
        """Every k bucket that a request in candidate bucket m_bucket
        asking for a k of `ks` takes: k clamps to the request's n, which
        lies in (m_bucket / 2, m_bucket], or in [1, m_bucket] for the
        smallest bucket."""
        lo = 1 if m_bucket <= self.min_bucket else m_bucket // 2 + 1
        out = set()
        for k in ks:
            k = self._validate_k(k, m_bucket)
            kb = self._k_bucket(min(k, lo), m_bucket)
            while kb <= self._k_bucket(k, m_bucket):
                out.add(kb)
                kb *= 2
        return sorted(out)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _pad(self, X):
        X, n, _ = self._validate_request(X, None)
        mb = bucket_for(n, self.min_bucket)
        Xp = np.zeros((mb, X.shape[1]), np.float32)
        Xp[:n] = X
        return self._to_device(Xp), n

    def _program(self, kind: str, *dims):
        key = (kind, *dims)
        fn = self._programs.get(key)
        if fn is None:
            fn = self._programs[key] = _Program(self._build(kind, *dims))
        return fn

    @staticmethod
    def _build(kind: str, *dims):
        """One program per (kind, bucket dims). Padded rows are masked to
        -inf after the product, so they lose every comparison against a
        finite score; with the stable sort's lowest-index-first rule, a
        padded row (index >= n) never displaces a real one, even at
        equal keys."""
        if kind == 'scores':
            (mb,) = dims

            def scores_fn(Xp, w, n_valid):
                s = Xp @ w
                live = torch.arange(mb, device=s.device) < n_valid
                return torch.where(live, s, float('-inf'))

            return scores_fn
        if kind == 'topk':
            mb, kb = dims

            def topk_fn(Xp, w, n_valid):
                s = Xp @ w
                live = torch.arange(mb, device=s.device) < n_valid
                return _stable_top(torch.where(live, s, float('-inf')), kb)

            return topk_fn
        if kind == 'batch':
            bb, mb, kb = dims

            def batch_fn(Xp, w, n_valid):
                s = Xp @ w                                  # (bb, mb)
                live = (torch.arange(mb, device=s.device)[None, :]
                        < n_valid[:, None])
                s = torch.where(live, s, float('-inf'))
                return (s, *_stable_top(s, kb))

            return batch_fn
        if kind == 'grouped':
            (mb,) = dims

            def grouped_fn(Xp, w, n_valid, groups):
                s = Xp @ w
                live = torch.arange(mb, device=s.device) < n_valid
                s = torch.where(live, s, float('-inf'))
                # Two stable sorts compose into (group asc, score desc,
                # index asc): padded rows carry s = -inf and the largest
                # group id, so both passes push them to the tail.
                by_score = torch.sort(s, descending=True,
                                      stable=True).indices
                by_group = torch.sort(groups[by_score], stable=True).indices
                return by_score[by_group]

            return grouped_fn
        raise AssertionError(f'unknown program kind {kind!r}')
