"""Incremental retraining: warm-start BMRM across data changes.

The port of `repro.core.incremental` (DESIGN.md §11). The bundle
method's empirical risk is a sum over preference pairs, so every cutting
plane, a tangent of R_emp at some support iterate, is a scaled sum over
pairs too. When the training set changes by whole row blocks, the
retained planes need not be recut: they are revalidated by evaluating
the oracle over the changed rows only, at each plane's stored support
iterate (`BundleState.S`).

The `PlaneLedger` keeps, per component c (the base component from the
last full solve, plus one entry per block appended since):

    ell_c[i] + g_c[i] @ (w - S[i])  <=  N_c * R_c(w)     for all w

with N_c the component's within-component pairs, R_c its risk,
g_c[i] = N_c * subgrad_c(S[i]) and ell_c[i] = N_c * R_c(S[i]). Summing
the components and dividing by the merged pair count gives planes that
lower-bound the merged risk (cross-component pairs are dropped: exact
when no query spans blocks). Appending a block of Δ rows costs
O(planes·Δ) oracle work; retiring an appended block is an exact
subtraction (`planes()` sums the components afresh, in insertion order,
so append-then-retire round-trips bit for bit). A base-component block
cannot be subtracted: the ledger rebuilds per-block partials over the
survivors, or the caller refits from w alone (`mode='w-only'`).

The ledger algebra is float64 numpy, as in the reference. What differs
is where a block is revalidated: a block held on the card, and any dense
or CSR block in RAM, goes through the fused oracle on the oracle's
device, so its P plane evaluations launch the counting kernel there;
only a memmap block streams (`block_partials`).

`IncrementalFit` is the state machine (`data.rowblocks.BlockStore` +
`PlaneLedger` + the last fitted `BundleState`); `RankSVM.refit` drives
it. `refit_chunk_step` adapts one device-driver chunk to
`runtime.loop.run`'s step contract, so a long refit composes with
checkpointed resume.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..data.rowblocks import (BlockStore, CSRBlockSource, DenseBlockSource,
                              TensorBlockSource)
from ..kernels.platform import full_f32
from .bmrm import BundleState, _run_chunk, bundle_state_from_planes, f32
from .oracle import _loss_norm_weights, _validate_loss, make_oracle

# Losses whose planes are per-block decomposable: a component tangent
# lower-bounds the component's unnormalized merged-risk contribution.
# True for 'hinge' (a block's pairs are a subset of the merged pairs) and
# 'toppush' (merging only grows each anchored example's lower set, and a
# running max over a superset is no smaller). False for 'poshinge': its
# weights depend on the example's utility rank within the MERGED group,
# so block-local weights would over-bound the merged risk; that loss
# keeps no ledger and refits w-only (DESIGN.md §12).
LEDGER_LOSSES = ('hinge', 'toppush')


class BaseRetireError(ValueError):
    """Raised by `PlaneLedger.retire_block` for a block covered by the
    base component, whose planes are not per-block decomposable: the
    caller must rebuild over the survivors or fall back to w-only."""


@dataclasses.dataclass(frozen=True)
class LedgerBlock:
    """One component's per-plane partial sums at the stored iterates:
    `ell[i] = n_pairs * R_block(S[i])`, `g[i] = n_pairs *
    subgrad_block(S[i])`; `n_pairs` counts within-component pairs only
    (the loss's normalizer)."""

    ell: np.ndarray        # (P,)   float64
    g: np.ndarray          # (P, n) float64
    n_pairs: int


def _revalidation_input(X):
    """What a block is revalidated on: the native X of an in-RAM or
    on-card member (a fused oracle on the device), the source itself for
    a memmap member (the streaming oracle)."""
    if isinstance(X, TensorBlockSource):
        return X.tensor
    if isinstance(X, (DenseBlockSource, CSRBlockSource)):
        return X._X
    return X


def block_partials(X, y, groups, S, *, engine=None, pair_block: int = 2048,
                   loss: str = 'hinge', device=None) -> LedgerBlock:
    """One block's `LedgerBlock` at the P stored iterates S: P oracle
    evaluations over this block's rows only, scaled by the block's loss
    normalizer (N for the hinge, the anchored count N+ for 'toppush').
    A pairless block contributes zeros without building an oracle.

    X is the block's features (dense numpy or torch, CSR, or a row-block
    source). A tensor on the card and any in-RAM dense or CSR block are
    evaluated by a fused 'tree' oracle on `device` with `engine` (the
    estimator's counting engine: 'pallas' launches the rank-counts
    kernel); an np.memmap or memmap source streams."""
    _validate_loss(loss)
    if loss not in LEDGER_LOSSES:
        raise ValueError(
            f'loss {loss!r} has no per-block plane decomposition '
            f'(LEDGER_LOSSES = {LEDGER_LOSSES}): its position weights '
            'depend on merged within-group utility ranks, so block-local '
            "partials would over-bound the merged risk; refit with "
            "mode='w-only'")
    y = np.asarray(y.detach().cpu().numpy() if torch.is_tensor(y) else y)
    if torch.is_tensor(groups):
        groups = groups.detach().cpu().numpy()
    S = np.asarray(S, np.float64)
    P, n = S.shape
    norm, _ = _loss_norm_weights(y, groups, loss)
    norm = int(norm)
    if norm == 0 or P == 0:
        return LedgerBlock(np.zeros(P), np.zeros((P, n)), norm)
    X = _revalidation_input(X)
    method = 'auto' if isinstance(X, np.memmap) or getattr(
        X, 'disk_backed', False) else 'tree'
    oracle = make_oracle(X, y, groups, method=method, loss=loss,
                         engine=engine, pair_block=pair_block,
                         device=device)
    ell = np.zeros(P)
    g = np.zeros((P, n))
    for i in range(P):
        loss_i, a = oracle.loss_and_subgrad(S[i])
        ell[i] = norm * float(loss_i)
        g[i] = norm * (a.double().cpu().numpy() if torch.is_tensor(a)
                       else np.asarray(a, np.float64))
    return LedgerBlock(ell, g, norm)


class PlaneLedger:
    """Block-keyed per-plane partial sums behind plane revalidation.

    Components: one `base` (planes read off the last solve's
    `BundleState`, covering every block retained then, cross-block pairs
    included) plus one `LedgerBlock` per block appended since, in
    insertion order. `planes()` recomputes the merged (A, b) from the
    components on every call; components are immutable and sums are
    never updated in place, so retiring an appended block restores the
    exact floating-point planes of the never-appended ledger."""

    def __init__(self, S: np.ndarray, alpha: np.ndarray,
                 base: LedgerBlock, base_bids):
        S = np.asarray(S, np.float64)
        alpha = np.asarray(alpha, np.float64).ravel()
        if S.ndim != 2 or alpha.shape != (S.shape[0],):
            raise ValueError(f'iterates S{S.shape} and dual '
                             f'alpha{alpha.shape} do not align')
        if base.ell.shape != (S.shape[0],) or base.g.shape != S.shape:
            raise ValueError('base component does not match the iterates')
        self.S = S
        self.alpha = alpha
        self._base = base
        self._base_bids = frozenset(int(b) for b in base_bids)
        self._entries: dict[int, LedgerBlock] = {}

    @classmethod
    def from_state(cls, state: BundleState, n_pairs: int,
                   block_ids) -> 'PlaneLedger':
        """Read the base component off a fitted device-driver state with
        no oracle work: plane i satisfies a_i @ w + b_i <= R(w) with
        tangent point S[i], so g0[i] = N a_i and
        ell0[i] = N (b_i + a_i @ S[i])."""
        P = int(state.n_active)

        def host(t):
            return t.detach().cpu().numpy().astype(np.float64)[:P]

        A, b, S, alpha = (host(t) for t in (state.A, state.b, state.S,
                                            state.alpha))
        N = float(int(n_pairs))
        g0 = N * A
        ell0 = N * (b + np.einsum('ij,ij->i', A, S))
        return cls(S, alpha, LedgerBlock(ell0, g0, int(n_pairs)),
                   block_ids)

    @property
    def n_planes(self) -> int:
        return int(self.S.shape[0])

    @property
    def base_bids(self) -> frozenset:
        return self._base_bids

    @property
    def entry_bids(self) -> tuple:
        return tuple(self._entries)

    @property
    def n_pairs(self) -> int:
        """Merged pair count (cross-component pairs excluded: they are
        the dropped, not double-counted, part of the bound)."""
        return self._base.n_pairs + sum(
            e.n_pairs for e in self._entries.values())

    def covers(self, bid: int) -> bool:
        return bid in self._base_bids or bid in self._entries

    def append_block(self, bid: int, block: LedgerBlock):
        bid = int(bid)
        if self.covers(bid):
            raise ValueError(f'block {bid} is already in the ledger')
        if block.ell.shape != (self.n_planes,) or (
                block.g.shape != self.S.shape):
            raise ValueError(f'block partials ell{block.ell.shape}/'
                             f'g{block.g.shape} do not match the '
                             f'{self.n_planes}-plane ledger')
        self._entries[bid] = block

    def retire_block(self, bid: int):
        bid = int(bid)
        if bid in self._base_bids:
            raise BaseRetireError(
                f'block {bid} is part of the base component (planes from '
                'the last solve are tangents of the risk over ALL blocks '
                'retained then, cross-block pairs included) and cannot be '
                'subtracted out — rebuild per-block partials over the '
                "survivors or refit with mode='w-only'")
        if bid not in self._entries:
            raise ValueError(f'block {bid} is not in the ledger; entries: '
                             f'{sorted(self._entries)}')
        del self._entries[bid]

    def planes(self) -> tuple[np.ndarray, np.ndarray]:
        """Merged (A, b) for the current component set, float64:
        A[i] = (sum of g components)[i] / N_merged and
        b[i] = ell_merged[i] / N - A[i] @ S[i]. The sums run over the
        components in insertion order from copies of the base, never in
        place, so the result is a pure function of the component set."""
        N = float(self.n_pairs)
        if N <= 0:
            raise ValueError('ledger covers no preference pairs; nothing '
                             'to build planes from')
        ell = self._base.ell.copy()
        g = self._base.g.copy()
        for e in self._entries.values():
            ell = ell + e.ell
            g = g + e.g
        A = g / N
        b = ell / N - np.einsum('ij,ij->i', A, self.S)
        return A, b


@dataclasses.dataclass
class RefitReport:
    """What one `RankSVM.refit` did and what it cost."""

    mode: str                    # 'ledger' | 'w-only' (as resolved)
    appended: tuple              # block ids appended by this call
    retired: tuple               # block ids retired by this call
    n_planes: int                # planes carried into the warm start
    delta_rows: int              # rows revalidated against (appended)
    revalidate_seconds: float    # wall time of the block partials
    fit: object = None           # the warm solve's FitReport


class IncrementalFit:
    """State machine of data-warm-started refits.

    Owns the `BlockStore` (the data), the `PlaneLedger` (revalidated
    planes; None when the last fit ran on the host driver, which keeps no
    bundle state) and the last fitted `BundleState`. `RankSVM.fit`
    creates one; `RankSVM.refit` drives it. Usable on its own:
    append/retire, `warm_state()` to seed the device driver, then
    `commit()` with the solved state."""

    def __init__(self, store: BlockStore, state: 'BundleState | None',
                 n_pairs: int, partials_fn=None):
        self.store = store
        self.state = state
        self._partials_fn = partials_fn or block_partials
        self.revalidate_seconds = 0.0
        self.ledger = None
        if state is not None and int(state.n_active) > 0 and n_pairs > 0:
            self.ledger = PlaneLedger.from_state(state, n_pairs,
                                                 store.block_ids)

    def _partials(self, bid: int, S) -> LedgerBlock:
        mem = self.store.member(bid)
        return self._partials_fn(mem.source, mem.y, mem.groups, S)

    def append(self, X, y, groups=None) -> int:
        """Append a block to the store and revalidate every retained
        plane against it (O(planes·Δ) oracle work; none without a
        ledger)."""
        bid = self.store.append(X, y, groups)
        if self.ledger is not None:
            t0 = time.perf_counter()
            self.ledger.append_block(bid, self._partials(bid,
                                                         self.ledger.S))
            self.revalidate_seconds += time.perf_counter() - t0
        return bid

    def retire(self, bid: int):
        """Retire a block: an appended block is subtracted exactly; a
        base-component block makes the ledger rebuild per-block partials
        over the survivors (O(planes·m_surviving); `RankSVM.refit` under
        mode='auto' prefers w-only then)."""
        self.store.retire(bid)
        if self.ledger is None:
            return
        try:
            self.ledger.retire_block(bid)
        except BaseRetireError:
            self._rebuild()

    def _rebuild(self):
        """An empty base plus one freshly evaluated `LedgerBlock` per
        surviving block, at the stored iterates. Cross-block pairs drop
        (bounds loosen but stay valid)."""
        S, alpha = self.ledger.S, self.ledger.alpha
        P, n = S.shape
        led = PlaneLedger(S, alpha,
                          LedgerBlock(np.zeros(P), np.zeros((P, n)), 0),
                          frozenset())
        t0 = time.perf_counter()
        for bid in self.store.block_ids:
            led.append_block(bid, self._partials(bid, S))
        self.revalidate_seconds += time.perf_counter() - t0
        self.ledger = led

    def warm_state(self, dim: int, max_planes: int, w0=None,
                   device='cuda') -> 'BundleState | None':
        """The revalidated planes as a device-driver warm start on
        `device`, or None when there is nothing to warm from (no ledger,
        no planes or no pairs). Past `max_planes` the planes of highest
        dual weight are kept."""
        if self.ledger is None or self.ledger.n_planes == 0:
            return None
        if self.ledger.n_pairs <= 0:
            return None
        A, b = self.ledger.planes()
        S, alpha = self.ledger.S, self.ledger.alpha
        K = int(max_planes)
        if A.shape[0] > K:
            keep = np.sort(np.argsort(alpha)[::-1][:K])
            A, b, S, alpha = A[keep], b[keep], S[keep], alpha[keep]
        return bundle_state_from_planes(A, b, S, dim, K, w0=w0,
                                        alpha=alpha, device=device)

    def commit(self, state: 'BundleState | None', n_pairs: int):
        """Adopt a finished solve: its planes become the new base
        component (covering every retained block) and the appended
        entries reset."""
        self.state = state
        self.ledger = None
        if state is not None and int(state.n_active) > 0 and n_pairs > 0:
            self.ledger = PlaneLedger.from_state(state, n_pairs,
                                                 self.store.block_ids)


def refit_chunk_step(oracle, lam: float, eps: float, *,
                     sync_every: int = 8, qp_iters: int = 128):
    """One device-driver chunk as `runtime.loop.run`'s step.

    Returns `step(state, batch) -> (state, {'loss': j_best, 'gap': gap})`
    over a `BundleState` on the oracle's device (a checkpointable tree):
    `sync_every` bundle steps, converged steps frozen, as `bmrm`'s device
    driver runs them. `batch` is ignored (the oracle owns its data), so
    drive it with `batch_fn=lambda step: None`. The plane capacity is
    the state's (`init_bundle_state(dim, max_planes)`), where the
    reference's step takes `max_planes=` to build its chunk. A resume
    restores the exact bundle state: planes, dual, iterates."""
    step_fn = oracle.step_fn()
    dev = oracle.device
    lam_d = torch.tensor(lam, dtype=f32, device=dev)
    eps_d = torch.tensor(eps, dtype=f32, device=dev)
    steps, qp_iters = max(1, int(sync_every)), int(qp_iters)

    def step(state: BundleState, batch):
        del batch
        with full_f32():
            state, _ = _run_chunk(state, step_fn, lam_d, eps_d, qp_iters,
                                  steps)
        return state, {'loss': state.j_best, 'gap': state.gap}

    return step
