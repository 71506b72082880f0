"""The BMRM oracle layer: one (loss, subgradient) abstraction on the device.

The counterpart of the single-device part of `repro.core.oracle`. Every
training path is a `RankOracle`, an object that evaluates

    loss_and_subgrad(w) -> (R_emp(w), a)      a = X^T (c - d) / N   (Lemma 2)

plus what BMRM needs (m, n, the exact pair count N, the device). The
fused oracles keep X, y and every per-iteration vector on their device:
the matvec p = Xw, the counting pass, the loss and the transpose-matvec
run there, and only w goes in and (loss, a) comes out. X is dense
(`_DenseFeatures`) or CSR (`_CSRFeatures`: a gather matvec, and a
transpose-matvec on the device or, with csr_rmatvec='host', through
scipy's CSR loops on the host).

`StreamingOracle` (method='stream', or 'auto' over a memory budget)
keeps only O(m) vectors on the device and streams the features through
two chunked passes over a row-block source (`data.rowblocks`, DESIGN.md
§6); the counting pass between them runs on the device.

Every oracle carries the loss axis (DESIGN.md §12) through one counting
core, `_loss_and_coeffs`: the paper's hinge ('hinge', coefficients c - d
over the N pairs), the position-weighted hinge ('poshinge', the weighted
counts c~ - v d over the pair weight W) and the top-rank loss
('toppush', one sorted pass and no frequency vectors, over the anchored
count N+).

`ShardedOracle` (method='sharded') splits X over a mesh of ranks
(`core.distributed`, `launch.mesh`): bf16 rows and columns of dense X,
CSR slot rows, or a rank's own rows streamed from a row-block source;
the counting pass runs on the gathered scores. It implements the hinge
only.
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from ..data import rowblocks as _rowblocks
from ..data.rowblocks import (_validate_block_rows, _validate_prefetch,
                              resolve_prefetch)
from ..kernels.platform import full_f32, resolve_device
from ..launch.mesh import ROWS, default_mesh
from . import counts as _counts
from . import distributed as _dist

f32 = torch.float32

LOSSES = ('hinge', 'toppush', 'poshinge')
METHODS = ('tree', 'pairs', 'auto', 'sharded', 'stream')


def _validate_loss(loss: str) -> None:
    """Reject an unknown loss name before any oracle is built."""
    if loss not in LOSSES:
        raise ValueError(f'unknown loss {loss!r}; expected one of {LOSSES}')


def _group_members(groups):
    """Each group's example indices, in ascending group order and, inside
    a group, in the examples' order: what the reference's `groups == u`
    masks select, from one stable sort instead of one pass over m per
    group (8192 queries of 128 rows would take 2^33 compares)."""
    groups = np.asarray(groups)
    order = np.argsort(groups, kind='stable')
    cuts = np.flatnonzero(np.diff(groups[order])) + 1
    return np.split(order, cuts) if order.size else []


def _toppush_norm(y: np.ndarray, groups) -> int:
    """The exact count of ANCHORED examples, those with a strictly lower
    utility in their group: the TopPush normalizer N+."""
    y = np.asarray(y)
    if y.size == 0:
        return 0
    if groups is None:
        return int(np.sum(y > y.min()))
    return int(sum(np.sum(y[i] > y[i].min()) for i in _group_members(groups)))


def _poshinge_weights_norm(y: np.ndarray, groups):
    """(v, W) of the position-weighted hinge, exact on the host:
    v_i = 1 / log2(1 + rank_i), rank_i = |{k in group : y_k > y_i}| + 1,
    and W = the sum over preference pairs (i, j), y_i < y_j, of v_j.
    O(m log m): one sort and two searches per group."""
    y = np.asarray(y, np.float64)
    m = y.shape[0]
    v = np.zeros(m)
    W = 0.0
    members = ([np.arange(m)] if groups is None
               else _group_members(np.asarray(groups, np.int64)))
    for idx in members:
        yy = y[idx]
        ys = np.sort(yy)
        rank = (yy.shape[0] - np.searchsorted(ys, yy, side='right')) + 1
        vv = 1.0 / np.log2(1.0 + rank)
        v[idx] = vv
        lower = np.searchsorted(ys, yy, side='left')   # strictly lower
        W += float(np.sum(vv * lower))
    return v, W


def _loss_norm_weights(y, groups, loss: str):
    """(norm, v): the loss's exact normalizer and its per-example weights
    (float64 numpy for 'poshinge', else None).

      'hinge'     N  = the preference pairs
      'toppush'   N+ = the anchored examples
      'poshinge'  W  = the pairs' weight, with v

    The three vanish together (each needs a within-group pair of unequal
    utilities), so the oracles' no-pairs check covers every loss."""
    if loss == 'toppush':
        return _toppush_norm(y, groups), None
    if loss == 'poshinge':
        v, W = _poshinge_weights_norm(y, groups)
        return W, v
    return _exact_pairs(y, groups), None


class RankOracle:
    """Interface: per-iteration (loss, subgradient) for BMRM.

    Attributes:
      m, n: examples and features.
      n_pairs: exact number of preference pairs N (host int).
      norm: the loss normalizer: N for the hinge, the anchored count N+
        for 'toppush', the pair weight W for 'poshinge'
        (`_loss_norm_weights`).
      device: the torch device the oracle computes on.
      device_resident: True when `loss_and_subgrad` returns tensors on
        `device`; BMRM then keeps its planes there.
      supports_device_solver: True when `step_fn` gives a step the device
        driver can run.
      prefer_device_solver: the bmrm solver='auto' hint, True when the
        device driver suits this oracle's layout. False for CSR features
        whose transpose-matvec runs on the host (the device driver would
        force it onto the device) and for streamed CSR sources (its step
        densifies a slab per block, the host passes stay sparse).
      supports_path_vmap: True when `step_fn` also takes a batch of
        iterates W (L, n) and returns (R_emp (L,), A (L, n)), so that
        `bmrm_path(mode='vmap')` can step every lambda of a path at once.
        True for the fused oracles; False for the streaming oracle, whose
        passes over row blocks take one iterate.
    """

    name = 'abstract'
    device_resident = False
    supports_device_solver = False
    prefer_device_solver = False
    supports_path_vmap = False
    loss = 'hinge'
    m: int
    n: int
    n_pairs: int
    norm: float
    device: torch.device

    def loss_and_subgrad(self, w):
        raise NotImplementedError

    def step_fn(self):
        raise NotImplementedError(
            f'{type(self).__name__} has no step_fn; use the host driver')


def _exact_pairs(y: np.ndarray, groups) -> int:
    if groups is None:
        return _counts.num_pairs_host(y)
    return int(sum(_counts.num_pairs_host(y[i])
                   for i in _group_members(groups)))


def _validate_groups(groups, m: int) -> np.ndarray:
    """Validate group ids; returns them relabelled onto [0, n_groups) as
    int32. NaN or fractional ids would corrupt the key-offset keys with
    no error downstream, and sparse id values would inflate them."""
    g = np.asarray(groups)
    if g.ndim != 1:
        raise ValueError(f'groups must be 1-D (one id per example); got '
                         f'shape {g.shape}')
    if g.shape[0] != m:
        raise ValueError(f'groups has {g.shape[0]} entries but y has {m} '
                         'examples; they must align one-to-one')
    if g.dtype == np.bool_:
        g = g.astype(np.int32)
    if (g.dtype == object or np.issubdtype(g.dtype, np.complexfloating)
            or not np.issubdtype(g.dtype, np.number)):
        raise ValueError(f'groups must be integer ids; got dtype {g.dtype}')
    if np.issubdtype(g.dtype, np.floating):
        if np.isnan(g).any():
            raise ValueError('groups contains NaN; every example needs a '
                             'valid integer group id')
        if np.isinf(g).any():
            raise ValueError('groups contains infinite values; group ids '
                             'must be finite integers')
        if not np.all(g == np.floor(g)):
            raise ValueError('groups contains non-integer values; group '
                             'ids must be (castable to) integers')
    gi = g.astype(np.int64)
    if g.size and not np.array_equal(gi.astype(g.dtype), g):
        raise ValueError('group ids overflow int64; relabel them first '
                         '(e.g. np.unique(groups, return_inverse=True))')
    return np.unique(gi, return_inverse=True)[1].astype(np.int32)


def _warn_group_key_scale(groups: np.ndarray, y: np.ndarray, tol: float,
                          stacklevel: int = 4) -> None:
    """Warn when the float32 key offsets of grouped counting may round by
    more than `tol` margin units."""
    if not groups.size:
        return
    n_groups = int(groups.max()) + 1
    key_scale = n_groups * (float(y.max() - y.min()) + 3.5)
    ulp = key_scale * 2.0 ** -23
    if ulp > tol:
        warnings.warn(
            f'{n_groups} groups with y-range {float(y.max() - y.min()):.3g}'
            ' push the f32 key-offset keys of grouped counting to a scale '
            f'where one ulp (~{ulp:.1e} margin units) exceeds this '
            f'oracle\'s ~{tol:g} tolerance; counts and subgradients will be '
            'quietly inaccurate. Shrink the y range or split the fit into '
            'fewer-query shards (core.counts._group_offsets).',
            RuntimeWarning, stacklevel=stacklevel)


def _as_numpy(a, dtype) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


# Replicas of the transpose-matvec's accumulator: row r adds into replica
# r % R, so a column that many rows share (tf-idf's common terms) takes R
# times fewer atomic adds on one address. Each replica is a float64 copy
# of the output, 8 n bytes; under a memory budget R shrinks to fit
# (`csr_replicas`).
RMATVEC_REPLICAS = 64
# Nonzeros per chunk of the CSR products. A chunk's temporaries (about 24
# bytes a nonzero in the transpose-matvec) stay near 50 MB at any size, so
# a fused CSR oracle holds its features, 8 bytes a nonzero (12 with ragged
# rows) as `data.rowblocks.projected_resident_gib` charges, plus O(m + n).
CSR_CHUNK_NNZ = 2**21
# What the transpose-matvec holds per column besides its replicas: the
# column bounds (8 bytes, resident) and, while its exact sum is set up
# and read out, the bounds, exponents and scales (at most 36 bytes).
RMATVEC_COLUMN_BYTES = 48
# The O(m) vectors a call holds beside its counting pass (scores, labels,
# coefficients, weights), as the streaming rule reserves them.
VECTOR_BYTES = 24


def _csr_layout(X):
    """(m, n, nnz, bytes a nonzero, nonzeros of the largest chunk) of a
    CSR input, as `_CSRFeatures` lays it out."""
    X = _rowblocks.as_csr_matrix(X)
    m, n = map(int, X.shape)
    lens = np.diff(np.asarray(X.indptr, np.int64))
    nnz = int(lens.sum())
    uniform = bool(m > 0 and np.all(lens == lens[0]) and lens[0] > 0)
    widest = int(lens.max()) if m else 0
    return (m, n, nnz, 8 if uniform else 12,
            min(nnz, max(CSR_CHUNK_NNZ, widest)))


def csr_replicas(m: int, n: int, nnz: int, nnz_bytes: int, chunk_nnz: int,
                 memory_budget=None) -> int:
    """The accumulator replicas of a fused CSR oracle's transpose-matvec.

    Without a budget: `RMATVEC_REPLICAS`, capped by m and by 2^31 slots.
    With one (GiB): as many as fit, 8 n bytes each, in what the budget
    leaves after the features (`nnz_bytes` a nonzero, what
    `projected_resident_gib` charges), the O(m) vectors, the per-column
    state and a chunk's temporaries; 0 when not even one does. The
    counting pass is over when the transpose-matvec runs (the step frees
    its temporaries first), so the two share the budget's remainder."""
    cap = max(1, min(RMATVEC_REPLICAS, m, (2**31 - 1) // max(n, 1)))
    if memory_budget is None:
        return cap
    left = (float(memory_budget) * 2**30 - nnz_bytes * nnz
            - VECTOR_BYTES * m - RMATVEC_COLUMN_BYTES * n - 24 * chunk_nnz)
    return max(0, min(cap, int(left // (8 * max(n, 1)))))


class _ExactSum:
    """out[j] = the sum of the values added at index j (mod `size`),
    bit-reproducible on any device and in any order of summation.

    A CUDA `index_add_` adds floats through atomics, whose order, and so
    whose rounding, varies from run to run. Here a value added at j is
    rounded once to a multiple of 2^(e_j - 51), where bound[j] < 2^e_j
    bounds the sum of |values| added at j, and the multiples are added as
    float64 integers: every partial sum is an integer below 2^51 + nnz/2
    < 2^53, so each addition, the final sum over the `replicas` copies of
    the output included, is exact and the result does not depend on the
    order. Each value moves by at most 2^-52 of 2 * bound[j], its own
    output's bound, so a small output keeps its own precision. `bound` is
    a (size,) float64 tensor on the device (no read-back); an index
    addresses replica index // size."""

    def __init__(self, bound, replicas: int = 1):
        _, e = torch.frexp(bound)
        # 2^(51 - e), built from its float64 bits: exact for any e.
        self.scale = ((1074 - e.to(torch.int64)) << 52).view(torch.float64)
        self.size, self.replicas = bound.numel(), replicas
        self.acc = torch.zeros(replicas * self.size, dtype=torch.float64,
                               device=bound.device)

    def add(self, vals, index) -> None:
        q = (vals * self.scale[index % self.size]).round_()
        self.acc.index_add_(0, index, q)

    def sums(self):
        """The sums in fixed point: float64 integers, the replicas added.
        Two accumulators made with the same bound over disjoint values
        add exactly, so ranks that each sum their own rows can add these
        and round once (`core.distributed`)."""
        return self.acc.view(self.replicas, self.size).sum(dim=0)

    def result(self, sums=None):
        """The sums as float32: of this accumulator, or `sums` in its
        fixed point."""
        return (self.sums() if sums is None else sums).div_(
            self.scale).to(f32)


class _DenseFeatures:
    """Row-major dense X in float32 on the device; both matvecs are gemv,
    and for a batch of iterates W (L, n) or coefficients V (L, m) one
    product each (W X^T and V X)."""

    kind = 'dense'
    device_rmatvec = True

    def __init__(self, X, device: torch.device):
        if torch.is_tensor(X):
            Xt = X.detach().to(device=device, dtype=f32)
        else:
            Xt = torch.as_tensor(np.asarray(X, np.float32), device=device)
        if Xt.dim() != 2:
            raise ValueError(f'X must be 2-D; got shape {tuple(Xt.shape)}')
        self.X = Xt.contiguous()
        self.m, self.n = map(int, self.X.shape)

    def matvec(self, w):
        return self.X @ w if w.dim() == 1 else w @ self.X.T

    def rmatvec(self, v):
        return self.X.T @ v if v.dim() == 1 else v @ self.X


class _CSRFeatures:
    """CSR X on the device: float32 values and int32 accumulator slots,
    8 bytes a nonzero, plus int32 row ids when rows are ragged; column j
    of row r sits in slot (r % R) * n + j (R = `RMATVEC_REPLICAS`), and
    j = slot % n. Both products run over row chunks of about
    `CSR_CHUNK_NNZ` nonzeros. The forward matvec gathers: a dense (rows,
    s) gather and row sum when every row has the same nnz s (the tf-idf
    layout), else an exact segment sum over the row ids. The
    transpose-matvec runs on the device, float32 products summed in
    exact fixed point per column (`_ExactSum`, bit-reproducible where a
    float scatter-add is not), or, with csr_rmatvec='host', through
    scipy's CSR loops over the host copy. 'auto' takes the host on a CPU
    device, as the reference takes it on its CPU backend, and the device
    elsewhere. A batch of iterates or coefficients (L rows) runs the
    exact products once per row."""

    kind = 'csr'

    def __init__(self, X, device: torch.device, csr_rmatvec: str = 'auto',
                 memory_budget=None):
        if csr_rmatvec == 'auto':
            csr_rmatvec = 'host' if device.type == 'cpu' else 'device'
        if csr_rmatvec not in ('host', 'device'):
            raise ValueError(f'unknown csr_rmatvec {csr_rmatvec!r}')
        self.device_rmatvec = csr_rmatvec == 'device'
        X = _rowblocks.as_csr_matrix(X)
        self._host = X
        self.m, self.n = map(int, X.shape)
        data = np.asarray(X.data, np.float32)
        indices = np.asarray(X.indices, np.int32)
        indptr = np.asarray(X.indptr, np.int64)
        lens = np.diff(indptr)
        self._uniform = bool(self.m > 0 and np.all(lens == lens[0])
                             and lens[0] > 0)
        # A budget too small for one replica still gets one: 'auto'
        # streams such inputs instead (`make_oracle`).
        self._replicas = max(1, csr_replicas(*_csr_layout(X),
                                             memory_budget=memory_budget))
        slot = (indices + (X._rows % self._replicas) * self.n).astype(
            np.int32)
        if self._uniform:
            s = int(lens[0])
            self.data = torch.as_tensor(data.reshape(self.m, s),
                                        device=device)
            self.slot = torch.as_tensor(slot.reshape(self.m, s),
                                        device=device)
            self.rows = None
            step = max(1, CSR_CHUNK_NNZ // s)
            self._chunks = [(r0, min(r0 + step, self.m))
                            for r0 in range(0, self.m, step)]
        else:
            self.data = torch.as_tensor(data, device=device)
            self.slot = torch.as_tensor(slot, device=device)
            self.rows = torch.as_tensor(X._rows.astype(np.int32),
                                        device=device)
            # Nonzero ranges of whole rows, at most CSR_CHUNK_NNZ each (a
            # longer row alone).
            self._chunks, r0 = [], 0
            while r0 < self.m:
                r1 = int(np.searchsorted(indptr, indptr[r0] + CSR_CHUNK_NNZ,
                                         side='right')) - 1
                r1 = min(max(r1, r0 + 1), self.m)
                self._chunks.append((int(indptr[r0]), int(indptr[r1])))
                r0 = r1
        # Bounds of the exact sums: the row and column sums of |X| (of the
        # float32 values the device holds).
        absd = np.abs(data.astype(np.float64))
        self._row_abs = (None if self._uniform else torch.as_tensor(
            np.bincount(X._rows, absd, minlength=self.m), device=device))
        self._col_abs = torch.as_tensor(
            np.bincount(indices, absd, minlength=self.n), device=device)

    def matvec(self, w):
        if w.dim() == 2:
            return torch.stack([self.matvec(row) for row in w])
        n = self.n
        if self._uniform:
            out = torch.empty(self.m, dtype=f32, device=w.device)
            for r0, r1 in self._chunks:
                out[r0:r1] = (self.data[r0:r1]
                              * w[self.slot[r0:r1] % n]).sum(dim=1)
            return out
        acc = _ExactSum(self._row_abs * w.abs().max())
        for k0, k1 in self._chunks:
            acc.add(self.data[k0:k1] * w[self.slot[k0:k1] % n],
                    self.rows[k0:k1])
        return acc.result()

    def rmatvec(self, v):
        if v.dim() == 2:
            return torch.stack([self.rmatvec(row) for row in v])
        acc = _ExactSum(self._col_abs * v.abs().max(), self._replicas)
        if self._uniform:
            for r0, r1 in self._chunks:
                acc.add((self.data[r0:r1] * v[r0:r1, None]).view(-1),
                        self.slot[r0:r1].view(-1))
        else:
            for k0, k1 in self._chunks:
                acc.add(self.data[k0:k1] * v[self.rows[k0:k1]],
                        self.slot[k0:k1])
        return acc.result()

    def rmatvec_host(self, v: np.ndarray) -> np.ndarray:
        return self._host.rmatvec(v)


def _features(X, device: torch.device, csr_rmatvec: str = 'auto',
              memory_budget=None):
    if _rowblocks.is_sparse_input(X):
        return _CSRFeatures(X, device, csr_rmatvec=csr_rmatvec,
                            memory_budget=memory_budget)
    return _DenseFeatures(X, device)


def _toppush_loss_coeffs(p, y, g, inv_n):
    """The TopPush-style top-rank loss and its subgradient coefficients in
    one sorted pass, with no frequency vectors (DESIGN.md §12).

    Each ANCHORED example i (one with a strictly lower utility in its
    group) pays its margin against the highest score of that lower set:

        R(w) = (1/N+) sum_i hinge(1 + M_i - p_i),
        M_i  = max{p_k : g_k = g_i, y_k < y_i}

    One stable sort by (g, y) makes every lower set a prefix of its
    group's segment. M is a segmented running max: `torch.cummax` of an
    int64 key, the segment's start times m plus the score's stable rank,
    so a segment's keys exceed every earlier segment's. The coefficients
    put -1 on each active example and +1 on the LEFTMOST attainer of its
    lower set's max (the last new-max event at or before it, a running
    max of indices; `cummax`'s own indices do not promise the first of
    equal values), so they are exact, and equal to the reference's.
    Returns (loss, coeffs), with the subgradient X^T (coeffs * inv_n)."""
    m = p.shape[0]
    dev = p.device
    pf, yf = p.to(f32), y.to(f32)
    if m == 0:
        return pf.sum() * inv_n, torch.zeros((0,), dtype=f32, device=dev)
    gi = (torch.zeros((m,), dtype=torch.int32, device=dev) if g is None
          else g.to(torch.int32))
    order = _counts.lexsort(yf, gi)
    gs, ys, ps = gi[order], yf[order], pf[order]
    idx = torch.arange(m, device=dev)
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    g_change = torch.cat([one, gs[1:] != gs[:-1]])
    key_change = g_change | torch.cat([one, ys[1:] != ys[:-1]])
    del gs, ys
    seg_start = torch.cummax(torch.where(g_change, idx, -1), 0).values
    fr = torch.cummax(torch.where(key_change, idx, -1), 0).values
    del key_change
    # the running max inside each segment, by the stable rank of p
    rank_order = torch.sort(ps, stable=True).indices
    key = torch.empty_like(rank_order)
    key[rank_order] = idx
    key += seg_start * m
    running = ps[rank_order[torch.cummax(key, 0).values - seg_start * m]]
    del rank_order, key
    prev_run = torch.cat([ps[:1], running[:-1]])
    new_max = g_change | (ps > prev_run)
    del prev_run, g_change
    attain = torch.cummax(torch.where(new_max, idx, -1), 0).values
    del new_max
    # the strictly lower prefix of example t is [seg_start, fr)
    anchored = fr > seg_start
    safe = (fr - 1).clamp_(min=0)
    del fr, seg_start
    margin = 1.0 + running[safe] - ps
    active = anchored & (margin > 0)
    loss = torch.where(active, margin, 0.0).sum() * inv_n
    act = active.to(f32)
    coeffs = (-act).index_add_(0, torch.where(active, attain[safe], 0), act)
    out = torch.empty((m,), dtype=f32, device=dev)
    out[order] = coeffs
    return loss, out


def _loss_counter(y, g, engine: str, block: int, loss: str, v=None):
    """The counting pass of `loss` for fixed y (and g), made once per
    oracle: `p -> (c, d)` for the hinge, `p -> (c~, d)` for 'poshinge'
    (`counts.make_counter(v=)`), and `(p, inv_n) -> (loss, coeffs)` for
    'toppush', for which `engine` is inert. Each takes a batch of scores
    (L, m) as well, row by row (`counts.by_row`)."""
    if loss == 'toppush':
        return lambda p, inv_n: _counts.by_row(
            lambda q: _toppush_loss_coeffs(q, y, g, inv_n), p)
    return _counts.make_counter(y, g, engine=engine, block=block, v=v)


def _loss_and_coeffs(p, count, inv_n, v=None, loss: str = 'hinge'):
    """Scores -> (R_emp, subgradient coefficients), the counting core of
    every oracle; `count` is the loss's `_loss_counter`.

      'hinge'     c - d, and the Lemma 1 sum (c - d) p + c over N
      'poshinge'  c~ - v d, and sum (c~ - v d) p + c~ over W: Lemma 1 with
                  the c side weighted by the higher side's decay and the d
                  side by the example's own weight v
      'toppush'   the one-pass running max (`_toppush_loss_coeffs`)

    Scores (L, m), one row per lambda of a path, give (L,) losses and
    (L, m) coefficients."""
    if loss == 'toppush':
        return count(p, inv_n)
    c, d = count(p)
    # d, and c as an integer, go as soon as they are used: a batch of L
    # rows holds L such vectors.
    if loss == 'poshinge':
        cd = c - v * d.to(f32)
        del d
        return (cd * p + c).sum(dim=-1) * inv_n, cd
    cd = (c - d).to(f32)
    del d
    c = c.to(f32)
    return (cd * p + c).sum(dim=-1) * inv_n, cd


def _fused_step_impl(w, feats, count, inv_n, v=None, loss: str = 'hinge'):
    """The fused step: matvec -> counts -> loss -> subgradient, for one
    iterate w (n,) or a batch W (L, n)."""
    p = feats.matvec(w)
    loss_val, cd = _loss_and_coeffs(p, count, inv_n, v, loss)
    del p
    return loss_val, feats.rmatvec(cd * inv_n)


class _FusedOracle(RankOracle):
    """Shared machinery of the fused oracles. Subclasses pick the counting
    engine ('tree' | 'blocked' | 'pallas' | 'auto') through `_engine`; an
    explicit `engine=` overrides it. `memory_budget` (GiB) sizes a CSR
    input's accumulator replicas (`csr_replicas`)."""

    device_resident = True
    supports_device_solver = True
    supports_path_vmap = True
    _engine = 'tree'
    _block = 0          # only the blocked engine reads it
    _count = None       # the counter, made at the first step_fn

    def __init__(self, X, y, groups=None, csr_rmatvec: str = 'auto',
                 engine: str | None = None, engine_block: int = 2048,
                 loss: str = 'hinge', device=None, memory_budget=None):
        _validate_loss(loss)
        self.loss = loss
        self.device = resolve_device(device)
        if engine is not None:
            _counts._validate_engine(engine)
            self._engine = engine
            self.name = f'{self.name}[{engine}]'
        if loss != 'hinge':
            self.name = f'{self.name}/{loss}'
        y = _as_numpy(y, np.float32)
        self._feats = _features(X, self.device, csr_rmatvec=csr_rmatvec,
                                memory_budget=memory_budget)
        self.m, self.n = self._feats.m, self._feats.n
        if y.shape[0] != self.m:
            raise ValueError(f'X has {self.m} rows but y has {y.shape[0]}')
        if groups is not None:
            groups = _validate_groups(_as_numpy(groups, None), self.m)
            _warn_group_key_scale(groups, y, tol=1e-3, stacklevel=4)
        self.n_pairs = _exact_pairs(y, groups)
        if self.n_pairs == 0:
            raise ValueError('training data induces no preference pairs')
        self._y = torch.as_tensor(y, device=self.device)
        self._g = (None if groups is None
                   else torch.as_tensor(groups, device=self.device))
        # N+ and W vanish exactly when N does, so the check above gives
        # every loss a positive normalizer.
        norm, pw = ((self.n_pairs, None) if loss == 'hinge'
                    else _loss_norm_weights(y, groups, loss))
        self.norm = float(norm)
        self._pw = (None if pw is None
                    else torch.as_tensor(pw, dtype=f32, device=self.device))
        self._inv_n = 1.0 / self.norm
        self._inv_n_dev = torch.tensor(self._inv_n, dtype=f32,
                                       device=self.device)
        if engine is not None:
            self._block = (min(_counts._validate_block_rows(
                engine_block, 'engine block'), self.m)
                if engine == 'blocked' else 0)
        # A host transpose-matvec (csr_rmatvec='host') would be forced
        # onto the device by the device driver; solver='auto' then keeps
        # the host driver.
        self.prefer_device_solver = bool(self._feats.device_rmatvec)

    def _counter(self):
        """The loss's counter, made once per oracle: y is fixed, so its
        rank compression and level guard are not redone per step."""
        if self._count is None:
            self._count = _loss_counter(self._y, self._g, self._engine,
                                        self._block, self.loss, self._pw)
        return self._count

    def loss_and_subgrad(self, w):
        """(R_emp(w), a): tensors on the oracle's device, or, with a host
        transpose-matvec, the loss on the device and a as float64 numpy."""
        w = torch.as_tensor(w if torch.is_tensor(w) else np.asarray(w),
                            dtype=f32, device=self.device)
        feats = self._feats
        with full_f32():
            if feats.device_rmatvec:
                return self.step_fn()(w)
            loss, cd = _loss_and_coeffs(feats.matvec(w), self._counter(),
                                        self._inv_n_dev, self._pw,
                                        self.loss)
        return loss, feats.rmatvec_host(
            cd.cpu().numpy().astype(np.float64) * self._inv_n)

    def step_fn(self):
        """`w -> (loss, a)` on the device, for the BMRM drivers. It always
        finishes the transpose-matvec on the device: the device driver has
        no host to hand c - d to. The batched path sweep passes W (L, n)
        and gets (L,) losses and (L, n) subgradients: one product for the
        scores (dense features), the counting pass row by row, one
        product for the subgradients."""
        feats, count, inv_n = self._feats, self._counter(), self._inv_n_dev
        v, loss = self._pw, self.loss

        def fn(w):
            return _fused_step_impl(w, feats, count, inv_n, v, loss)

        return fn


class TreeOracle(_FusedOracle):
    """The paper's method: merge-sort-tree counts, O(ms + m log^2 m)/iter."""

    name = 'tree'
    _engine = 'tree'


class TopPushOracle(_FusedOracle):
    """The top-rank oracle by name: `TreeOracle(..., loss='toppush')`.
    Its one sorted pass counts nothing, so `engine=` is inert and kept
    for the interface's sake."""

    name = 'toppush'
    _engine = 'tree'

    def __init__(self, X, y, groups=None, csr_rmatvec: str = 'auto',
                 engine: str | None = None, engine_block: int = 2048,
                 device=None, memory_budget=None):
        super().__init__(X, y, groups=groups, csr_rmatvec=csr_rmatvec,
                         engine=engine, engine_block=engine_block,
                         loss='toppush', device=device,
                         memory_budget=memory_budget)
        self.name = self.name.replace('/toppush', '', 1)


class PairwiseOracle(_FusedOracle):
    """O(m^2) counting: the blocked pass (PairRSVM baseline) or, with
    dispatch='auto', `kernels.pairwise_rank.counts_auto`."""

    def __init__(self, X, y, groups=None, block: int = 2048,
                 dispatch: str = 'blocked', csr_rmatvec: str = 'auto',
                 engine: str | None = None, loss: str = 'hinge',
                 device=None, memory_budget=None):
        if dispatch not in ('blocked', 'auto'):
            raise ValueError(f'unknown dispatch {dispatch!r}')
        block = _counts._validate_block_rows(block, 'PairwiseOracle block')
        self._engine = 'blocked' if dispatch == 'blocked' else 'auto'
        self.name = 'pairs' if dispatch == 'blocked' else 'auto'
        super().__init__(X, y, groups=groups, csr_rmatvec=csr_rmatvec,
                         engine=engine, engine_block=block, loss=loss,
                         device=device, memory_budget=memory_budget)
        if engine is None:
            self._block = min(block, self.m) if dispatch == 'blocked' else 0


class GroupedOracle(_FusedOracle):
    """Per-query LTR: within-group pairs only, still one pass through the
    key-offset trick. `inner` picks the counting engine."""

    name = 'grouped'

    def __init__(self, X, y, groups, inner: str = 'tree', block: int = 2048,
                 csr_rmatvec: str = 'auto', engine: str | None = None,
                 loss: str = 'hinge', device=None, memory_budget=None):
        if groups is None:
            raise ValueError('GroupedOracle requires group ids')
        if inner not in ('tree', 'pairs', 'auto'):
            raise ValueError(f'unknown inner oracle {inner!r}')
        block = _counts._validate_block_rows(block, 'GroupedOracle block')
        self._engine = {'tree': 'tree', 'pairs': 'blocked',
                        'auto': 'auto'}[inner]
        self.name = f'grouped/{inner}'
        super().__init__(X, y, groups=groups, csr_rmatvec=csr_rmatvec,
                         engine=engine, engine_block=block, loss=loss,
                         device=device, memory_budget=memory_budget)
        if engine is None:
            self._block = min(block, self.m) if inner == 'pairs' else 0


# ------------------------------------------------------- streaming oracle


DEFAULT_STREAM_BLOCK = 8192


def _fetch_padded(src, B: int, m: int, n: int, i) -> np.ndarray:
    """Block i of `src` as a dense f32 (B, n) slab, zero-row padded at the
    ragged tail (pad rows score 0 and receive v = 0, so they never
    contribute; the score slice drops them before counting). Module
    level, so that `StreamingOracle.step_fn` closes over (src, B, m, n)
    and not over the oracle."""
    i = int(i)
    lo = i * B
    hi = min(lo + B, m)
    blk = np.asarray(src.block(lo, hi), np.float32)
    if hi - lo < B:
        blk = np.concatenate([blk, np.zeros((B - (hi - lo), n),
                                            np.float32)])
    return blk


# Peak bytes a streamed call's counting pass allocates per example beyond
# the O(m) vectors, for the losses whose pass is not the hinge's tree:
# the weighted tree (its level adds the weights' prefix sums and the
# sort's indices) and TopPush's sorts and running maxima. Upper bounds of
# the peaks measured on the card at m = 2^20
# (tests/test_torch_cuda.py::test_loss_counting_peaks_hold_their_charge).
LOSS_COUNT_BYTES = {'poshinge': 112, 'toppush': 112}


def _auto_stream_block(m: int, row_bytes: int, memory_budget,
                       count_bytes=None) -> int:
    """Rows per block from a GiB budget: reserve the O(m) per-example
    vectors (~6 f32 scalars each: p, y, c, d, c-d, v), spend at most half
    the remainder on the resident blocks; the other half stays headroom
    for the counting pass's temporaries. A counting pass that needs more
    (`count_bytes`, a loss's `LOSS_COUNT_BYTES` times m) takes that much
    instead, and the blocks get the rest. `row_bytes` is the source's
    layout-native per-row cost (`RowBlockSource.row_bytes`), times the
    blocks in flight."""
    if memory_budget is None:
        return max(1, min(DEFAULT_STREAM_BLOCK, max(m, 1)))
    budget = float(memory_budget) * 2**30
    overhead = 6 * 4 * m
    if budget <= overhead:
        warnings.warn(
            f'memory_budget={memory_budget:g} GiB cannot even hold the '
            f'mandatory O(m) score/coefficient vectors '
            f'(~{overhead / 2**30:.3g} GiB at m={m}); streaming will run '
            'with 1-row blocks, which is almost certainly not what you '
            'want: raise the budget or pass stream_block explicitly.',
            RuntimeWarning, stacklevel=3)
        return 1
    if count_bytes is None:
        b = int((budget - overhead) * 0.5 // max(row_bytes, 1))
    else:
        free = budget - overhead
        b = int((free - max(float(count_bytes), free * 0.5))
                // max(row_bytes, 1))
    return max(1, min(b, max(m, 1)))


class StreamingOracle(RankOracle):
    """Out-of-core oracle: two chunked passes over a `RowBlockSource`.

    The subgradient needs only O(m) scalars resident, the score vector
    and the pair-count coefficients, so the features never have to be.
    Each call is:

      pass 1  p = X w, block by block
      counts  one global counting pass on the device over the full score
              vector (`_loss_and_coeffs` with the oracle's engine; the
              default 'auto' tiers as the fused oracles do)
      pass 2  a = sum over blocks of X_block^T v_block, v = (c - d) / N

with the loss's counting pass and normalizer (`_loss_and_coeffs`) in
place of c - d and N for 'poshinge' and 'toppush'.

    Features can live in RAM, in CSR or in an `np.memmap` on disk
    (`data.rowblocks`). `prefetch=` (blocks of read-ahead; None/'auto'
    double-buffers memmap sources and stays synchronous otherwise)
    overlaps the next block's fetch with the current block's product on
    both surfaces; results are bit-identical at any depth for a given
    block size.

    Two surfaces, same math:
      * `loss_and_subgrad`: host passes (float64 numpy per-block
        products, sparse for CSR), counting on the device; what holds on
        the device is O(m) vectors and the counting pass's temporaries.
      * `step_fn`: the device driver's step, the same two passes as a
        Python loop that copies one padded dense slab at a time to the
        device and multiplies it there; each slab is dropped before the
        next is fetched and before the counting pass.

    `memory_budget` (GiB) sizes the blocks (`_auto_stream_block`), with
    the read-ahead's in-flight blocks counted against it, and the
    counting pass of 'poshinge' or 'toppush' charged at its own peak
    (`LOSS_COUNT_BYTES`).
    """

    name = 'stream'
    device_resident = False
    supports_device_solver = True
    prefer_device_solver = True
    supports_path_vmap = False   # its passes take one iterate at a time

    def __init__(self, X, y, groups=None, block_rows: int | None = None,
                 memory_budget: float | None = None, engine: str = 'auto',
                 prefetch=None, loss: str = 'hinge', device=None):
        _validate_loss(loss)
        self.loss = loss
        _counts._validate_engine(engine)
        self._engine = engine
        self._cblock = 2048 if engine == 'blocked' else 0
        self.device = resolve_device(device)
        y = _as_numpy(y, np.float32)
        self._src = _rowblocks.as_row_block_source(X)
        self._prefetch = resolve_prefetch(self._src, prefetch)
        self.m, self.n = self._src.m, self._src.n
        if y.shape[0] != self.m:
            raise ValueError(f'X has {self.m} rows but y has {y.shape[0]}')
        if groups is not None:
            groups = _validate_groups(_as_numpy(groups, None), self.m)
            _warn_group_key_scale(groups, y, tol=1e-3, stacklevel=3)
        self.n_pairs = _exact_pairs(y, groups)
        if self.n_pairs == 0:
            raise ValueError('training data induces no preference pairs')
        if block_rows is None:
            # In-flight read-ahead blocks count against the budget: depth
            # pending + 1 being consumed.
            block_rows = _auto_stream_block(
                self.m, self._src.row_bytes() * (1 + self._prefetch),
                memory_budget,
                None if loss == 'hinge' else LOSS_COUNT_BYTES[loss] * self.m)
        block_rows = _validate_block_rows(block_rows,
                                          'StreamingOracle block_rows')
        self._B = min(block_rows, self.m)
        self._nblk = self._src.n_blocks(self._B)
        self._y = torch.as_tensor(y, device=self.device)
        self._g = (None if groups is None
                   else torch.as_tensor(groups, device=self.device))
        norm, pw = ((self.n_pairs, None) if loss == 'hinge'
                    else _loss_norm_weights(y, groups, loss))
        self.norm = float(norm)
        self._pw = (None if pw is None
                    else torch.as_tensor(pw, dtype=f32, device=self.device))
        self._inv_n = 1.0 / self.norm
        self._inv_n_dev = torch.tensor(self._inv_n, dtype=f32,
                                       device=self.device)
        self._count = None
        self.name = f'stream/{self._src.kind}'
        if loss != 'hinge':
            self.name = f'{self.name}/{loss}'
        # The device step densifies one (block, n) slab per fetch; for
        # CSR sources the host passes stay sparse, so solver='auto' keeps
        # them on the host driver.
        self.prefer_device_solver = self._src.kind != 'csr'

    @property
    def block_rows(self) -> int:
        return self._B

    @property
    def prefetch(self) -> int:
        """Resolved read-ahead depth (0 = synchronous fetches)."""
        return self._prefetch

    def block_resident_bytes(self) -> int:
        """Peak feature bytes resident at any point of a pass, at the
        source's layout-native per-row cost (dense f32 slab; O(nnz_row)
        for CSR), counting the read-ahead's in-flight blocks (`prefetch`
        pending + 1 consumed); the O(m) vectors come on top. Forcing
        solver='device' on a CSR source densifies each slab to
        block_rows * n * 4 bytes instead."""
        return (1 + self._prefetch) * self._B * self._src.row_bytes()

    def _counter(self):
        if self._count is None:
            self._count = _loss_counter(self._y, self._g, self._engine,
                                        self._cblock, self.loss, self._pw)
        return self._count

    def loss_and_subgrad(self, w):
        """(R_emp(w), a): the loss as a device scalar, a as float64
        numpy."""
        src, B, depth = self._src, self._B, self._prefetch
        w64 = _as_numpy(w, np.float64)
        p = np.empty(self.m, np.float32)
        for lo, hi, payload in src.iter_payloads(B, prefetch=depth):
            p[lo:hi] = src._payload_matvec(payload, w64)
        with full_f32():
            loss, cd = _loss_and_coeffs(
                torch.as_tensor(p, device=self.device), self._counter(),
                self._inv_n_dev, self._pw, self.loss)
        v = cd.cpu().numpy().astype(np.float64) * self._inv_n
        del cd
        a = np.zeros(self.n, np.float64)
        for lo, hi, payload in src.iter_payloads(B, prefetch=depth):
            a += src._payload_rmatvec(payload, v[lo:hi])
        return loss, a

    def step_fn(self):
        """`w -> (loss, a)` on the device, for the device driver: each
        pass fetches the padded dense slabs (through a wraparound
        `_ReadAhead` when prefetching: the last block of the score pass
        warms block 0 of the gradient pass) and copies them to the device
        one at a time. The closure holds locals only, never the oracle."""
        B, n, m, nblk = self._B, self.n, self.m, self._nblk
        dev, count, inv_n = self.device, self._counter(), self._inv_n_dev
        pw, loss_name = self._pw, self.loss
        fetch = functools.partial(_fetch_padded, self._src, B, m, n)
        if self._prefetch and nblk > 1:
            # get(i) is exact for any access order (a miss fetches
            # synchronously), so correctness never leans on the order.
            fetch = _rowblocks._ReadAhead(fetch, nblk, self._prefetch,
                                          wrap=True).get

        def fn(w):
            w = w.to(device=dev, dtype=f32)
            p = torch.empty(nblk * B, dtype=f32, device=dev)
            for i in range(nblk):
                blk = torch.from_numpy(fetch(i)).to(dev)
                p[i * B:(i + 1) * B] = blk @ w
                del blk
            loss, cd = _loss_and_coeffs(p[:m], count, inv_n, pw, loss_name)
            v = torch.zeros(nblk * B, dtype=f32, device=dev)
            v[:m] = cd * inv_n
            del p, cd
            a = torch.zeros(n, dtype=f32, device=dev)
            for i in range(nblk):
                blk = torch.from_numpy(fetch(i)).to(dev)
                a += blk.T @ v[i * B:(i + 1) * B]
                del blk
            return loss, a

        return fn


# --------------------------------------------------------- sharded oracle


class ShardedOracle(RankOracle):
    """The oracle split over a mesh of ranks: `core.distributed`'s bodies
    (bf16 X split over rows and columns, gathered scores, the counting
    engine on the gathered keys, DESIGN.md §5) behind the `RankOracle`
    interface, so that `RankSVM(method='sharded')` and the BMRM drivers run
    it as any other oracle. Every rank of the mesh builds the oracle from
    the whole input and keeps its own block; each call is collective, and
    every rank gets the same (loss, a), a whole on every rank.

    `mesh` is a `launch.mesh.Mesh`; None takes `launch.mesh.default_mesh`
    on `device` (every rank of the process group on 'data', or the 1 x 1
    mesh without one). Group ids ride with y, and the counting pass folds
    them in through the key offsets. The products run on bf16 values (the
    pod-scale trade), so the counts see bf16-rounded scores and agree with
    the float32 oracles to about 1e-2, which BMRM tolerates as an inexact
    oracle.

    Three feature layouts (DESIGN.md §9):
      * dense (numpy or torch): the rank's rows and columns in bf16, the
        dense body.
      * CSR (`data.sparse.CSRMatrix`, scipy, a torch sparse tensor, a
        `CSRBlockSource`), named 'sharded/csr': stays sparse, the rank's
        rows padded to their widest row's slot count
        (`core.distributed.csr_slot_arrays`), O(nnz) products.
      * `np.memmap` or any other `RowBlockSource`, named
        'sharded/stream': each rank reads only its own rows, `block_rows`
        at a time, `prefetch` blocks ahead
        (`core.distributed.assemble_row_sharded`), and X is never whole
        on the host.

    Rows are padded to a multiple of the row group: pad rows have zero
    features, a group of their own and tied utilities, so they add no
    pair, no count and nothing to the loss or a.

    Like the fused oracles it runs on the device driver (`step_fn`, which
    takes a batch of iterates for the path sweep too). The bundle state is
    replicated on every rank (`core.bmrm`)."""

    name = 'sharded'
    device_resident = True
    supports_device_solver = True
    prefer_device_solver = True
    supports_path_vmap = True

    def __init__(self, X, y, groups=None, mesh=None, variant: str = 'base',
                 engine: str = 'tree', block_rows: int | None = None,
                 prefetch=None, loss: str = 'hinge', device=None):
        # The loss gate first: an unsupported loss fails before anything
        # below reads, pads or moves X.
        _validate_loss(loss)
        _dist.validate_sharded_loss(loss)
        self.loss = loss
        _counts._validate_engine(engine)
        _validate_prefetch(prefetch)
        if variant not in _dist.VARIANTS:
            raise ValueError(f'unknown variant {variant!r}; expected one of '
                             f'{_dist.VARIANTS}')
        if mesh is not None and device is not None and \
                torch.device(device).type != mesh.device.type:
            raise ValueError(f'device={device!r} but the mesh is on '
                             f'{mesh.device}')
        self.variant, self.engine = variant, engine
        y = _as_numpy(y, np.float32)
        src = None
        if isinstance(X, (np.memmap, _rowblocks.RowBlockSource)) and \
                not isinstance(X, _rowblocks.CSRBlockSource):
            src = _rowblocks.as_row_block_source(X)
            layout = 'stream'
            self.m, self.n = src.m, src.n
        else:
            if isinstance(X, _rowblocks.CSRBlockSource):
                X = X._X                     # the layout-native CSR object
            if _rowblocks.is_sparse_input(X):
                X = _rowblocks.as_csr_matrix(X)
                layout = 'csr'
            else:
                layout = 'dense'
                if not torch.is_tensor(X):
                    X = np.asarray(X)
                if X.ndim != 2:
                    raise ValueError('ShardedOracle features must be 2-D; '
                                     f'got shape {tuple(X.shape)}')
            self.m, self.n = map(int, X.shape)
        if y.shape[0] != self.m:
            raise ValueError(f'X has {self.m} rows but y has {y.shape[0]}')
        if groups is not None:
            groups = _validate_groups(_as_numpy(groups, None), self.m)
            # ~1e-2 tolerance: the bf16 products already round the scores.
            _warn_group_key_scale(groups, y, tol=1e-2, stacklevel=3)
        self.n_pairs = _exact_pairs(y, groups)
        if self.n_pairs == 0:
            raise ValueError('training data induces no preference pairs')
        self.norm = float(self.n_pairs)   # hinge only (the gate above)
        # A pair bound of |c_i - d_i|: the largest group's size less one.
        widest = (self.m if groups is None
                  else int(np.bincount(groups).max())) - 1
        self.mesh = mesh if mesh is not None else default_mesh(device)
        self.device = self.mesh.device
        msize = self.mesh.size('model')
        if self.n % msize:
            raise ValueError(
                f"mesh 'model' axis of size {msize} does not divide the "
                f'feature dim n={self.n}; pick a mesh whose model axis '
                'divides n (or pad the features upstream)')
        pad = (-self.m) % self.mesh.size(ROWS)
        if pad:
            y = np.concatenate([y, np.zeros(pad, np.float32)])
            base = groups if groups is not None else np.zeros(self.m,
                                                              np.int32)
            groups = np.concatenate([base, np.full(pad, int(base.max()) + 1,
                                                   np.int32)])
        self.block = blk = _dist.rank_block(self.mesh, self.m + pad, self.n)
        dev = self.device
        yd = torch.as_tensor(y, device=dev)
        gd = None if groups is None else torch.as_tensor(groups, device=dev)
        self._count = _dist.make_rank_counter(blk, yd, gd, variant=variant,
                                              engine=engine)
        r0, r1 = blk.rows
        lo, hi = min(r0, self.m), min(r1, self.m)   # the real rows
        if layout == 'csr':
            self.name = 'sharded/csr'
            rows = X.row_slice(lo, hi)
            data2, idx2 = _dist.csr_slot_arrays(
                rows.data, rows.indices, rows.indptr, (hi - lo, self.n),
                pad_rows=(r1 - r0) - (hi - lo))
            replicas = max(1, min(RMATVEC_REPLICAS, self.m + pad,
                                  (2**31 - 1) // max(self.n, 1)))
            base = (np.arange(r0, r1, dtype=np.int64) % replicas) * self.n
            slot = (idx2 + base[:, None]).astype(np.int32)
            # The transpose's bound: column sums of |data| (the bf16
            # values the products use) over every row of X.
            vals = torch.from_numpy(np.asarray(X.data, np.float32)).to(
                torch.bfloat16).to(torch.float64).abs().numpy()
            col_abs = torch.as_tensor(
                np.bincount(np.asarray(X.indices, np.int64), vals,
                            minlength=self.n), device=dev)
            bound = col_abs * (widest / self.n_pairs)
            self._body = _dist.make_csr_oracle_body(self.mesh, blk,
                                                    self._count, bound,
                                                    replicas)
            self._scores = functools.partial(_dist.csr_scores, n=self.n)
            self._transpose = functools.partial(
                _dist.csr_transpose, self.mesh, bound=bound,
                replicas=replicas)
            self._args = (
                torch.from_numpy(data2).to(torch.bfloat16).to(dev),
                torch.from_numpy(slot).to(dev))
        else:
            if layout == 'stream':
                self.name = 'sharded/stream'
                block_rows = _validate_block_rows(
                    block_rows if block_rows is not None
                    else DEFAULT_STREAM_BLOCK, 'ShardedOracle block_rows')
                Xb = _dist.assemble_row_sharded(
                    src, blk, dev, block_rows=min(block_rows, max(self.m, 1)),
                    prefetch=prefetch)
            else:
                c0, c1 = blk.cols
                part = X[lo:hi, c0:c1]
                part = (part.detach() if torch.is_tensor(part)
                        else torch.from_numpy(np.ascontiguousarray(part)))
                # float64 input is rounded to float32 first, as the
                # reference's inputs are, then to bf16.
                Xb = torch.zeros((r1 - r0, c1 - c0), dtype=torch.bfloat16,
                                 device=dev)
                Xb[:hi - lo] = part.to(dev).to(f32).to(torch.bfloat16)
            self._body = _dist.make_oracle_body(self.mesh, blk,
                                                self._count)
            self._scores = functools.partial(_dist.dense_scores, self.mesh,
                                             blk)
            self._transpose = functools.partial(_dist.dense_transpose,
                                                self.mesh)
            self._args = (Xb,)
        self._np = torch.tensor(float(self.n_pairs), dtype=f32, device=dev)

    def loss_and_subgrad(self, w):
        """(R_emp(w), a): a device scalar and a (n,) on the oracle's
        device, the same on every rank. Collective: every rank calls it
        with the same w."""
        w = torch.as_tensor(w if torch.is_tensor(w) else np.asarray(w),
                            dtype=f32, device=self.device)
        return self.step_fn()(w)

    def step_fn(self):
        """`w -> (loss, a)` over the rank's block, for the BMRM drivers; a
        batch W (L, n) gives (L,) losses and (L, n) subgradients. The
        closure holds the block's tensors, not the oracle."""
        body, args, n_pairs = self._body, self._args, self._np

        def fn(w):
            return body(*args, w, n_pairs)

        return fn

    def rank_counts(self, w):
        """(c, d) of the rank's rows at w, the counting pass of one call
        on its own, for checks against another mesh or the tree.
        Collective, as a call."""
        w = torch.as_tensor(w if torch.is_tensor(w) else np.asarray(w),
                            dtype=f32, device=self.device)
        p = self._scores(*self._args, w)
        return self._count(self.mesh.all_gather(p, ROWS, dim=-1))


def make_oracle(X, y, groups=None, method: str = 'tree', *,
                loss: str = 'hinge', engine: str | None = None,
                pair_block: int = 2048, csr_rmatvec: str = 'auto',
                memory_budget: float | None = None,
                stream_block: int | None = None, prefetch=None,
                device=None, mesh=None,
                variant: str = 'base') -> RankOracle:
    """Build the RankOracle for (X, y[, groups]) selected by `method`.

      method    oracle            features resident    counting engine
                                                       (engine= overrides)
      'tree'    TreeOracle        all of X             merge-sort tree
      'pairs'   PairwiseOracle    all of X             blocked O(m^2)
      'auto'    PairwiseOracle    all of X             counts_auto: on the
                or StreamingOracle (budget rule)       card the pairwise
                                                       kernel to
                                                       KERNEL_MAX_M
                                                       examples,
                                                       rank-counts above;
                                                       the tree elsewhere
      'stream'  StreamingOracle   one block + O(m)     'auto'
      'sharded' ShardedOracle     the rank's block     'tree' on the
                                  (bf16, or CSR slots) gathered scores

    X is dense (numpy, torch), CSR (`data.sparse.CSRMatrix`, scipy, a
    torch sparse tensor), an `np.memmap` or a `data.rowblocks`
    `RowBlockSource`. `groups=` routes the first three through
    GroupedOracle with the same engine, and works natively on 'stream'.
    `engine=` is one of `counts.ENGINES`; 'pallas' is the rank-counts
    kernel. `csr_rmatvec` ('auto' | 'host' | 'device') places a fused
    CSR oracle's transpose-matvec. `device` defaults to 'cuda'.

    `loss` is 'hinge', 'toppush' or 'poshinge' (DESIGN.md §12) for every
    method; `TopPushOracle` is the top-rank oracle by name.

    method='auto' streams when the projected fused residency
    (`data.rowblocks.projected_resident_gib`) exceeds `memory_budget`
    GiB, when a CSR input's transpose-matvec would not fit one
    accumulator replica beside it (`csr_replicas`), and always for an
    `np.memmap` or a `RowBlockSource`; otherwise it keeps the fused
    counts_auto oracle, whose replicas the budget sizes. `stream_block`
    (rows) defaults to the budget-derived size (`_auto_stream_block`);
    `prefetch` (None/'auto' | int >= 0) is the streaming oracle's
    read-ahead depth and is ignored by the fused oracles.

    method='sharded' takes every layout (dense, CSR kept sparse, memmap
    and row-block sources read rank by rank), `groups=`, `mesh=` (a
    `launch.mesh.Mesh`; default `launch.mesh.default_mesh(device)`),
    `variant=` ('base' | 'opt': the tree's queries split over the ranks)
    and every engine, and the hinge only: another loss raises before X
    is touched. `stream_block` and `prefetch` size its streamed reads."""
    if method not in METHODS:
        raise ValueError(f'unknown oracle method {method!r}; '
                         f'expected one of {METHODS}')
    _validate_loss(loss)
    if method == 'sharded':
        _dist.validate_sharded_loss(loss)
    if engine is not None:
        _counts._validate_engine(engine)
    _validate_prefetch(prefetch)
    if method == 'sharded':
        return ShardedOracle(X, y, groups=groups, mesh=mesh, variant=variant,
                             engine=engine if engine is not None else 'tree',
                             block_rows=stream_block, prefetch=prefetch,
                             loss=loss, device=device)
    stream_only = isinstance(X, (_rowblocks.RowBlockSource, np.memmap))
    if method == 'auto' and not stream_only and memory_budget is not None:
        if _rowblocks.projected_resident_gib(X) > float(memory_budget) or (
                _rowblocks.is_sparse_input(X) and csr_replicas(
                    *_csr_layout(X), memory_budget=memory_budget) == 0):
            method = 'stream'
    if method == 'stream' or (method == 'auto' and stream_only):
        return StreamingOracle(X, y, groups=groups, block_rows=stream_block,
                               memory_budget=memory_budget,
                               engine=engine if engine is not None
                               else 'auto', prefetch=prefetch, loss=loss,
                               device=device)
    if isinstance(X, _rowblocks.RowBlockSource):
        raise ValueError(
            f"method={method!r} needs materialized features, but X is a "
            f'{type(X).__name__} row-block source; train it with '
            "method='stream' or 'sharded' (or 'auto', which streams such "
            'sources)')
    kw = dict(csr_rmatvec=csr_rmatvec, engine=engine, loss=loss,
              device=device, memory_budget=memory_budget)
    if groups is not None:
        return GroupedOracle(X, y, groups, inner=method, block=pair_block,
                             **kw)
    if method == 'tree':
        return TreeOracle(X, y, engine_block=pair_block, **kw)
    return PairwiseOracle(
        X, y, block=pair_block,
        dispatch='auto' if method == 'auto' else 'blocked', **kw)


def empirical_risk(scores, utilities, groups=None, loss: str = 'hinge',
                   device=None) -> float:
    """R_emp for precomputed scores, the risk the oracles minimize under
    `loss`: the mean pairwise hinge over the N pairs ('hinge'), the mean
    anchored top-rank margin over N+ ('toppush'), or the
    position-weighted pair hinge over the weight W ('poshinge'), through
    the tree. Returns a host float; 0.0 when the data induces no
    preference pairs."""
    _validate_loss(loss)
    dev = resolve_device(device)
    y = _as_numpy(utilities, np.float32)
    if groups is not None:
        groups = _validate_groups(_as_numpy(groups, None), y.shape[0])
    norm, pw = _loss_norm_weights(y, groups, loss)
    if norm == 0:
        return 0.0
    p = (scores.detach().to(device=dev, dtype=f32) if torch.is_tensor(scores)
         else torch.as_tensor(np.asarray(scores, np.float32), device=dev))
    g = None if groups is None else torch.as_tensor(groups, device=dev)
    v = None if pw is None else torch.as_tensor(pw, dtype=f32, device=dev)
    count = _loss_counter(torch.as_tensor(y, device=dev), g, 'tree', 0,
                          loss, v)
    val, _ = _loss_and_coeffs(p, count, torch.tensor(
        1.0 / float(norm), dtype=f32, device=dev), v, loss)
    return float(val)
