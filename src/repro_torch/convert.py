"""Carry a model and its state from the JAX package to the port.

`from_reference(w, bundle_state)` takes what the JAX package holds as
plain numpy arrays: `RankSVM.w_`, and optionally the fields of a
`repro.core.bmrm.BundleState` (the device driver's fixed-capacity plane
buffer, e.g. `{f: np.asarray(getattr(state, f)) for f in state._fields}`).
It returns the port's `RankSVM` with `w_` set and the same state as a
torch `BundleState` on `device`, so the two packages score alike and
take the same next BMRM step from there. Nothing of the JAX package is
imported: the arguments are numpy arrays or anything numpy can read.
The same call carries the L-leading state of a batched path sweep (the
reference's `init_path_state` or a vmap result's fields): every field
keeps its leading lambda axis, so `bmrm_path`'s batched driver of either
package can start from one state. `path_point_from_reference(point)`
carries a reference `PathPoint` (lam, w, report) across.

`lm_params_from_reference(tree)` does the same for an LM: it takes the
reference's parameter pytree (nested dicts, layers stacked) as float32
numpy arrays and returns the port's `state_dict` in bf16, for
`models.lm.from_state_dict`. `lm_cache_from_reference(cache)` carries a
decode cache (RWKV-6 states, or attention keys and values), so both
packages decode from the same state. `pad_cache(cache, capacity)` grows a
prefill's attention cache (S = T positions) to a decode capacity, zeros
past T, as the reference's serving loop and tests pad theirs. A model
with a dense layer 0 declared apart carries its 'layer0' keys across
as they are, and its cache's first layer is layer 0's, in both
packages.
`train_state_from_reference(state, cfg)` carries a whole train state
(parameters, AdamW master/m/v and count, step), so both packages take
the same train step from it.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.bmrm import BundleState
from .core.ranksvm import FitReport, PathPoint, RankSVM
from .kernels.platform import resolve_device
from .models.lm import from_state_dict, state_dict_from_tree

_DTYPES = {'n_active': torch.int32, 'done': torch.bool}


def bundle_state_from_arrays(fields, device=None) -> BundleState:
    """A torch `BundleState` from a mapping (or namedtuple) of arrays with
    the reference's field names: one lambda's state, or a batched one
    with a leading lambda axis on every field."""
    dev = resolve_device(device)
    if hasattr(fields, '_asdict'):
        fields = fields._asdict()
    missing = [f for f in BundleState._fields if f not in fields]
    if missing:
        raise ValueError(f'bundle state lacks fields {missing}')
    state = BundleState(**{
        f: torch.as_tensor(np.array(fields[f]),
                           dtype=_DTYPES.get(f, torch.float32), device=dev)
        for f in BundleState._fields})
    lead = tuple(state.j_best.shape)
    for f, t in zip(BundleState._fields, state):
        if tuple(t.shape[:len(lead)]) != lead:
            raise ValueError(f'bundle state field {f} has shape '
                             f'{tuple(t.shape)}; every field must lead '
                             f'with j_best\'s {lead}')
    return state


def path_point_from_reference(point) -> PathPoint:
    """The port's `PathPoint` from a reference `PathPoint`: lam, w as
    float64 numpy and the report's fields, copied."""
    rep = point.report
    report = FitReport(**{f: getattr(rep, f)
                          for f in FitReport.__dataclass_fields__})
    report.loss_history = [float(x) for x in report.loss_history]
    return PathPoint(lam=float(point.lam),
                     w=np.asarray(point.w, np.float64).copy(),
                     report=report)


def from_reference(w, bundle_state=None, *, device=None, **ranksvm_kwargs):
    """(RankSVM with `w_` = w, BundleState or None) on `device`.

    `ranksvm_kwargs` are the estimator's arguments (lam, eps, method, ...),
    which should match the reference estimator's for the next step to be
    the same."""
    svm = RankSVM(device=device, **ranksvm_kwargs)
    w = np.asarray(w, np.float64).ravel()
    svm.w_ = w
    state = (None if bundle_state is None
             else bundle_state_from_arrays(bundle_state, svm.device))
    if state is not None and state.w.shape[0] != w.shape[0]:
        raise ValueError(f'w has {w.shape[0]} features but the bundle '
                         f'state {state.w.shape[0]}')
    return svm, state


def _tree_to_torch(tree, dev, dtype=torch.bfloat16):
    return {k: (_tree_to_torch(v, dev, dtype) if isinstance(v, dict) else
                torch.as_tensor(np.array(v, np.float32)).to(dev, dtype))
            for k, v in tree.items()}


def lm_params_from_reference(tree, *, device=None, dtype=torch.bfloat16):
    """The port's LM state_dict from the reference's parameter pytree.

    Leaves are numpy arrays that read as float32 (a bf16 JAX array cast
    to float32 first, which is exact); they are cast to `dtype` and the
    leading layer axis of 'layers' is unstacked."""
    return state_dict_from_tree(_tree_to_torch(tree, resolve_device(device),
                                               dtype))


def train_state_from_reference(state, cfg, *, device=None,
                               dtype=torch.bfloat16):
    """The port's train state (`train.trainer`) from the reference's:
    {'params': tree, 'opt': {'mu': tree of {'master', 'm', 'v'},
    'count'}, 'step'} with numpy leaves that read as float32 (ints for
    count and step). The parameters become an `LM` of `cfg` in `dtype`
    (the reference state's parameter dtype); master, m and v stay
    float32, keyed by the port's parameter names. Nothing is shared with
    the arguments."""
    dev = resolve_device(device)
    model = from_state_dict(cfg, lm_params_from_reference(
        state['params'], device=dev, dtype=dtype))
    mu = {}
    for part in ('master', 'm', 'v'):
        tree = _pick(state['opt']['mu'], part)
        for name, val in state_dict_from_tree(
                _tree_to_torch(tree, dev, torch.float32)).items():
            mu.setdefault(name, {})[part] = val.clone()

    def scalar(x):
        return torch.as_tensor(np.array(x, np.int32), device=dev)
    return {'params': model,
            'opt': {'mu': mu, 'count': scalar(state['opt']['count'])},
            'step': scalar(state['step'])}


def _pick(tree, part):
    """The tree of `part` leaves from a tree whose leaves are
    {'master', 'm', 'v'} dicts."""
    if set(tree) == {'master', 'm', 'v'}:
        return tree[part]
    return {k: _pick(v, part) for k, v in tree.items()}


def lm_cache_from_reference(cache, *, device=None):
    """The port's decode cache from the reference's: 's' float32,
    'tm_last' and 'cm_last' bf16 (RWKV-6), 'k' and 'v' bf16 (attention),
    or 'ckv' and 'krope' bf16 (MLA), layers stacked as in both
    packages."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v, np.float32)).to(
        dev, torch.float32 if k == 's' else torch.bfloat16)
        for k, v in cache.items()}


def pad_cache(cache, capacity: int):
    """A decode cache of `capacity` positions from a prefill's cache: the
    attention entries 'k' and 'v' (L, B, T, G, hd), or MLA's 'ckv' (L, B,
    T, lora) and 'krope' (L, B, T, r), are copied into zeros of `capacity`
    positions on their device; any other entry (an RWKV-6 state, which
    does not grow) is passed through. Decode then writes into the result
    in place."""
    out = {}
    for key, val in cache.items():
        if key in ('k', 'v', 'ckv', 'krope'):
            t = val.shape[2]
            if t > capacity:
                raise ValueError(f'a cache of {t} positions does not fit a '
                                 f'capacity of {capacity}')
            grown = val.new_zeros(val.shape[:2] + (capacity,)
                                  + val.shape[3:])
            grown[:, :, :t] = val
            val = grown
        out[key] = val
    return out
