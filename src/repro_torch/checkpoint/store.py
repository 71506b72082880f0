"""Sharded, restart-safe checkpoint store: the port of
`repro.checkpoint.store`, with the same API, directory layout and
two-phase commit, and a shard encoding of its own.

Layout (one directory per step):

    <root>/step_00000042/
        meta.json                 # step, leaves: path, shape, dtype and
                                  # each chunk's shard, offset, length
        shard_00000_of_00004.bin  # the chunks' raw bytes back to back
                                  # (zstd-framed when compressed)
        COMMITTED                 # written LAST: the visibility marker

* Each host writes only the shards it owns (`shard_filter`); a single
  process writes everything and commits. `latest_step` skips
  directories without the marker, so a crash mid-save is harmless.
* Leaves are stored whole (chunked in 64 MiB pieces striped over the
  shards), independent of where they lived: a restore places each leaf
  on the device it is asked for.
* `gc` keeps the newest `keep` committed steps.

Where the reference packs each shard's chunks with msgpack, a shard here
is the chunks' bytes back to back and meta.json records where each one
lies, so a restore reads a leaf with one seek per chunk and the store
needs nothing beyond the standard library, numpy and torch.
compression='auto' is zstd where the optional `zstandard` package
imports and 'none' elsewhere; 'zstd' without it raises.

A tree is nested dicts, lists, tuples and NamedTuples (a `BundleState`,
a train state) whose leaves are torch tensors, numpy arrays or numbers;
an `nn.Module` counts as the dict of its `state_dict`. bfloat16 is
stored as its 16-bit pattern (dtype 'bfloat16', as the reference's) and
comes back bit-exact.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

try:
    import zstandard
except ImportError:            # optional: only needed for compression='zstd'
    zstandard = None

_CHUNK = 1 << 26               # 64 MiB raw chunks inside a shard file
_LEVEL = 3
_ZSTD_MAGIC = b'\x28\xb5\x2f\xfd'   # zstd frame header
RESERVED_META = frozenset({'step', 'n_shards', 'compression', 'leaves'})


def _require_zstandard(what: str):
    if zstandard is None:
        raise ModuleNotFoundError(
            f'{what} requires the optional `zstandard` package '
            f"(pip install zstandard, or the project's [compression] "
            f"extra); pass compression='none' to save uncompressed.")
    return zstandard


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, '_fields')


def _children(node):
    """(key, child) pairs of a container node, or None for a leaf. Dict
    keys are visited sorted, as `jax.tree` visits them."""
    if isinstance(node, torch.nn.Module):
        node = node.state_dict(keep_vars=True)
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node, key=str)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten(tree, prefix: str = ''):
    """[(path, leaf)] of a tree, paths '/'-joined keys."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out.extend(flatten(child, f'{prefix}/{key}' if prefix else key))
    return out


def _host_array(leaf) -> 'tuple[np.ndarray, str]':
    """(host numpy array, dtype name) of a leaf, as a copy that no later
    in-place update of the leaf can reach; bfloat16 as its int16 bits."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).to('cpu', copy=True).numpy(),
                    'bfloat16')
        a = t.to('cpu', copy=True).numpy()
        return a, str(a.dtype)
    a = np.array(leaf, copy=True)
    return a, str(a.dtype)


def snapshot(tree):
    """[(path, host array, dtype name)] of a tree: every leaf copied to
    host memory now (what `AsyncCheckpointer.save` hands its thread)."""
    return [(p, *_host_array(leaf)) for p, leaf in flatten(tree)]


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f'step_{step:08d}')


def _shard_name(sid: int, n_shards: int) -> str:
    return f'shard_{sid:05d}_of_{n_shards:05d}.bin'


def _write_atomic(path: str, data: bytes) -> None:
    with open(path + '.tmp', 'wb') as f:
        f.write(data)
    os.replace(path + '.tmp', path)


def save(root: str, step: int, tree, *, n_shards: int = 1,
         shard_filter=None, compression: str = 'auto',
         meta_extra: dict | None = None) -> str:
    """Write `tree` as checkpoint `step` under `root`; returns its
    directory.

    n_shards: shard files the leaves' chunks are striped over.
    shard_filter: optional `shard_id -> bool`; a host writes only the
      shards it owns, and then one designated host calls `commit` after
      a barrier. Without it the checkpoint is committed here.
    compression: 'zstd' | 'none' | 'auto' (zstd where `zstandard`
      imports, else none); 'zstd' without the package raises
      ModuleNotFoundError.
    meta_extra: JSON-serializable entries merged into meta.json (and
      handed back by `restore`); the store's own keys ('step',
      'n_shards', 'compression', 'leaves') are rejected."""
    return _save_snapshot(root, step, snapshot(tree), n_shards=n_shards,
                          shard_filter=shard_filter, compression=compression,
                          meta_extra=meta_extra)


def _save_snapshot(root, step, snap, *, n_shards=1, shard_filter=None,
                   compression='auto', meta_extra=None) -> str:
    if meta_extra:
        clash = RESERVED_META & set(meta_extra)
        if clash:
            raise ValueError(f'meta_extra may not override reserved meta '
                             f'keys {sorted(clash)}')
    if compression == 'auto':
        compression = 'zstd' if zstandard is not None else 'none'
    if compression not in ('zstd', 'none'):
        raise ValueError(f'unknown compression {compression!r}')
    cctx = (_require_zstandard("compression='zstd'")
            .ZstdCompressor(level=_LEVEL) if compression == 'zstd' else None)
    n_shards = int(n_shards)
    d = _step_dir(root, step)
    os.makedirs(d, exist_ok=True)

    meta = {'step': int(step), 'n_shards': n_shards,
            'compression': compression, 'leaves': []}
    if meta_extra:
        meta.update(meta_extra)
    shards = [[] for _ in range(n_shards)]   # per shard: chunk buffers
    sizes = [0] * n_shards
    for li, (path, a, dtype) in enumerate(snap):
        buf = memoryview(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
        recs = []
        for ci, o in enumerate(range(0, max(len(buf), 1), _CHUNK)):
            piece = buf[o:o + _CHUNK]
            sid = (li + ci) % n_shards
            recs.append({'shard': sid, 'offset': sizes[sid],
                         'length': len(piece)})
            shards[sid].append(piece)
            sizes[sid] += len(piece)
        meta['leaves'].append({'path': path, 'shape': list(a.shape),
                               'dtype': dtype, 'nbytes': len(buf),
                               'chunks': recs})

    for sid in range(n_shards):
        if shard_filter is not None and not shard_filter(sid):
            continue
        fn = os.path.join(d, _shard_name(sid, n_shards))
        with open(fn + '.tmp', 'wb') as f:
            if cctx is None:
                for piece in shards[sid]:
                    f.write(piece)
            else:
                with cctx.stream_writer(f, closefd=False) as zf:
                    for piece in shards[sid]:
                        zf.write(piece)
        os.replace(fn + '.tmp', fn)

    _write_atomic(os.path.join(d, 'meta.json'), json.dumps(meta).encode())
    if shard_filter is None:
        commit(root, step)
    return d


def commit(root: str, step: int) -> None:
    """Write the visibility marker (once, after every host saved)."""
    with open(os.path.join(_step_dir(root, step), 'COMMITTED'), 'w') as f:
        f.write('ok')


def _committed_steps(root: str) -> list:
    if not os.path.isdir(root):
        return []
    return sorted(
        int(name.split('_')[1]) for name in os.listdir(root)
        if name.startswith('step_')
        and os.path.exists(os.path.join(root, name, 'COMMITTED')))


def latest_step(root: str) -> int | None:
    """Largest committed step under root, or None."""
    steps = _committed_steps(root)
    return steps[-1] if steps else None


class _Shards:
    """Reads chunks out of a checkpoint's shard files: by seeking into an
    uncompressed shard, from the decompressed bytes of a zstd one (told
    apart by the zstd frame magic, per shard, so shards written by hosts
    with and without `zstandard` can mix)."""

    def __init__(self, d: str, n_shards: int):
        self._d, self._n = d, n_shards
        self._files, self._inflated = {}, {}

    def read(self, sid: int, offset: int, length: int) -> bytes:
        if sid in self._inflated:
            return self._inflated[sid][offset:offset + length]
        f = self._files.get(sid)
        if f is None:
            f = open(os.path.join(self._d, _shard_name(sid, self._n)), 'rb')
            self._files[sid] = f
            if f.read(4) == _ZSTD_MAGIC:
                f.seek(0)
                dctx = _require_zstandard(
                    'restoring a zstd-compressed shard').ZstdDecompressor()
                self._inflated[sid] = dctx.stream_reader(f).read()
                return self.read(sid, offset, length)
        f.seek(offset)
        return f.read(length)

    def close(self):
        for f in self._files.values():
            f.close()


def _leaf_tensor(rec, shards: _Shards) -> torch.Tensor:
    """One stored leaf as a CPU tensor of its dtype."""
    raw = bytearray(rec['nbytes'])
    at = 0
    for c in rec['chunks']:
        piece = shards.read(c['shard'], c['offset'], c['length'])
        raw[at:at + len(piece)] = piece
        at += len(piece)
    dt = rec['dtype']
    if dt == 'bfloat16':
        a = np.frombuffer(raw, np.int16)
        t = torch.from_numpy(a.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(raw, np.dtype(dt)).copy())
    return t.reshape(rec['shape'])


def _place(t: torch.Tensor, like_leaf, device):
    """A restored CPU tensor in the form of `like_leaf`: a tensor on
    `device` (default: the like tensor's device, the CPU for a meta one),
    a numpy array, or a Python number."""
    if torch.is_tensor(like_leaf):
        dev = device
        if dev is None:
            dev = ('cpu' if like_leaf.device.type == 'meta'
                   else like_leaf.device)
        return t.to(dev)
    if isinstance(like_leaf, (bool, int, float)):
        return type(like_leaf)(t.item())
    return t.numpy() if t.dtype != torch.bfloat16 else t


def _rebuild(like, values: dict, prefix: str = ''):
    """`like`'s structure with each leaf replaced by values[path]; an
    `nn.Module` loads its entries in place (`load_state_dict(assign=
    True)`, so that a module on the meta device gets the restored
    tensors themselves)."""
    if isinstance(like, torch.nn.Module):
        sd = like.state_dict(keep_vars=True)
        like.load_state_dict(
            {k: _rebuild(v, values, f'{prefix}/{k}' if prefix else k)
             for k, v in sd.items()}, strict=True, assign=True)
        return like
    def sub(key, child):
        return _rebuild(child, values, f'{prefix}/{key}' if prefix else key)

    if isinstance(like, dict):
        return {k: sub(str(k), v) for k, v in like.items()}
    kids = _children(like)
    if kids is None:
        return values[prefix]
    built = [sub(key, child) for key, child in kids]
    if _is_namedtuple(like):
        return type(like)(*built)
    return type(like)(built)


def restore(root: str, step: int | None = None, *, like=None, device=None):
    """Load checkpoint `step` (default: the latest committed one).

    Without `like`: `({path: CPU tensor}, meta)` (or on `device`). With
    `like` (a tree of the state's structure: its tensors may be on the
    meta device, so that nothing is allocated before the restore), the
    stored leaves are mapped onto its paths and each is placed on
    `device` once (default: the like leaf's own device, the CPU for a
    meta one): `(tree, meta)`. A leaf missing from the checkpoint raises
    KeyError, a shape mismatch ValueError."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f'no committed checkpoint under {root}')
    d = _step_dir(root, step)
    with open(os.path.join(d, 'meta.json')) as f:
        meta = json.load(f)
    recs = {rec['path']: rec for rec in meta['leaves']}
    shards = _Shards(d, meta['n_shards'])
    try:
        if like is None:
            return ({p: _leaf_tensor(rec, shards).to(device or 'cpu')
                     for p, rec in recs.items()}, meta)
        values = {}
        for p, leaf in flatten(like):
            if p not in recs:
                raise KeyError(f'checkpoint missing leaf {p!r}')
            rec = recs[p]
            want = tuple(np.shape(leaf)) if not torch.is_tensor(leaf) \
                else tuple(leaf.shape)
            if tuple(rec['shape']) != want:
                raise ValueError(f'leaf {p}: checkpoint {tuple(rec["shape"])}'
                                 f' != model {want}')
            values[p] = _place(_leaf_tensor(rec, shards), leaf, device)
        return _rebuild(like, values), meta
    finally:
        shards.close()


def gc(root: str, keep: int) -> list:
    """Delete all but the newest `keep` committed checkpoints; returns
    the deleted steps."""
    steps = _committed_steps(root)
    drop = steps[:-keep] if keep > 0 else []
    for s in drop:
        shutil.rmtree(_step_dir(root, s), ignore_errors=True)
    return drop
