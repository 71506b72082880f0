"""The port's checkpoint store and async checkpointer
(`repro_torch.checkpoint`): the eight cases of tests/test_checkpoint.py
on torch trees, then what the port adds: a bf16 round trip bit for bit,
the reserved `meta_extra` keys, the encoding (meta.json offsets into raw
shards, zstd only where `zstandard` imports), NamedTuple and module
trees restored from a structure on the meta device, and the
checkpointer's snapshot taken before `save` returns."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from repro_torch.checkpoint import (AsyncCheckpointer, commit, gc,  # noqa: E402
                                    latest_step, restore, save, store)
from repro_torch.core import bmrm as TB  # noqa: E402
from torch_parity import torch_one_thread  # noqa: E402,F401


def _tree():
    return {'a': torch.arange(12, dtype=torch.float32).reshape(3, 4),
            'n': {'b': torch.ones((5,), dtype=torch.bfloat16),
                  'step': torch.tensor(3, dtype=torch.int32)}}


def _like(tree):
    return {k: _like(v) if isinstance(v, dict)
            else torch.empty(v.shape, dtype=v.dtype, device='meta')
            for k, v in tree.items()}


def _leaves(tree):
    return [leaf for _, leaf in store.flatten(tree)]


def test_roundtrip(tmp_path):
    t = _tree()
    save(str(tmp_path), 7, t)
    out, meta = restore(str(tmp_path), like=_like(t))
    assert meta['step'] == 7
    for a, b in zip(_leaves(t), _leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_roundtrip_multi_shard(tmp_path):
    t = {'big': torch.arange(100000, dtype=torch.float32)}
    save(str(tmp_path), 1, t, n_shards=4)
    out, _ = restore(str(tmp_path), like=_like(t))
    assert torch.equal(out['big'], t['big'])


def test_uncommitted_checkpoints_invisible(tmp_path):
    t = _tree()
    save(str(tmp_path), 5, t)
    # a crash mid-save of step 9: shards written, no COMMITTED marker
    save(str(tmp_path), 9, t, shard_filter=lambda s: True)
    assert latest_step(str(tmp_path)) == 5
    commit(str(tmp_path), 9)
    assert latest_step(str(tmp_path)) == 9


def test_gc_keeps_newest(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4):
        save(str(tmp_path), s, t)
    assert gc(str(tmp_path), keep=2) == [1, 2]
    assert latest_step(str(tmp_path)) == 4
    restore(str(tmp_path), 3, like=_like(t))     # still present


def test_restore_shape_mismatch_raises(tmp_path):
    save(str(tmp_path), 1, {'a': torch.zeros(3)})
    with pytest.raises(ValueError):
        restore(str(tmp_path), like={'a': torch.empty(4, device='meta')})


def test_restore_missing_leaf_raises(tmp_path):
    save(str(tmp_path), 1, {'a': torch.zeros(3)})
    with pytest.raises(KeyError):
        restore(str(tmp_path), like={'zz': torch.empty(3, device='meta')})


def test_async_checkpointer_overlaps_and_persists(tmp_path):
    t = _tree()
    with AsyncCheckpointer(str(tmp_path), keep=2) as ck:
        ck.save(1, t)
        ck.save(2, t)       # waits for 1 internally
        ck.save(3, t)
    assert latest_step(str(tmp_path)) == 3
    steps = sorted(d for d in os.listdir(str(tmp_path))
                   if d.startswith('step_'))
    assert len(steps) == 2   # gc keep=2


def test_async_checkpointer_surfaces_errors(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path / 'missing' / ('x' * 300)), keep=1)
    ck.save(1, _tree())
    with pytest.raises(Exception):
        ck.wait()


# ------------------------------------------------------- port additions


@pytest.mark.parametrize('compression', ['none', 'auto'])
def test_bf16_round_trip_bit_exact(tmp_path, compression):
    """Every bf16 pattern, NaNs, infinities and subnormals included,
    comes back bit for bit (stored as its 16-bit pattern)."""
    bits = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16)
    t = {'w': bits.view(torch.bfloat16).reshape(256, 256)}
    save(str(tmp_path), 1, t, compression=compression)
    out, meta = restore(str(tmp_path))
    assert meta['leaves'][0]['dtype'] == 'bfloat16'
    got = out['w']
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), t['w'].view(torch.int16))


def test_meta_extra_reserved_keys(tmp_path):
    for key in ('step', 'n_shards', 'compression', 'leaves'):
        with pytest.raises(ValueError, match='reserved'):
            save(str(tmp_path), 1, _tree(), meta_extra={key: 0})
    assert latest_step(str(tmp_path)) is None
    save(str(tmp_path), 2, _tree(), meta_extra={'loss': 'toppush'})
    _, meta = restore(str(tmp_path))
    assert meta['loss'] == 'toppush' and meta['step'] == 2


def test_shards_are_raw_chunks_at_recorded_offsets(tmp_path, monkeypatch):
    """meta.json says where each chunk lies; a shard is the chunks' bytes
    back to back (no msgpack), striped over the shards chunk by chunk."""
    monkeypatch.setattr(store, '_CHUNK', 1000)
    t = {'x': torch.arange(700, dtype=torch.float32),
         'y': torch.arange(30, dtype=torch.int64)}
    d = save(str(tmp_path), 3, t, n_shards=3, compression='none')
    meta = json.load(open(os.path.join(d, 'meta.json')))
    assert meta['compression'] == 'none'
    for rec in meta['leaves']:
        raw = b''
        for c in rec['chunks']:
            with open(os.path.join(
                    d, f'shard_{c["shard"]:05d}_of_00003.bin'), 'rb') as f:
                f.seek(c['offset'])
                raw += f.read(c['length'])
        arr = np.frombuffer(raw, np.dtype(rec['dtype']))
        np.testing.assert_array_equal(arr, t[rec['path']].numpy())
    x = next(r for r in meta['leaves'] if r['path'] == 'x')
    assert len(x['chunks']) == 3
    assert len({c['shard'] for c in x['chunks']}) == 3


def test_zstd_needs_the_package(tmp_path, monkeypatch):
    monkeypatch.setattr(store, 'zstandard', None)
    with pytest.raises(ModuleNotFoundError, match='zstandard'):
        save(str(tmp_path), 1, _tree(), compression='zstd')
    d = save(str(tmp_path), 2, _tree(), compression='auto')
    assert json.load(open(os.path.join(d, 'meta.json')))[
        'compression'] == 'none'
    out, _ = restore(str(tmp_path), like=_like(_tree()))
    assert torch.equal(out['a'], _tree()['a'])
    with pytest.raises(ValueError, match='compression'):
        save(str(tmp_path), 3, _tree(), compression='lz4')


def test_zstd_shards_round_trip(tmp_path):
    pytest.importorskip('zstandard')
    t = {'z': torch.zeros(50000), 'r': torch.arange(10.0)}
    d = save(str(tmp_path), 1, t, n_shards=2, compression='zstd')
    raw = sum(os.path.getsize(os.path.join(d, f))
              for f in os.listdir(d) if f.endswith('.bin'))
    assert raw < 50000 * 4 // 10
    out, meta = restore(str(tmp_path), like=_like(t))
    assert meta['compression'] == 'zstd'
    assert torch.equal(out['z'], t['z']) and torch.equal(out['r'], t['r'])


def test_bundle_state_round_trip_from_a_meta_structure(tmp_path):
    """A NamedTuple tree: the structure comes from `init_bundle_state`
    on the meta device, and each leaf lands on the asked device with its
    own dtype (int32 n_active, bool done)."""
    st = TB.init_bundle_state(9, 4, w0=np.arange(9.0), device='cpu')
    st = st._replace(A=torch.randn(4, 9), n_active=torch.tensor(
        2, dtype=torch.int32), done=torch.tensor(True))
    save(str(tmp_path), 4, st)
    like = TB.init_bundle_state(9, 4, device='meta')
    out, _ = restore(str(tmp_path), like=like, device='cpu')
    assert isinstance(out, TB.BundleState)
    for f in TB.BundleState._fields:
        a, b = getattr(st, f), getattr(out, f)
        assert a.dtype == b.dtype and a.device == b.device, f
        assert torch.equal(a, b), f


def test_module_state_restores_into_a_meta_model(tmp_path):
    """An nn.Module leaf is its state_dict; restored into a model built on
    the meta device, its parameters become the restored tensors."""
    mod = torch.nn.Linear(4, 3).to(torch.bfloat16)
    tree = {'params': mod, 'step': torch.tensor(5), 'lr': 0.5,
            'seq': [torch.ones(2), np.arange(3)]}
    save(str(tmp_path), 1, tree)
    like = {'params': torch.nn.Linear(4, 3, device='meta').to(
        torch.bfloat16), 'step': torch.empty((), dtype=torch.int64,
                                             device='meta'),
            'lr': 0.0, 'seq': [torch.empty(2, device='meta'),
                               np.zeros(3, np.int64)]}
    out, _ = restore(str(tmp_path), like=like, device='cpu')
    assert out['params'] is like['params']
    assert isinstance(out['params'].weight, torch.nn.Parameter)
    assert torch.equal(out['params'].weight, mod.weight)
    assert out['params'].weight.device.type == 'cpu'
    assert out['step'].item() == 5 and out['lr'] == 0.5
    assert torch.equal(out['seq'][0], torch.ones(2))
    np.testing.assert_array_equal(out['seq'][1], np.arange(3))


def test_async_snapshot_is_taken_before_save_returns(tmp_path):
    """The state may be updated in place right after `save` returns (the
    port's train step does): the checkpoint holds the values at the
    call."""
    t = {'w': torch.zeros(100000)}
    with AsyncCheckpointer(str(tmp_path), keep=1) as ck:
        ck.save(1, t)
        t['w'].add_(1.0)
    out, _ = restore(str(tmp_path))
    assert torch.equal(out['w'], torch.zeros(100000))


def test_restore_without_like_gives_tensors(tmp_path):
    save(str(tmp_path), 1, _tree())
    leaves, meta = restore(str(tmp_path))
    assert sorted(leaves) == ['a', 'n/b', 'n/step']
    assert leaves['n/step'].dtype == torch.int32
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / 'none'))
