"""The port's fault-tolerant loop (`repro_torch.runtime.run`) on the
reduced rwkv6-3b train step, the cases of tests/test_runtime.py: a
restart after a preemption ends on the uninterrupted run's state bit for
bit (bf16 parameters, float32 master weights and moments, counts), a
double failure, the NaN skip and halt policies (a skipped step, NaN in
its gradient or its loss, leaves the state as it was), and straggler detection
(on an injected sleep, counted, never timed against a bar). Then the
train CLI with checkpoints, the cases of tests/test_train_cli.py on
--arch rwkv6-3b --reduced --device cpu."""

import json
import os
import time

import pytest

torch = pytest.importorskip('torch')

from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.data import TokenPipeline, TokenPipelineConfig  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.runtime import (LoopConfig, SimulatedPreemption,  # noqa: E402
                                 run)
from repro_torch.train.trainer import init_state, make_train_step  # noqa: E402
from torch_parity import torch_one_thread  # noqa: E402,F401


@pytest.fixture(scope='module')
def setup():
    cfg = reduced('rwkv6-3b')
    tcfg = TrainConfig(remat='none', warmup_steps=2, decay_steps=20)
    step_fn = make_train_step(cfg, tcfg)
    tp = TokenPipeline(TokenPipelineConfig(cfg.vocab, 16, 2, seed=0))

    def init_fn(device):
        return init_state(cfg, 0, device=device)

    return cfg, step_fn, tp, init_fn


def _loop(tmp_path, name, total, **kw):
    return LoopConfig(total_steps=total, ckpt_dir=str(tmp_path / name),
                      ckpt_every=kw.pop('ckpt_every', 2), async_ckpt=False,
                      **kw)


def _assert_states_equal(a, b):
    pa, pb = dict(a['params'].named_parameters()), dict(
        b['params'].named_parameters())
    assert pa.keys() == pb.keys()
    for k in pa:
        assert pa[k].dtype == pb[k].dtype == torch.bfloat16
        assert torch.equal(pa[k].view(torch.int16), pb[k].view(torch.int16)), k
        for f in ('master', 'm', 'v'):
            assert torch.equal(a['opt']['mu'][k][f], b['opt']['mu'][k][f]), (
                k, f)
    assert torch.equal(a['opt']['count'], b['opt']['count'])
    assert torch.equal(a['step'], b['step'])


def test_restart_is_bit_identical(tmp_path, setup):
    _, step_fn, tp, init_fn = setup
    state_a, rep_a = run(step_fn, init_fn, tp.batch, _loop(tmp_path, 'a', 6),
                         device='cpu')
    assert rep_a.resumed_from is None
    lc_b = _loop(tmp_path, 'b', 6)
    with pytest.raises(SimulatedPreemption):
        run(step_fn, init_fn, tp.batch, lc_b, device='cpu', fail_at=3)
    state_b, rep_b = run(step_fn, init_fn, tp.batch, lc_b, device='cpu')
    assert rep_b.resumed_from == 2
    _assert_states_equal(state_a, state_b)
    # the losses replayed from the checkpoint are the uninterrupted tail
    assert rep_b.losses == rep_a.losses[2:]


def test_double_failure_restart(tmp_path, setup):
    _, step_fn, tp, init_fn = setup
    lc = _loop(tmp_path, 'c', 8)
    for fail in (3, 6):
        with pytest.raises(SimulatedPreemption):
            run(step_fn, init_fn, tp.batch, lc, device='cpu', fail_at=fail)
    _, rep = run(step_fn, init_fn, tp.batch, lc, device='cpu')
    assert rep.resumed_from == 6
    assert rep.final_step == 8


def test_nan_skip_policy(tmp_path, setup):
    _, step_fn, tp, init_fn = setup
    calls = {'n': 0}

    def poisoned_step(state, batch):
        calls['n'] += 1
        new_state, metrics = step_fn(state, batch)
        if calls['n'] == 2:
            metrics = dict(metrics, loss=torch.tensor(float('nan')))
        return new_state, metrics

    log = tmp_path / 'd.jsonl'
    lc = _loop(tmp_path, 'd', 4, ckpt_every=10, nan_policy='skip',
               log_path=str(log))
    _, rep = run(poisoned_step, init_fn, tp.batch, lc, device='cpu')
    assert rep.skipped_steps == 1
    assert len(rep.losses) == 3
    recs = [json.loads(line) for line in open(log)]
    assert [r['step'] for r in recs] == [1, 3, 4]
    assert all({'loss', 'sec', 'gnorm', 'lr'} <= r.keys() for r in recs)


@pytest.mark.parametrize('poison', ['grad', 'loss'])
def test_nan_skip_keeps_the_state_before_the_step(tmp_path, setup,
                                                  monkeypatch, poison):
    """A real non-finite step (one NaN gradient with a finite loss, or a
    NaN loss with finite gradients) updates nothing in place: under
    nan_policy='skip' the run ends on the state of a run that never saw
    that step's batch, bit for bit."""
    from repro_torch.runtime.loop import _to_device
    from repro_torch.train import trainer as T
    _, step_fn, tp, init_fn = setup
    real = T.loss_and_grads
    calls = {'n': 0}

    def poisoned(*args):
        loss, grads = real(*args)
        calls['n'] += 1
        if calls['n'] == 2 and poison == 'grad':
            name = next(iter(grads))
            grads[name] = torch.full_like(grads[name], float('nan'))
        elif calls['n'] == 2:
            loss = torch.full_like(loss, float('nan'))
        return loss, grads

    monkeypatch.setattr(T, 'loss_and_grads', poisoned)
    lc = _loop(tmp_path, 'g', 3, ckpt_every=10, nan_policy='skip')
    state, rep = run(step_fn, init_fn, tp.batch, lc, device='cpu')
    assert rep.skipped_steps == 1 and len(rep.losses) == 2
    monkeypatch.setattr(T, 'loss_and_grads', real)
    want = init_fn('cpu')
    for step in (0, 2):
        want, _ = step_fn(want, _to_device(tp.batch(step), 'cpu'))
    _assert_states_equal(state, want)


def test_nan_halt_policy(tmp_path, setup):
    _, step_fn, tp, init_fn = setup

    def nan_step(state, batch):
        new_state, metrics = step_fn(state, batch)
        return new_state, dict(metrics, loss=torch.tensor(float('nan')))

    lc = _loop(tmp_path, 'e', 4, ckpt_every=10, nan_policy='halt')
    with pytest.raises(FloatingPointError):
        run(nan_step, init_fn, tp.batch, lc, device='cpu')


def test_straggler_detection(tmp_path, setup):
    """One injected slow step, 20 times the slowest step before it (so
    the bar never depends on the machine's speed), is counted."""
    _, step_fn, tp, init_fn = setup
    spans = []

    def slow_step(state, batch):
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        if len(spans) == 4:
            time.sleep(0.2 + 20 * max(spans))
        spans.append(time.perf_counter() - t0)
        return out

    seen = []
    lc = _loop(tmp_path, 'f', 6, ckpt_every=10, straggler_factor=3.0)
    _, rep = run(slow_step, init_fn, tp.batch, lc, device='cpu',
                 on_straggler=lambda s, ratio: seen.append((s, ratio)))
    assert rep.straggler_steps >= 1
    assert seen and seen[0][1] > 3.0


# ------------------------------------------------------------ train CLI


ARGS = ['--arch', 'rwkv6-3b', '--reduced', '--device', 'cpu', '--batch',
        '2', '--seq', '16']


@pytest.mark.parametrize('objective,batch', [('lm', '2'),
                                             ('rank_hinge', '4')])
def test_cli_checkpoints(tmp_path, capsys, objective, batch):
    train_main(ARGS[:-4] + ['--batch', batch, '--seq', '16', '--steps', '2',
                            '--objective', objective,
                            '--ckpt-dir', str(tmp_path)])
    assert latest_step(str(tmp_path)) == 2
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith('done: 2 steps in ')
    assert out[-1].endswith(f'checkpoints in {tmp_path}')
    assert os.path.exists(tmp_path / 'metrics.jsonl')


def test_cli_resumes(tmp_path, capsys):
    args = ARGS + ['--steps', '3', '--ckpt-dir', str(tmp_path),
                   '--ckpt-every', '1']
    train_main(args)
    capsys.readouterr()
    # the second invocation is a no-op resume from step 3
    train_main(args)
    out = capsys.readouterr().out
    assert '(resumed from step 3)' in out and 'already complete' in out
    assert latest_step(str(tmp_path)) == 3
