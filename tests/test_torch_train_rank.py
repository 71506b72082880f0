"""Port parity of the RWKV-6 rank_hinge train step against the JAX
package, and the port's train CLI (RWKV-6; and reduced qwen2.5-3b and
the vision internvl2-26b stopped by a preemption and resumed from their
checkpoints to the uninterrupted run's final loss).

The rank_hinge objective scores the last hidden state with the score head
and trains it with the paper's linearithmic pairwise hinge
(`core.rank_loss.pairwise_hinge_loss`). From one reference train state
both packages take two steps on the same reward batch, on each WKV route
(grouped utilities on the kernel route) and with remat='none';
tests/torch_train_parity.py holds them to the bf16 bars. The batch has 16
sequences: with 4, the JAX package's own two routes already differ by
3.7e-3 in the hinge loss (bf16 rounding moves a few pairs' margins), more
than the 2e-3 bar.
"""

import functools
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip('torch')

from torch_parity import torch_one_thread  # noqa: E402,F401
from torch_train_parity import check_pair, step_pair  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..', 'src')


@pytest.mark.parametrize('impl,groups', [('scan', 0), ('kernel', 2)])
def test_rank_hinge_train_step_matches_reference(impl, groups):
    check_pair(step_pair('rwkv6-3b', 'rank_hinge', impl=impl, batch=16,
                         groups=groups))


def test_train_step_without_remat_matches_reference():
    check_pair(step_pair('rwkv6-3b', 'rank_hinge', impl='scan', batch=16,
                         remat='none'))


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run(
        [sys.executable, '-m', 'repro_torch.launch.train', '--arch',
         'rwkv6-3b', '--reduced', '--steps', '3', '--batch', '4', '--seq',
         '32', '--device', 'cpu', *args], env=env, capture_output=True,
        text=True, timeout=300)


@pytest.mark.parametrize('objective', ['lm', 'rank_hinge'])
def test_train_cli_prints_step_and_done_lines(objective):
    proc = _cli('--objective', objective)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    steps = [ln for ln in lines if ln.startswith('step ')]
    assert len(steps) == 3
    losses = [float(ln.split('loss')[1].split()[0]) for ln in steps]
    assert all(0 < x < 100 for x in losses)
    assert lines[-1].startswith('done: 3 steps in ')


@pytest.mark.parametrize('arch', ['qwen2.5-3b', 'internvl2-26b'])
def test_train_cli_resumes_a_dense_model_to_the_same_loss(arch, tmp_path,
                                                         monkeypatch):
    """Four steps with checkpoints every 2, uninterrupted; and the same
    command preempted before step 4, then run again: it resumes from
    step 2, and its last step's loss is the uninterrupted run's, bit
    for bit (metrics.jsonl)."""
    from repro_torch.launch import train as T
    from repro_torch.runtime import SimulatedPreemption, run

    def args(name):
        return ['--arch', arch, '--reduced', '--device', 'cpu', '--steps',
                '4', '--batch', '2', '--seq', '16', '--ckpt-every', '2',
                '--ckpt-dir', str(tmp_path / name)]

    def last_loss(name):
        with open(tmp_path / name / 'metrics.jsonl') as f:
            return [json.loads(ln) for ln in f][-1]

    T.main(args('a'))
    with monkeypatch.context() as m:
        m.setattr(T, 'run', functools.partial(run, fail_at=3))
        with pytest.raises(SimulatedPreemption):
            T.main(args('b'))
    T.main(args('b'))
    a, b = last_loss('a'), last_loss('b')
    assert a['step'] == b['step'] == 4
    assert a['loss'] == b['loss']
