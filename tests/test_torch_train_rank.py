"""Port parity of the RWKV-6 rank_hinge train step against the JAX
package, and the port's train CLI.

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
    check_pair(step_pair(impl, 'rank_hinge', batch=16, groups=groups))


def test_train_step_without_remat_matches_reference():
    check_pair(step_pair('scan', 'rank_hinge', batch=16, remat='none'))


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
