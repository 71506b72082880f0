"""Port parity of the dense-attention rank_hinge train step against the
JAX package.

The rank_hinge objective scores the last hidden state with the score head
and trains it with the paper's linearithmic pairwise hinge. From one
reference train state both packages take two steps on the same reward
batch of each of the six reduced dense configs (the state and the
frontends' inputs as in tests/test_torch_dense_train_step.py), and once
with remat='none' and grouped utilities; tests/torch_train_parity.py's
`check_pair` holds them to the bf16 bars (loss 2e-3, gnorm 2e-2, masters
2 lr; measured with tools/dense_train_gap.py, loss at most 9.6e-4 and
gnorm 5.6e-3 apart). The batch has 16 sequences, as for RWKV-6
(tests/test_torch_train_rank.py says why). Within the port, remat='none'
and remat='layer' take the same two steps bit for bit: the checkpoint
recomputes the layer with the same operations.
"""

import pytest

torch = pytest.importorskip('torch')

from torch_parity import torch_one_thread  # noqa: E402,F401
from torch_train_parity import check_pair, step_pair  # noqa: E402

ARCHS = ('qwen2.5-3b', 'minicpm-2b', 'command-r-plus-104b',
         'nemotron-4-340b', 'internvl2-26b', 'musicgen-medium')


@pytest.mark.parametrize('arch', ARCHS)
def test_dense_rank_hinge_train_step_matches_reference(arch):
    check_pair(step_pair(arch, 'rank_hinge', batch=16))


def test_dense_train_step_without_remat_matches_reference():
    check_pair(step_pair('musicgen-medium', 'rank_hinge', batch=16,
                         groups=2, remat='none'))


def test_remat_none_equals_remat_layer_bit_for_bit():
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.reduced import reduced
    from repro_torch.train.trainer import init_state, make_train_step
    from torch_train_parity import _raw_batch
    cfg = reduced('qwen2.5-3b')
    tb = {k: torch.as_tensor(v)
          for k, v in _raw_batch(cfg, 'lm', 4, 32, 0, 0).items()}
    out = {}
    for remat in ('none', 'layer'):
        tcfg = TrainConfig(remat=remat, warmup_steps=0, decay_steps=10)
        state = init_state(cfg, seed=2, device='cpu')
        step = make_train_step(cfg, tcfg)
        metrics = [step(state, tb)[1] for _ in range(2)]
        out[remat] = (metrics, state)
    (m_a, s_a), (m_b, s_b) = out['none'], out['layer']
    for a, b in zip(m_a, m_b):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for (name, p), q in zip(s_a['params'].named_parameters(),
                            s_b['params'].parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(s_a['opt']['mu'][name]['master'],
                           s_b['opt']['mu'][name]['master']), name
