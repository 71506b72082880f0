"""Port parity of the MoE family's bf16 train steps against the JAX
package, and remat='none' against remat='layer' within the port.

From one reference train state (tests/torch_train_parity.py: the
reference's init, its layer and expert matrices at std 1/sqrt(fan-in),
the router at its own 0.02) both packages take two bf16 train steps on
the same batch of reduced deepseek-v2-lite-16b (MLA) and
moonshot-v1-16b-a3b (GQA), under both objectives;
`torch_train_parity.check_pair` first asserts that both packages route
every token alike at both steps, the reference's margin at least
LM_MARGIN = 1e-3, then holds them to the bf16 bars (loss 2e-3, gnorm
2e-2, masters 2 lr).

Routing decides the sizes and seeds. The router is drawn at std 0.02,
so a token's four probabilities lie near 1/4 and its second and third
often nearly tie: over 64 tokens and two layers, most seeds leave some
token within 1e-3 of a tie at one of the two steps. So 'lm' runs 2
sequences of 32 positions and 'rank_hinge' 16 of 4 (16 sequences, as
for the dense family, for the hinge's pairs; tests/test_torch_train_rank.py
says why). The seeds are the first whose reference margin is at least
1.2e-3 at both steps and whose tokens the port routes alike at both;
`tools/moe_train_gap.py` finds them and shows that every such seed of
its sweep passes `check_pair` (none is left out for a gap).

Within the port, remat='none' and remat='layer' take the same two steps
bit for bit, and the checkpoint's recompute hands each MoE layer the
same input, bit for bit, as the forward did, so it routes alike.
"""

import pytest

torch = pytest.importorskip('torch')

from torch_parity import torch_one_thread  # noqa: E402,F401
from torch_train_parity import check_pair, step_pair  # noqa: E402

# (arch, objective): seed; 'lm' at 2 x 32, 'rank_hinge' at 16 x 4
SEEDS = {('deepseek-v2-lite-16b', 'lm'): 26,
         ('deepseek-v2-lite-16b', 'rank_hinge'): 14,
         ('moonshot-v1-16b-a3b', 'lm'): 4,
         ('moonshot-v1-16b-a3b', 'rank_hinge'): 1}
SIZES = {'lm': (2, 32), 'rank_hinge': (16, 4)}


@pytest.mark.parametrize('arch,objective', list(SEEDS))
def test_moe_train_step_matches_reference(arch, objective):
    batch, seq = SIZES[objective]
    check_pair(step_pair(arch, objective, batch=batch, seq=seq,
                         seed=SEEDS[arch, objective]))


def test_moe_train_step_without_remat_matches_reference():
    check_pair(step_pair('moonshot-v1-16b-a3b', 'lm', batch=2, seq=32,
                         seed=SEEDS['moonshot-v1-16b-a3b', 'lm'],
                         remat='none'))


def test_moe_remat_none_equals_remat_layer_bit_for_bit():
    """Reduced deepseek-v2-lite-16b, two lm steps each way from one init;
    under remat='layer' each MoE layer is called twice a step (forward,
    then recompute in the backward, in reverse), on the same bits."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.reduced import reduced
    from repro_torch.models.layers import MoE
    from repro_torch.train.trainer import init_state, make_train_step
    from torch_train_parity import _raw_batch
    cfg = reduced('deepseek-v2-lite-16b')
    tb = {k: torch.as_tensor(v)
          for k, v in _raw_batch(cfg, 'lm', 4, 32, 0, 0).items()}
    out = {}
    for remat in ('none', 'layer'):
        tcfg = TrainConfig(remat=remat, warmup_steps=0, decay_steps=10)
        state = init_state(cfg, seed=2, device='cpu')
        seen = []
        hooks = [m.register_forward_pre_hook(
            lambda mod, args: seen.append(args[0].detach().clone()))
            for m in state['params'].modules() if isinstance(m, MoE)]
        step = make_train_step(cfg, tcfg)
        metrics = [step(state, tb)[1] for _ in range(2)]
        for h in hooks:
            h.remove()
        out[remat] = (metrics, state, seen)
    (m_a, s_a, x_a), (m_b, s_b, x_b) = out['none'], out['layer']
    moe = len(x_a) // 2                       # MoE calls a step, no remat
    assert moe == cfg.n_layers - 1 and len(x_b) == 4 * moe
    for i in range(2):                        # per step: forward, recompute
        fwd, rec = x_b[2 * moe * i:][:moe], x_b[2 * moe * i + moe:][:moe]
        for a, b, c in zip(x_a[moe * i:][:moe], fwd, rec[::-1]):
            assert torch.equal(a, b) and torch.equal(b, c)
    for a, b in zip(m_a, m_b):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for (name, p), q in zip(s_a['params'].named_parameters(),
                            s_b['params'].parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(s_a['opt']['mu'][name]['master'],
                           s_b['opt']['mu'][name]['master']), name
