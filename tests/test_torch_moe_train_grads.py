"""Port parity of the MoE family's whole-model gradient against the JAX
package, in float32.

For reduced deepseek-v2-lite-16b (MLA) and moonshot-v1-16b-a3b (GQA),
each a dense layer 0 then two MoE layers of 4 experts top-2 with a
shared expert, under both objectives, and with two microbatches,
`torch_train_parity.f32_grad_pair` gives every leaf's gradient of the
loss from one state (the reference's init, its layer and expert
matrices at std 1/sqrt(fan-in), the router at its own 0.02) on one
batch, in float32 in both packages: `jax.grad` of the reference's
`loss_fn` against the port's `loss_and_grads` (remat='layer'). Before
any gradient is compared, both packages' MoE calls, forward and
recompute, are asserted to route every token alike, the reference's
margin at least F32_MARGIN = 1e-4 (`torch_train_parity.routing_gap`).
Per leaf within F32_GRAD_BAR = 1e-5 of the leaf's scale, the dense
family's bar (tests/test_torch_dense_train_grads.py); measured with
tools/moe_train_gap.py, at most 2.9e-6 of scale over these cases. A
leaf that the objective does not use (the score head under 'lm', the
untied LM head under 'rank_hinge') gets zeros in both.
"""

import pytest

torch = pytest.importorskip('torch')

from test_torch_dense_train_grads import _check  # noqa: E402
from torch_parity import torch_one_thread  # noqa: E402,F401
from torch_train_parity import f32_grad_pair  # noqa: E402

ARCHS = ('deepseek-v2-lite-16b', 'moonshot-v1-16b-a3b')


@pytest.mark.parametrize('objective', ['lm', 'rank_hinge'])
@pytest.mark.parametrize('arch', ARCHS)
def test_moe_model_f32_grads_match_reference(arch, objective):
    _check(*f32_grad_pair(arch, objective,
                          batch=4 if objective == 'lm' else 16))


@pytest.mark.parametrize('arch', ARCHS)
def test_moe_model_f32_grads_with_microbatches_match_reference(arch):
    """Two microbatches of 2: the port sums each microbatch's gradients in
    float32 and divides by 2, as the reference's step accumulates them;
    each microbatch routes on its own tokens, in both alike."""
    _check(*f32_grad_pair(arch, 'lm', batch=4, microbatches=2))
