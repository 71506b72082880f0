"""Port parity of the dense-attention train step against the JAX package.

From one reference train state carried over by
`convert.train_state_from_reference`, both packages take two steps of
`objective='lm'` on the same batch of each of the six reduced dense
configs (bf16 weights, QKV biases drawn, layer matrices at std
1/sqrt(fan-in)): token batches, image embeddings before the tokens with
text targets (`internvl2-26b`), and audio frames (`musicgen-medium`);
and once with two microbatches. tests/torch_train_parity.py's
`check_pair` holds them to the RWKV-6 pairs' bf16 bars (loss within
2e-3 and gnorm within 2e-2 at both steps, masters after step 1 within
2 lr); measured with tools/dense_train_gap.py, loss at most 2.7e-4 and
gnorm 1.1e-3 apart here. The rank_hinge objective and remat='none' are in
tests/test_torch_dense_train_rank.py, the float32 gradients of the whole
model in tests/test_torch_dense_train_grads.py.
"""

import pytest

torch = pytest.importorskip('torch')

from torch_parity import torch_one_thread  # noqa: E402,F401
from torch_train_parity import check_pair, step_pair  # noqa: E402

ARCHS = ('qwen2.5-3b', 'minicpm-2b', 'command-r-plus-104b',
         'nemotron-4-340b', 'internvl2-26b', 'musicgen-medium')


@pytest.mark.parametrize('arch', ARCHS)
def test_dense_lm_train_step_matches_reference(arch):
    check_pair(step_pair(arch, 'lm', batch=4))


def test_dense_lm_train_step_with_microbatches_matches_reference():
    """Two microbatches of 2 on the vision config: gradients summed in
    float32, loss and gradients divided by 2, as the reference
    accumulates them."""
    check_pair(step_pair('internvl2-26b', 'lm', batch=4, microbatches=2))
