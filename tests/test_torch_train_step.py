"""Port parity of the RWKV-6 LM train step against the JAX package.

From one reference train state carried over by
`convert.train_state_from_reference`, both packages take two steps of
`objective='lm'` on the same batch of reduced rwkv6-3b (bf16 weights),
on each WKV route, and with two microbatches; tests/torch_train_parity.py
holds them to the bf16 bars (loss 2e-3, gnorm 2e-2, master after step 1
within 2 lr) and says why. The rank_hinge objective and remat='none'
are in tests/test_torch_train_rank.py.
"""

import pytest

torch = pytest.importorskip('torch')

from torch_parity import torch_one_thread  # noqa: E402,F401
from torch_train_parity import check_pair, step_pair  # noqa: E402


@pytest.mark.parametrize('impl', ['scan', 'kernel'])
def test_lm_train_step_matches_reference(impl):
    check_pair(step_pair('rwkv6-3b', 'lm', impl=impl, batch=4))


def test_lm_train_step_with_microbatches_matches_reference():
    """Two microbatches of 2: gradients summed in float32, loss and
    gradients divided by 2, as the reference accumulates them."""
    check_pair(step_pair('rwkv6-3b', 'lm', impl='kernel', batch=4,
                         microbatches=2))
