"""Port parity of the dense-attention model's whole gradient against the
JAX package, in float32.

For each of the six reduced dense configs and both objectives, and once
with two microbatches, `torch_train_parity.f32_grad_pair` gives every
leaf's gradient of the loss from one state (the reference's init, QKV
biases drawn, layer matrices at std 1/sqrt(fan-in)) on one batch (the
frontends' inputs as the train CLI makes them), in float32 in both
packages: `jax.grad` of the reference's `loss_fn` against the port's
`loss_and_grads`. This holds what lies outside a layer (the embedding
and the tied or untied head, the final norm, the vision model's cut to
the text positions, the audio frames, the score head under rank_hinge,
the microbatches' accumulation) as tightly as the blocks are held in
tests/test_torch_dense_train.py: per leaf within F32_GRAD_BAR of the
leaf's scale (its largest absolute value). The two packages sum the
same float32 products in another order; measured with
tools/dense_train_gap.py, at most 2.5e-6 of scale over these cases. A
leaf that the objective does not use (the score head under 'lm', an
untied LM head under 'rank_hinge') gets zeros in both.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from torch_parity import torch_one_thread  # noqa: E402,F401
from torch_train_parity import f32_grad_pair  # noqa: E402

ARCHS = ('qwen2.5-3b', 'minicpm-2b', 'command-r-plus-104b',
         'nemotron-4-340b', 'internvl2-26b', 'musicgen-medium')
F32_GRAD_BAR = 1e-5


def _check(want, got):
    assert sorted(got) == sorted(want)
    for name, b in want.items():
        a = got[name]
        assert a.shape == b.shape, name
        assert np.all(np.isfinite(a)), name
        scale = float(np.abs(b).max())
        if scale == 0.0:
            assert not np.any(a), name
            continue
        err = float(np.abs(a - b).max())
        assert err <= F32_GRAD_BAR * scale, (name, err / scale)


@pytest.mark.parametrize('objective', ['lm', 'rank_hinge'])
@pytest.mark.parametrize('arch', ARCHS)
def test_dense_model_f32_grads_match_reference(arch, objective):
    _check(*f32_grad_pair(arch, objective,
                          batch=4 if objective == 'lm' else 16))


def test_dense_model_f32_grads_with_microbatches_match_reference():
    """The vision config in two microbatches of 2: the port sums each
    microbatch's gradients in float32 and divides by 2, as the
    reference's step accumulates them."""
    _check(*f32_grad_pair('internvl2-26b', 'lm', batch=4, microbatches=2))
