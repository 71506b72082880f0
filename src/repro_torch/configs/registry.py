"""Architecture registry of the port: `get(arch)` resolves a name.

Only the architectures whose forward the port runs are here: RWKV-6,
the dense-attention (GQA) family with its vision and audio frontends,
and the MoE family (MLA or GQA attention, routed and shared experts, a
dense layer 0). The other names of the reference registry are known, and
`get` raises for them, naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from . import (command_r_plus_104b, deepseek_v2_lite_16b, internvl2_26b,
               minicpm_2b, moonshot_v1_16b_a3b, musicgen_medium,
               nemotron_4_340b, qwen2_5_3b, rwkv6_3b)
from .base import LM_SHAPES, ModelConfig, ShapeConfig, shapes_for  # noqa: F401

ARCHS = {
    'command-r-plus-104b': command_r_plus_104b.config,
    'minicpm-2b': minicpm_2b.config,
    'qwen2.5-3b': qwen2_5_3b.config,
    'nemotron-4-340b': nemotron_4_340b.config,
    'rwkv6-3b': rwkv6_3b.config,
    'internvl2-26b': internvl2_26b.config,
    'deepseek-v2-lite-16b': deepseek_v2_lite_16b.config,
    'moonshot-v1-16b-a3b': moonshot_v1_16b_a3b.config,
    'musicgen-medium': musicgen_medium.config,
}

# Names of the reference registry that the port does not run yet.
UNPORTED = {'jamba-1.5-large-398b', 'ranksvm-linear'}


def get(arch: str) -> ModelConfig:
    if arch in ARCHS:
        return ARCHS[arch]()
    if arch in UNPORTED:
        raise NotImplementedError(
            f'{arch!r} is not ported yet: the Mamba hybrid is ROADMAP Queue '
            '1 item 13(c)(iii), the dry-run configs item 13(c)(iv)')
    raise KeyError(f'unknown arch {arch!r}; known: {sorted(ARCHS)}')
