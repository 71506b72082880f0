"""Architecture registry of the port: `get(arch)` resolves a name.

Only the architectures whose forward the port runs are here. The other
names of the reference registry are known, and `get` raises for them,
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from . import rwkv6_3b
from .base import LM_SHAPES, ModelConfig, ShapeConfig, shapes_for  # noqa: F401

ARCHS = {
    'rwkv6-3b': rwkv6_3b.config,
}

# Names of the reference registry that the port does not run yet.
UNPORTED = {
    'command-r-plus-104b', 'minicpm-2b', 'qwen2.5-3b', 'nemotron-4-340b',
    'internvl2-26b', 'jamba-1.5-large-398b', 'deepseek-v2-lite-16b',
    'moonshot-v1-16b-a3b', 'musicgen-medium', 'ranksvm-linear',
}


def get(arch: str) -> ModelConfig:
    if arch in ARCHS:
        return ARCHS[arch]()
    if arch in UNPORTED:
        raise NotImplementedError(
            f'{arch!r} is not ported yet: the LM families other than '
            'RWKV-6 are ROADMAP Queue 1 item 13(c)')
    raise KeyError(f'unknown arch {arch!r}; known: {sorted(ARCHS)}')
