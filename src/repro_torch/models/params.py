"""Parameter declarations: shape + logical-axes defs -> initialized tensors.

The port's copy of the reference's parameter system. A model declares
each parameter once as a `ParamDef`; `init_params` materializes a tree of
defs into a tree of tensors drawn from an explicit `torch.Generator`, and
`count_params` sums their sizes. Layer stacks are declared stacked
(`stack_tree`), as in the reference, so that both packages count and
initialize the same leaves; the model modules (`models/lm.py`) hold the
layers unstacked.

The initialization scale is the reference's rule, quirk included: a
normal def without an explicit scale gets std 1/sqrt(fan_in), where
fan_in is the def's LEADING dimension. For a stacked (L, d, h*hd) matrix
that is the layer count L, not d, so every such matrix of rwkv6-3b gets
std 1/sqrt(32). The reference does this (ROADMAP Queue 3) and the port
keeps it, so that the two draw from the same distributions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple                  # logical axis names, len == len(shape)
    init: str = 'normal'         # normal | zeros | ones
    scale: float | None = None   # stddev; default 1/sqrt(fan-in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f'shape {self.shape} and axes {self.axes} '
                             'differ in length')


def _items(tree, prefix=()):
    """(path, leaf) pairs of a nested dict in sorted-key order, the order
    in which `jax.tree.flatten` visits a dict."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _items(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _set(tree, path, val):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = val


def init_params(defs, generator: torch.Generator, dtype=torch.bfloat16):
    """Materialize a ParamDef tree into tensors on `generator.device`.

    Leaves are drawn in sorted-key order from `generator`; normal leaves
    are drawn in float32, scaled in place (one float32 transient a leaf:
    19.2 GB for deepseek-v2-lite-16b's largest, where an out-of-place
    scale would hold two), then cast to `dtype`."""
    dev = generator.device
    out = {}
    for path, d in _items(defs):
        if d.init == 'zeros':
            arr = torch.zeros(d.shape, dtype=dtype, device=dev)
        elif d.init == 'ones':
            arr = torch.ones(d.shape, dtype=dtype, device=dev)
        else:
            fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[-1], 1)
            scale = d.scale if d.scale is not None else 1.0 / np.sqrt(fan_in)
            arr = torch.randn(d.shape, generator=generator, device=dev,
                              dtype=torch.float32).mul_(scale).to(dtype)
        _set(out, path, arr)
    return out


def count_params(defs) -> int:
    return int(sum(np.prod(d.shape) for _, d in _items(defs)))


def stack_defs(d: ParamDef, n: int, axis_name: str = 'layers') -> ParamDef:
    """Prepend a stacked leading dimension to a ParamDef."""
    return dataclasses.replace(d, shape=(n,) + d.shape,
                               axes=(axis_name,) + d.axes)


def stack_tree(defs, n: int):
    return {k: (stack_tree(v, n) if isinstance(v, dict) else stack_defs(v, n))
            for k, v in defs.items()}


def add_params(module: torch.nn.Module, defs, device=None) -> None:
    """Register one uninitialized bf16 `nn.Parameter` on `module` for each
    leaf of a flat ParamDef dict, named by its key (the reference's key)."""
    for name, d in defs.items():
        module.register_parameter(name, torch.nn.Parameter(
            torch.empty(d.shape, dtype=torch.bfloat16, device=device)))
