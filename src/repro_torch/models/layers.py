"""Building blocks shared by the LM families: for now the RMS norm only.

The port's counterpart of the reference's `models/layers.py`; attention,
MLA, MoE and the MLP wait for the families that use them (ROADMAP Queue 1
item 13(c)).
"""

from __future__ import annotations

import torch
from torch import nn

from .params import ParamDef, add_params

f32 = torch.float32


def rmsnorm_defs(d):
    return {'scale': ParamDef((d,), ('embed_act',), init='ones')}


def rmsnorm(p, x, eps=1e-6):
    """Normalize in float32, cast back to x's dtype, then scale in that
    dtype (the reference's order of roundings)."""
    xf = x.to(f32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p.scale


class RMSNorm(nn.Module):
    """Parameters of `rmsnorm_defs(d)`: `scale` (d,)."""

    def __init__(self, d, device=None):
        super().__init__()
        add_params(self, rmsnorm_defs(d), device)

    def forward(self, x):
        return rmsnorm(self, x)
