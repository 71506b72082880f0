"""RWKV-6 "Finch" block: attention-free time mix with data-dependent decay.

The port of the reference's `models/rwkv6.py` (arXiv:2404.05892). The
per-channel decay w_t is a function of the input (low rank:
w_t = exp(-exp(w0 + tanh(x A) B))) and the recurrence keeps a per-head
(K x V) state

    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t.

Two routes compute the recurrence, chosen as in the reference:
`cfg.wkv_impl == 'kernel'` with more than one token sends it to the WKV
op (`kernels/wkv`: the CUDA kernels for tensors on the card, their plain
versions on the CPU), which streams r, k, v in their dtype (bf16 on the
model path), returns o rounded to it, and differentiates through the
backward kernel; otherwise (`'scan'`, and every one-token decode step)
`_wkv_scan` runs it in float32 step by step, under autograd.

Each block is an `nn.Module` whose parameters carry the reference's keys;
the forward functions take the module where the reference takes its
parameter dict. Matrix products promote their operands to a common
dtype, as the reference's einsums do, so float32 weights run on bf16
activations.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.wkv.ops import wkv_apply
from .layers import mm as _mm
from .params import ParamDef, add_params

f32 = torch.float32
DECAY_LORA = 64


def rwkv_defs(cfg):
    d = cfg.d_model
    h = cfg.n_heads
    hd = cfg.rwkv_head_dim
    ff = cfg.d_ff
    return {
        'tm': {  # time mix
            'mu_r': ParamDef((d,), ('embed_act',), init='zeros'),
            'mu_k': ParamDef((d,), ('embed_act',), init='zeros'),
            'mu_v': ParamDef((d,), ('embed_act',), init='zeros'),
            'mu_w': ParamDef((d,), ('embed_act',), init='zeros'),
            'mu_g': ParamDef((d,), ('embed_act',), init='zeros'),
            'wr': ParamDef((d, h * hd), ('embed', 'heads')),
            'wk': ParamDef((d, h * hd), ('embed', 'heads')),
            'wv': ParamDef((d, h * hd), ('embed', 'heads')),
            'wg': ParamDef((d, h * hd), ('embed', 'heads')),
            'wo': ParamDef((h * hd, d), ('heads', 'embed')),
            # data-dependent decay (the Finch contribution)
            'w0': ParamDef((h * hd,), ('heads',), init='zeros'),
            'wa': ParamDef((d, DECAY_LORA), ('embed', 'none'), scale=0.02),
            'wb': ParamDef((DECAY_LORA, h * hd), ('none', 'heads'),
                           scale=0.02),
            'u': ParamDef((h, hd), ('heads', 'head_dim'), init='zeros'),
            'ln_scale': ParamDef((h * hd,), ('heads',), init='ones'),
        },
        'cm': {  # channel mix
            'mu_k': ParamDef((d,), ('embed_act',), init='zeros'),
            'mu_r': ParamDef((d,), ('embed_act',), init='zeros'),
            'wk': ParamDef((d, ff), ('embed', 'ffn')),
            'wv': ParamDef((ff, d), ('ffn', 'embed')),
            'wr': ParamDef((d, d), ('embed', 'embed_act')),
        },
    }


def _token_shift(x, last):
    """Shift right by one along T; `last` (B, d) fills position 0."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _lerp(x, xs, mu):
    return x + (xs - x) * mu


def _wkv_scan(r, k, v, w, u, s0):
    """r, k, v, w: (B, T, H, K); u: (H, K); s0: (B, H, K, V=K).
    Returns (o (B, T, H, V), sT)."""
    s = s0
    uu = u[..., None]
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]     # (B, H, K, V)
        outs.append(torch.einsum('bhk,bhkv->bhv', r[:, t], s + uu * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


def rwkv_time_mix(p, cfg, x, *, state=None, shift_last=None):
    """x: (B, T, d) normed input; state: (B, H, K, V) or None; shift_last:
    (B, d) the previous token's normed input (decode).
    Returns (out (B, T, d), new state float32, x[:, -1])."""
    b, t, d = x.shape
    h, hd = cfg.n_heads, cfg.rwkv_head_dim
    if shift_last is None:
        shift_last = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, shift_last)
    xr = _lerp(x, xs, p.mu_r)
    xk = _lerp(x, xs, p.mu_k)
    xv = _lerp(x, xs, p.mu_v)
    xw = _lerp(x, xs, p.mu_w)
    xg = _lerp(x, xs, p.mu_g)

    r = _mm(xr, p.wr).reshape(b, t, h, hd)
    k = _mm(xk, p.wk).reshape(b, t, h, hd)
    v = _mm(xv, p.wv).reshape(b, t, h, hd)
    g = F.silu(_mm(xg, p.wg))

    # data-dependent decay in (0, 1): w = exp(-exp(w0 + tanh(x wa) wb));
    # w0 + dd is summed in the weights' dtype, then raised to float32
    dd = _mm(torch.tanh(_mm(xw, p.wa)), p.wb)
    w = torch.exp(-torch.exp((p.w0 + dd).to(f32))).reshape(b, t, h, hd)

    s0 = (torch.zeros((b, h, hd, hd), dtype=f32, device=x.device)
          if state is None else state.to(f32))
    if cfg.wkv_impl == 'kernel' and t > 1:
        # (B, T, H, K) -> (B*H, T, K), batch the leading factor of N.
        # r/k/v/o stream in their dtype; the decay w stays float32. u is
        # broadcast per sequence, so autograd sums du back to (H, K).
        def flat(a):
            return a.permute(0, 2, 1, 3).reshape(b * h, t, hd)
        u_flat = p.u.to(f32)[None].expand(b, h, hd).reshape(b * h, hd)
        o, sT = wkv_apply(flat(r), flat(k), flat(v), flat(w), u_flat,
                          s0.reshape(b * h, hd, hd))
        o = o.to(f32).reshape(b, h, t, hd).permute(0, 2, 1, 3)
        sT = sT.reshape(b, h, hd, hd)
    else:
        o, sT = _wkv_scan(r.to(f32), k.to(f32), v.to(f32), w, p.u.to(f32),
                          s0)
    # per-head group norm, population variance
    o = o.reshape(b, t, h, hd)
    o = (o - o.mean(-1, keepdim=True)) * torch.rsqrt(
        o.var(-1, keepdim=True, correction=0) + 1e-5)
    o = o.reshape(b, t, h * hd).to(x.dtype) * p.ln_scale * g
    return _mm(o, p.wo), sT, x[:, -1, :]


def rwkv_channel_mix(p, cfg, x, *, shift_last=None):
    b, t, d = x.shape
    if shift_last is None:
        shift_last = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, shift_last)
    xk = _lerp(x, xs, p.mu_k)
    xr = _lerp(x, xs, p.mu_r)
    k = torch.square(F.relu(_mm(xk, p.wk)))
    kv = _mm(k, p.wv)
    r = torch.sigmoid(_mm(xr, p.wr))
    return r * kv, x[:, -1, :]


class TimeMix(nn.Module):
    """Parameters of `rwkv_defs(cfg)['tm']`."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        add_params(self, rwkv_defs(cfg)['tm'], device)

    def forward(self, x, state=None, shift_last=None):
        return rwkv_time_mix(self, self.cfg, x, state=state,
                             shift_last=shift_last)


class ChannelMix(nn.Module):
    """Parameters of `rwkv_defs(cfg)['cm']`."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        add_params(self, rwkv_defs(cfg)['cm'], device)

    def forward(self, x, shift_last=None):
        return rwkv_channel_mix(self, self.cfg, x, shift_last=shift_last)
