"""Building blocks of the LM families: the RMS norm, RoPE, grouped-query
attention (GQA) and the MLP.

The port of the reference's `models/layers.py` without MLA and MoE
(ROADMAP Queue 1 item 13(c)(ii)). Each block has a `*_defs(cfg)`
declaration and a forward function that takes the block's `nn.Module`
(whose parameters carry the reference's keys) where the reference takes
its parameter dict.

Attention keeps the reference's arithmetic, which is plain jnp, not a
Pallas kernel: an online softmax over blocks of keys (1024 in prefill
and training, 2048 in decode) that never forms the (T, S) score matrix.
The scores and P.V take bf16 operands with float32 products and sums
(the reference's `preferred_element_type=f32`); the port upcasts and
multiplies under `full_f32()`, so that TF32 rounds nothing. q is scaled
and rounded to its dtype first, p is rounded to q's dtype before P.V,
and RoPE works in float32 and casts back.

Two departures compute the same values with less traffic:

* No repeated keys. The reference repeats each KV head for its query
  heads (`_repeat_kv`) before it attends. The port groups the query
  heads instead, (B, G, rep*T, D) against (B, G, S, D): the same dot
  products, with no copy of the keys and values (at decode that copy
  would be the whole cache, every step).
* The decode cache is written in place. The reference's
  `dynamic_update_slice` returns a new cache; the port writes the new
  key and value at `pos` into the caller's cache tensors and returns
  those same tensors, so a decode step copies nothing of the cache. Key
  blocks that lie wholly at or past `kv_len` are skipped: each would add
  p = 0 under a correction of exp(0) = 1, which leaves every running sum
  bit for bit as it was (tests/test_torch_attention.py holds the two
  equal).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.platform import full_f32
from .params import ParamDef, add_params

f32 = torch.float32


def mm(a, b):
    """a @ b in the promoted dtype of the two (jnp.einsum's rule): bf16
    operands give a bf16 product, float32 weights on bf16 activations a
    float32 one."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


# ---------------------------------------------------------------- norms/rope


def rmsnorm_defs(d):
    return {'scale': ParamDef((d,), ('embed_act',), init='ones')}


def rmsnorm(p, x, eps=1e-6):
    """Normalize in float32, cast back to x's dtype, then scale in that
    dtype (the reference's order of roundings)."""
    xf = x.to(f32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p.scale


def rope(x, positions, theta: float):
    """x: (..., T, H, D) with D even; positions: (..., T). Rotates the
    two halves of each head in float32 and casts back to x's dtype.

    The frequencies theta^(-i/half) are taken in float64 and rounded to
    float32: the reference's float32 power is correctly rounded, torch's
    is not always, and an ulp of a frequency is 2e-3 rad at position
    32767."""
    half = x.shape[-1] // 2
    expo = -torch.arange(0, half, dtype=f32, device=x.device) / half
    freq = (theta ** expo.double()).to(f32)
    ang = positions[..., None].to(f32) * freq              # (..., T, half)
    cos = torch.cos(ang)[..., None, :]                     # (..., T, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(f32), x[..., half:].to(f32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------- attention


def attention_defs(cfg):
    d, h, g, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        'wq': ParamDef((d, h * hd), ('embed', 'heads')),
        'wk': ParamDef((d, g * hd), ('embed', 'kv_heads')),
        'wv': ParamDef((d, g * hd), ('embed', 'kv_heads')),
        'wo': ParamDef((h * hd, d), ('heads', 'embed')),
    }
    if cfg.qkv_bias:
        defs['bq'] = ParamDef((h * hd,), ('heads',), init='zeros')
        defs['bk'] = ParamDef((g * hd,), ('kv_heads',), init='zeros')
        defs['bv'] = ParamDef((g * hd,), ('kv_heads',), init='zeros')
    return defs


def _repeat_kv(x, n_rep: int):
    """(B, S, G, D) -> (B, S, G*n_rep, D), query head g*n_rep + r reading
    KV head g: the reference's layout, which `blockwise_attention`'s
    grouping reproduces without the copy this makes."""
    if n_rep == 1:
        return x
    b, s, g, d = x.shape
    return x[:, :, :, None, :].expand(b, s, g, n_rep, d).reshape(
        b, s, g * n_rep, d)


def blockwise_attention(q, k, v, *, causal: bool, q_offset=0,
                        block_kv: int = 1024, kv_len=None):
    """Online-softmax attention. q: (B, T, H, D); k, v: (B, S, G, D) with
    G dividing H, query head h reading KV head h // (H/G) (the layout of
    the reference's `_repeat_kv`; G = H is the reference's own call).

    Never forms (T, S): scans the keys in blocks of `block_kv` with a
    running max and denominator. The last block is shorter when S is not
    a multiple of `block_kv` (the reference pads it with masked zeros,
    which add nothing). Positions >= `kv_len` are masked, as in a decode
    step over a fixed-capacity cache. `kv_len` is an int or a 0-d integer
    tensor on q's device: an int lets the scan stop at the last block
    that holds a position below it (the blocks past it would add p = 0
    under a correction of 1: bit for bit the same result), a tensor is
    masked in every block, with no read on the host. Returns (B, T, H, D)
    in q's dtype."""
    b, t, h, dh = q.shape
    s, g = k.shape[1], k.shape[2]
    if h % g:
        raise ValueError(f'{h} query heads do not group over {g} KV heads')
    rep = h // g
    blk = min(block_kv, s)
    nblk = -(-s // blk)
    host_len = isinstance(kv_len, int)
    if host_len:
        nblk = min(nblk, -(-kv_len // blk))
    # the reference multiplies by the scale rounded to q's dtype (jnp's
    # weak-type rule), then rounds the product to that dtype
    scale = float(torch.tensor(dh ** -0.5, dtype=q.dtype))
    q = q * scale
    dev = q.device
    qg = q.to(f32).reshape(b, t, g, rep, dh).permute(0, 2, 3, 1, 4).reshape(
        b, g, rep * t, dh)
    qpos = q_offset + torch.arange(t, device=dev)
    acc = torch.zeros((b, h, t, dh), dtype=f32, device=dev)
    m = torch.full((b, h, t), -torch.inf, dtype=f32, device=dev)
    denom = torch.zeros((b, h, t), dtype=f32, device=dev)
    with full_f32():
        for j in range(nblk):
            lo, hi = j * blk, min((j + 1) * blk, s)
            n = hi - lo
            kj = k[:, lo:hi].to(f32).permute(0, 2, 3, 1)     # (B, G, D, n)
            vj = v[:, lo:hi].to(f32).permute(0, 2, 1, 3)     # (B, G, n, D)
            sc = (qg @ kj).view(b, h, t, n)
            kpos = torch.arange(lo, hi, device=dev)
            mask = None
            if causal:
                mask = qpos[:, None] >= kpos[None, :]
            if kv_len is not None and not (host_len and hi <= kv_len):
                live = (kpos < kv_len)[None, :]
                mask = live if mask is None else mask & live
            if mask is not None:
                sc = torch.where(mask, sc, -torch.inf)
            m_new = torch.maximum(m, sc.amax(-1))
            # guard: fully-masked rows keep m == -inf; exp(-inf - -inf) is
            # nan. exp(-inf - m_safe) = 0 zeroes the first block's
            # correction; m's -inf is never rewritten to 0 here.
            m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
            p = torch.exp(sc - m_safe[..., None])
            corr = torch.exp(m - m_safe)
            denom = denom * corr + p.sum(-1)
            pv = (p.to(q.dtype).to(f32).view(b, g, rep * t, n) @ vj).view(
                b, h, t, dh)
            acc = acc * corr[..., None] + pv
            m = m_new
    denom = torch.clamp(denom, min=1e-30)
    return (acc / denom[..., None]).permute(0, 2, 1, 3).to(q.dtype)


def gqa_attention(p, cfg, x, positions, *, cache_kv=None, cache_len=None,
                  decode=False):
    """Returns (out, (k, v)).

    Train and prefill: causal self-attention over x (B, T, d); (k, v) are
    this call's keys (after RoPE) and values, (B, T, G, D).
    Decode: `cache_kv` is the layer's (k, v) cache, each (B, S, G, D) of
    capacity S, and `cache_len` (an int) the number of positions already
    in it. The new key and value are written into the cache tensors in
    place at that position (raising if they do not fit), the step attends
    over positions < cache_len + 1, and the same cache tensors come back.
    """
    b, t, _ = x.shape
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = mm(x, p.wq), mm(x, p.wk), mm(x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = rope(q.reshape(b, t, h, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, t, g, hd), positions, cfg.rope_theta)
    v = v.reshape(b, t, g, hd)
    if decode:
        ck, cv = cache_kv
        pos = int(cache_len)
        if pos < 0 or pos + t > ck.shape[1]:
            raise ValueError(f'{t} new positions at {pos} do not fit a '
                             f'cache of capacity {ck.shape[1]}')
        ck[:, pos:pos + t] = k
        cv[:, pos:pos + t] = v
        out = blockwise_attention(q, ck, cv, causal=False, kv_len=pos + 1,
                                  block_kv=2048)
        new_kv = (ck, cv)
    else:
        out = blockwise_attention(q, k, v, causal=True, block_kv=1024)
        new_kv = (k, v)
    return mm(out.reshape(b, t, h * hd), p.wo), new_kv


# ------------------------------------------------------------------- FFN


def mlp_defs(cfg, d_ff=None):
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    if cfg.act == 'sq_relu':
        return {'w1': ParamDef((d, ff), ('embed', 'ffn')),
                'w2': ParamDef((ff, d), ('ffn', 'embed'))}
    return {'w1': ParamDef((d, ff), ('embed', 'ffn')),
            'w3': ParamDef((d, ff), ('embed', 'ffn')),
            'w2': ParamDef((ff, d), ('ffn', 'embed'))}


def mlp(p, cfg, x):
    """The gated SiLU MLP ('swiglu') or the squared-ReLU one
    ('sq_relu', no gate)."""
    if cfg.act == 'sq_relu':
        h = torch.square(F.relu(mm(x, p.w1)))
    else:
        h = F.silu(mm(x, p.w1)) * mm(x, p.w3)
    return mm(h, p.w2)


# ---------------------------------------------------------------- modules


class RMSNorm(nn.Module):
    """Parameters of `rmsnorm_defs(d)`: `scale` (d,)."""

    def __init__(self, d, device=None):
        super().__init__()
        add_params(self, rmsnorm_defs(d), device)

    def forward(self, x):
        return rmsnorm(self, x)


class Attention(nn.Module):
    """Parameters of `attention_defs(cfg)`: wq, wk, wv, wo, and bq, bk, bv
    with `cfg.qkv_bias`."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        add_params(self, attention_defs(cfg), device)

    def forward(self, x, positions, cache_kv=None, cache_len=None,
                decode=False):
        return gqa_attention(self, self.cfg, x, positions, cache_kv=cache_kv,
                             cache_len=cache_len, decode=decode)


class MLP(nn.Module):
    """Parameters of `mlp_defs(cfg)`: w1, w2, and w3 unless 'sq_relu'."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        add_params(self, mlp_defs(cfg), device)

    def forward(self, x):
        return mlp(self, self.cfg, x)
