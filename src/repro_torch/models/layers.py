"""Building blocks of the LM families: the RMS norm, RoPE, grouped-query
attention (GQA), multi-head latent attention (MLA), the MLP and the
mixture of experts (MoE).

The port of the reference's `models/layers.py` but `moe_ffn_ep`, which
needs a mesh (ROADMAP Queue 1 item 13(c)(iv)); without one the reference
falls back to `moe_ffn`, and so does the port for `moe_impl='ep'`. Each
block has a `*_defs(cfg)` declaration and a forward function that takes
the block's `nn.Module` (whose parameters carry the reference's keys)
where the reference takes its parameter dict.

Attention keeps the reference's arithmetic, which is plain jnp, not a
Pallas kernel: an online softmax over blocks of keys (1024 in prefill
and training, 2048 in decode) that never forms the (T, S) score matrix.
The scores and P.V take bf16 operands with float32 products and sums
(the reference's `preferred_element_type=f32`); the port upcasts and
multiplies under `full_f32()`, so that TF32 rounds nothing. q is scaled
and rounded to its dtype first, p is rounded to q's dtype before P.V,
and RoPE works in float32 and casts back.

Departures that compute the same values with less traffic:

* No repeated keys. The reference repeats each KV head for its query
  heads (`_repeat_kv`) before it attends. The port groups the query
  heads instead, (B, G, rep*T, D) against (B, G, S, D): the same dot
  products, with no copy of the keys and values (at decode that copy
  would be the whole cache, every step).
* The decode cache is written in place. The reference's
  `dynamic_update_slice` returns a new cache; the port writes the new
  entries at `pos` into the caller's cache tensors and returns those
  same tensors, so a decode step copies nothing of the cache. Key
  blocks that lie wholly at or past `kv_len` are skipped: each would add
  p = 0 under a correction of exp(0) = 1, which leaves every running sum
  bit for bit as it was (tests/test_torch_attention.py holds the two
  equal).
* MLA's keys and values are written into buffers a block of 2048
  positions at a time, where the reference forms them in one product
  over all positions; under autograd the writes' backward (CopySlices)
  hands each block's gradient to w_uk, w_uv and the rope key, the
  gradients the reference's (tests/test_torch_moe_train.py).
* MLA decode up-projects only the cached positions that the scan visits
  (the blocks of 2048 below `kv_len`), where the reference projects the
  whole capacity every step; the projection runs a block of 2048
  positions at a time, so the visited blocks get the bits that the whole
  capacity's would (tests/test_torch_mla.py). MLA's values are not
  padded to the keys' width: P.V's output columns do not depend on each
  other, and the test shows the first head_dim columns equal to the
  padded call's.
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
    """Online-softmax attention. q, k: (B, T, H, D) and (B, S, G, D), v:
    (B, S, G, Dv) with G dividing H, query head h reading KV head
    h // (H/G) (the layout of the reference's `_repeat_kv`; G = H is the
    reference's own call).

    Never forms (T, S): scans the keys in blocks of `block_kv` with a
    running max and denominator. The last block is shorter when S is not
    a multiple of `block_kv` (the reference pads it with masked zeros,
    which add nothing). Positions >= `kv_len` are masked, as in a decode
    step over a fixed-capacity cache. `kv_len` is an int or a 0-d integer
    tensor on q's device: an int lets the scan stop at the last block
    that holds a position below it (the blocks past it would add p = 0
    under a correction of 1: bit for bit the same result), a tensor is
    masked in every block, with no read on the host. Returns (B, T, H, Dv)
    in q's dtype."""
    b, t, h, dh = q.shape
    dv = v.shape[-1]
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
    acc = torch.zeros((b, h, t, dv), dtype=f32, device=dev)
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
                b, h, t, dv)
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


# ------------------------------------------------------------------- MLA

# Positions a decode step attends to and up-projects at a time (the
# reference's decode key block).
DECODE_BLOCK = 2048


def mla_defs(cfg):
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    lora, rdim = cfg.mla_kv_lora, cfg.mla_rope_dim
    return {
        'wq': ParamDef((d, h * (hd + rdim)), ('embed', 'heads')),
        'w_dkv': ParamDef((d, lora), ('embed', 'kv_lora')),
        'w_krope': ParamDef((d, rdim), ('embed', 'none')),
        'w_uk': ParamDef((lora, h * hd), ('kv_lora', 'heads')),
        'w_uv': ParamDef((lora, h * hd), ('kv_lora', 'heads')),
        'wo': ParamDef((h * hd, d), ('heads', 'embed')),
    }


def mla_project(p, cfg, x, positions):
    """(q, c_kv, k_rope) of x (B, T, d): the queries (B, T, H, hd + r),
    RoPE on their last r columns; the latent c_kv (B, T, lora) and the
    rope key (B, T, r) shared by the heads, which the cache keeps."""
    b, t, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = mm(x, p.wq).reshape(b, t, h, hd + cfg.mla_rope_dim)
    q = torch.cat([q[..., :hd], rope(q[..., hd:], positions, cfg.rope_theta)],
                  dim=-1)
    krope = rope(mm(x, p.w_krope)[:, :, None, :], positions,
                 cfg.rope_theta)[:, :, 0, :]
    return q, mm(x, p.w_dkv), krope


def mla_keys_values(p, cfg, ckv, krope):
    """Keys (B, S, H, hd + r) and values (B, S, H, hd) of S positions of
    c_kv (B, S, lora) and k_rope (B, S, r): c_kv up-projected by w_uk and
    w_uv, DECODE_BLOCK positions at a time, and k_rope broadcast over the
    heads (an expanded view written into the keys)."""
    b, s, _ = ckv.shape
    h, hd, rdim = cfg.n_heads, cfg.head_dim, cfg.mla_rope_dim
    k = ckv.new_empty((b, s, h, hd + rdim))
    v = ckv.new_empty((b, s, h, hd))
    for lo in range(0, s, DECODE_BLOCK):
        c = ckv[:, lo:lo + DECODE_BLOCK]
        n = c.shape[1]
        k[:, lo:lo + n, :, :hd] = mm(c, p.w_uk).view(b, n, h, hd)
        k[:, lo:lo + n, :, hd:] = krope[:, lo:lo + n, None, :].expand(
            b, n, h, rdim)
        v[:, lo:lo + n] = mm(c, p.w_uv).view(b, n, h, hd)
    return k, v


def mla_attention(p, cfg, x, positions, *, cache=None, cache_len=None,
                  decode=False):
    """Multi-head latent attention (DeepSeek-V2). Returns (out, cache),
    the cache (c_kv (B, S, lora), k_rope (B, S, r)): the compressed
    latent and the shared rope key, not per-head keys and values.

    Train and prefill: causal self-attention over x (B, T, d); the cache
    is this call's (S = T).
    Decode: `cache` is the layer's (c_kv, k_rope) of capacity S and
    `cache_len` (an int) the positions already in it. The new entries are
    written in place at that position (raising if they do not fit), the
    step projects and attends over the blocks of DECODE_BLOCK positions
    below cache_len + 1, and the same cache tensors come back."""
    b, t, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q, ckv_new, krope_new = mla_project(p, cfg, x, positions)
    if decode:
        ckv, krope = cache
        pos = int(cache_len)
        if pos < 0 or pos + t > ckv.shape[1]:
            raise ValueError(f'{t} new positions at {pos} do not fit a '
                             f'cache of capacity {ckv.shape[1]}')
        ckv[:, pos:pos + t] = ckv_new
        krope[:, pos:pos + t] = krope_new
        kv_len = pos + 1
        n = min(ckv.shape[1], -(-kv_len // DECODE_BLOCK) * DECODE_BLOCK)
        k, v = mla_keys_values(p, cfg, ckv[:, :n], krope[:, :n])
        out = blockwise_attention(q, k, v, causal=False, kv_len=kv_len,
                                  block_kv=DECODE_BLOCK)
        new_cache = (ckv, krope)
    else:
        k, v = mla_keys_values(p, cfg, ckv_new, krope_new)
        out = blockwise_attention(q, k, v, causal=True, block_kv=1024)
        new_cache = (ckv_new, krope_new)
    return mm(out.reshape(b, t, h * hd), p.wo), new_cache


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


# ------------------------------------------------------------------- MoE


def moe_defs(cfg):
    m = cfg.moe
    d, ff, e = cfg.d_model, m.moe_d_ff, m.num_experts
    defs = {
        'router': ParamDef((d, e), ('embed', 'experts'), scale=0.02),
        'w1': ParamDef((e, d, ff), ('experts', 'embed', 'ffn')),
        'w3': ParamDef((e, d, ff), ('experts', 'embed', 'ffn')),
        'w2': ParamDef((e, ff, d), ('experts', 'ffn', 'embed')),
    }
    if m.shared_experts:
        defs['shared'] = mlp_defs(cfg, d_ff=m.moe_d_ff * m.shared_experts)
    return defs


def _router_probs(p, xf):
    """Softmax over the experts of the float32 router logits of xf
    (n, d): exact products of the bf16 operands, float32 sums."""
    with full_f32():
        return torch.softmax(xf.to(f32) @ p.router.to(f32), dim=-1)


def _top_k(probs, k):
    """(values, indices) of the k largest probabilities of each row,
    descending, ties to the lower index (`jax.lax.top_k`'s order; a
    stable descending sort keeps it, where `torch.topk` need not)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def expert_capacity(cfg, n: int) -> int:
    """Slots per expert for n tokens: the reference's expression, rounded
    up to a multiple of 8."""
    m = cfg.moe
    cap = int(max(1, (n * m.top_k / m.num_experts) * m.capacity_factor))
    return -(-cap // 8) * 8


def moe_route(p, cfg, xf):
    """The reference's routing of n tokens xf (n, d), returned as (gate,
    idx, keep, slot, table):

    gate (n, k) float32, the top-k probabilities renormalized to sum 1;
    idx (n, k) their experts; keep (n*k,) whether each (token, choice),
    in token-major order, found a slot; slot (n*k,) that slot, e*cap for
    a dropped one; table (e, cap) the token in each slot, n where empty.
    A choice's place in its expert's queue counts the earlier choices of
    that expert in the flat (n*k) order; places at or past the capacity
    are dropped. The reference counts them by a cumulative sum over an
    (n*k, E) one-hot; the port gets the same integers from a stable sort
    by expert (the flat order kept within each expert) less each
    expert's first sorted position, where the one-hot's scan down its
    n*k rows took 76 ms a layer on the H100 at 8 x 4096 tokens."""
    n = xf.shape[0]
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cap = expert_capacity(cfg, n)
    gate, idx = _top_k(_router_probs(p, xf), k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_e = idx.reshape(-1)
    by_expert = torch.sort(flat_e, stable=True)[1]
    count = torch.bincount(flat_e, minlength=e)
    first = count.cumsum(0) - count
    place = torch.empty_like(flat_e)
    place[by_expert] = (torch.arange(flat_e.numel(), device=xf.device)
                        - first[flat_e[by_expert]])
    keep = place < cap
    slot = torch.where(keep, flat_e * cap + place, e * cap)
    table = torch.full((e * cap + 1,), n, dtype=torch.long, device=xf.device)
    # dropped choices all land in the last (overflow) entry, cut below
    table[slot] = torch.arange(n, device=xf.device).repeat_interleave(k)
    return gate, idx, keep, slot, table[:e * cap].view(e, cap)


def moe_combine(y_slots, gate, keep, slot):
    """(n, d): each token's k choices' slot outputs y_slots (e*cap, d),
    each scaled by its float32 gate (n, k), summed in float32. A dropped
    choice reads slot 0 under gate 0, as the reference's does: it adds
    exactly 0 to its token, and in the backward exactly 0 to slot 0 (the
    gather's backward is an accumulating `index_put_`)."""
    n, k = gate.shape
    slot_gate = torch.where(keep, gate.reshape(-1), 0.0)
    y_tok = y_slots[torch.where(keep, slot, 0)] * slot_gate[:, None]
    return y_tok.view(n, k, -1).sum(1)


def moe_ffn(p, cfg, x):
    """Top-k capacity-based MoE: tokens gathered into an (E, cap, d)
    buffer by the dispatch table (`moe_route`), the experts' gated SiLU
    MLPs as batched products, each kept choice's output scaled by its
    float32 gate and summed over the k choices in float32
    (`moe_combine`), the shared experts' MLP added, and the sum cast to
    x's dtype.

    Under autograd the gradient follows the reference's: the gate, the
    top-k probabilities renormalized, carries it to the router (through
    the sort's values, `_top_k`); the routing's integers (the sorts'
    indices, places, slots and table) carry none."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    gate, _, keep, slot, table = moe_route(p, cfg, xf)
    x_e = torch.cat([xf, xf.new_zeros((1, d))])[table]       # (e, cap, d)
    h = F.silu(mm(x_e, p.w1)) * mm(x_e, p.w3)
    y_slots = mm(h, p.w2).reshape(-1, d)                      # (e*cap, d)
    y = moe_combine(y_slots, gate, keep, slot)
    if cfg.moe.shared_experts:
        y = y + mlp(p.shared, cfg, xf)
    return y.reshape(b, t, d).to(x.dtype)


def moe_aux_loss(p, cfg, x):
    """Load-balancing auxiliary loss (Switch-style): E times the sum over
    experts of the share of top-k choices and the mean probability."""
    m = cfg.moe
    probs = _router_probs(p, x.reshape(-1, x.shape[-1]))
    _, idx = _top_k(probs, m.top_k)
    frac = F.one_hot(idx, m.num_experts).to(f32).mean((0, 1))
    return m.num_experts * torch.sum(frac * probs.mean(0))


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


class MLA(nn.Module):
    """Parameters of `mla_defs(cfg)`: wq, w_dkv, w_krope, w_uk, w_uv,
    wo."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        add_params(self, mla_defs(cfg), device)

    def forward(self, x, positions, cache=None, cache_len=None,
                decode=False):
        return mla_attention(self, self.cfg, x, positions, cache=cache,
                             cache_len=cache_len, decode=decode)


class MLP(nn.Module):
    """Parameters of `mlp_defs(cfg, d_ff)`: w1, w2, and w3 unless
    'sq_relu'. Its forward runs under `cfg` (default: the module's)."""

    def __init__(self, cfg, device=None, d_ff=None):
        super().__init__()
        self.cfg = cfg
        add_params(self, mlp_defs(cfg, d_ff), device)

    def forward(self, x, cfg=None):
        return mlp(self, cfg or self.cfg, x)


class MoE(nn.Module):
    """Parameters of `moe_defs(cfg)`: router (d, E), w1 and w3 (E, d,
    ff), w2 (E, ff, d), and `shared`, an MLP of width ff times the shared
    experts, where the config has them."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        defs = moe_defs(cfg)
        shared = defs.pop('shared', None)
        add_params(self, defs, device)
        if shared is not None:
            m = cfg.moe
            self.shared = MLP(cfg, device, d_ff=m.moe_d_ff * m.shared_experts)

    def forward(self, x, cfg=None):
        """moe_ffn under `cfg` (default: the module's), whose capacity
        factor and routing apply."""
        return moe_ffn(self, cfg or self.cfg, x)
