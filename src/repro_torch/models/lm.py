"""Decoder-LM assembly: parameter declarations, the layer stack, and the
train / prefill / decode forwards, for the RWKV-6 family, the dense
attention (GQA) family with its vision and audio frontends, and the MoE
family (MLA or GQA attention; routed and shared experts; a dense layer
0).

The port of the reference's `models/lm.py` but its Mamba hybrid (ROADMAP
Queue 1 item 13(c)(iii)), which raises. The reference scans one layer
body over stacked parameters; the port holds the layers unstacked in an
`nn.ModuleList` and loops over them. Declarations stay stacked
(`model_defs`), so both packages count and draw the same leaves, and
`state_dict_from_tree` unstacks a stacked tree into the port's
`state_dict` keys ('layers.<l>.tm.wr', 'layers.<l>.attn.wq', ...). A
config with `dense_d_ff_first` declares its first layer apart, as
'layer0' (a dense MLP of that width), before the L-1 stacked 'layers';
the forwards run it first and its cache entry comes first.

Every family trains (`train.trainer`) and serves (`launch/steps.py`).
The forwards take the model where the reference takes its parameter
tree, and the config separately, so that one set of weights can run
either WKV route. `forward_train` runs under autograd, each layer
checkpointed (`remat='layer'`, the reference's `jax.checkpoint` of its
scanned layer) so that only the layer boundaries are kept for the
backward; `chunked_xent` is the LM loss over it. A layer 0 declared
apart is checkpointed too, where the reference runs it outside its
checkpoint: the values are the same, and on the card its activations
would stay through the whole backward (chip_smoke.py's moe_train phase
measures the peak both ways). Under the checkpoint's recompute a MoE
layer gets its forward's input bit for bit, so it routes as the forward
did. Prefill and decode are serving entry points and run without
autograd.

The frontends are stubs, as in the reference (`_assemble_inputs`): a
vision model takes precomputed image embeddings, placed before the token
embeddings; an audio model takes precomputed frame embeddings in place
of tokens, in prefill and in decode.

The decode cache keeps the reference's stacked layout. RWKV-6: 's' (L,
B, H, K, K) float32, 'tm_last' and 'cm_last' (L, B, d) bf16, the last
token of each layer's normed inputs; a decode step returns a new cache.
Attention: 'k' and 'v' (L, B, S, G, hd) bf16 of a fixed capacity S, or
for MLA 'ckv' (L, B, S, lora) and 'krope' (L, B, S, r); a prefill returns
them at S = T (`convert.pad_cache` grows them to a capacity), and a
decode step writes the new position into the caller's cache tensors in
place and returns the same dict (`layers.gqa_attention`,
`layers.mla_attention`).
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.platform import full_f32, resolve_device
from . import rwkv6 as R
from .layers import (MLA, MLP, Attention, MoE, RMSNorm, attention_defs,
                     gqa_attention, mla_attention, mla_defs, mlp_defs,
                     moe_defs, rmsnorm, rmsnorm_defs)
from .params import ParamDef, add_params, init_params, stack_tree

f32 = torch.float32
bf16 = torch.bfloat16

# Shape and dtype of a tensor that is not allocated (the counterpart of
# jax.ShapeDtypeStruct).
TensorSpec = collections.namedtuple('TensorSpec', 'shape dtype')


def check_family(cfg):
    if cfg.hybrid_period > 0:
        raise NotImplementedError(
            f'{cfg.name}: the Mamba hybrid is not ported yet (ROADMAP Queue '
            '1 item 13(c)(iii)); the port runs RWKV-6, GQA and MLA '
            'attention, and MoE')
    if cfg.attn not in ('rwkv6', 'gqa', 'mla'):
        raise ValueError(f'{cfg.name}: unknown attention {cfg.attn!r}')


def padded_vocab(cfg) -> int:
    """Vocab rounded up to 256 (the reference's rule)."""
    return -(-cfg.vocab // 256) * 256


# ------------------------------------------------------------- declarations


def _ffn_defs(cfg, l: int):
    if cfg.layer_is_moe(l):
        return moe_defs(cfg)
    if cfg.dense_d_ff_first and l == 0:
        return mlp_defs(cfg, d_ff=cfg.dense_d_ff_first)
    return mlp_defs(cfg)


def _layer_defs(cfg, l: int):
    """Layer l's declaration; the stacked layers are declared from one
    index (1 after a separate layer 0, else 0), as the reference's are."""
    defs = {'ln1': rmsnorm_defs(cfg.d_model),
            'ln2': rmsnorm_defs(cfg.d_model)}
    if cfg.attn == 'rwkv6':
        defs.update(R.rwkv_defs(cfg))
    else:
        defs['attn'] = (mla_defs(cfg) if cfg.attn == 'mla'
                        else attention_defs(cfg))
        defs['ffn'] = _ffn_defs(cfg, l)
    return defs


def _stacked_from(cfg) -> int:
    """The index whose declaration the stacked 'layers' share: 1 when
    layer 0 is declared apart (`dense_d_ff_first`), else 0."""
    return 1 if cfg.dense_d_ff_first else 0


def _top_defs(cfg):
    vp = padded_vocab(cfg)
    d = cfg.d_model
    defs = {
        'embed': ParamDef((vp, d), ('vocab', 'embed'), scale=0.02),
        'score_head': ParamDef((d,), ('embed_act',), scale=0.02),
    }
    if not cfg.tie_embeddings:
        defs['lm_head'] = ParamDef((d, vp), ('embed', 'vocab'))
    return defs


def model_defs(cfg):
    check_family(cfg)
    defs = _top_defs(cfg)
    defs['ln_f'] = rmsnorm_defs(cfg.d_model)
    first = _stacked_from(cfg)
    if first:
        defs['layer0'] = _layer_defs(cfg, 0)
    defs['layers'] = stack_tree(_layer_defs(cfg, first), cfg.n_layers - first)
    return defs


# ------------------------------------------------------------- modules


class RWKVLayer(nn.Module):
    """One RWKV-6 layer: ln1, tm (time mix), ln2, cm (channel mix)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.d_model, device)
        self.tm = R.TimeMix(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, device)
        self.cm = R.ChannelMix(cfg, device)

    def forward(self, x, state=None, tm_last=None, cm_last=None):
        return _rwkv_layer(self, self.cfg, x, state, tm_last, cm_last)


class AttnLayer(nn.Module):
    """One attention layer, declared as layer l: ln1, attn (GQA, or MLA),
    ln2, ffn (MLP, of width `dense_d_ff_first` for a layer 0 declared
    apart, or MoE)."""

    def __init__(self, cfg, l=0, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.d_model, device)
        self.attn = (MLA if cfg.attn == 'mla' else Attention)(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, device)
        if cfg.layer_is_moe(l):
            self.ffn = MoE(cfg, device)
        else:
            first = cfg.dense_d_ff_first and l == 0
            self.ffn = MLP(cfg, device,
                           d_ff=cfg.dense_d_ff_first if first else None)

    def forward(self, x, positions, cache=None, cache_len=None,
                decode=False):
        return _attn_layer(self, self.cfg, x, positions, cache, cache_len,
                           decode)


class LM(nn.Module):
    """The decoder LM: embed, layer0 (with `dense_d_ff_first`), layers
    (unstacked), ln_f, lm_head (unless tied) and score_head, with the
    reference's keys, in bf16. Parameters are left uninitialized;
    `init_model` and `from_state_dict` fill them."""

    def __init__(self, cfg, device=None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        add_params(self, _top_defs(cfg), device)
        self.ln_f = RMSNorm(cfg.d_model, device)
        first = _stacked_from(cfg)
        if cfg.attn == 'rwkv6':
            self.layers = nn.ModuleList(RWKVLayer(cfg, device)
                                        for _ in range(cfg.n_layers))
        else:
            if first:
                self.layer0 = AttnLayer(cfg, 0, device)
            self.layers = nn.ModuleList(AttnLayer(cfg, first, device)
                                        for _ in range(cfg.n_layers - first))

    def forward(self, tokens):
        return forward_train(self, self.cfg, {'tokens': tokens})


def all_layers(params):
    """The model's layers in order: layer0 (where declared apart), then
    the stacked ones."""
    first = getattr(params, 'layer0', None)
    return ([first] if first is not None else []) + list(params.layers)


def state_dict_from_tree(tree, prefix=''):
    """The port's state_dict from a (stacked) parameter tree in the
    reference's layout: the leading layer axis of 'layers' is unstacked
    (as views, no copy); 'layer0' keeps its keys."""
    out = {}
    for key, val in tree.items():
        name = prefix + key
        if isinstance(val, dict):
            out.update(state_dict_from_tree(val, name + '.'))
        elif name.startswith('layers.'):
            rest = name[len('layers.'):]
            for l, layer in enumerate(val.unbind(0)):
                out[f'layers.{l}.{rest}'] = layer
        else:
            out[name] = val
    return out


def from_state_dict(cfg, state_dict) -> LM:
    """An `LM` whose parameters are the tensors of `state_dict` (no copy;
    device and dtype are theirs)."""
    model = LM(cfg, device='meta')
    model.load_state_dict(state_dict, strict=True, assign=True)
    return model


def init_model(cfg, seed: int = 0, device=None, dtype=bf16) -> LM:
    """An `LM` with the reference's initialization (`init_params` over
    `model_defs(cfg)`, in `dtype`) drawn from a `torch.Generator` seeded
    with `seed` on `device` (default: the CUDA device). On the meta
    device nothing is drawn: the model's structure, with no storage."""
    dev = resolve_device(device)
    if dev.type == 'meta':
        return LM(cfg, device=dev).to(dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return from_state_dict(cfg, state_dict_from_tree(
        init_params(model_defs(cfg), gen, dtype)))


# ------------------------------------------------------------- cache


def cache_struct(cfg, batch: int, seq: int, dtype=bf16):
    """TensorSpecs of the decode cache (also used to allocate). The RWKV-6
    state does not grow with `seq`; the attention cache (MLA's latent
    and rope key) holds `seq` positions."""
    check_family(cfg)
    n = cfg.n_layers
    if cfg.attn == 'rwkv6':
        h, k, d = cfg.n_heads, cfg.rwkv_head_dim, cfg.d_model
        return {'s': TensorSpec((n, batch, h, k, k), f32),
                'tm_last': TensorSpec((n, batch, d), dtype),
                'cm_last': TensorSpec((n, batch, d), dtype)}
    if cfg.attn == 'mla':
        return {'ckv': TensorSpec((n, batch, seq, cfg.mla_kv_lora), dtype),
                'krope': TensorSpec((n, batch, seq, cfg.mla_rope_dim), dtype)}
    kv = TensorSpec((n, batch, seq, cfg.n_kv_heads, cfg.head_dim), dtype)
    return {'k': kv, 'v': kv}


def init_cache(cfg, batch: int, seq: int, dtype=bf16, device=None):
    dev = resolve_device(device)
    return {name: torch.zeros(s.shape, dtype=s.dtype, device=dev)
            for name, s in cache_struct(cfg, batch, seq, dtype).items()}


# ------------------------------------------------------------- forwards

# Vocab columns of the LM head cast to float32 at a time by `_last_logits`.
HEAD_COLUMNS = 32768


def _rwkv_layer(lp, cfg, x, state=None, tm_last=None, cm_last=None):
    h, new_s, new_tm = R.rwkv_time_mix(lp.tm, cfg, rmsnorm(lp.ln1, x),
                                       state=state, shift_last=tm_last)
    x = x + h
    h2, new_cm = R.rwkv_channel_mix(lp.cm, cfg, rmsnorm(lp.ln2, x),
                                    shift_last=cm_last)
    x = x + h2
    return x, new_s, new_tm, new_cm


def _attn_layer(lp, cfg, x, positions, cache=None, cache_len=None,
                decode=False):
    """One attention layer under `cfg`: GQA or MLA, then the MLP or the
    MoE, called as its module (so that forward hooks see the FFN's
    input). Returns (x, the layer's cache pair)."""
    h = rmsnorm(lp.ln1, x)
    if cfg.attn == 'mla':
        h, new_cache = mla_attention(lp.attn, cfg, h, positions, cache=cache,
                                     cache_len=cache_len, decode=decode)
    else:
        h, new_cache = gqa_attention(lp.attn, cfg, h, positions,
                                     cache_kv=cache, cache_len=cache_len,
                                     decode=decode)
    x = x + h
    x = x + lp.ffn(rmsnorm(lp.ln2, x), cfg)
    return x, new_cache


def _embed_tokens(params, cfg, tokens):
    return F.embedding(tokens, params.embed)


def _assemble_inputs(params, cfg, batch):
    """The (B, S, d) input of the stack: image embeddings before the
    token embeddings (vision), frame embeddings in place of them
    (audio), or the token embeddings."""
    if cfg.frontend == 'vision':
        tok = _embed_tokens(params, cfg, batch['tokens'])
        return torch.cat([batch['image_embeds'].to(tok.dtype), tok], dim=1)
    if cfg.frontend == 'audio':
        return batch['frame_embeds']
    return _embed_tokens(params, cfg, batch['tokens'])


def _positions(x):
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def lm_head_weight(params, cfg):
    if cfg.tie_embeddings:
        return params.embed.T
    return params.lm_head


def _last_logits(params, cfg, x):
    """Last-position logits (B, vocab_padded): a bf16 x bf16 product with
    float32 accumulation and output, never rounded to bf16. The head is
    cast to float32 HEAD_COLUMNS vocab columns at a time, each logit's sum
    unchanged, so no float32 copy of the whole head is made (18.9 GB at
    nemotron-4-340b's width)."""
    xl = x[:, -1].to(bf16).to(f32)
    w = lm_head_weight(params, cfg)
    return torch.cat([xl @ w[:, c:c + HEAD_COLUMNS].to(f32)
                      for c in range(0, w.shape[1], HEAD_COLUMNS)], dim=1)


def _layer_out(lp, cfg, x, positions):
    if cfg.attn == 'rwkv6':
        return _rwkv_layer(lp, cfg, x)[0]
    return _attn_layer(lp, cfg, x, positions)[0]


def forward_train(params, cfg, batch, remat: str = 'layer'):
    """Full causal forward -> final hidden states (B, S, d), bf16 for bf16
    weights. With autograd on and remat='layer', each layer runs under
    `torch.utils.checkpoint` (non-reentrant): its activations are
    recomputed in the backward, so the forward keeps only each layer's
    input. remat='none' keeps every activation."""
    if remat not in ('none', 'layer'):
        raise ValueError(f"remat must be 'none' or 'layer'; got {remat!r}")
    with full_f32():
        x = _assemble_inputs(params, cfg, batch).to(bf16)
        positions = _positions(x)
        for lp in all_layers(params):
            if remat == 'layer' and torch.is_grad_enabled():
                x = checkpoint(_layer_out, lp, cfg, x, positions,
                               use_reentrant=False)
            else:
                x = _layer_out(lp, cfg, x, positions)
        return rmsnorm(params.ln_f, x)


def chunked_xent(params, cfg, hidden, targets, chunk: int = 512):
    """Mean next-token cross-entropy over the valid targets (0 <= t <
    vocab), in chunks of `chunk` positions (the reference's rule: the
    positions past the last whole chunk are dropped). Each chunk's logits
    are float32 products of the bf16 hidden states and head (exact
    products, float32 sums); the target logit is picked with `gather`,
    which equals the reference's one-hot sum for finite logits."""
    b, s, _ = hidden.shape
    w = lm_head_weight(params, cfg).to(f32)
    chunk = min(chunk, s)
    tot = torch.zeros((), dtype=f32, device=hidden.device)
    cnt = torch.zeros((), dtype=f32, device=hidden.device)
    with full_f32():
        for c0 in range(0, (s // chunk) * chunk, chunk):
            t = targets[:, c0:c0 + chunk].long()
            logits = hidden[:, c0:c0 + chunk].to(f32) @ w
            lse = torch.logsumexp(logits, dim=-1)
            tl = logits.gather(-1, t.clamp(0, logits.shape[-1] - 1)[..., None])
            valid = (t >= 0) & (t < cfg.vocab)
            tot = tot + torch.where(valid, lse - tl[..., 0], 0.0).sum()
            cnt = cnt + valid.sum()
    return tot / torch.clamp(cnt, min=1.0)


@torch.no_grad()
def forward_prefill(params, cfg, batch):
    """Causal forward that also returns the populated cache (attention:
    k and v, or MLA's ckv and krope, at capacity S = T; layer 0's first)
    and the last-position logits (B, vocab_padded) float32."""
    names = tuple(cache_struct(cfg, 0, 0))
    with full_f32():
        x = _assemble_inputs(params, cfg, batch).to(bf16)
        positions = _positions(x)
        cache = collections.defaultdict(list)
        for lp in all_layers(params):
            if cfg.attn == 'rwkv6':
                x, st, tm, cm = _rwkv_layer(lp, cfg, x)
                new = {'s': st, 'tm_last': tm, 'cm_last': cm}
            else:
                x, pair = _attn_layer(lp, cfg, x, positions)
                new = dict(zip(names, pair))
            for key, val in new.items():
                cache[key].append(val)
        x = rmsnorm(params.ln_f, x)
        logits = _last_logits(params, cfg, x)
    return {k: torch.stack(v) for k, v in cache.items()}, logits


@torch.no_grad()
def forward_decode(params, cfg, cache, batch, pos):
    """One-token decode. `batch` holds 'tokens' (B, 1), or 'frame_embeds'
    (B, 1, d) for an audio model; `pos` (an int) counts the positions
    already in the cache. Returns (cache, logits).

    RWKV-6 needs no position and returns a new state cache. Attention
    writes the new key and value at `pos` into `cache['k']` and
    `cache['v']` in place (MLA: its latent and rope key into
    `cache['ckv']` and `cache['krope']`; their capacity must exceed
    `pos`) and returns the caller's dict, so a step copies nothing of the
    cache."""
    with full_f32():
        if cfg.frontend == 'audio':
            x = batch['frame_embeds'].to(bf16)                  # (B, 1, d)
        else:
            x = _embed_tokens(params, cfg, batch['tokens']).to(bf16)
        if cfg.attn == 'rwkv6':
            new = {'s': [], 'tm_last': [], 'cm_last': []}
            for l, lp in enumerate(params.layers):
                x, st, tm, cm = _rwkv_layer(
                    lp, cfg, x, state=cache['s'][l],
                    tm_last=cache['tm_last'][l], cm_last=cache['cm_last'][l])
                new['s'].append(st)
                new['tm_last'].append(tm)
                new['cm_last'].append(cm)
            cache = {k: torch.stack(v) for k, v in new.items()}
        else:
            pos = int(pos)
            positions = torch.full((x.shape[0], 1), pos, device=x.device)
            names = tuple(cache_struct(cfg, 0, 0))
            for l, lp in enumerate(all_layers(params)):
                x, _ = _attn_layer(lp, cfg, x, positions,
                                   cache=tuple(cache[k][l] for k in names),
                                   cache_len=pos, decode=True)
        x = rmsnorm(params.ln_f, x)
        logits = _last_logits(params, cfg, x)
    return cache, logits
