"""Train-step factory: LM cross-entropy or RankSVM-hinge (reward model)
objectives, microbatch gradient accumulation, AdamW and a schedule; the
counterpart of `repro.train.trainer`.

The `rank_hinge` objective is the paper's technique as a training
objective: a scalar score head on the last hidden state, trained against
the exact pairwise hinge over the whole batch through the linearithmic
loss of `core.rank_loss` (its gradient is Lemma 2's subgradient).

The train state is {'params': an `LM` (bf16 compute weights),
'opt': `optim.adamw` state, 'step': int32 scalar}. A step updates it in
place (see `optim.adamw`) and returns it with its metrics. Since an
update in place cannot be dropped afterwards, a step whose loss or
gradient norm is not finite makes none: it leaves the state as it was
and reports a NaN loss, so that the runtime loop's NaN policy sees it
('skip' then keeps the state of the step before, as the reference's
does). That check reads one flag back before the update. The whole
step, backward and optimizer included, runs under `full_f32()`, so that
no float32 product of the backward falls to TF32.
"""

from __future__ import annotations

import torch

from ..core.rank_loss import pairwise_hinge_loss
from ..kernels.platform import full_f32, resolve_device
from ..models import lm as LM
from ..optim import adamw
from ..optim.schedules import make_schedule

f32 = torch.float32


def loss_fn(params, cfg, tcfg, batch):
    """The scalar float32 loss of `batch` under `tcfg.objective`."""
    hidden = LM.forward_train(params, cfg, batch, remat=tcfg.remat)
    if tcfg.objective == 'rank_hinge':
        scores = hidden[:, -1, :].to(f32) @ params.score_head.to(f32)
        return pairwise_hinge_loss(scores, batch['utilities'],
                                   batch.get('groups'))
    if tcfg.objective != 'lm':
        raise ValueError(f"objective must be 'lm' or 'rank_hinge'; got "
                         f'{tcfg.objective!r}')
    targets = batch['targets']
    if cfg.frontend == 'vision':
        hidden = hidden[:, -targets.shape[1]:, :]   # loss on text positions
    return LM.chunked_xent(params, cfg, hidden, targets)


def loss_and_grads(params, cfg, tcfg, batch):
    """(loss, {name: gradient}) of `batch`, split into
    `tcfg.microbatches` along the batch: with more than one, each
    microbatch's gradients are summed in float32 and the sums and the
    loss divided by their number, as the reference does. With one, the
    gradients are in the parameters' dtype."""
    names, leaves = zip(*params.named_parameters())

    def grad(loss):   # an unused head (score_head or lm_head) gets zeros
        return torch.autograd.grad(loss, leaves, allow_unused=True,
                                   materialize_grads=True)

    k = tcfg.microbatches
    if k <= 1:
        loss = loss_fn(params, cfg, tcfg, batch)
        return loss.detach(), dict(zip(names, grad(loss)))
    lsum = torch.zeros((), dtype=f32, device=leaves[0].device)
    gsum = [torch.zeros(p.shape, dtype=f32, device=p.device)
            for p in leaves]
    rows = next(iter(batch.values())).shape[0]
    if rows % k:
        raise ValueError(f'batch of {rows} does not split into {k} '
                         'microbatches')
    step = rows // k
    for i in range(k):
        mb = {key: val[i * step:(i + 1) * step] for key, val in batch.items()}
        loss = loss_fn(params, cfg, tcfg, mb)
        for acc, g in zip(gsum, grad(loss)):
            acc.add_(g.to(f32))
        lsum = lsum + loss.detach()
    return lsum / k, {name: g / k for name, g in zip(names, gsum)}


def make_train_step(cfg, tcfg):
    """train_step(state, batch) -> (state, {'loss', 'gnorm', 'lr'}), where
    batch holds the model's inputs ('tokens'; 'image_embeds' before them
    for a vision model, 'frame_embeds' in their place for an audio one)
    and 'targets' (lm) or 'utilities' and optionally 'groups'
    (rank_hinge), on the parameters' device.

    The RWKV-6, dense attention (GQA), MLA and MoE families train, a
    dense layer 0 included, their gradients held to the reference's; the
    Mamba hybrid raises in `models.lm` (ROADMAP Queue 1 item 13(c)(iii)).
    As in the reference, the loss is the objective's alone: MoE's
    load-balancing loss (`layers.moe_aux_loss`) is not added."""
    LM.check_family(cfg)
    schedule = make_schedule(cfg, tcfg)

    def train_step(state, batch):
        model = state['params']
        with full_f32():
            loss, grads = loss_and_grads(model, cfg, tcfg, batch)
            lr = schedule(state['step']).to(loss.device)
            gnorm = adamw.global_norm(grads)
            if not bool(torch.isfinite(loss) & torch.isfinite(gnorm)):
                return state, {'loss': torch.full_like(loss, float('nan')),
                               'gnorm': gnorm, 'lr': lr}
            _, opt, gnorm = adamw.apply(
                grads, state['opt'], dict(model.named_parameters()), lr=lr,
                beta1=tcfg.beta1, beta2=tcfg.beta2, eps=tcfg.eps,
                weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip,
                gnorm=gnorm)
        state['opt'] = opt
        state['step'] = state['step'] + 1
        return state, {'loss': loss, 'gnorm': gnorm, 'lr': lr}

    return train_step


def state_for(model):
    """The train state at step 0 of an `LM`: the model, its AdamW state
    (master weights copied from it)."""
    params = dict(model.named_parameters())
    return {'params': model, 'opt': adamw.init(params),
            'step': torch.zeros((), dtype=torch.int32,
                                device=next(iter(params.values())).device)}


def init_state(cfg, seed: int = 0, dtype=torch.bfloat16, device=None):
    """A fresh train state: `LM.init_model(cfg, seed)` in `dtype` on
    `device` (default: the CUDA device), its AdamW state, step 0."""
    return state_for(LM.init_model(cfg, seed=seed,
                                   device=resolve_device(device),
                                   dtype=dtype))
