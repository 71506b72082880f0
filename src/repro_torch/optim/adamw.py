"""AdamW with bf16 compute weights over float32 master weights and
moments (mixed precision), the counterpart of `repro.optim.adamw`.

State: {'mu': {name: {'master', 'm', 'v'}} float32 per parameter,
'count': int32 scalar}. The model's (bf16) parameters feed the forward
and backward; `apply` updates the float32 master copy and writes it back
rounded to the parameters' dtype.

Unlike the reference, whose arrays are immutable, `apply` updates the
state and the parameters in place: at the `rwkv6-3b` width master, m and
v take 36.9 GB, and a second copy would not fit beside them on the card.
Each update is computed as the reference writes it, every operation in
float32 (lr included, as a float32 scalar), so both packages round alike.
"""

from __future__ import annotations

import torch

f32 = torch.float32


def init(params) -> dict:
    """The optimizer state of `params` (a mapping name -> tensor, such as
    `dict(model.named_parameters())`): master = the parameter in float32,
    m = v = 0, count = 0."""
    return {'mu': {name: {'master': p.detach().to(f32).clone(),
                          'm': torch.zeros(p.shape, dtype=f32,
                                           device=p.device),
                          'v': torch.zeros(p.shape, dtype=f32,
                                           device=p.device)}
                   for name, p in params.items()},
            'count': torch.zeros((), dtype=torch.int32,
                                 device=next(iter(params.values())).device)}


@torch.no_grad()
def global_norm(grads):
    """The float32 global norm of `grads` (name -> tensor), the norm
    `apply` clips to."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(f32)))
                          for g in grads.values()))


@torch.no_grad()
def apply(grads, state, params, *, lr, beta1=0.9, beta2=0.95, eps=1e-8,
          weight_decay=0.1, grad_clip=1.0, gnorm=None):
    """One AdamW step, in place. `grads`, `params`: mappings name ->
    tensor with the keys of state['mu']; `lr`: this step's learning rate
    (a float32 scalar tensor or a number).

    The gradients are clipped to the global norm `grad_clip`; bias
    correction follows the int32 count; decay is decoupled:
    master <- master (1 - lr wd) - lr m^ / (sqrt(v^) + eps). `gnorm` is
    `global_norm(grads)` where the caller has computed it already. Returns
    (params, state, gnorm), the first two being the arguments, updated."""
    count = state['count'] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.where(gnorm > grad_clip, grad_clip / (gnorm + 1e-9),
                        torch.ones((), dtype=f32, device=gnorm.device))
    cf = count.to(f32)
    b1c = 1.0 - beta1 ** cf
    b2c = 1.0 - beta2 ** cf
    lr = torch.as_tensor(lr, dtype=f32, device=gnorm.device)
    keep = 1.0 - lr * weight_decay
    for name, s in state['mu'].items():
        g = grads[name].to(f32) * scale
        s['m'].mul_(beta1).add_((1 - beta1) * g)
        s['v'].mul_(beta2).add_((1 - beta2) * torch.square(g))
        upd = (s['m'] / b1c) / (torch.sqrt(s['v'] / b2c) + eps)
        s['master'].mul_(keep).sub_(lr * upd)
        params[name].copy_(s['master'])
    state['count'] = count
    return params, state, gnorm
