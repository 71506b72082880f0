"""Shared helpers of the port's train-step parity tests
(tests/test_torch_train_step.py, tests/test_torch_train_rank.py,
tests/test_torch_dense_train*.py).

`step_pair` builds a reduced config with the JAX package's init (bf16
weights; RWKV-6's `mu_*`, `w0` and `u` given seeded values, as
tests/test_torch_rwkv.py does; the attention configs' zero-initialized
QKV biases drawn, as tests/test_torch_dense_lm.py does, and their layer
matrices brought to std 1/sqrt(fan-in), see `_reference_state`),
carries the reference's whole train state into the port with
`convert.train_state_from_reference`, and lets both packages take two
train steps on the same batch from it. The batch is the model's inputs
(tokens; image embeddings before them for a vision model, codebook
frames in their place for an audio one, by the train CLI's
`repro_torch.data.frontend_inputs`) with targets or utilities.
`check_pair` holds the results to the bf16 bars:

* loss within 2e-3 relative and gnorm within 2e-2 relative, at both
  steps; the learning rates equal;
* master weights after step 1 within 2 lr elementwise, plus one float32
  rounding of the master: Adam's first step moves each weight by at most
  lr, so a gradient whose sign differs between the packages (a gradient
  near zero, where bf16 rounding decides it) moves the two masters 2 lr
  apart.

`f32_grad_pair` gives both packages' gradients of the whole model in
float32 from the same state and batch.

MoE routing. Top-k is discrete: a token routed to another expert moves
by a whole expert's output, so the bars above hold only where both
packages route alike. For a MoE config both helpers record every MoE
call's input and router in both packages (`record_routing`) and
compare them call by call (the forward's layers in order, then, under
remat='layer', their recompute in the backward in reverse;
`routing_gap`). Before any result is compared, every token must go to
the same experts, with the reference's probabilities leaving a relative
margin between each token's k-th and (k+1)-th of at least LM_MARGIN =
1e-3 in bf16 (tests/test_torch_moe_lm.py) or F32_MARGIN = 1e-4 in
float32, where the packages' inputs differ by float32 sums in another
order, some 1e-6 of themselves (tests/test_torch_moe.py):
`f32_grad_pair` asserts it, `check_pair` asserts it first, at both
steps (after step 1 the two packages' weights differ by ulps, and a
weight that rounds to another bf16 value moves by 2^-8 of itself).
"""

import contextlib
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.reduced import reduced as j_reduced
from repro.data import RewardPipeline, TokenPipeline, TokenPipelineConfig
from repro.distributed.sharding import NoSharding
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models.params import init_params as j_init
from repro.optim import adamw as JA
from repro.train import trainer as JT
from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.reduced import reduced
from repro_torch.data import frontend_inputs
from repro_torch.kernels.platform import full_f32
from repro_torch.models import layers as TL
from repro_torch.models import lm as LM
from repro_torch.models.lm import state_dict_from_tree
from repro_torch.train import trainer as TT

LR = 3e-4
LM_MARGIN = 1e-3
F32_MARGIN = 1e-4


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _fan_in(path, a):
    """A stacked layer matrix (L, in, out), or an expert's (L, E, in,
    out), drawn at std 1/sqrt(L) scaled to std 1/sqrt(in); the router
    (drawn at its own std 0.02), the norms and biases as they are."""
    if path[-1].key == 'router' or a.ndim < 3:
        return a
    return a * np.sqrt(a.shape[0] / a.shape[-2])


def _reference_state(cfg, seed, fan_in=True):
    """The reference's train state at step 0 of its init, with seeded
    values where the init has constants. The reference's fan-in rule
    reads a stacked layer matrix's leading axis, the layer count, so it
    draws every layer matrix at std 1/sqrt(L): at the reduced sizes that
    saturates the attention's softmax, and a bf16 step there is decided
    by rounding (the reference's own compiled and op-by-op steps then
    differ in gnorm by up to 98% at step 2). With `fan_in` the attention
    configs' layer matrices (L, in, out), and the experts' (L, E, in,
    out), are scaled to std 1/sqrt(in), the rule applied to one layer
    (`_fan_in`). A dense layer 0, declared apart, is unstacked and its
    init already reads its own fan-in."""
    tree = jax.tree.map(_f32, j_init(JLM.model_defs(cfg),
                                     jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    lay = tree['layers']
    if cfg.attn == 'rwkv6':
        for blk in ('tm', 'cm'):
            for name in [k for k in lay[blk] if k.startswith('mu_')]:
                lay[blk][name] = rng.uniform(0, 1, lay[blk][name].shape)
        lay['tm']['w0'] = rng.uniform(-2, 1, lay['tm']['w0'].shape)
        lay['tm']['u'] = rng.normal(0, 0.5, lay['tm']['u'].shape)
    else:
        for name in ('bq', 'bk', 'bv'):
            if name in lay['attn']:
                lay['attn'][name] = rng.normal(0, 0.5,
                                               lay['attn'][name].shape)
        if fan_in:
            tree['layers'] = jax.tree_util.tree_map_with_path(_fan_in, lay)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    return {'params': params, 'opt': JA.init(params),
            'step': jnp.zeros((), jnp.int32)}


@contextlib.contextmanager
def record_routing(model):
    """Records, for the calls made inside, each MoE call's (input,
    router) in the reference (a `jax.debug.callback` in a wrapped
    `repro.models.layers.moe_ffn`, which the reference's layers look up
    at trace time) and in the port (forward pre-hooks on `model`'s MoE
    modules), into the yielded {'ref': [...], 'port': [...]}."""
    rec = {'ref': [], 'port': []}
    inner = JL.moe_ffn

    def wrapped(p, cfg, x, shd):
        jax.debug.callback(
            lambda v, r: rec['ref'].append((np.asarray(v), np.asarray(r))),
            x, p['router'])
        return inner(p, cfg, x, shd)

    def hook(mod, args):
        rec['port'].append((args[0].detach().clone(),
                            mod.router.detach().clone()))

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, TL.MoE)]
    JL.moe_ffn = wrapped
    try:
        yield rec
        jax.effects_barrier()
    finally:
        JL.moe_ffn = inner
        for h in hooks:
            h.remove()


def routing_gap(rec, cfg):
    """(tokens routed apart, least margin) over `record_routing`'s calls,
    call by call: the number of tokens that the port sends to other
    experts than the reference does, and the least relative margin
    between a token's k-th and (k+1)-th probability in the reference.
    Both packages must have made the same number of calls. The records
    read are cleared."""
    jax.effects_barrier()
    k = cfg.moe.top_k
    assert len(rec['ref']) == len(rec['port']) > 0, (
        len(rec['ref']), len(rec['port']))
    apart, margin = 0, np.inf
    for (xr, rr), (xt, rt) in zip(rec['ref'], rec['port']):
        xr = jnp.asarray(xr).reshape(-1, xr.shape[-1])
        probs = jax.nn.softmax(jnp.einsum('nd,de->ne', xr, jnp.asarray(rr),
                                          preferred_element_type=jnp.float32))
        top = -np.sort(-np.asarray(probs), axis=-1)
        margin = min(margin, float(
            ((top[:, k - 1] - top[:, k]) / top[:, k - 1]).min()))
        with torch.no_grad():
            _, idx, _, _, _ = TL.moe_route(
                SimpleNamespace(router=rt), cfg, xt.reshape(-1, xt.shape[-1]))
        want = np.sort(np.asarray(jax.lax.top_k(probs, k)[1]), axis=1)
        apart += int((np.sort(idx.numpy(), axis=1) != want).any(1).sum())
    rec['ref'].clear()
    rec['port'].clear()
    return apart, margin


def assert_same_routing(gap, margin):
    """Every token routed alike, the reference's margin at least
    `margin`: `routing_gap`'s (apart, least margin)."""
    apart, least = gap
    assert apart == 0 and least >= margin, (
        f'{apart} tokens routed apart; least margin {least:.2e} '
        f'(needs {margin:.0e})')


def _raw_batch(cfg, objective, batch, seq, groups, seed):
    """numpy batch of the config's inputs and the objective's labels."""
    if objective == 'lm':
        raw = TokenPipeline(TokenPipelineConfig(cfg.vocab, seq, batch,
                                                seed=seed)).batch(0)
    else:
        raw = RewardPipeline(cfg.vocab, seq, batch, seed=seed,
                             n_groups=groups).batch(0)
    tokens = raw.pop('tokens')
    return {**raw, **frontend_inputs(cfg, batch, seed)(0, tokens)}


def _masters(mu):
    """{port name: float32 master} of a reference `mu` tree."""
    return state_dict_from_tree(jax.tree.map(
        lambda d: torch.as_tensor(np.array(d['master'])), mu,
        is_leaf=lambda d: isinstance(d, dict) and 'master' in d))


def step_pair(arch, objective, *, batch, impl=None, remat='layer',
              microbatches=1, groups=0, seed=0, seq=32, fan_in=True):
    """Two train steps of each package from one state on one batch of
    `batch` sequences of `seq` positions of reduced `arch` (RWKV-6 on the
    WKV route `impl`): {'jax'|'port': {'metrics': [step 1, step 2],
    'master': {name: master after step 1}}, 'count', 'step', 'routing'}
    ('routing': a MoE config's `routing_gap` at each step, which
    `check_pair` asserts first; else empty). `fan_in` as in
    `_reference_state`."""
    jcfg, cfg = j_reduced(arch), reduced(arch)
    if impl is not None:
        jcfg = dataclasses.replace(jcfg, wkv_impl=impl)
        cfg = dataclasses.replace(cfg, wkv_impl=impl)
    kw = dict(objective=objective, remat=remat, microbatches=microbatches,
              learning_rate=LR, warmup_steps=0, decay_steps=10)
    raw = _raw_batch(cfg, objective, batch, seq, groups, seed)
    state = _reference_state(jcfg, seed, fan_in)
    np_state = {'params': jax.tree.map(_f32, state['params']),
                'opt': {'mu': jax.tree.map(np.asarray, state['opt']['mu']),
                        'count': np.asarray(state['opt']['count'])},
                'step': np.asarray(state['step'])}

    tstate = convert.train_state_from_reference(np_state, cfg, device='cpu')
    tstep = TT.make_train_step(cfg, TrainConfig(**kw))
    tb = {k: torch.as_tensor(v) for k, v in raw.items()}
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    recorder = (record_routing(tstate['params']) if cfg.is_moe
                else contextlib.nullcontext())
    jm, tm, js, routing = [], [], state, []
    with recorder as rec:
        jstep = jax.jit(JT.make_train_step(jcfg, JTrainConfig(**kw),
                                           NoSharding()))
        for i in range(2):
            js, m = jstep(js, jb)
            jm.append(m)
            if i == 0:
                jmaster = _masters(js['opt']['mu'])
            tstate, m = tstep(tstate, tb)
            tm.append(m)
            if i == 0:
                master = {k: v['master'].clone()
                          for k, v in tstate['opt']['mu'].items()}
            if rec is not None:
                routing.append(routing_gap(rec, cfg))
    out = {'jax': {'metrics': [{k: float(v) for k, v in m.items()}
                               for m in jm], 'master': jmaster},
           'port': {'metrics': [{k: float(v) for k, v in m.items()}
                                for m in tm], 'master': master}}
    out['count'] = (int(tstate['opt']['count']), int(js['opt']['count']))
    out['step'] = (int(tstate['step']), int(js['step']))
    out['routing'] = routing
    return out


def check_pair(res):
    for gap in res['routing']:   # a MoE config routes alike at both steps
        assert_same_routing(gap, LM_MARGIN)
    assert res['count'] == (2, 2) and res['step'] == (2, 2)
    for mj, mt in zip(res['jax']['metrics'], res['port']['metrics']):
        assert all(np.isfinite(v) for v in mt.values()), mt
        assert abs(mt['loss'] - mj['loss']) <= 2e-3 * abs(mj['loss']), (
            mt, mj)
        assert abs(mt['gnorm'] - mj['gnorm']) <= 2e-2 * mj['gnorm'], (mt, mj)
        assert mt['lr'] == mj['lr']
    lr = res['jax']['metrics'][0]['lr']
    assert lr > 0
    for name, want in res['jax']['master'].items():
        got = res['port']['master'][name]
        bar = 2 * lr + 2.0 ** -23 * want.abs()
        assert bool(((got - want).abs() <= bar).all()), name


class _Float32Numpy:
    """jax.numpy with `bfloat16` read as float32."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def float32_inputs():
    """Both packages' LM forwards cast the model's inputs to bf16
    (`repro.models.lm.forward_train`, `repro_torch.models.lm.
    forward_train`), so a model with float32 weights still rounds the
    gradient that reaches the embedding, and the reference's layer scan
    refuses a float32 layer output after a bf16 input. Within this
    context both make that cast a float32 one: every operation of the
    model is then float32."""
    saved = JLM.jnp, LM.bf16
    JLM.jnp, LM.bf16 = _Float32Numpy(), torch.float32
    try:
        yield
    finally:
        JLM.jnp, LM.bf16 = saved


def f32_grad_pair(arch, objective, *, batch, microbatches=1, seed=0,
                  seq=32, fan_in=True):
    """({name: reference gradient}, {name: port gradient}), float32
    numpy, of the loss of reduced `arch` under `objective` in float32
    (`float32_inputs`), from `_reference_state`'s weights and
    `_raw_batch`'s batch: `jax.grad` of the reference's `loss_fn`
    against the port's `loss_and_grads` (remat='layer'), a MoE config's
    routing asserted alike in both. With microbatches, the reference's
    gradients of each microbatch are averaged as its train step
    accumulates them."""
    jcfg, cfg = j_reduced(arch), reduced(arch)
    raw = _raw_batch(cfg, objective, batch, seq, 0, seed)
    tree = jax.tree.map(_f32,
                        _reference_state(jcfg, seed, fan_in)['params'])
    kw = dict(objective=objective, remat='layer')
    jt, rows = JTrainConfig(**kw), batch // microbatches
    model = LM.from_state_dict(cfg, convert.lm_params_from_reference(
        tree, device='cpu', dtype=torch.float32))
    routing = (record_routing(model) if cfg.is_moe
               else contextlib.nullcontext())
    with float32_inputs(), routing as rec:
        grads = [jax.jit(jax.grad(lambda p, b: JT.loss_fn(
            p, jcfg, jt, b, NoSharding())))(
                jax.tree.map(jnp.asarray, tree),
                {k: jnp.asarray(v[i * rows:(i + 1) * rows])
                 for k, v in raw.items()})
            for i in range(microbatches)]
        with full_f32():
            _, got = TT.loss_and_grads(
                model, cfg, TrainConfig(microbatches=microbatches, **kw),
                {k: torch.as_tensor(v) for k, v in raw.items()})
        if rec is not None:   # routed alike (module doc)
            assert_same_routing(routing_gap(rec, cfg), F32_MARGIN)
    want = state_dict_from_tree(jax.tree.map(
        lambda *g: torch.as_tensor(sum(map(_f32, g)) / microbatches),
        *grads))
    return ({k: v.numpy() for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})
