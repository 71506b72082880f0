"""Port parity of the RWKV-6 training pieces against the JAX package.

The same seeded numpy inputs go to the JAX function and its port:

* `pairwise_hinge_loss` and `loss_and_subgradient` (grouped and
  ungrouped, with ties in scores and utilities): equal counts, so the
  same loss to float32 rounding and the same subgradient;
* `chunked_xent` on the same hidden states, with targets outside
  [0, vocab): value and gradients;
* AdamW `init` and `apply` on the same gradients and state, with the clip
  engaged and not, and the schedules at several steps;
* the token and reward pipelines, byte for byte;
* the RWKV-6 blocks' gradients with float32 weights and inputs, on both
  WKV routes, per leaf within 1e-4 of the leaf's scale. (The reference's
  whole-model forward cannot run float32 weights: its layer scan carries
  the bf16 residual stream and refuses the float32 layer output, so the
  whole train step is held with bf16 weights, in test_torch_train_step.py
  and test_torch_train_rank.py.)
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.reduced import reduced as j_reduced  # noqa: E402
from repro.core import rank_loss as JRL  # noqa: E402
from repro.data import tokens as JTok  # noqa: E402
from repro.distributed.sharding import NoSharding  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import rwkv6 as JR6  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.optim import schedules as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.core import counts as TC  # noqa: E402
from repro_torch.core import rank_loss as TRL  # noqa: E402
from repro_torch.data import tokens as TTok  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models import rwkv6 as R6  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim import schedules as TS  # noqa: E402
from torch_parity import n, t, torch_one_thread  # noqa: E402,F401

SHD = NoSharding()


def _scores(kind, m, seed):
    rng = np.random.default_rng(seed)
    if kind == 'ties':          # scores on a 0.5 grid, few utility levels
        p = (rng.integers(-4, 5, size=m) * 0.5).astype(np.float32)
        y = rng.integers(0, 3, size=m).astype(np.float32)
    else:
        p = rng.normal(size=m).astype(np.float32)
        y = rng.normal(size=m).astype(np.float32)
    g = rng.integers(0, 4, size=m).astype(np.int32) * 1000 + 7
    return p, y, g


@pytest.mark.parametrize('grouped', [False, True])
@pytest.mark.parametrize('kind', ['ties', 'normal'])
def test_pairwise_hinge_loss_matches_reference(kind, grouped):
    """Value and gradient of g * loss through the autograd function against
    jax.grad through the custom VJP; the utilities get zeros."""
    p, y, g = _scores(kind, 300, seed=len(kind) + grouped)
    gid = g if grouped else None
    j_val, (j_dp, j_dy) = jax.value_and_grad(
        lambda p_, y_: 3.0 * JRL.pairwise_hinge_loss(
            p_, y_, None if gid is None else jnp.asarray(gid)),
        argnums=(0, 1))(jnp.asarray(p), jnp.asarray(y))
    pt, yt = t(p).requires_grad_(True), t(y).requires_grad_(True)
    val = 3.0 * TRL.pairwise_hinge_loss(pt, yt,
                                        None if gid is None else t(gid))
    dp, dy = torch.autograd.grad(val, (pt, yt))
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-6)
    np.testing.assert_array_equal(n(dp), n(j_dp))
    np.testing.assert_array_equal(n(dy), np.zeros_like(p))
    # the counts behind them are equal
    if grouped:
        jc = JRL._counts.counts_grouped(
            jnp.asarray(p), jnp.asarray(y),
            JRL._compact_ids(jnp.asarray(g)))
        tc = TC.counts_grouped(t(p), t(y), TRL._compact_ids(t(g)))
    else:
        jc = JRL._counts.counts(jnp.asarray(p), jnp.asarray(y))
        tc = TC.counts(t(p), t(y))
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(n(a), n(b))


@pytest.mark.parametrize('grouped', [False, True])
def test_loss_and_subgradient_matches_reference(grouped):
    p, y, g = _scores('ties', 257, seed=11)
    gid = g if grouped else None
    j_loss, j_sub = JRL.loss_and_subgradient(
        jnp.asarray(p), jnp.asarray(y),
        None if gid is None else jnp.asarray(gid))
    loss, sub = TRL.loss_and_subgradient(t(p), t(y),
                                         None if gid is None else t(gid))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6)
    np.testing.assert_array_equal(n(sub), n(j_sub))


def _lm_pair(dtype):
    """(JAX params, port LM) of reduced rwkv6-3b on equal `dtype` values."""
    cfg = j_reduced('rwkv6-3b')
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        j_init(JLM.model_defs(cfg), jax.random.PRNGKey(1),
                               jnp.float32))
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jd), tree)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jparams)
    model = LM.from_state_dict(reduced('rwkv6-3b'),
                               convert.lm_params_from_reference(
                                   tree, device='cpu', dtype=dtype))
    return jparams, model


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_chunked_xent_matches_reference(dtype):
    """Two chunks of 16 positions and a dropped tail (S = 36), targets
    with -1, vocab and padded-vocab ids (invalid, masked out): the loss,
    and its gradients with respect to the hidden states and the head."""
    jparams, model = _lm_pair(dtype)
    rng = np.random.default_rng(2)
    hid = rng.normal(size=(2, 36, 64)).astype(np.float32)
    tg = rng.integers(0, 512, size=(2, 36)).astype(np.int32)
    tg[0, :3] = (-1, 512, 700)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    cfg = j_reduced('rwkv6-3b')

    def j_loss(h, head):
        p = dict(jparams, lm_head=head)
        return JLM.chunked_xent(p, cfg, h, jnp.asarray(tg), SHD, chunk=16)
    j_val, (j_dh, j_dw) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        jnp.asarray(hid, jd), jparams['lm_head'])
    h = t(hid, dtype).requires_grad_(True)
    val = LM.chunked_xent(model, model.cfg, h, t(tg), chunk=16)
    dh, dw = torch.autograd.grad(val, (h, model.lm_head))
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-5)
    if dtype == torch.float32:
        for a, b in ((dh, j_dh), (dw, j_dw)):
            b = n(b)
            assert np.abs(n(a) - b).max() <= 1e-4 * np.abs(b).max()
    else:
        # bf16 gradients. The reference's scan carries the head's
        # cotangent in bf16, so each of its two chunks' sums is rounded to
        # bf16 once more; the port sums the chunks in float32 and rounds
        # once. So: one bf16 ulp of the leaf's scale per chunk, plus 1e-4
        # of the scale for the float32 sums' order.
        for a, b in ((dh, j_dh), (dw, j_dw)):
            bf = n(b.astype(jnp.float32))
            scale = float(np.abs(bf).max())
            ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
            assert np.abs(n(a.float()) - bf).max() <= 1e-4 * scale + 2 * ulp


def _leaves(rng, shapes):
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize('clip', [1e3, 0.5])
def test_adamw_matches_reference(clip):
    """Three AdamW steps from `init` on the same gradients: masters, m, v,
    the bf16 parameters and gnorm as the reference's, with the clip
    engaged (0.5) and not; lr is a float32 schedule value."""
    rng = np.random.default_rng(3)
    shapes = {'a': (7, 5), 'b': (13,), 'c': (2, 3, 4)}
    p0 = _leaves(rng, shapes)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p0.items()}
    tp = {k: t(n(v.astype(jnp.float32)), torch.bfloat16)
          for k, v in jp.items()}
    js, ts = JA.init(jp), TA.init(tp)
    for k in shapes:
        np.testing.assert_array_equal(n(ts['mu'][k]['master']),
                                      n(js['mu'][k]['master']))
    kw = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
              grad_clip=clip)
    for step in range(3):
        grads = _leaves(rng, shapes)
        lr = JS.cosine(jnp.asarray(step, jnp.int32), base_lr=3e-3,
                       warmup_steps=1, decay_steps=3)
        jp, js, jg = JA.apply({k: jnp.asarray(v, jnp.bfloat16)
                               for k, v in grads.items()}, js, jp, lr=lr,
                              **kw)
        tlr = TS.cosine(torch.tensor(step, dtype=torch.int32), base_lr=3e-3,
                        warmup_steps=1, decay_steps=3)
        tp, ts, tg = TA.apply({k: t(v, torch.bfloat16)
                               for k, v in grads.items()}, ts, tp, lr=tlr,
                              **kw)
        np.testing.assert_allclose(float(tg), float(jg), rtol=1e-6)
        assert int(ts['count']) == int(js['count']) == step + 1
        for k in shapes:
            for part in ('master', 'm', 'v'):
                np.testing.assert_allclose(
                    n(ts['mu'][k][part]), n(js['mu'][k][part]),
                    rtol=2e-6, atol=1e-9, err_msg=f'{k}.{part}')
            np.testing.assert_array_equal(
                n(tp[k].float()), n(jp[k].astype(jnp.float32)))
    assert (float(jg) > clip) == (clip < 1.0)


@pytest.mark.parametrize('kind', ['cosine', 'wsd'])
def test_schedules_match_reference(kind):
    jcfg = dataclasses.replace(j_reduced('rwkv6-3b'), schedule=kind)
    tcfg_kw = dict(learning_rate=2e-3, warmup_steps=4, decay_steps=20)
    js = JS.make_schedule(jcfg, JTrainConfig(**tcfg_kw))
    ts = TS.make_schedule(dataclasses.replace(reduced('rwkv6-3b'),
                                              schedule=kind),
                          TrainConfig(**tcfg_kw))
    for step in (0, 1, 3, 4, 5, 10, 16, 17, 19, 20, 25):
        want = float(js(jnp.asarray(step, jnp.int32)))
        got = ts(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12)


def test_pipelines_are_byte_identical():
    for step in (0, 3):
        cfg = dict(vocab=512, seq_len=24, global_batch=4, seed=5, dp_rank=1,
                   dp_size=2)
        want = JTok.TokenPipeline(JTok.TokenPipelineConfig(**cfg)).batch(step)
        got = TTok.TokenPipeline(TTok.TokenPipelineConfig(**cfg)).batch(step)
        for k in ('tokens', 'targets'):
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes()
        for groups in (0, 3):
            want = JTok.RewardPipeline(512, 24, 4, seed=2,
                                       n_groups=groups).batch(step)
            got = TTok.RewardPipeline(512, 24, 4, seed=2,
                                      n_groups=groups).batch(step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert got[k].tobytes() == want[k].tobytes()


def _block_grads_close(got, want, names):
    for name, a, b in zip(names, got, want):
        a, b = n(a), np.asarray(b)
        scale = float(np.abs(b).max())
        assert a.shape == b.shape, name
        assert float(np.abs(a - b).max()) <= 1e-4 * scale, (name, scale)


@pytest.mark.parametrize('impl', ['scan', 'kernel'])
def test_time_mix_f32_grads_match_reference(impl):
    """Float32 weights and input: the gradients of sum(out * c) of one
    time-mix block (with a nonzero initial state) with respect to every
    weight and the input, per leaf within 1e-4 of the leaf's scale."""
    jparams, model = _lm_pair(torch.float32)
    cfg = dataclasses.replace(reduced('rwkv6-3b'), wkv_impl=impl)
    jcfg = dataclasses.replace(j_reduced('rwkv6-3b'), wkv_impl=impl)
    rng = np.random.default_rng(4)
    lpj = jax.tree.map(lambda a: a[0], jparams['layers']['tm'])
    lpj = dict(lpj, mu_r=jnp.asarray(rng.uniform(0, 1, 64), jnp.float32),
               mu_w=jnp.asarray(rng.uniform(0, 1, 64), jnp.float32),
               w0=jnp.asarray(rng.uniform(-2, 1, 64), jnp.float32),
               u=jnp.asarray(rng.normal(0, 0.5, (4, 16)), jnp.float32))
    tm = model.layers[0].tm
    with torch.no_grad():
        for k in ('mu_r', 'mu_w', 'w0', 'u'):
            getattr(tm, k).copy_(t(np.asarray(lpj[k])))
    x = rng.normal(size=(2, 24, 64)).astype(np.float32)
    s0 = (0.1 * rng.normal(size=(2, 4, 16, 16))).astype(np.float32)
    c = rng.normal(size=(2, 24, 64)).astype(np.float32)
    names = sorted(lpj)

    def j_loss(p, x_):
        out, sT, _ = JR6.rwkv_time_mix(p, jcfg, x_, SHD,
                                       state=jnp.asarray(s0))
        return jnp.sum(out * c) + jnp.sum(sT)
    jg, jx = jax.grad(j_loss, argnums=(0, 1))(lpj, jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    out, sT, _ = R6.rwkv_time_mix(tm, cfg, xt, state=t(s0))
    got = torch.autograd.grad((out * t(c)).sum() + sT.sum(),
                              [getattr(tm, k) for k in names] + [xt])
    _block_grads_close(got, [jg[k] for k in names] + [jx], names + ['x'])


def test_channel_mix_f32_grads_match_reference():
    jparams, model = _lm_pair(torch.float32)
    rng = np.random.default_rng(5)
    lpj = jax.tree.map(lambda a: a[0], jparams['layers']['cm'])
    lpj = dict(lpj, mu_k=jnp.asarray(rng.uniform(0, 1, 64), jnp.float32),
               mu_r=jnp.asarray(rng.uniform(0, 1, 64), jnp.float32))
    cm = model.layers[0].cm
    with torch.no_grad():
        for k in ('mu_k', 'mu_r'):
            getattr(cm, k).copy_(t(np.asarray(lpj[k])))
    x = rng.normal(size=(2, 24, 64)).astype(np.float32)
    c = rng.normal(size=(2, 24, 64)).astype(np.float32)
    names = sorted(lpj)
    jg, jx = jax.grad(lambda p, x_: jnp.sum(
        JR6.rwkv_channel_mix(p, j_reduced('rwkv6-3b'), x_)[0] * c),
        argnums=(0, 1))(lpj, jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    out, _ = R6.rwkv_channel_mix(cm, model.cfg, xt)
    got = torch.autograd.grad((out * t(c)).sum(),
                              [getattr(cm, k) for k in names] + [xt])
    _block_grads_close(got, [jg[k] for k in names] + [jx], names + ['x'])


def test_train_state_from_reference_carries_everything():
    """Parameters (unstacked, in the given dtype), master, m, v (float32),
    count and step equal the reference state's."""
    cfg = j_reduced('rwkv6-3b')
    params = j_init(JLM.model_defs(cfg), jax.random.PRNGKey(2))
    opt = JA.init(params)
    opt['mu'] = jax.tree.map(lambda a: a + 0.5, opt['mu'])
    opt['count'] = jnp.asarray(3, jnp.int32)
    state = {'params': params, 'opt': opt, 'step': jnp.asarray(3, jnp.int32)}
    np_state = jax.tree.map(lambda a: np.asarray(
        a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a), state)
    got = convert.train_state_from_reference(np_state, reduced('rwkv6-3b'),
                                             device='cpu')
    assert int(got['step']) == int(got['opt']['count']) == 3
    want_p = LM.state_dict_from_tree(jax.tree.map(
        lambda a: torch.as_tensor(np.asarray(a.astype(jnp.float32))),
        params))
    sd = got['params'].state_dict()
    assert sorted(sd) == sorted(want_p) == sorted(got['opt']['mu'])
    for k, v in sd.items():
        assert v.dtype == torch.bfloat16
        assert torch.equal(v.float(), want_p[k])
    for part in ('master', 'm', 'v'):
        want = LM.state_dict_from_tree(jax.tree.map(
            lambda d: torch.as_tensor(np.asarray(d[part])), opt['mu'],
            is_leaf=lambda d: isinstance(d, dict) and 'master' in d))
        for k, v in want.items():
            assert torch.equal(got['opt']['mu'][k][part], v), (k, part)
