"""Port parity of the MLA and MoE training pieces against the JAX package.

The same seeded numpy inputs go to the JAX function and its port:

* the float32 gradients of `mla_attention` (train branch: causal over
  T = 40, keys and values up-projected from the latent into buffers
  written in place, the rope key broadcast over the heads) with respect
  to the input and every weight, against `jax.grad` of the reference's:
  per leaf within F32_GRAD_BAR of the leaf's scale (its largest absolute
  value), from weights at std 1/sqrt(fan-in); and from the model's own
  init (`init='reference'`: the reference's stacked fan-in rule draws
  every layer matrix at std 1/sqrt(L), which saturates MLA's softmax),
  there within LAYER_GRAD_BAR, the dense family's bar for a saturated
  layer (tests/test_torch_dense_train.py). Measured here, at most
  6.7e-7 of scale at fan-in and 2.4e-5 at the reference's init (w_uk,
  where the saturated softmax's float32 sums in another order differ
  most);
* the float32 gradients of `moe_ffn` in tests/test_torch_moe.py's three
  routing cases (the reduced config's, which drops nothing; capacity
  factor 0.5, which drops; a router skewed to expert 0, which drops),
  for the router, w1, w3, w2, the shared expert and x, the routing
  first asserted equal (tests/test_torch_moe.py's margin MARGIN = 1e-4):
  within F32_GRAD_BAR; measured, at most 5.5e-7 of scale (the router);
* the combine's backward: a dropped choice reads slot 0 under gate 0,
  and its gradient adds exactly 0 to that slot; every slot's gradient
  is exactly its one kept choice's cotangent times its gate;
* the top-k values' gradient (the router's only path from the gate):
  `torch.sort`'s backward against `jax.lax.top_k`'s, bit for bit, with
  tied probabilities, inside and across the k-th place.

The whole model's float32 gradients are in
tests/test_torch_moe_train_grads.py, its bf16 train steps in
tests/test_torch_moe_train_step.py, whole layers, the converted train
state, `launch/steps.make_step` and the train CLI in
tests/test_torch_moe_train_model.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.reduced import reduced as j_reduced  # noqa: E402
from repro.distributed.sharding import NoSharding  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from test_torch_moe import CASES, _cfgs, _reference_routing  # noqa: E402
from test_torch_moe import _setup  # noqa: E402
from torch_parity import n, t, torch_one_thread  # noqa: E402,F401
from torch_train_parity import _f32, _reference_state  # noqa: E402

SHD = NoSharding()
F32_GRAD_BAR = 1e-5
LAYER_GRAD_BAR = 1e-4


def _grads_close(got, want, names, bar=F32_GRAD_BAR):
    for name, a, b in zip(names, got, want):
        a, b = n(a), np.asarray(b)
        assert a.shape == b.shape, name
        assert np.all(np.isfinite(a)), name
        scale = float(np.abs(b).max())
        assert scale > 0, name
        err = float(np.abs(a - b).max())
        assert err <= bar * scale, (name, err / scale)


def _flat(tree):
    """(dotted names, leaves) of a nested dict, in the tree's order."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return (['.'.join(k.key for k in path) for path, _ in flat],
            [leaf for _, leaf in flat])


@pytest.mark.parametrize('init', ['fan_in', 'reference'])
def test_mla_attention_f32_grads_match_reference(init):
    """Reduced deepseek-v2-lite-16b's MLA (4 heads of 16, kv_lora 32,
    rope 8) over T = 40: gradients of sum(out * c) with respect to wq,
    w_dkv, w_krope, w_uk, w_uv, wo and x."""
    arch = 'deepseek-v2-lite-16b'
    jcfg, cfg = j_reduced(arch), reduced(arch)
    rng = np.random.default_rng(50)
    if init == 'reference':
        state = _reference_state(jcfg, 5, fan_in=False)
        w = {k: _f32(v)[0]
             for k, v in state['params']['layers']['attn'].items()}
    else:
        w = {k: (rng.normal(size=d.shape) * d.shape[0] ** -0.5).astype(
            np.float32) for k, d in TL.mla_defs(cfg).items()}
    mod = TL.MLA(cfg, device='cpu')
    for k, v in w.items():
        getattr(mod, k).data = t(v)
    x = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    cot = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40), (2, 40)).astype(np.int32)
    names = sorted(w)

    def j_loss(p, x_):
        out, _ = JL.mla_attention(p, jcfg, x_, jnp.asarray(pos), SHD)
        return jnp.sum(out * cot)
    jg, jx = jax.grad(j_loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    out, _ = TL.mla_attention(mod, cfg, xt, t(pos))
    got = torch.autograd.grad((out * t(cot)).sum(),
                              [getattr(mod, k) for k in names] + [xt])
    _grads_close(got, [jg[k] for k in names] + [jx], names + ['x'],
                 bar=LAYER_GRAD_BAR if init == 'reference' else F32_GRAD_BAR)


@pytest.mark.parametrize('case', CASES)
def test_moe_ffn_f32_grads_match_reference(case):
    """Gradients of sum(out * c) with respect to the router, w1, w3, w2,
    the shared expert's w1, w3, w2 and x, the reference's routing
    asserted equal to the port's first."""
    cf, skew = CASES[case]
    cfg, jcfg = _cfgs(cf)
    jp, mod, xj, xt = _setup(cfg, jcfg, 'float32', seed=3, skew=skew)
    idx_ref = _reference_routing(jp, jcfg, xj)
    with torch.no_grad():
        _, idx, keep, _, _ = TL.moe_route(mod, cfg,
                                          xt.reshape(-1, cfg.d_model))
    assert np.array_equal(n(idx), idx_ref)
    assert bool(keep.all()) == (case == 'reduced')
    cot = np.random.default_rng(4).normal(size=xt.shape).astype(np.float32)
    jg, jx = jax.grad(lambda p, x_: jnp.sum(JL.moe_ffn(p, jcfg, x_, SHD)
                                            * cot), argnums=(0, 1))(jp, xj)
    names, want = _flat(jg)
    params = dict(mod.named_parameters())
    assert sorted(names) == sorted(params)
    xt = xt.clone().requires_grad_(True)
    got = torch.autograd.grad((TL.moe_ffn(mod, cfg, xt) * t(cot)).sum(),
                              [params[k] for k in names] + [xt])
    _grads_close(got, want + [jx], names + ['x'])


@pytest.mark.parametrize('case', ['cf0.5', 'skewed'])
def test_dropped_choices_add_no_gradient(case):
    """The combine of a routing that drops: the gradient of sum(y * c)
    with respect to the slot outputs is, bit for bit, each kept choice's
    cotangent times its gate in its slot and 0 in every other slot; slot
    0, which the dropped choices read under gate 0, gets its own kept
    choice's and nothing of theirs."""
    cf, skew = CASES[case]
    cfg, jcfg = _cfgs(cf)
    _, mod, _, xt = _setup(cfg, jcfg, 'float32', seed=3, skew=skew)
    xf = xt.reshape(-1, cfg.d_model)
    with torch.no_grad():
        gate, _, keep, slot, _ = TL.moe_route(mod, cfg, xf)
    k = cfg.moe.top_k
    assert not bool(keep.all()) and 0 in slot[keep].tolist()
    rng = np.random.default_rng(6)
    e_cap = cfg.moe.num_experts * TL.expert_capacity(cfg, xf.shape[0])
    y_slots = t(rng.normal(size=(e_cap, cfg.d_model)).astype(
        np.float32)).requires_grad_(True)
    cot = t(rng.normal(size=xf.shape).astype(np.float32))
    y = TL.moe_combine(y_slots, gate, keep, slot)
    (got,) = torch.autograd.grad((y * cot).sum(), [y_slots])
    want = torch.zeros_like(got)
    for j in torch.nonzero(keep)[:, 0].tolist():
        want[slot[j]] = cot[j // k] * gate.reshape(-1)[j]
    assert torch.equal(got, want)
    # and the forward: a token's dropped choices add nothing
    with torch.no_grad():
        kept = [sum(y_slots[slot[j]] * gate.reshape(-1)[j]
                    for j in range(i * k, (i + 1) * k) if keep[j])
                for i in range(xf.shape[0])]
    for i in range(xf.shape[0]):
        torch.testing.assert_close(y[i], kept[i] + torch.zeros_like(y[i]),
                                   rtol=1e-6, atol=0)


def test_top_k_gradient_matches_lax_top_k_with_ties():
    """`_top_k`'s values take their gradient through `torch.sort`'s
    backward: the same gradient as `jax.lax.top_k`'s, bit for bit, where
    probabilities tie (the lower expert first in both), inside the k
    and across the k-th place."""
    rng = np.random.default_rng(8)
    probs = rng.uniform(size=(6, 8)).astype(np.float32)
    probs[0, [2, 5]] = probs[0].max() + 0.1        # a tie for first
    probs[1, [1, 3, 6]] = probs[1].max() + 0.1     # first, second, third
    probs[2, :] = 0.125                            # all tied
    probs[3, [0, 7]] = np.sort(probs[3])[-2]       # a tie at the k-th
    cot = rng.normal(size=(6, 2)).astype(np.float32)
    vals_j, idx_j = jax.lax.top_k(jnp.asarray(probs), 2)
    want = jax.grad(lambda p: jnp.sum(jax.lax.top_k(p, 2)[0] * cot))(
        jnp.asarray(probs))
    pt = t(probs).requires_grad_(True)
    vals, idx = TL._top_k(pt, 2)
    (got,) = torch.autograd.grad((vals * t(cot)).sum(), [pt])
    assert np.array_equal(n(idx), np.asarray(idx_j))
    assert np.array_equal(n(vals.detach()), np.asarray(vals_j))
    assert np.array_equal(n(got), np.asarray(want))
