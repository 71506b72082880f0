"""Port parity of the mixture of experts against the JAX package.

`moe_ffn`, its routing (`moe_route`) and `moe_aux_loss` of
`repro_torch.models.layers` against `repro.models.layers` on the same
numpy inputs and parameters (the reference's init, its router at std
0.02), at the reduced MoE width (d = 64, 4 experts of width 32, top-2,
one shared expert), in float32 and in bf16.

The reduced configs never drop a choice (capacity factor 2.0 over 4
experts top-2 gives every expert n slots), so two cases overflow: a
capacity factor of 0.5, and a router skewed towards expert 0 under a
factor of 1.0. In every case the dispatch table (token per slot) and the
keep mask must equal the reference's exactly. The reference does not
return its table; the test reads the gathered (E, cap, d) buffer that it
hands to its sharding hook (`shd.constrain`) and maps each row back to
its token (the tokens' rows are distinct; the sentinel row is zero).

Near ties. The router logits are float32 sums in another order in each
package, so a choice could flip only where the k-th and (k+1)-th
probabilities of a token nearly tie. Every case asserts that the
reference's probabilities leave a relative margin of at least MARGIN =
1e-4 between them: the softmax subtracts the row's largest logit (at
most about 9 here) and rounds to float32, which moves a probability by
some 1e-6 of itself at most, so equal routing is what the test can
demand.

Bars: outputs at tests/test_torch_dense_lm.py's model bars in bf16 (3%
in relative norm, 5% of the largest value), and within 1e-5 of their
scale in float32, where both packages sum the same products in another
order.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.reduced import reduced as j_reduced  # noqa: E402
from repro.distributed.sharding import NoSharding  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from torch_parity import n, t, torch_one_thread  # noqa: E402,F401

ARCH = 'deepseek-v2-lite-16b'
MODEL_BARS = dict(rel=0.03, peak=0.05)
F32_BAR = 1e-5
MARGIN = 1e-4
DTYPES = {'float32': (torch.float32, jnp.float32),
          'bfloat16': (torch.bfloat16, jnp.bfloat16)}
# (capacity factor, skew towards expert 0): the reduced config's own
# routing, and two that overflow
CASES = {'reduced': (2.0, 0.0), 'cf0.5': (0.5, 0.0), 'skewed': (1.0, 0.5)}


class _Recorder(NoSharding):
    """The reference's sharding hook, keeping what it is handed."""

    def __init__(self):
        self.seen = {}

    def constrain(self, x, logical_axes):
        self.seen[tuple(logical_axes)] = x
        return x


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _cfgs(cf=2.0, shared=1, impl='gather'):
    """(port config, reference config): the reduced MoE config with the
    given capacity factor, shared experts and implementation."""
    out = []
    for cfg in (reduced(ARCH), j_reduced(ARCH)):
        moe = dataclasses.replace(cfg.moe, capacity_factor=cf,
                                  shared_experts=shared)
        out.append(dataclasses.replace(cfg, moe=moe, moe_impl=impl))
    return out


def _setup(cfg, jcfg, dtype, seed, skew=0.0, tokens=(2, 32)):
    """(reference params, port MoE module, reference x, port x) on the
    same values in `dtype`. A skew adds to the router's expert-0 column
    and gives the tokens a mean of skew / 2, so that every token ranks
    expert 0 first (its logit up by about skew^2 d / 2)."""
    tdt, jdt = DTYPES[dtype]
    tree = jax.tree.map(_f32, j_init(JL.moe_defs(jcfg),
                                     jax.random.PRNGKey(seed)))
    router = np.array(tree['router'])
    router[:, 0] += skew
    tree['router'] = router
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)
    mod = TL.MoE(cfg, device='meta')
    mod.load_state_dict(convert.lm_params_from_reference(
        jax.tree.map(_f32, jp), device='cpu', dtype=tdt), assign=True)
    rng = np.random.default_rng(seed + 100)
    x = rng.normal(size=tokens + (cfg.d_model,)) + skew / 2
    xj = jnp.asarray(x, jdt)
    return jp, mod, xj, t(_f32(xj), tdt)


def _reference_routing(jp, jcfg, xj):
    """The reference's expert choices idx (n, k) by its own operations,
    after asserting the relative margin between each token's k-th and
    (k+1)-th probabilities."""
    xf = xj.reshape(-1, xj.shape[-1])
    logits = jnp.einsum('nd,de->ne', xf, jp['router'],
                        preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    k = jcfg.moe.top_k
    top = -np.sort(-np.asarray(probs), axis=-1)
    margin = (top[:, k - 1] - top[:, k]) / top[:, k - 1]
    assert float(margin.min()) >= MARGIN
    return np.asarray(jax.lax.top_k(probs, k)[1])


def _reference_table(x_e, xf):
    """The dispatch table (E, cap) from the reference's gathered buffer:
    each row's token, n for the zero sentinel row."""
    rows = {xf[i].tobytes(): i for i in range(xf.shape[0])}
    assert len(rows) == xf.shape[0]
    zero = np.zeros(xf.shape[1], xf.dtype).tobytes()
    rows[zero] = xf.shape[0]
    return np.array([[rows[r.tobytes()] for r in ex] for ex in x_e])


def _assert_close(got, want, bars=None, bar=None):
    got = n(got.float()).astype(np.float32)
    want = _f32(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    if bar is not None:
        assert err <= bar * scale, (err, scale)
        return
    r = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert r < bars['rel'], r
    assert err <= bars['peak'] * scale, (err, scale)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', CASES)
def test_moe_ffn_matches_reference(case, dtype):
    """Routing (experts, dispatch table, keep mask) equal to the
    reference's, the output within the bars; the overflowing cases drop
    choices."""
    cf, skew = CASES[case]
    cfg, jcfg = _cfgs(cf)
    jp, mod, xj, xt = _setup(cfg, jcfg, dtype, seed=3, skew=skew)
    rec = _Recorder()
    want = JL.moe_ffn(jp, jcfg, xj, rec)
    x_e = _f32(rec.seen[('experts', 'expert_cap', 'embed_act')])
    xf = _f32(xj).reshape(-1, cfg.d_model)
    table_ref = _reference_table(x_e, xf)
    idx_ref = _reference_routing(jp, jcfg, xj)

    with torch.no_grad():
        _, idx, keep, slot, table = TL.moe_route(mod, cfg, xt.reshape(
            -1, cfg.d_model))
        got = TL.moe_ffn(mod, cfg, xt)
    assert table.shape == table_ref.shape
    assert np.array_equal(n(idx), idx_ref)
    assert np.array_equal(n(table), table_ref)
    keep_ref = np.array([i in table_ref[e] for i, row in enumerate(idx_ref)
                         for e in row])
    assert np.array_equal(n(keep), keep_ref)
    assert keep_ref.all() == (case == 'reduced')
    kept = n(slot)[n(keep)]
    assert np.array_equal(np.sort(kept), np.flatnonzero(table_ref.ravel()
                                                        < xf.shape[0]))
    assert got.dtype == xt.dtype
    if dtype == 'float32':
        _assert_close(got, want, bar=F32_BAR)
    else:
        _assert_close(got, want, MODEL_BARS)


@pytest.mark.parametrize('shared', [0, 1, 2])
def test_shared_experts_match_reference(shared):
    """With 0, 1 and 2 shared experts (an MLP of width moe_d_ff times
    that), float32."""
    cfg, jcfg = _cfgs(shared=shared)
    jp, mod, xj, xt = _setup(cfg, jcfg, 'float32', seed=5)
    assert hasattr(mod, 'shared') == bool(shared)
    if shared:
        assert mod.shared.w1.shape == (cfg.d_model,
                                       cfg.moe.moe_d_ff * shared)
    with torch.no_grad():
        got = TL.moe_ffn(mod, cfg, xt)
    _assert_close(got, JL.moe_ffn(jp, jcfg, xj, NoSharding()), bar=F32_BAR)


@pytest.mark.parametrize('dtype', DTYPES)
def test_expert_parallel_impl_falls_back_without_a_mesh(dtype):
    """moe_impl='ep' without a mesh is moe_ffn in the reference
    (`moe_ffn_ep`'s fallback) and in the port, which has no mesh path:
    the same output as 'gather', bit for bit, within the bars of the
    reference's 'ep' call."""
    cfg, jcfg = _cfgs(0.5, impl='ep')
    jp, mod, xj, xt = _setup(cfg, jcfg, dtype, seed=7)
    gather = dataclasses.replace(cfg, moe_impl='gather')
    with torch.no_grad():
        got = mod(xt)
        assert torch.equal(got, TL.moe_ffn(mod, gather, xt))
    want = JL.moe_ffn_ep(jp, jcfg, xj, NoSharding())
    if dtype == 'float32':
        _assert_close(got, want, bar=F32_BAR)
    else:
        _assert_close(got, want, MODEL_BARS)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('skew', [0.0, 0.5])
def test_moe_aux_loss_matches_reference(skew, dtype):
    """The load-balancing loss, within 1e-6 relative (the same top-k
    shares; the mean probabilities sum in another order). A skewed
    router raises it above its balanced value of about 1."""
    cfg, jcfg = _cfgs()
    jp, mod, xj, xt = _setup(cfg, jcfg, dtype, seed=9, skew=skew)
    _reference_routing(jp, jcfg, xj)
    want = float(JL.moe_aux_loss(jp, jcfg, xj))
    with torch.no_grad():
        got = TL.moe_aux_loss(mod, cfg, xt)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    assert (want > 1.2) == (skew > 0)


def test_capacity_is_the_reference_expression():
    """cap = int(max(1, n k / E * cf)) rounded up to a multiple of 8: 3840
    for the deepseek prefill of 8 x 4096 tokens, 8 for its decode step at
    batch 8, 64 for the reduced config's 64 tokens."""
    from repro_torch.configs.registry import get
    full = get(ARCH)
    assert TL.expert_capacity(full, 8 * 4096) == 3840
    assert TL.expert_capacity(full, 8) == 8
    assert TL.expert_capacity(reduced(ARCH), 64) == 64
    assert TL.expert_capacity(_cfgs(0.5)[0], 64) == 16


def test_routing_ties_go_to_the_lower_expert():
    """Equal probabilities are taken in expert order, as jax.lax.top_k
    takes them: a router with two equal columns and one token row that
    ties everywhere."""
    cfg, jcfg = _cfgs()
    jp, mod, xj, xt = _setup(cfg, jcfg, 'float32', seed=11)
    with torch.no_grad():
        mod.router[:, 3] = mod.router[:, 1]
        xt[0, 0] = 0.0
        _, idx, _, _, _ = TL.moe_route(mod, cfg, xt.reshape(-1, cfg.d_model))
    assert idx[0].tolist() == [0, 1]
    probs = torch.softmax(xt.reshape(-1, cfg.d_model) @ mod.router, -1)
    want = np.asarray(jax.lax.top_k(jnp.asarray(n(probs)), 2)[1])
    assert np.array_equal(n(idx), want)
