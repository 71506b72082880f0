"""The port on the card: each CUDA kernel against its plain torch version,
bit for bit, and a fit on the card against the same fit on the CPU.

Every test here needs a CUDA device (Hopper, for the sm_90a kernels) and
is marked `cuda`; without one it skips. This module imports neither JAX
nor the JAX package, so it runs on a machine that has only torch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from repro_torch.core import counts as TC  # noqa: E402
from repro_torch.core.ranksvm import RankSVM  # noqa: E402
from repro_torch.data import cadata_like, ordinal_like  # noqa: E402
from repro_torch.kernels.pairwise_rank import ops as PR  # noqa: E402
from repro_torch.kernels.pairwise_rank.ref import (  # noqa: E402
    pairwise_counts_plain)
from repro_torch.kernels.rank_counts import ops as RC  # noqa: E402
from repro_torch.kernels.rank_counts.ref import (  # noqa: E402
    rank_counts_plain)
from torch_parity import cuda_device, torch_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.cuda


def _case(kind, m, seed=0):
    rng = np.random.default_rng(seed + m)
    if kind == 'grid':          # every frontier on a run of p +- 1 ties
        p = (np.arange(m) % 5).astype(np.float32)
        y = rng.integers(0, 4, size=m).astype(np.float32)
    elif kind == 'halves':
        p = (rng.integers(-4, 5, size=m) * 0.5).astype(np.float32)
        y = rng.integers(0, 3, size=m).astype(np.float32)
    else:
        p = rng.normal(size=m).astype(np.float32) * 3
        y = rng.integers(0, 8, size=m).astype(np.float32)
    return p, y


@pytest.mark.parametrize('m', [1, 127, 1025, 4096])
@pytest.mark.parametrize('kind', ['grid', 'halves', 'normal'])
def test_pairwise_kernel_equals_plain(kind, m, cuda_device):
    p, y = (torch.as_tensor(a, device=cuda_device) for a in _case(kind, m))
    before = PR.PAIRWISE.launches
    c, d = PR.pairwise_counts(p, y)
    cp, dp = pairwise_counts_plain(p, y)
    torch.cuda.synchronize()
    assert PR.PAIRWISE.launches == before + 1
    assert torch.equal(c, cp) and torch.equal(d, dp)


@pytest.mark.parametrize('ti,tj', [(256, 256), (64, 1024), (1024, 32)])
@pytest.mark.parametrize('m', [1, 300, 5000, 70000])
@pytest.mark.parametrize('kind', ['grid', 'halves', 'normal'])
def test_rank_counts_kernel_equals_plain(kind, m, ti, tj, cuda_device):
    p, y = (torch.as_tensor(a, device=cuda_device) for a in _case(kind, m))
    prep = RC._prepare(p, RC._compact_ranks(y), ti, tj, 256)[1:]
    c, d = RC.sorted_counts(*prep, ti, tj)
    cp, dp = rank_counts_plain(*prep, ti, tj)
    torch.cuda.synchronize()
    assert torch.equal(c, cp) and torch.equal(d, dp)
    c, d = RC.rank_counts(p, y, ti=ti, tj=tj)
    cf, df = TC.counts_fused(p, y)
    assert torch.equal(c, cf) and torch.equal(d, df)


@pytest.mark.parametrize('engine', ['tree', 'pallas', 'auto'])
@pytest.mark.parametrize('data', ['cadata', 'ordinal'])
def test_fit_on_the_card_matches_the_cpu(data, engine, cuda_device):
    ds = (cadata_like(m=2048, m_test=256, seed=1) if data == 'cadata'
          else ordinal_like(m=2048, m_test=256, n=16, seed=2))
    kw = dict(lam=1e-2, eps=1e-4, engine=engine, solver='host')
    on_card = RankSVM(device=cuda_device, **kw).fit(ds.X, ds.y)
    on_cpu = RankSVM(device='cpu', **kw).fit(ds.X, ds.y)
    j_card = on_card.objective(ds.X, ds.y)
    j_cpu = on_cpu.objective(ds.X, ds.y)
    assert abs(j_card - j_cpu) <= 1e-4
