"""Shared pieces of the port's parity tests (tests/test_torch_*.py).

Each port test module imports the two fixtures below by name:

* `torch_one_thread` (autouse, module scope) pins torch to one intra-op
  thread for the module's duration and restores the previous count, so
  the port's tests do not crowd the CPU that the JAX package's
  wall-clock tests share under pytest-xdist;
* `cuda_device` skips a test that needs the card when no CUDA device is
  present. The decision is taken inside the fixture, never at import, so
  every worker collects the same tests.

Inputs are made with numpy from a seed and handed to both packages.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def torch_one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (run on the H100: python3 '
                    'chip_smoke.py, or pytest -m cuda there)')
    return torch.device('cuda')


def t(a, dtype=None, device='cpu'):
    """numpy -> torch on `device` (dtype kept unless given)."""
    out = torch.as_tensor(np.asarray(a))
    return out.to(device=device, dtype=dtype or out.dtype)


def n(x):
    """torch or jax array -> numpy."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)
