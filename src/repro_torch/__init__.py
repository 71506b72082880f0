"""PyTorch and CUDA port of the linearithmic RankSVM trainer.

A package of its own beside the JAX reference `repro`, with the same
module layout and public names, so that a call such as
`RankSVM(method='tree', engine='pallas').fit(X, y)` reads the same in
both. It imports torch and numpy only. Entry points run on the CUDA
device unless given device='cpu'; the counting kernels are hand-written
CUDA for Hopper (`kernels/csrc`), built at first use.
"""

from .core import RankSVM, make_oracle  # noqa: F401
from .core.bmrm import bmrm  # noqa: F401
