# The paper's linearithmic RankSVM training on the dense single-device
# path, in PyTorch:
#  - counts:    merge-sort-tree counts and the engine dispatch
#  - ref:       O(m^2) references
#  - rank_loss: pairwise ranking error
#  - qp/bmrm:   bundle-method optimizer (Algorithm 1)
#  - oracle:    the BMRM oracle layer (tree/pairs/auto, grouped)
#  - ranksvm:   the estimator
from . import bmrm, counts, oracle, qp, rank_loss, ranksvm, ref  # noqa: F401
from .oracle import (GroupedOracle, PairwiseOracle, RankOracle,  # noqa: F401
                     TreeOracle, empirical_risk, make_oracle)
from .rank_loss import ranking_error  # noqa: F401
from .ranksvm import RankSVM  # noqa: F401
