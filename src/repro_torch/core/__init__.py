# The paper's linearithmic RankSVM training on one device or a mesh of
# ranks, in PyTorch (dense, CSR and streamed features; the hinge, toppush
# and poshinge losses):
#  - counts:    merge-sort-tree counts (weighted too) and the engine
#               dispatch
#  - joachims:  the r-level baseline (SVM^rank's O(rm) counts)
#  - ref:       O(m^2) references
#  - rank_loss: ranking metrics and the differentiable pairwise hinge
#  - qp/bmrm:   bundle-method optimizer (Algorithm 1)
#  - oracle:    the BMRM oracle layer (tree/pairs/auto/grouped/sharded/
#               stream)
#  - distributed: the oracle split over a mesh of ranks
#  - ranksvm:   the estimator
from . import (bmrm, counts, distributed, joachims, oracle,  # noqa: F401
               qp, rank_loss, ranksvm, ref)
from .oracle import (LOSSES, GroupedOracle, PairwiseOracle,  # noqa: F401
                     RankOracle, ShardedOracle, StreamingOracle,
                     TopPushOracle, TreeOracle, empirical_risk, make_oracle)
from .rank_loss import (poshinge_weights,  # noqa: F401
                        position_weighted_error, ranking_error, top1_error)
from .ranksvm import RankSVM  # noqa: F401
