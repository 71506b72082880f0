from .ops import (KERNEL_MAX_M, counts_auto, pairwise_counts,  # noqa: F401
                  pairwise_rank_loss)
