from .rowblocks import (CSRBlockSource, DenseBlockSource,  # noqa: F401
                        MemmapBlockSource, RowBlock, RowBlockSource,
                        as_row_block_source, projected_resident_gib)
from .sparse import CSRMatrix, random_tfidf  # noqa: F401
from .synthetic import (RankingData, cadata_like, ordinal_like,  # noqa: F401
                        reuters_like)
from .tokens import (RewardPipeline, TokenPipeline,  # noqa: F401
                     TokenPipelineConfig)
