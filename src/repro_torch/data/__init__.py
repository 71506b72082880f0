from .rowblocks import (BlockStore, CSRBlockSource,  # noqa: F401
                        DenseBlockSource, MemmapBlockSource, RowBlock,
                        RowBlockSource, TensorBlockSource,
                        as_row_block_source, projected_resident_gib)
from .sparse import CSRMatrix, random_tfidf  # noqa: F401
from .synthetic import (RankingData, cadata_drift,  # noqa: F401
                        cadata_like, ordinal_like, reuters_like)
from .tokens import (RewardPipeline, TokenPipeline,  # noqa: F401
                     TokenPipelineConfig, frontend_inputs)
