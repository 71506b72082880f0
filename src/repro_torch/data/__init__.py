from .synthetic import RankingData, cadata_like, ordinal_like  # noqa: F401
from .tokens import (RewardPipeline, TokenPipeline,  # noqa: F401
                     TokenPipelineConfig)
