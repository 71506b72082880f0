from .synthetic import RankingData, cadata_like, ordinal_like  # noqa: F401
