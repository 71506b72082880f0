from .ops import DEFAULT_LEVELS, rank_counts, rank_counts_grouped  # noqa: F401
