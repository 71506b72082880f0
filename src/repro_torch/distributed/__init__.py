# Collectives of data-parallel training on torch.distributed: the int8
# error-feedback compressed mean (compression.py). The LM's sharding rules
# (the reference's sharding.py) serve its dry-run only and are not ported.
from .compression import compressed_mean  # noqa: F401
