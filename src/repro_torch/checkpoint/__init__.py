"""Sharded, restart-safe checkpoints of tensor trees (`store`) and their
asynchronous writer (`async_ckpt`): the port of `repro.checkpoint`."""

from . import store  # noqa: F401
from .async_ckpt import AsyncCheckpointer  # noqa: F401
from .store import commit, gc, latest_step, restore, save  # noqa: F401
