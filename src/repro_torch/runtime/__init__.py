"""The fault-tolerant training loop (`loop.run`): the port of
`repro.runtime`."""

from .loop import LoopConfig, LoopReport, SimulatedPreemption, run  # noqa: F401
