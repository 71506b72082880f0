"""Async checkpointing: serialization and disk IO overlap the next steps.

The port of `repro.checkpoint.async_ckpt`. `AsyncCheckpointer.save()`
copies every leaf to host memory before it returns (device tensors
through a synchronous copy, host tensors and arrays cloned), so training
may update the state in place right away, as the port's train step does;
a background thread writes the copy and collects old steps. `wait()`
joins it before the next save or at shutdown: one outstanding save at
most, which bounds host memory at twice the state.
"""

from __future__ import annotations

import threading

from . import store


class AsyncCheckpointer:
    def __init__(self, root: str, *, keep: int = 3, n_shards: int = 1):
        self.root = root
        self.keep = keep
        self.n_shards = n_shards
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def wait(self) -> None:
        """Block until the outstanding save (if any) is durable; re-raise
        its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree) -> None:
        """Snapshot now, persist in the background."""
        self.wait()
        snap = store.snapshot(tree)

        def work():
            try:
                store._save_snapshot(self.root, step, snap,
                                     n_shards=self.n_shards)
                store.gc(self.root, self.keep)
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()
        return False
