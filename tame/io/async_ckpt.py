"""Asynchronous checkpoint writer for in-fit periodic checkpointing.

During a long fit, the write of a snapshot should overlap the next
compiled segment instead of blocking it: the device arrays are fetched to
host (the only part that must be synchronous) and the native-store write
(``tame/io/cstore.cpp``: CRC32 + atomic rename) runs on a background
thread.  At most one write is in flight — a new ``save`` first joins the
previous one, so the checkpoint directory is never written concurrently
and the atomic-rename contract of :func:`tame.io.save_checkpoint` holds.

The reference has no training checkpointing at all (SURVEY.md §5); this
subsystem is new surface in support of multi-hour production fits.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np


class AsyncCheckpointer:
    """Overlapped checkpoint writes through :func:`tame.io.save_checkpoint`.

    Usage::

        ckptr = AsyncCheckpointer()
        for segment in ...:
            state = run_segment(...)
            ckptr.save(ckpt_dir, state_dict)   # returns immediately
        ckptr.wait()                            # join the last write

    ``save`` snapshots arrays to host numpy synchronously (cheap relative
    to a fit segment) and performs the file I/O off-thread.  Exceptions
    from the background write re-raise on the next ``save``/``wait``.
    """

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    @staticmethod
    def _snapshot(value: Any) -> Any:
        if isinstance(value, dict):
            return {k: AsyncCheckpointer._snapshot(v)
                    for k, v in value.items()}
        if hasattr(value, "__array__") and not np.isscalar(value):
            return np.asarray(value)
        return value

    def save(self, ckpt_dir, state: Dict[str, Any]) -> None:
        """Queue a checkpoint write; blocks only for (a) a still-running
        previous write and (b) the device->host fetch of ``state``."""
        from tame.io import save_checkpoint

        self._join()
        snapshot = self._snapshot(state)

        def _write() -> None:
            try:
                save_checkpoint(ckpt_dir, snapshot)
            except BaseException as e:  # surfaced on next save()/wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the in-flight write (if any) completes."""
        self._join()
