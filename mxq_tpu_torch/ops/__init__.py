"""The hand-written kernels' wrappers. Each wrapper counts its launches in
``<wrapper>.launches``, through :func:`count_launch`."""

from __future__ import annotations

import threading

_COUNT_LOCK = threading.Lock()


def count_launch(fn, n: int = 1) -> None:
    """Add ``n`` to ``fn.launches`` under a lock: ranks simulated by threads
    of one process (``serving.multihost.run_ranks``) launch at once, and a
    bare ``+=`` can lose an increment when the interpreter switches
    threads between its read and its write."""
    with _COUNT_LOCK:
        fn.launches += n
