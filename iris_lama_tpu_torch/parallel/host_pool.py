"""Host-side worker pool.

reference: include/lama/thread_pool.h:21, src/thread_pool.cpp:52-114 — a
lock-free-queue thread pool with enqueue/wait used to fan scan matching and
map updates across particles. On the GPU the compute parallelism is the
particle axis of the tensors, so the host-side concurrency left is
IO-shaped: writing per-particle map snapshots, PNG exports, dataset
prefetch. This wraps concurrent.futures with the reference's
init/enqueue/wait surface for those uses.
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import Callable, List, Optional


class ThreadPool:
    """init/enqueue/wait like the reference (thread_pool.h:21-49)."""

    def __init__(self) -> None:
        self._exec: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._pending: List[concurrent.futures.Future] = []

    def init(self, workers: int = 0) -> None:
        if workers <= 0:
            workers = os.cpu_count() or 1
        self._exec = concurrent.futures.ThreadPoolExecutor(workers)

    def enqueue(self, fn: Callable, *args, **kwargs) -> None:
        assert self._exec is not None, "call init() first"
        self._pending.append(self._exec.submit(fn, *args, **kwargs))

    def wait(self) -> None:
        """Barrier: block until every enqueued task finished
        (thread_pool.cpp:108-114); re-raises the first task exception."""
        pending, self._pending = self._pending, []
        for f in concurrent.futures.as_completed(pending):
            f.result()

    def shutdown(self) -> None:
        if self._exec is not None:
            self._exec.shutdown(wait=True)
            self._exec = None
