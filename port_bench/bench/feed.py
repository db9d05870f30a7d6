"""The feed: the program's loader, handed to ``fit`` by the benchmark.

One iterator over the loader serves every ``fit`` call of a run (the
checked steps, the warm-up, the window), so the loader thread and its
prefetch run on across them. The feed times each ``next`` (the wait the
step sees for its batch), stops at a count of batches or a deadline,
and calls ``before_fetch(batches handed so far)`` before each
fetch: after step k has returned and before step k + 1 begins.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, List, Optional


class Feed:
    def __init__(self, loader):
        self._it = iter(loader)
        self.handed = 0
        self.waits: List[float] = []
        self.before_fetch: Optional[Callable[[int], None]] = None

    def take(self, count: Optional[int] = None,
             deadline: Optional[float] = None) -> Iterator:
        """An iterable for one ``fit`` call."""
        n = 0
        while True:
            if self.before_fetch is not None:
                self.before_fetch(self.handed)
            if (count is not None and n >= count) or (
                    deadline is not None and time.perf_counter() >= deadline):
                return
            t = time.perf_counter()
            batch = next(self._it)
            self.waits.append(time.perf_counter() - t)
            n += 1
            self.handed += 1
            yield batch

    def close(self) -> None:
        """End the loader's iterator: its thread stops and is drained."""
        self._it.close()
