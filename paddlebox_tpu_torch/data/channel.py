"""Bounded MPMC channel — the port of ``data/channel.py``.

The counterpart of the reference's ``ChannelObject`` and
``BlockingQueue``: ``queue.Queue`` with close semantics, so consumers
drain what was put and then stop.
"""

from __future__ import annotations

import queue
import threading
from typing import Generic, Iterator, Optional, TypeVar

T = TypeVar("T")


class Channel(Generic[T]):
    def __init__(self, capacity: int = 0):
        self._q: queue.Queue = queue.Queue(maxsize=capacity)
        self._closed = threading.Event()

    def put(self, item: T) -> None:
        if self._closed.is_set():
            raise RuntimeError("put on closed channel")
        self._q.put(item)

    def get(self, timeout: Optional[float] = None) -> Optional[T]:
        """Blocking get; returns None when the channel is closed and
        drained."""
        while True:
            try:
                item = self._q.get(
                    timeout=0.05 if self._closed.is_set() else timeout)
            except queue.Empty:
                if self._closed.is_set() and self._q.empty():
                    return None
                continue
            return item

    def close(self) -> None:
        self._closed.set()

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def __iter__(self) -> Iterator[T]:
        while True:
            item = self.get()
            if item is None:
                return
            yield item

    def qsize(self) -> int:
        return self._q.qsize()
