"""Progress event bus (port of ``tpusfm/utils/events.py``, host-only).

Parity with the reference's SSE eventing (src/utils/Event.h:43-48 events
``{type, progress}``; src/utils/ConcurrentQueue.h mutex+condvar MPMC queue;
src/utils/MyProgress.h adapter pushing stage progress).  Python's
queue.Queue is the concurrent queue; events are plain dicts serialized to
the same JSON shape."""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass, field


@dataclass
class Event:
    type: str
    progress: float
    payload: dict = field(default_factory=dict)
    timestamp: float = field(default_factory=time.time)

    def to_json(self) -> str:
        d = {"type": self.type, "progress": round(float(self.progress), 4)}
        d.update(self.payload)
        return json.dumps(d)


class EventBus:
    """MPMC event queue with multi-subscriber fan-out (the reference drains
    one global queue into the SSE stream, main.cpp:227-233; here each
    subscriber gets its own queue so concurrent clients all see events)."""

    def __init__(self):
        self._subs: list[queue.Queue] = []
        self._lock = threading.Lock()
        self.history: list[Event] = []

    def publish(self, type: str, progress: float, **payload) -> None:
        ev = Event(type, progress, payload)
        with self._lock:
            self.history.append(ev)
            for q in self._subs:
                q.put(ev)

    def subscribe(self) -> queue.Queue:
        q: queue.Queue = queue.Queue()
        with self._lock:
            self._subs.append(q)
        return q

    def unsubscribe(self, q: queue.Queue) -> None:
        with self._lock:
            if q in self._subs:
                self._subs.remove(q)

    def progress_fn(self):
        """Callback with the (type, progress) signature the pipeline stages
        call (MyProgress-equivalent)."""
        return lambda type, progress, **kw: self.publish(type, progress, **kw)
