"""In-process event store backend.

Plays the role the reference's HBase backend plays in production and its
test doubles play in specs (reference: data/src/main/scala/io/prediction/
data/storage/hbase/HBLEvents.scala) — but as a thread-safe in-memory store,
the default for tests and single-process quickstarts.

Events are kept sorted by (event_time, insertion seq) per (app, channel) so
scans are ordered without per-query sorts; insertion is O(log n) bisect.

Copied from ``predictionio_tpu/storage/memory.py``; the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import bisect
import threading
import uuid
from typing import Iterator

from .event import Event
from .events_base import EventBackend, EventQuery, TableNotInitialized

__all__ = ["MemoryEvents"]


class _Table:
    __slots__ = ("keys", "events", "by_id", "seq")

    def __init__(self):
        self.keys: list[tuple[float, int]] = []  # (epoch, seq) sort keys
        self.events: list[Event] = []
        self.by_id: dict[str, Event] = {}
        self.seq = 0


class MemoryEvents(EventBackend):
    BATCH_ATOMIC = True  # see insert_batch: validated upfront, one lock

    def __init__(self, config: dict | None = None):
        self._tables: dict[tuple[int, int | None], _Table] = {}
        self._lock = threading.RLock()

    def _table(self, app_id: int, channel_id: int | None, create: bool = False) -> _Table:
        key = (app_id, channel_id)
        with self._lock:
            t = self._tables.get(key)
            if t is None:
                if not create:
                    raise TableNotInitialized(
                        f"events table for app {app_id} channel {channel_id} "
                        "not initialized (run init_app / `pio app new`)"
                    )
                t = self._tables[key] = _Table()
            return t

    # -- lifecycle --------------------------------------------------------
    def init_app(self, app_id: int, channel_id: int | None = None) -> bool:
        self._table(app_id, channel_id, create=True)
        return True

    def remove_app(self, app_id: int, channel_id: int | None = None) -> bool:
        with self._lock:
            return self._tables.pop((app_id, channel_id), None) is not None

    # -- writes -----------------------------------------------------------
    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        t = self._table(app_id, channel_id, create=True)
        with self._lock:
            e = event if event.event_id else event.with_id(uuid.uuid4().hex)
            if e.event_id in t.by_id:
                self._remove_from_lists(t, e.event_id)
            key = (e.event_time.timestamp(), t.seq)
            t.seq += 1
            pos = bisect.bisect_right(t.keys, key)
            t.keys.insert(pos, key)
            t.events.insert(pos, e)
            t.by_id[e.event_id] = e  # type: ignore[index]
            return e.event_id  # type: ignore[return-value]

    def insert_batch(
        self, events, app_id: int, channel_id: int | None = None
    ) -> list[str]:
        """All-or-nothing by construction (BATCH_ATOMIC): ids are
        assigned before any mutation and the appends are plain in-process
        list/dict operations under one lock — there is no failure path
        between the first and last event."""
        t = self._table(app_id, channel_id, create=True)
        out = []
        with self._lock:
            for event in events:
                e = event if event.event_id else event.with_id(uuid.uuid4().hex)
                if e.event_id in t.by_id:
                    self._remove_from_lists(t, e.event_id)
                key = (e.event_time.timestamp(), t.seq)
                t.seq += 1
                pos = bisect.bisect_right(t.keys, key)
                t.keys.insert(pos, key)
                t.events.insert(pos, e)
                t.by_id[e.event_id] = e
                out.append(e.event_id)
        return out

    @staticmethod
    def _remove_from_lists(t: _Table, event_id: str) -> None:
        for i, ev in enumerate(t.events):
            if ev.event_id == event_id:
                del t.events[i]
                del t.keys[i]
                break

    # -- point ops --------------------------------------------------------
    def get(self, event_id: str, app_id: int, channel_id: int | None = None) -> Event | None:
        t = self._table(app_id, channel_id)
        with self._lock:
            return t.by_id.get(event_id)

    def delete(self, event_id: str, app_id: int, channel_id: int | None = None) -> bool:
        t = self._table(app_id, channel_id)
        with self._lock:
            e = t.by_id.pop(event_id, None)
            if e is None:
                return False
            self._remove_from_lists(t, event_id)
            return True

    # -- scans ------------------------------------------------------------
    def find(self, query: EventQuery) -> Iterator[Event]:
        t = self._table(query.app_id, query.channel_id)
        with self._lock:
            events = list(t.events)  # snapshot; already time-ordered
        if query.reversed:
            events = events[::-1]
        limit = query.limit if query.limit is not None and query.limit >= 0 else None
        n = 0
        for e in events:
            if query.matches(e):
                yield e
                n += 1
                if limit is not None and n >= limit:
                    return
