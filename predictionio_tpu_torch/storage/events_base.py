"""Event-store SPI.

The query surface mirrors the reference's ``LEvents``/``PEvents`` traits
(reference: data/src/main/scala/io/prediction/data/storage/LEvents.scala:31-451,
PEvents.scala:30-138): time-range, entity, event-name and target-entity
filters, limit and reversal, plus ``$set``-fold property aggregation.

Differences from the reference, by design:

- One backend class serves both the "local" (iterator) and "parallel" roles.
  The parallel read path is ``find_frame`` which returns a columnar
  ``EventFrame`` (see frame.py) instead of an ``RDD[Event]`` — the frame is
  what gets sharded onto the device mesh.
- Synchronous core methods; the event server wraps them in worker threads.
  (The reference's Futures exist because HBase RPCs are slow; the built-in
  backends here are in-process.)

Target-entity filters use the ``ANY`` sentinel: ``ANY`` = no restriction,
``None`` = event must have no target entity, a string = exact match —
the reference's ``None`` / ``Some(None)`` / ``Some(Some(x))`` triple
(LEvents.scala:111-118).

Copied from ``predictionio_tpu/storage/events_base.py``; the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from datetime import datetime
from typing import Any, Iterator, Sequence

from .aggregate import aggregate_properties_frame, aggregate_properties_single
from .datamap import PropertyMap
from .event import Event
from .frame import EventFrame

__all__ = ["ANY", "EventBackend", "EventQuery", "StorageError",
           "TableNotInitialized"]


class StorageError(RuntimeError):
    pass


class TableNotInitialized(StorageError):
    """The per-app events table was never ``init_app``'d — the one
    storage failure that legitimately reads as 404 on the API's read and
    delete paths. Every other ``StorageError`` is a real backend fault
    and must surface as 500, not masquerade as "Not Found"."""


class _Any:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "ANY"


#: no-restriction sentinel for target-entity filters
ANY: Any = _Any()


@dataclass(frozen=True)
class EventQuery:
    """All find() filters in one value (hashable, usable as a memo key)."""

    app_id: int
    channel_id: int | None = None
    start_time: datetime | None = None
    until_time: datetime | None = None
    entity_type: str | None = None
    entity_id: str | None = None
    event_names: tuple[str, ...] | None = None
    target_entity_type: Any = ANY
    target_entity_id: Any = ANY
    limit: int | None = None
    reversed: bool = False

    def __post_init__(self):
        # naive datetimes are treated as UTC, matching Event.__post_init__ —
        # otherwise backends would compare/encode them in server-local time
        from datetime import timezone

        for name in ("start_time", "until_time"):
            t = getattr(self, name)
            if t is not None and t.tzinfo is None:
                object.__setattr__(self, name, t.replace(tzinfo=timezone.utc))

    def matches(self, e: Event) -> bool:
        if self.start_time is not None and e.event_time < self.start_time:
            return False
        if self.until_time is not None and e.event_time >= self.until_time:
            return False
        if self.entity_type is not None and e.entity_type != self.entity_type:
            return False
        if self.entity_id is not None and e.entity_id != self.entity_id:
            return False
        if self.event_names is not None and e.event not in self.event_names:
            return False
        if self.target_entity_type is not ANY:
            if e.target_entity_type != self.target_entity_type:
                return False
        if self.target_entity_id is not ANY:
            if e.target_entity_id != self.target_entity_id:
                return False
        return True


class EventBackend(abc.ABC):
    """Abstract event store. One instance manages all apps/channels of one
    configured EVENTDATA source (reference: Storage.getLEvents,
    Storage.scala:283-296)."""

    # -- lifecycle (LEvents.scala:44-68) ----------------------------------
    @abc.abstractmethod
    def init_app(self, app_id: int, channel_id: int | None = None) -> bool:
        """Initialize storage for an app/channel (idempotent)."""

    @abc.abstractmethod
    def remove_app(self, app_id: int, channel_id: int | None = None) -> bool:
        """Remove all events of an app/channel."""

    def close(self) -> None:
        pass

    # -- writes -----------------------------------------------------------
    @abc.abstractmethod
    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        """Insert one event, returning its assigned event id."""

    #: True when ``insert_batch`` is all-or-nothing (a failure persists
    #: NOTHING). The event server only takes the batch fast path for
    #: atomic backends — a partial insert followed by a blanket 500 would
    #: make clients re-send events that already landed.
    BATCH_ATOMIC = False

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        """Bulk insert (the import path; reference tools/imprt/FileToEvents
        uses PEvents.write). Backends may override for a faster path; an
        all-or-nothing override should also set ``BATCH_ATOMIC``."""
        return [self.insert(e, app_id, channel_id) for e in events]

    # -- point reads / deletes (LEvents.scala:71-103) ---------------------
    @abc.abstractmethod
    def get(self, event_id: str, app_id: int, channel_id: int | None = None) -> Event | None:
        ...

    @abc.abstractmethod
    def delete(self, event_id: str, app_id: int, channel_id: int | None = None) -> bool:
        ...

    def remove_before(self, app_id: int, cutoff, channel_id: int | None = None) -> int:
        """Delete every event with ``event_time < cutoff``; returns the
        count removed. The data-ageing verb behind
        ``pio app data-delete --before`` (role of the reference's
        trim-app engine, examples/experimental/scala-parallel-trim-app —
        which re-reads and re-writes the keep-window instead). Generic
        fallback: scan + per-event delete; backends override with a bulk
        path."""
        ids = [e.event_id for e in
               self.find(EventQuery(app_id=app_id, channel_id=channel_id,
                                    until_time=cutoff))]
        removed = 0
        for eid in ids:
            removed += bool(self.delete(eid, app_id, channel_id))
        return removed

    # -- queries ----------------------------------------------------------
    @abc.abstractmethod
    def find(self, query: EventQuery) -> Iterator[Event]:
        """Filtered scan ordered by event_time (descending if
        ``query.reversed``), truncated to ``query.limit`` (None or -1 = all)."""

    def find_frame(self, query: EventQuery) -> EventFrame:
        """Columnar scan — the parallel/TPU read path (PEvents.find analog).
        Limit/reversed are ignored (full filtered scan), as in the
        reference's parallel API which has no limit (PEvents.scala:70-80)."""
        q = EventQuery(**{**query.__dict__, "limit": None, "reversed": False})
        return EventFrame.from_events(self.find(q))

    def aggregate_properties(
        self,
        app_id: int,
        *,
        entity_type: str,
        channel_id: int | None = None,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        required: Sequence[str] | None = None,
    ) -> dict[str, PropertyMap]:
        """$set/$unset/$delete fold per entity (LEvents.scala:153-194).

        Reads through ``find_frame`` (one columnar scan) and the
        vectorized frame fold — the read pushdown; semantics are
        pinned bit-identical to the row-at-a-time
        ``aggregate_properties(self.find(...))`` it replaces."""
        frame = self.find_frame(
            EventQuery(
                app_id=app_id,
                channel_id=channel_id,
                entity_type=entity_type,
                start_time=start_time,
                until_time=until_time,
                event_names=("$set", "$unset", "$delete"),
            )
        )
        result = aggregate_properties_frame(frame)
        if required:
            result = {
                k: v
                for k, v in result.items()
                if all(r in v for r in required)
            }
        return result

    def aggregate_properties_of_entity(
        self,
        app_id: int,
        entity_type: str,
        entity_id: str,
        channel_id: int | None = None,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
    ) -> PropertyMap | None:
        """Single-entity fold (LEvents.scala:196-230)."""
        events = self.find(
            EventQuery(
                app_id=app_id,
                channel_id=channel_id,
                entity_type=entity_type,
                entity_id=entity_id,
                start_time=start_time,
                until_time=until_time,
                event_names=("$set", "$unset", "$delete"),
            )
        )
        return aggregate_properties_single(events)
