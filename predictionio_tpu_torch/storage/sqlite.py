"""SQLite event store backend — the durable single-node EVENTDATA store.

Replaces the role of the reference's HBase event backend (reference:
data/src/main/scala/io/prediction/data/storage/hbase/HBEventsUtil.scala,
HBLEvents.scala): one table per (app, channel) named
``events_<appId>[_<channelId>]`` like the reference's
``pio_event:events_<appId>_<channelId>`` naming (HBEventsUtil.scala:51-58),
rows keyed by a time-ordered synthetic key, with indexed columns for the
standard filters. Properties ride as JSON text.

SQLite (WAL mode) gives durable multi-reader/single-writer semantics in one
file with zero external services — the right call for a single host; the
storage registry lets a real distributed backend plug in behind the same
``EventBackend`` SPI without touching callers.

Copied from ``predictionio_tpu/storage/sqlite.py``; the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import uuid
from datetime import datetime, timezone
from typing import Iterator, Sequence

import numpy as np

from ._sqlite_util import LockedConnection
from .datamap import DataMap
from .event import Event
from .frame import EventFrame
from .events_base import ANY, EventBackend, EventQuery, StorageError, TableNotInitialized

__all__ = ["SQLiteEvents"]

_SCHEMA = """
CREATE TABLE IF NOT EXISTS {table} (
  event_id TEXT PRIMARY KEY,
  event TEXT NOT NULL,
  entity_type TEXT NOT NULL,
  entity_id TEXT NOT NULL,
  target_entity_type TEXT,
  target_entity_id TEXT,
  properties TEXT NOT NULL,
  event_time REAL NOT NULL,
  tags TEXT NOT NULL,
  pr_id TEXT,
  creation_time REAL NOT NULL,
  seq INTEGER
);
CREATE INDEX IF NOT EXISTS {table}_time ON {table} (event_time, seq);
CREATE INDEX IF NOT EXISTS {table}_entity ON {table} (entity_type, entity_id, event_time);
"""


def _table_name(app_id: int, channel_id: int | None) -> str:
    if channel_id is None:
        return f"events_{app_id}"
    return f"events_{app_id}_{channel_id}"


class SQLiteEvents(EventBackend):
    def __init__(self, config: dict | None = None):
        config = config or {}
        path = config.get("path", ":memory:")
        # see MetadataStore._conn: in-memory mode = one serialized connection
        self._memory = path == ":memory:"
        self._path = path
        self._local = threading.local()
        self._lock = threading.RLock()
        self._shared = LockedConnection(path, self._lock) if self._memory else None
        self._all_conns: list = []
        self._closed = False
        self._known_tables: set[str] = set()
        self._seq = 0

    def _raise_if_closed(self) -> None:
        if self._closed:
            raise RuntimeError(f"{type(self).__name__} is closed")

    def _conn(self) -> sqlite3.Connection:
        self._raise_if_closed()
        if self._shared is not None:
            return self._shared
        conn = getattr(self._local, "conn", None)
        if conn is None:
            # check_same_thread=False so close() can REALLY close every
            # thread's connection (each conn is still used by one thread;
            # writes additionally serialize under self._lock) — otherwise
            # worker conns dangle open past close() and leak the file
            # handle until thread exit
            conn = sqlite3.connect(self._path, timeout=30.0,
                                   check_same_thread=False)
            with self._lock:
                if self._closed:  # close() raced us: do not leak a conn
                    conn.close()
                    self._raise_if_closed()
                self._all_conns.append(conn)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
            self._local.conn = conn
        return conn

    def _ensure_table(self, app_id: int, channel_id: int | None, create: bool) -> str:
        table = _table_name(app_id, channel_id)
        if table in self._known_tables:
            return table
        conn = self._conn()
        row = conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' AND name=?", (table,)
        ).fetchone()
        if row is None:
            if not create:
                raise TableNotInitialized(
                    f"events table for app {app_id} channel {channel_id} "
                    "not initialized (run init_app / `pio app new`)"
                )
            with self._lock:
                conn.executescript(_SCHEMA.format(table=table))
                conn.commit()
        else:
            # resume the tie-break sequence past any rows already on disk
            (mx,) = conn.execute(f"SELECT COALESCE(MAX(seq), 0) FROM {table}").fetchone()
            with self._lock:
                self._seq = max(self._seq, int(mx))
        self._known_tables.add(table)
        return table

    # -- lifecycle --------------------------------------------------------
    def init_app(self, app_id: int, channel_id: int | None = None) -> bool:
        self._ensure_table(app_id, channel_id, create=True)
        return True

    def remove_app(self, app_id: int, channel_id: int | None = None) -> bool:
        table = _table_name(app_id, channel_id)
        conn = self._conn()
        with self._lock:
            conn.execute(f"DROP TABLE IF EXISTS {table}")
            conn.commit()
            self._known_tables.discard(table)
        return True

    def close(self) -> None:
        """Close every thread's connection. Post-close use on ANY thread
        — including a find() iterator already mid-flight — surfaces as
        the "is closed" RuntimeError via the ``_closed`` guard, never a
        raw ``sqlite3.ProgrammingError`` over a dangling handle."""
        with self._lock:
            self._closed = True
            for conn in self._all_conns:
                try:
                    conn.close()
                except sqlite3.ProgrammingError:
                    pass  # mid-statement on another thread; GC'd at exit
            self._all_conns.clear()
            self._local.conn = None
            if self._shared is not None:
                self._shared.close()
                self._shared = None

    # -- writes -----------------------------------------------------------
    def _row(self, e: Event) -> tuple:
        return (
            e.event_id,
            e.event,
            e.entity_type,
            e.entity_id,
            e.target_entity_type,
            e.target_entity_id,
            e.properties.to_json(),
            e.event_time.timestamp(),
            "[]" if not e.tags else json.dumps(list(e.tags)),
            e.pr_id,
            e.creation_time.timestamp(),
        )

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        table = self._ensure_table(app_id, channel_id, create=True)
        e = event if event.event_id else event.with_id(uuid.uuid4().hex)
        conn = self._conn()
        with self._lock:
            self._seq += 1
            conn.execute(
                f"INSERT OR REPLACE INTO {table} VALUES (?,?,?,?,?,?,?,?,?,?,?,?)",
                self._row(e) + (self._seq,),
            )
            conn.commit()
        return e.event_id  # type: ignore[return-value]

    BATCH_ATOMIC = True  # one executemany inside one transaction

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        table = self._ensure_table(app_id, channel_id, create=True)
        withids = [e if e.event_id else e.with_id(uuid.uuid4().hex) for e in events]
        conn = self._conn()
        with self._lock:
            rows = []
            for e in withids:
                self._seq += 1
                rows.append(self._row(e) + (self._seq,))
            try:
                conn.executemany(
                    f"INSERT OR REPLACE INTO {table} VALUES (?,?,?,?,?,?,?,?,?,?,?,?)", rows
                )
                conn.commit()
            except sqlite3.Error as e:
                # the BATCH_ATOMIC contract: a failure persists NOTHING.
                # Without the rollback, rows already in the implicit
                # transaction would ride out on the NEXT commit of this
                # (thread-reused) connection; callers also only catch
                # StorageError, not raw sqlite3 errors.
                conn.rollback()
                raise StorageError(f"batch insert failed: {e}") from e
        return [e.event_id for e in withids]  # type: ignore[misc]

    # -- point ops --------------------------------------------------------
    def _from_row(self, row: tuple) -> Event:
        return Event(
            event_id=row[0],
            event=row[1],
            entity_type=row[2],
            entity_id=row[3],
            target_entity_type=row[4],
            target_entity_id=row[5],
            properties=DataMap.from_json(row[6]),
            event_time=datetime.fromtimestamp(row[7], tz=timezone.utc),
            tags=tuple(json.loads(row[8])),
            pr_id=row[9],
            creation_time=datetime.fromtimestamp(row[10], tz=timezone.utc),
        )

    def get(self, event_id: str, app_id: int, channel_id: int | None = None) -> Event | None:
        table = self._ensure_table(app_id, channel_id, create=False)
        try:
            row = self._conn().execute(
                f"SELECT * FROM {table} WHERE event_id=?", (event_id,)
            ).fetchone()
        except sqlite3.ProgrammingError:
            self._raise_if_closed()  # close() raced us mid-statement
            raise
        return self._from_row(row) if row else None

    def delete(self, event_id: str, app_id: int, channel_id: int | None = None) -> bool:
        table = self._ensure_table(app_id, channel_id, create=False)
        conn = self._conn()
        with self._lock:
            cur = conn.execute(f"DELETE FROM {table} WHERE event_id=?", (event_id,))
            conn.commit()
            return cur.rowcount > 0

    def remove_before(self, app_id: int, cutoff, channel_id: int | None = None) -> int:
        """Bulk time-windowed trim: one indexed DELETE instead of the
        base class's scan + per-row deletes."""
        table = self._ensure_table(app_id, channel_id, create=False)
        if cutoff.tzinfo is None:
            # naive datetimes are UTC everywhere in this codebase
            # (EventQuery.__post_init__); .timestamp() on a naive value
            # would read it in server-local time instead
            cutoff = cutoff.replace(tzinfo=timezone.utc)
        conn = self._conn()
        with self._lock:
            cur = conn.execute(
                f"DELETE FROM {table} WHERE event_time < ?",
                (cutoff.timestamp(),))
            conn.commit()
            return cur.rowcount

    # -- scans ------------------------------------------------------------
    @staticmethod
    def _where(query: EventQuery) -> tuple[str, list]:
        clauses, params = [], []
        if query.start_time is not None:
            clauses.append("event_time >= ?")
            params.append(query.start_time.timestamp())
        if query.until_time is not None:
            clauses.append("event_time < ?")
            params.append(query.until_time.timestamp())
        if query.entity_type is not None:
            clauses.append("entity_type = ?")
            params.append(query.entity_type)
        if query.entity_id is not None:
            clauses.append("entity_id = ?")
            params.append(query.entity_id)
        if query.event_names is not None:
            clauses.append(
                "event IN (%s)" % ",".join("?" * len(query.event_names))
            )
            params.extend(query.event_names)
        if query.target_entity_type is not ANY:
            if query.target_entity_type is None:
                clauses.append("target_entity_type IS NULL")
            else:
                clauses.append("target_entity_type = ?")
                params.append(query.target_entity_type)
        if query.target_entity_id is not ANY:
            if query.target_entity_id is None:
                clauses.append("target_entity_id IS NULL")
            else:
                clauses.append("target_entity_id = ?")
                params.append(query.target_entity_id)
        return (" WHERE " + " AND ".join(clauses)) if clauses else "", params

    def find(self, query: EventQuery) -> Iterator[Event]:
        table = self._ensure_table(query.app_id, query.channel_id, create=False)
        where, params = self._where(query)
        order = "DESC" if query.reversed else "ASC"
        sql = f"SELECT * FROM {table}{where} ORDER BY event_time {order}, seq {order}"
        if query.limit is not None and query.limit >= 0:
            sql += f" LIMIT {int(query.limit)}"
        # the lazy cursor iterates across yields; close() can land between
        # them, and its intended signal is the _closed RuntimeError — not a
        # raw sqlite3.ProgrammingError off the dead cursor
        try:
            rows = iter(self._conn().execute(sql, params))
        except sqlite3.ProgrammingError:
            self._raise_if_closed()
            raise
        while True:
            try:
                row = next(rows)
            except StopIteration:
                return
            except sqlite3.ProgrammingError:
                self._raise_if_closed()
                raise
            yield self._from_row(row)

    def find_frame(self, query: EventQuery):
        """Columnar scan straight from SQL rows — the training read path
        skips per-event ``Event``/``DataMap`` materialization (measured
        ~4x over the base from_events path at 200k events; this is the
        HBase-scan-to-RDD stage of reference training reads,
        HBPEvents.scala:66-99, as one SELECT into numpy columns)."""
        table = self._ensure_table(query.app_id, query.channel_id,
                                   create=False)
        where, params = self._where(query)
        sql = (f"SELECT event, entity_type, entity_id, target_entity_type, "
               f"target_entity_id, event_time, properties FROM {table}"
               f"{where} ORDER BY event_time ASC, seq ASC")
        rows = self._conn().execute(sql, params).fetchall()
        if not rows:
            empty = np.empty(0, dtype=object)
            return EventFrame(event=empty, entity_type=empty.copy(),
                              entity_id=empty.copy(),
                              target_entity_type=empty.copy(),
                              target_entity_id=empty.copy(),
                              event_time=np.empty(0, dtype=np.float64),
                              properties=[])
        # one C-level transpose instead of 7 assignments per row — the
        # per-row loop was ~half the 200k-event scan cost
        ev_c, et_c, ei_c, tt_c, ti_c, tm_c, pj_c = zip(*rows)
        loads = json.loads
        # bulk imports repeat property shapes; memoizing on the raw JSON
        # string skips most of the parse cost. The dicts are therefore
        # SHARED across rows — EventFrame.properties is a read-only view.
        memo: dict = {}
        pr = []
        for p in pj_c:
            d = memo.get(p)
            if d is None:
                d = loads(p) if p else {}
                memo[p] = d
            pr.append(d)
        return EventFrame(
            event=np.array(ev_c, dtype=object),
            entity_type=np.array(et_c, dtype=object),
            entity_id=np.array(ei_c, dtype=object),
            target_entity_type=np.array(tt_c, dtype=object),
            target_entity_id=np.array(ti_c, dtype=object),
            event_time=np.array(tm_c, dtype=np.float64),
            properties=pr)
