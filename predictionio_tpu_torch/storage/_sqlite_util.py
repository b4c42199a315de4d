"""Shared sqlite helpers for the in-memory mode of the storage backends.

A ``:memory:`` database is private to one connection, so memory mode must
share a single connection between threads. Python's sqlite3 serializes
individual C calls, but lazy cursor iteration interleaved across threads on
one connection is not safe. ``LockedConnection`` makes every statement
atomic: it takes the store's lock, executes, materializes all rows, and
returns a detached result — so callers can keep the exact same
``conn.execute(...)`` / iterate / ``fetchone`` code paths they use with
per-thread file connections.

Copied from ``predictionio_tpu/storage/_sqlite_util.py``; the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import sqlite3
import threading

__all__ = ["LockedConnection"]


class _Rows:
    """A fully-materialized, detached cursor result."""

    __slots__ = ("_rows", "rowcount", "lastrowid")

    def __init__(self, rows: list, rowcount: int, lastrowid: int | None):
        self._rows = rows
        self.rowcount = rowcount
        self.lastrowid = lastrowid

    def fetchone(self):
        return self._rows[0] if self._rows else None

    def fetchall(self) -> list:
        return list(self._rows)

    def __iter__(self):
        return iter(self._rows)


class LockedConnection:
    """Single shared sqlite connection; each call locks + materializes."""

    def __init__(self, path: str, lock: threading.RLock):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = lock

    def execute(self, sql: str, params: tuple | list = ()) -> _Rows:
        with self._lock:
            cur = self._conn.execute(sql, params)
            rows = cur.fetchall() if cur.description is not None else []
            return _Rows(rows, cur.rowcount, cur.lastrowid)

    def executemany(self, sql: str, seq) -> _Rows:
        with self._lock:
            cur = self._conn.executemany(sql, seq)
            return _Rows([], cur.rowcount, cur.lastrowid)

    def executescript(self, script: str) -> None:
        with self._lock:
            self._conn.executescript(script)

    def commit(self) -> None:
        with self._lock:
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()
