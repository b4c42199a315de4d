"""Metadata entities and their DAOs.

The reference keeps framework metadata (apps, access keys, channels, engine
manifests/instances, evaluation instances) in Elasticsearch/MongoDB behind
per-entity DAO traits (reference: data/src/main/scala/io/prediction/data/
storage/{Apps,AccessKeys,Channels,EngineManifests,EngineInstances,
EvaluationInstances}.scala). Here a single SQLite database holds all
metadata tables — one file, transactional, zero services; ``:memory:`` for
tests. Entities are frozen dataclasses serialized to/from JSON columns.

Copied from ``predictionio_tpu/storage/metadata.py``; the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import json
import re
import secrets
import sqlite3
import threading
from dataclasses import asdict, dataclass, field, replace
from datetime import datetime, timezone

from ._sqlite_util import LockedConnection

__all__ = [
    "App", "AccessKey", "Channel", "EngineManifest", "EngineInstance",
    "EvaluationInstance", "Model", "MetadataStore", "CHANNEL_NAME_RE",
]

#: reference Channels.scala:35-39
CHANNEL_NAME_RE = re.compile(r"^[a-zA-Z0-9-]{1,16}$")


@dataclass(frozen=True)
class App:
    id: int
    name: str
    description: str | None = None


@dataclass(frozen=True)
class AccessKey:
    key: str
    appid: int
    events: tuple[str, ...] = ()  # empty = all events allowed (AccessKeys.scala:27-34)


@dataclass(frozen=True)
class Channel:
    id: int
    name: str
    appid: int

    @staticmethod
    def is_valid_name(s: str) -> bool:
        return bool(CHANNEL_NAME_RE.match(s))


@dataclass(frozen=True)
class EngineManifest:
    """Registered engine build (reference EngineManifests.scala:33-43);
    ``files`` are the engine's code paths (module dirs, not jars)."""
    id: str
    version: str
    name: str
    description: str | None = None
    files: tuple[str, ...] = ()
    engine_factory: str = ""


def _utcnow() -> datetime:
    return datetime.now(timezone.utc)


@dataclass(frozen=True)
class EngineInstance:
    """One training/evaluation run's record (EngineInstances.scala:47-67).
    Status lifecycle: INIT -> TRAINING -> COMPLETED | ABORTED, plus
    ABANDONED for stale-heartbeat orphans flipped by the reaper."""
    id: str = ""
    status: str = "INIT"
    start_time: datetime = field(default_factory=_utcnow)
    end_time: datetime = field(default_factory=_utcnow)
    engine_id: str = ""
    engine_version: str = ""
    engine_variant: str = ""
    engine_factory: str = ""
    evaluator_class: str = ""
    batch: str = ""
    env: dict = field(default_factory=dict)
    backend_conf: dict = field(default_factory=dict)  # reference: sparkConf
    data_source_params: str = ""
    preparator_params: str = ""
    algorithms_params: str = ""
    serving_params: str = ""
    evaluator_params: str = ""
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""
    #: UTC isoformat of the supervisor's last liveness stamp; empty until
    #: the first heartbeat. Lets `pio status` / the reaper tell a live
    #: INIT run from an orphan whose process died.
    last_heartbeat: str = ""
    #: supervised retry attempt currently running (0 = first attempt)
    attempt: int = 0
    #: JSON list of [phase, seconds] pairs from the SUCCESSFUL training
    #: attempt (tracing.phase_times_json) — `pio status` shows where the
    #: run's wall clock went. Empty for pre-telemetry records.
    phase_times: str = ""
    #: JSON list of per-attempt convergence summaries (obs/training
    #: ConvergenceTracker.summaries: final/first loss, iterations run,
    #: mean step seconds, final delta norm) stamped at the final status
    #: flip — `pio status` prints them. Empty for pre-telemetry records.
    convergence: str = ""
    #: JSON map of per-process liveness for elastic multi-host runs:
    #: ``{"<process_id>": {"ts": iso, "attempt": n}}``. Each process of
    #: the run stamps its own entry; ``pio status`` shows all of them and
    #: ``supervisor.check_peer_liveness`` raises ``HostLostError`` when a
    #: peer's goes stale. Empty for single-host / pre-elastic records.
    host_heartbeats: str = ""
    #: JSON tuning leaderboard (workflow/tuning.py TuneResult
    #: .leaderboard_json: per-trial params/score/status/error plus the
    #: winning trial index and metric header) stamped onto the WINNER's
    #: instance by ``run_tune`` — `pio status` and the dashboard's
    #: /tune.json read it. Empty for non-tuned runs.
    tuning: str = ""


@dataclass(frozen=True)
class EvaluationInstance:
    """(EvaluationInstances.scala:38-50)"""
    id: str = ""
    status: str = ""
    start_time: datetime = field(default_factory=_utcnow)
    end_time: datetime = field(default_factory=_utcnow)
    evaluation_class: str = ""
    engine_params_generator_class: str = ""
    batch: str = ""
    env: dict = field(default_factory=dict)
    backend_conf: dict = field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""


@dataclass(frozen=True)
class Model:
    """Serialized model blob keyed by engine-instance id (Models.scala:30).
    ``checksum`` is ``"sha256:<hex>"`` over ``models``; empty for blobs
    written before integrity tracking (verification skips those)."""
    id: str
    models: bytes
    checksum: str = ""

    @staticmethod
    def compute_checksum(blob: bytes) -> str:
        import hashlib

        return "sha256:" + hashlib.sha256(blob).hexdigest()


_DT_FIELDS = {"start_time", "end_time"}


def _utc_sort_key(t: datetime) -> str:
    """Normalized-UTC isoformat for the indexed start_time columns, so
    lexicographic ORDER BY matches chronological order across offsets."""
    if t.tzinfo is None:
        t = t.replace(tzinfo=timezone.utc)
    return t.astimezone(timezone.utc).isoformat()


def _ser(obj) -> str:
    d = asdict(obj)
    for k in _DT_FIELDS & d.keys():
        d[k] = d[k].isoformat()
    return json.dumps(d)


def _deser(cls, s: str):
    d = json.loads(s)
    for k in _DT_FIELDS & d.keys():
        d[k] = datetime.fromisoformat(d[k])
    for k, v in list(d.items()):
        if isinstance(v, list):
            d[k] = tuple(v)
    return cls(**d)


class MetadataStore:
    """All metadata DAOs over one SQLite database.

    JSON-document tables with a few indexed columns — the same shape as the
    reference's ES documents (e.g. ESEngineInstances.scala:40-90) without
    the cluster.
    """

    def __init__(self, path: str = ":memory:"):
        # A plain :memory: database is private to one connection, so in-memory
        # mode shares a single serialized connection across threads (sqlite3
        # is built in serialized threading mode; our writes additionally hold
        # self._lock so transactions never interleave). File mode uses
        # per-thread connections + WAL.
        self._memory = path == ":memory:"
        self._path = path
        self._local = threading.local()
        self._lock = threading.RLock()
        self._shared = LockedConnection(path, self._lock) if self._memory else None
        self._all_conns: list = []
        self._closed = False
        self._init_schema()

    def _conn(self) -> sqlite3.Connection:
        if self._closed:
            raise RuntimeError(f"{type(self).__name__} is closed")
        if self._shared is not None:
            return self._shared
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self._path, timeout=30.0)
            with self._lock:
                self._all_conns.append(conn)
            conn.execute("PRAGMA journal_mode=WAL")
            self._local.conn = conn
        return conn

    def _init_schema(self) -> None:
        c = self._conn()
        with self._lock:
            c.executescript(
                """
                CREATE TABLE IF NOT EXISTS apps (
                  id INTEGER PRIMARY KEY AUTOINCREMENT, name TEXT UNIQUE, doc TEXT);
                CREATE TABLE IF NOT EXISTS access_keys (
                  key TEXT PRIMARY KEY, appid INTEGER, doc TEXT);
                CREATE TABLE IF NOT EXISTS channels (
                  id INTEGER PRIMARY KEY AUTOINCREMENT, appid INTEGER, name TEXT, doc TEXT,
                  UNIQUE(appid, name));
                CREATE TABLE IF NOT EXISTS engine_manifests (
                  id TEXT, version TEXT, doc TEXT, PRIMARY KEY (id, version));
                CREATE TABLE IF NOT EXISTS engine_instances (
                  id TEXT PRIMARY KEY, status TEXT, engine_id TEXT,
                  engine_version TEXT, engine_variant TEXT, start_time TEXT,
                  last_heartbeat TEXT DEFAULT '', attempt INTEGER DEFAULT 0,
                  doc TEXT);
                CREATE TABLE IF NOT EXISTS evaluation_instances (
                  id TEXT PRIMARY KEY, status TEXT, start_time TEXT, doc TEXT);
                CREATE TABLE IF NOT EXISTS models (
                  id TEXT PRIMARY KEY, blob BLOB, checksum TEXT DEFAULT '');
                CREATE TABLE IF NOT EXISTS sequences (
                  name TEXT PRIMARY KEY, value INTEGER);
                """
            )
            # Databases created before heartbeat/attempt/checksum existed
            # migrate in place (ALTER TABLE ADD COLUMN is cheap and
            # idempotent via the PRAGMA check).
            self._add_missing_column(c, "engine_instances",
                                     "last_heartbeat", "TEXT DEFAULT ''")
            self._add_missing_column(c, "engine_instances",
                                     "attempt", "INTEGER DEFAULT 0")
            self._add_missing_column(c, "models", "checksum", "TEXT DEFAULT ''")
            c.commit()

    @staticmethod
    def _add_missing_column(c, table: str, column: str, decl: str) -> None:
        cols = {r[1] for r in c.execute(f"PRAGMA table_info({table})")}
        if column not in cols:
            c.execute(f"ALTER TABLE {table} ADD COLUMN {column} {decl}")

    def close(self) -> None:
        self._closed = True
        with self._lock:
            for conn in self._all_conns:
                try:
                    conn.close()
                except sqlite3.ProgrammingError:
                    pass  # a conn owned by a live worker thread; dropped at exit
            self._all_conns.clear()
        self._local.conn = None
        if self._shared is not None:
            self._shared.close()
            self._shared = None

    # -- sequences (ESSequences analog) -----------------------------------
    def next_id(self, name: str) -> int:
        c = self._conn()
        with self._lock:
            c.execute(
                "INSERT INTO sequences VALUES (?, 1) "
                "ON CONFLICT(name) DO UPDATE SET value = value + 1",
                (name,),
            )
            (v,) = c.execute("SELECT value FROM sequences WHERE name=?", (name,)).fetchone()
            c.commit()
            return int(v)

    # -- apps (Apps.scala:41-70) ------------------------------------------
    def app_insert(self, name: str, description: str | None = None) -> App | None:
        c = self._conn()
        with self._lock:
            try:
                cur = c.execute(
                    "INSERT INTO apps (name, doc) VALUES (?, ?)", (name, "")
                )
            except sqlite3.IntegrityError:
                return None
            app = App(id=cur.lastrowid, name=name, description=description)
            c.execute("UPDATE apps SET doc=? WHERE id=?", (_ser(app), app.id))
            c.commit()
            return app

    def app_get(self, app_id: int) -> App | None:
        row = self._conn().execute("SELECT doc FROM apps WHERE id=?", (app_id,)).fetchone()
        return _deser(App, row[0]) if row else None

    def app_get_by_name(self, name: str) -> App | None:
        row = self._conn().execute("SELECT doc FROM apps WHERE name=?", (name,)).fetchone()
        return _deser(App, row[0]) if row else None

    def app_get_all(self) -> list[App]:
        return [_deser(App, r[0]) for r in self._conn().execute("SELECT doc FROM apps ORDER BY id")]

    def app_update(self, app: App) -> bool:
        c = self._conn()
        with self._lock:
            try:
                cur = c.execute(
                    "UPDATE apps SET name=?, doc=? WHERE id=?",
                    (app.name, _ser(app), app.id),
                )
            except sqlite3.IntegrityError:  # rename onto an existing name
                return False
            c.commit()
            return cur.rowcount > 0

    def app_delete(self, app_id: int) -> bool:
        c = self._conn()
        with self._lock:
            cur = c.execute("DELETE FROM apps WHERE id=?", (app_id,))
            c.commit()
            return cur.rowcount > 0

    # -- access keys (AccessKeys.scala:37-77) -----------------------------
    def access_key_insert(
        self, appid: int, events: tuple[str, ...] = (), key: str | None = None
    ) -> AccessKey | None:
        """None on duplicate caller-chosen key (same conflict contract as
        app_insert/channel_insert)."""
        ak = AccessKey(key=key or secrets.token_urlsafe(32), appid=appid, events=tuple(events))
        c = self._conn()
        with self._lock:
            try:
                c.execute(
                    "INSERT INTO access_keys VALUES (?, ?, ?)", (ak.key, appid, _ser(ak))
                )
            except sqlite3.IntegrityError:
                return None
            c.commit()
        return ak

    def access_key_get(self, key: str) -> AccessKey | None:
        row = self._conn().execute("SELECT doc FROM access_keys WHERE key=?", (key,)).fetchone()
        return _deser(AccessKey, row[0]) if row else None

    def access_key_get_all(self) -> list[AccessKey]:
        return [_deser(AccessKey, r[0]) for r in self._conn().execute("SELECT doc FROM access_keys")]

    def access_key_get_by_appid(self, appid: int) -> list[AccessKey]:
        return [
            _deser(AccessKey, r[0])
            for r in self._conn().execute("SELECT doc FROM access_keys WHERE appid=?", (appid,))
        ]

    def access_key_delete(self, key: str) -> bool:
        c = self._conn()
        with self._lock:
            cur = c.execute("DELETE FROM access_keys WHERE key=?", (key,))
            c.commit()
            return cur.rowcount > 0

    # -- channels (Channels.scala:44-71) ----------------------------------
    def channel_insert(self, appid: int, name: str) -> Channel | None:
        if not Channel.is_valid_name(name):
            return None
        c = self._conn()
        with self._lock:
            try:
                cur = c.execute(
                    "INSERT INTO channels (appid, name, doc) VALUES (?, ?, ?)",
                    (appid, name, ""),
                )
            except sqlite3.IntegrityError:
                return None
            ch = Channel(id=cur.lastrowid, name=name, appid=appid)
            c.execute("UPDATE channels SET doc=? WHERE id=?", (_ser(ch), ch.id))
            c.commit()
            return ch

    def channel_get(self, channel_id: int) -> Channel | None:
        row = self._conn().execute("SELECT doc FROM channels WHERE id=?", (channel_id,)).fetchone()
        return _deser(Channel, row[0]) if row else None

    def channel_get_by_appid(self, appid: int) -> list[Channel]:
        return [
            _deser(Channel, r[0])
            for r in self._conn().execute(
                "SELECT doc FROM channels WHERE appid=? ORDER BY id", (appid,)
            )
        ]

    def channel_delete(self, channel_id: int) -> bool:
        c = self._conn()
        with self._lock:
            cur = c.execute("DELETE FROM channels WHERE id=?", (channel_id,))
            c.commit()
            return cur.rowcount > 0

    # -- engine manifests (EngineManifests.scala:47-77) -------------------
    def engine_manifest_insert(self, m: EngineManifest) -> None:
        c = self._conn()
        with self._lock:
            c.execute(
                "INSERT OR REPLACE INTO engine_manifests VALUES (?, ?, ?)",
                (m.id, m.version, _ser(m)),
            )
            c.commit()

    def engine_manifest_get(self, id: str, version: str) -> EngineManifest | None:
        row = self._conn().execute(
            "SELECT doc FROM engine_manifests WHERE id=? AND version=?", (id, version)
        ).fetchone()
        return _deser(EngineManifest, row[0]) if row else None

    def engine_manifest_get_all(self) -> list[EngineManifest]:
        return [
            _deser(EngineManifest, r[0])
            for r in self._conn().execute("SELECT doc FROM engine_manifests")
        ]

    def engine_manifest_delete(self, id: str, version: str) -> bool:
        c = self._conn()
        with self._lock:
            cur = c.execute(
                "DELETE FROM engine_manifests WHERE id=? AND version=?", (id, version)
            )
            c.commit()
            return cur.rowcount > 0

    # -- engine instances (EngineInstances.scala:72-130) ------------------
    def engine_instance_insert(self, i: EngineInstance) -> str:
        if not i.id:
            i = replace(i, id=f"ei_{self.next_id('engine_instances'):08d}")
        c = self._conn()
        with self._lock:
            c.execute(
                "INSERT OR REPLACE INTO engine_instances "
                "(id, status, engine_id, engine_version, engine_variant, "
                " start_time, last_heartbeat, attempt, doc) "
                "VALUES (?,?,?,?,?,?,?,?,?)",
                (i.id, i.status, i.engine_id, i.engine_version, i.engine_variant,
                 _utc_sort_key(i.start_time), i.last_heartbeat, i.attempt,
                 _ser(i)),
            )
            c.commit()
        return i.id

    def engine_instance_get(self, id: str) -> EngineInstance | None:
        row = self._conn().execute(
            "SELECT doc FROM engine_instances WHERE id=?", (id,)
        ).fetchone()
        return _deser(EngineInstance, row[0]) if row else None

    def engine_instance_get_all(self) -> list[EngineInstance]:
        return [
            _deser(EngineInstance, r[0])
            for r in self._conn().execute("SELECT doc FROM engine_instances")
        ]

    def engine_instance_get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        """Completed instances, latest first (EngineInstances.scala:100-110)."""
        rows = self._conn().execute(
            "SELECT doc FROM engine_instances WHERE status='COMPLETED' AND "
            "engine_id=? AND engine_version=? AND engine_variant=? "
            "ORDER BY start_time DESC",
            (engine_id, engine_version, engine_variant),
        )
        return [_deser(EngineInstance, r[0]) for r in rows]

    def engine_instance_get_by_status(self, status: str) -> list[EngineInstance]:
        """All instances with ``status``, latest first — the reaper's scan
        (status='INIT') and `pio status`'s live-run listing."""
        rows = self._conn().execute(
            "SELECT doc FROM engine_instances WHERE status=? "
            "ORDER BY start_time DESC",
            (status,),
        )
        return [_deser(EngineInstance, r[0]) for r in rows]

    def engine_instance_get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> EngineInstance | None:
        done = self.engine_instance_get_completed(engine_id, engine_version, engine_variant)
        return done[0] if done else None

    def engine_instance_update(self, i: EngineInstance) -> None:
        self.engine_instance_insert(i)

    def engine_instance_delete(self, id: str) -> bool:
        c = self._conn()
        with self._lock:
            cur = c.execute("DELETE FROM engine_instances WHERE id=?", (id,))
            c.commit()
            return cur.rowcount > 0

    # -- evaluation instances (EvaluationInstances.scala:55-90) -----------
    def evaluation_instance_insert(self, i: EvaluationInstance) -> str:
        if not i.id:
            i = replace(i, id=f"ev_{self.next_id('evaluation_instances'):08d}")
        c = self._conn()
        with self._lock:
            c.execute(
                "INSERT OR REPLACE INTO evaluation_instances VALUES (?,?,?,?)",
                (i.id, i.status, _utc_sort_key(i.start_time), _ser(i)),
            )
            c.commit()
        return i.id

    def evaluation_instance_get(self, id: str) -> EvaluationInstance | None:
        row = self._conn().execute(
            "SELECT doc FROM evaluation_instances WHERE id=?", (id,)
        ).fetchone()
        return _deser(EvaluationInstance, row[0]) if row else None

    def evaluation_instance_get_all(self) -> list[EvaluationInstance]:
        return [
            _deser(EvaluationInstance, r[0])
            for r in self._conn().execute("SELECT doc FROM evaluation_instances")
        ]

    def evaluation_instance_get_completed(self) -> list[EvaluationInstance]:
        rows = self._conn().execute(
            "SELECT doc FROM evaluation_instances WHERE status='EVALCOMPLETED' "
            "ORDER BY start_time DESC"
        )
        return [_deser(EvaluationInstance, r[0]) for r in rows]

    def evaluation_instance_update(self, i: EvaluationInstance) -> None:
        self.evaluation_instance_insert(i)

    def evaluation_instance_delete(self, id: str) -> bool:
        c = self._conn()
        with self._lock:
            cur = c.execute("DELETE FROM evaluation_instances WHERE id=?", (id,))
            c.commit()
            return cur.rowcount > 0

    # -- model blobs (Models.scala:36-50) ---------------------------------
    def model_insert(self, m: Model) -> None:
        c = self._conn()
        with self._lock:
            c.execute(
                "INSERT OR REPLACE INTO models (id, blob, checksum) "
                "VALUES (?, ?, ?)",
                (m.id, m.models, m.checksum),
            )
            c.commit()

    def model_get(self, id: str) -> Model | None:
        row = self._conn().execute(
            "SELECT blob, checksum FROM models WHERE id=?", (id,)
        ).fetchone()
        return Model(id=id, models=row[0], checksum=row[1] or "") if row else None

    def model_delete(self, id: str) -> bool:
        c = self._conn()
        with self._lock:
            cur = c.execute("DELETE FROM models WHERE id=?", (id,))
            c.commit()
            return cur.rowcount > 0
