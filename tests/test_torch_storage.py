"""The port's storage layer against the JAX package's.

The semantics of ``tests/test_event_store.py``, ``tests/test_metadata.py``
and ``tests/test_aggregate.py``: each body runs once on the reference's
``predictionio_tpu.storage`` and once on the port's copy
(``predictionio_tpu_torch.storage``), so the two packages answer the same
calls the same way. Event-store cases also run on both backends (memory
and sqlite). The aggregate fold is further held against the reference on
a random stream of ``$set``/``$unset``/``$delete`` events.
"""

import importlib
import random
import sqlite3
import sys
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
T0 = datetime(2020, 1, 1, tzinfo=timezone.utc)
APP = 1


class _Pkg:
    """One package's storage modules, loaded by name."""

    def __init__(self, root: str):
        self.root = root
        self.storage = importlib.import_module(f"{root}.storage")
        self.store = importlib.import_module(f"{root}.store.event_store")
        self.sqlite = importlib.import_module(f"{root}.storage.sqlite")
        self.events_base = importlib.import_module(
            f"{root}.storage.events_base")


@pytest.fixture(params=["predictionio_tpu", "predictionio_tpu_torch"],
                ids=["reference", "port"])
def pkg(request, tmp_path, monkeypatch):
    p = _Pkg(request.param)
    monkeypatch.setenv("PIO_HOME", str(tmp_path / "home"))
    p.storage.Storage.reset()
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        p.storage.Storage.configure(repo, "memory")
    yield p
    p.storage.Storage.reset()


@pytest.fixture(params=["memory", "sqlite"])
def backend(request, pkg, tmp_path):
    S = pkg.storage
    if request.param == "memory":
        be = S.MemoryEvents()
    else:
        be = S.SQLiteEvents({"path": str(tmp_path / "events.db")})
    be.init_app(APP)
    yield pkg, be
    be.close()


def mk(S, event="view", eid="u1", target=None, minutes=0, props=None):
    return S.Event(
        event=event,
        entity_type="user",
        entity_id=eid,
        target_entity_type="item" if target else None,
        target_entity_id=target,
        properties=S.DataMap(props or {}),
        event_time=T0 + timedelta(minutes=minutes),
    )


# -- the event store (tests/test_event_store.py) -----------------------------


def test_insert_get_delete(backend):
    pkg, be = backend
    eid = be.insert(mk(pkg.storage), APP)
    assert eid
    e = be.get(eid, APP)
    assert e is not None and e.event == "view" and e.event_id == eid
    assert be.delete(eid, APP)
    assert be.get(eid, APP) is None
    assert not be.delete(eid, APP)


def test_find_time_range(backend):
    pkg, be = backend
    S = pkg.storage
    for m in range(5):
        be.insert(mk(S, minutes=m), APP)
    got = list(be.find(S.EventQuery(
        app_id=APP, start_time=T0 + timedelta(minutes=1),
        until_time=T0 + timedelta(minutes=3))))
    assert [e.event_time for e in got] == [T0 + timedelta(minutes=1),
                                           T0 + timedelta(minutes=2)]


def test_find_filters(backend):
    pkg, be = backend
    S = pkg.storage
    Q = S.EventQuery
    be.insert(mk(S, event="view", eid="u1"), APP)
    be.insert(mk(S, event="buy", eid="u1", target="i1", minutes=1), APP)
    be.insert(mk(S, event="buy", eid="u2", target="i2", minutes=2), APP)
    assert len(list(be.find(Q(APP, entity_id="u1")))) == 2
    assert len(list(be.find(Q(APP, event_names=("buy",))))) == 2
    assert len(list(be.find(Q(APP, event_names=("buy",),
                              entity_id="u2")))) == 1
    assert len(list(be.find(Q(APP, target_entity_id=S.ANY)))) == 3
    assert len(list(be.find(Q(APP, target_entity_id=None)))) == 1
    assert len(list(be.find(Q(APP, target_entity_id="i2")))) == 1
    assert len(list(be.find(Q(APP, target_entity_type="item")))) == 2


def test_find_limit_and_reversed(backend):
    pkg, be = backend
    S = pkg.storage
    for m in range(10):
        be.insert(mk(S, minutes=m), APP)
    got = list(be.find(S.EventQuery(APP, limit=3)))
    assert len(got) == 3 and got[0].event_time == T0
    rev = list(be.find(S.EventQuery(APP, limit=2, reversed=True)))
    assert rev[0].event_time == T0 + timedelta(minutes=9)
    assert len(list(be.find(S.EventQuery(APP, limit=-1)))) == 10


def test_channels_isolated(backend):
    pkg, be = backend
    S = pkg.storage
    be.init_app(APP, 7)
    be.insert(mk(S), APP)
    be.insert(mk(S, eid="u9"), APP, 7)
    assert len(list(be.find(S.EventQuery(APP)))) == 1
    got = list(be.find(S.EventQuery(APP, channel_id=7)))
    assert len(got) == 1 and got[0].entity_id == "u9"


def test_remove_app(backend):
    pkg, be = backend
    S = pkg.storage
    be.insert(mk(S), APP)
    assert be.remove_app(APP)
    be.init_app(APP)
    assert list(be.find(S.EventQuery(APP))) == []


def test_aggregate_properties(backend):
    pkg, be = backend
    S = pkg.storage
    be.insert(mk(S, event="$set", eid="u1", props={"a": 1, "b": 2}), APP)
    be.insert(mk(S, event="$set", eid="u1", props={"b": 3}, minutes=1), APP)
    be.insert(mk(S, event="$set", eid="u2", props={"a": 9}), APP)
    be.insert(mk(S, event="$delete", eid="u2", minutes=1), APP)
    out = be.aggregate_properties(APP, entity_type="user")
    assert set(out) == {"u1"}
    assert out["u1"].to_dict() == {"a": 1, "b": 3}
    assert be.aggregate_properties(APP, entity_type="user",
                                   required=["missing"]) == {}


def test_aggregate_single_entity(backend):
    pkg, be = backend
    S = pkg.storage
    be.insert(mk(S, event="$set", eid="u1", props={"a": 1}), APP)
    pm = be.aggregate_properties_of_entity(APP, "user", "u1")
    assert pm is not None and pm.to_dict() == {"a": 1}
    assert be.aggregate_properties_of_entity(APP, "user", "nope") is None


def test_insert_batch(backend):
    pkg, be = backend
    S = pkg.storage
    ids = be.insert_batch([mk(S, minutes=m) for m in range(4)], APP)
    assert len(ids) == len(set(ids)) == 4
    assert len(list(be.find(S.EventQuery(APP)))) == 4


def test_find_frame_columnar(backend):
    pkg, be = backend
    S = pkg.storage
    be.insert(mk(S, event="rate", eid="u1", target="i1",
                 props={"rating": 4.0}), APP)
    be.insert(mk(S, event="rate", eid="u2", target="i2",
                 props={"rating": 2.0}, minutes=1), APP)
    frame = be.find_frame(S.EventQuery(APP, event_names=("rate",)))
    assert len(frame) == 2
    assert list(frame.entity_id) == ["u1", "u2"]
    ratings = frame.to_ratings()
    assert len(ratings) == 2
    assert ratings.num_users == 2 and ratings.num_items == 2


def test_remove_before_trims_by_time(backend):
    pkg, be = backend
    S = pkg.storage
    for d in range(6):
        be.insert(mk(S, eid=f"u{d}", minutes=d * 60), APP)
    cutoff = T0 + timedelta(minutes=3 * 60)
    assert be.remove_before(APP, cutoff) == 3
    left = list(be.find(S.EventQuery(app_id=APP)))
    assert len(left) == 3 and all(e.event_time >= cutoff for e in left)
    assert be.remove_before(APP, cutoff) == 0


def test_sqlite_batch_failure_persists_nothing(pkg, tmp_path):
    import unittest.mock as mock

    S = pkg.storage
    be = pkg.sqlite.SQLiteEvents({"path": str(tmp_path / "atomic.db")})
    be.init_app(APP)
    assert be.BATCH_ATOMIC
    real_row = type(be)._row
    built = []

    def poisoned(self, e):
        built.append(e)
        return ("bad",) if len(built) == 4 else real_row(self, e)

    with mock.patch.object(type(be), "_row", poisoned), \
            pytest.raises(pkg.events_base.StorageError):
        be.insert_batch([mk(S, minutes=m) for m in range(4)], APP)
    be.insert(mk(S, minutes=99), APP)
    assert len(list(be.find(S.EventQuery(APP)))) == 1
    be.close()


def test_sqlite_insert_batch_is_one_transaction(pkg, tmp_path):
    S = pkg.storage
    be = pkg.sqlite.SQLiteEvents({"path": str(tmp_path / "events.db")})
    be.init_app(APP)
    real = be._conn()

    class _CommitCounter:
        def __init__(self, conn):
            self._c = conn
            self.commits = 0

        def commit(self):
            self.commits += 1
            return self._c.commit()

        def __getattr__(self, name):
            return getattr(self._c, name)

    proxy = _CommitCounter(real)
    be._conn = lambda: proxy
    ids = be.insert_batch([mk(S, eid=f"u{i}", minutes=i)
                           for i in range(500)], APP)
    assert len(ids) == 500 and proxy.commits == 1
    be.close()


def test_sqlite_close_fails_cleanly(pkg, tmp_path):
    S = pkg.storage
    be = pkg.sqlite.SQLiteEvents({"path": str(tmp_path / "close.db")})
    be.init_app(APP)
    for m in range(3):
        be.insert(mk(S, eid=f"u{m}", minutes=m), APP)
    it = be.find(S.EventQuery(APP))
    assert next(it) is not None
    be.close()
    with pytest.raises(RuntimeError, match="closed"):
        next(it)
    with pytest.raises(RuntimeError, match="closed"):
        be.get("nope", APP)
    be.close()  # idempotent


def _shard_app(pkg):
    S = pkg.storage
    app = S.Storage.get_metadata().app_insert("ShardApp")
    ev = S.Storage.get_events()
    ev.init_app(app.id)
    for i in range(200):
        ev.insert(S.Event(
            event="rate", entity_type="user", entity_id=f"u{i % 40}",
            target_entity_type="item", target_entity_id=f"i{i % 11}",
            properties=S.DataMap({"rating": float(i % 5 + 1)})), app.id)
    return app


def test_host_shards_partition_the_stream(pkg):
    _shard_app(pkg)
    store = pkg.store.EventStore()
    full = store.find_frame("ShardApp")
    parts = [store.find_frame("ShardApp", host_shard=(i, 4))
             for i in range(4)]
    assert sum(len(p) for p in parts) == len(full) == 200
    seen: dict = {}
    for hi, p in enumerate(parts):
        for uid in set(p.entity_id.tolist()):
            assert seen.setdefault(uid, hi) == hi


def test_host_shard_bad_index(pkg):
    _shard_app(pkg)
    store = pkg.store.EventStore()
    assert len(store.find_frame("ShardApp", host_shard=(0, 1))) == 200
    for bad in ((5, 4), (3, 1), (0, 0)):
        with pytest.raises(ValueError):
            store.find_frame("ShardApp", host_shard=bad)


def test_event_store_facade_by_app_name(pkg):
    S = pkg.storage
    meta = S.Storage.get_metadata()
    app = meta.app_insert("Facade")
    S.Storage.get_events().init_app(app.id)
    store = pkg.store.EventStore(default_app_name="Facade")
    S.Storage.get_events().insert_batch(
        [mk(S, event="rate", eid=f"u{i}", target=f"i{i % 3}", minutes=i,
            props={"rating": float(i)}) for i in range(6)], app.id)
    frame = store.find_frame(event_names=("rate",))
    assert len(frame) == 6
    assert sorted(set(frame.target_entity_id.tolist())) == ["i0", "i1", "i2"]
    with pytest.raises(pkg.events_base.StorageError):
        store.find_frame(app_name="NoSuchApp")


# -- metadata (tests/test_metadata.py) ---------------------------------------


def test_apps_crud(pkg):
    s = pkg.storage.MetadataStore()
    app = s.app_insert("myapp", "desc")
    assert app is not None and app.id > 0
    assert s.app_insert("myapp") is None
    assert s.app_get(app.id) == app
    assert s.app_get_by_name("myapp") == app
    assert s.app_get_by_name("nope") is None
    app2 = s.app_insert("other")
    assert {a.name for a in s.app_get_all()} == {"myapp", "other"}
    assert s.app_delete(app2.id)
    assert s.app_get(app2.id) is None


def test_access_keys(pkg):
    s = pkg.storage.MetadataStore()
    app = s.app_insert("a")
    ak = s.access_key_insert(app.id, events=("view",))
    assert len(ak.key) > 20 and s.access_key_get(ak.key) == ak
    assert s.access_key_insert(app.id).events == ()
    assert len(s.access_key_get_by_appid(app.id)) == 2
    assert s.access_key_delete(ak.key)
    assert s.access_key_get(ak.key) is None


def test_channels(pkg):
    s = pkg.storage.MetadataStore()
    app = s.app_insert("a")
    ch = s.channel_insert(app.id, "mobile")
    assert ch is not None
    assert s.channel_insert(app.id, "bad name!") is None
    assert s.channel_insert(app.id, "x" * 17) is None
    assert s.channel_insert(app.id, "mobile") is None
    assert s.channel_get(ch.id) == ch
    assert [c.name for c in s.channel_get_by_appid(app.id)] == ["mobile"]
    assert s.channel_delete(ch.id)


def test_engine_manifests(pkg):
    S = pkg.storage
    s = S.MetadataStore()
    m = S.EngineManifest(id="e1", version="1", name="my-engine",
                         engine_factory="pkg.Factory")
    s.engine_manifest_insert(m)
    assert s.engine_manifest_get("e1", "1") == m
    assert s.engine_manifest_get("e1", "2") is None
    assert len(s.engine_manifest_get_all()) == 1
    assert s.engine_manifest_delete("e1", "1")


def test_engine_instances_lifecycle(pkg):
    S = pkg.storage
    s = S.MetadataStore()
    t = datetime.now(timezone.utc)
    id1 = s.engine_instance_insert(S.EngineInstance(
        status="INIT", engine_id="e1", engine_version="1",
        engine_variant="default", start_time=t - timedelta(hours=2)))
    got = s.engine_instance_get(id1)
    assert got.status == "INIT"
    s.engine_instance_update(S.EngineInstance(**{**got.__dict__,
                                                 "status": "COMPLETED"}))
    s.engine_instance_insert(S.EngineInstance(
        status="COMPLETED", engine_id="e1", engine_version="1",
        engine_variant="default", start_time=t))
    latest = s.engine_instance_get_latest_completed("e1", "1", "default")
    assert latest is not None and latest.start_time == t
    assert len(s.engine_instance_get_completed("e1", "1", "default")) == 2
    assert s.engine_instance_get_latest_completed("e1", "1", "other") is None


def test_evaluation_instances(pkg):
    S = pkg.storage
    s = S.MetadataStore()
    eid = s.evaluation_instance_insert(S.EvaluationInstance(status="INIT"))
    got = s.evaluation_instance_get(eid)
    s.evaluation_instance_update(S.EvaluationInstance(
        **{**got.__dict__, "status": "EVALCOMPLETED"}))
    assert len(s.evaluation_instance_get_completed()) == 1


def test_models_and_checksum(pkg):
    S = pkg.storage
    s = S.MetadataStore()
    blob = b"\x00\x01model bytes"
    ck = S.Model.compute_checksum(blob)
    assert ck.startswith("sha256:") and len(ck) == 7 + 64
    s.model_insert(S.Model(id="i1", models=blob, checksum=ck))
    assert s.model_get("i1").models == blob
    assert s.model_get("i1").checksum == ck
    s.model_insert(S.Model(id="i2", models=blob))
    assert s.model_get("i2").checksum == ""
    assert s.model_delete("i1") and s.model_get("i1") is None


def test_sequences(pkg):
    s = pkg.storage.MetadataStore()
    assert [s.next_id("x"), s.next_id("x"), s.next_id("y")] == [1, 2, 1]


def test_engine_instance_heartbeat_and_status_order(pkg):
    S = pkg.storage
    s = S.MetadataStore()
    t0 = datetime(2026, 8, 5, 12, 0, 0, tzinfo=timezone.utc)
    old = s.engine_instance_insert(S.EngineInstance(
        status="INIT", start_time=t0, last_heartbeat=t0.isoformat(),
        attempt=2))
    assert s.engine_instance_get(old).attempt == 2
    new = s.engine_instance_insert(S.EngineInstance(
        status="INIT", start_time=t0 + timedelta(minutes=5)))
    s.engine_instance_insert(S.EngineInstance(
        status="COMPLETED", start_time=t0 + timedelta(minutes=9)))
    assert [i.id for i in s.engine_instance_get_by_status("INIT")] == [new, old]
    assert s.engine_instance_get_by_status("ABANDONED") == []


def test_old_schema_database_migrates_in_place(pkg, tmp_path):
    import json

    path = str(tmp_path / "old.db")
    conn = sqlite3.connect(path)
    conn.executescript("""
        CREATE TABLE engine_instances (
          id TEXT PRIMARY KEY, status TEXT, engine_id TEXT,
          engine_version TEXT, engine_variant TEXT, start_time TEXT,
          doc TEXT);
        CREATE TABLE models (id TEXT PRIMARY KEY, blob BLOB);
        """)
    doc = json.dumps({"id": "ei_old", "status": "COMPLETED",
                      "start_time": "2026-08-01T00:00:00+00:00"})
    conn.execute("INSERT INTO engine_instances VALUES (?,?,?,?,?,?,?)",
                 ("ei_old", "COMPLETED", "default", "1", "default",
                  "2026-08-01T00:00:00+00:00", doc))
    conn.execute("INSERT INTO models VALUES (?,?)", ("ei_old", b"blob"))
    conn.commit()
    conn.close()
    s = pkg.storage.MetadataStore(path)
    inst = s.engine_instance_get("ei_old")
    assert inst.status == "COMPLETED" and inst.attempt == 0
    assert s.model_get("ei_old").checksum == ""
    s.close()


def test_storage_registry_sqlite_under_home(pkg, tmp_path, monkeypatch):
    """Durable defaults: sqlite metadata and events under PIO_HOME, and
    MODELDATA on sqlite keeps its blobs in the metadata database."""
    S = pkg.storage
    S.Storage.reset()
    monkeypatch.setenv("PIO_HOME", str(tmp_path / "durable"))
    S.Storage.configure("MODELDATA", "sqlite")
    app = S.Storage.get_metadata().app_insert("durable")
    S.Storage.get_events().init_app(app.id)
    S.Storage.get_events().insert(mk(S), app.id)
    S.Storage.get_models().insert(S.Model(id="m", models=b"x"))
    assert (tmp_path / "durable" / "metadata.db").exists()
    assert (tmp_path / "durable" / "events.db").exists()
    S.Storage.reset()
    S.Storage.configure("MODELDATA", "sqlite")
    assert S.Storage.get_metadata().app_get_by_name("durable") is not None
    assert S.Storage.get_models().get("m").models == b"x"
    assert len(list(S.Storage.get_events().find(S.EventQuery(app.id)))) == 1


def test_default_homes_are_apart(tmp_path, monkeypatch):
    """With no PIO_HOME the port keeps its storage under its own home:
    a default-configured port never opens the reference's metadata or
    model store."""
    ref, port = _Pkg("predictionio_tpu"), _Pkg("predictionio_tpu_torch")
    monkeypatch.delenv("PIO_HOME", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert ref.storage.Storage.home() == tmp_path / ".predictionio_tpu"
    assert port.storage.Storage.home() == tmp_path / ".predictionio_tpu_torch"
    S = port.storage
    S.Storage.reset()
    try:
        app = S.Storage.get_metadata().app_insert("mine")
        S.Storage.get_events().init_app(app.id)
        S.Storage.get_models().insert(S.Model(id="m", models=b"x"))
    finally:
        S.Storage.reset()
    assert (tmp_path / ".predictionio_tpu_torch" / "metadata.db").exists()
    assert (tmp_path / ".predictionio_tpu_torch" / "events.db").exists()
    assert not (tmp_path / ".predictionio_tpu").exists()


# -- the aggregate fold (tests/test_aggregate.py) ----------------------------


def special(S, name, eid, props, minutes):
    return S.Event(event=name, entity_type="user", entity_id=eid,
                   properties=S.DataMap(props),
                   event_time=T0 + timedelta(minutes=minutes))


@pytest.mark.parametrize("case", [
    ([("$set", "u1", {"a": 1, "b": 1}, 0), ("$set", "u1", {"b": 2, "c": 3}, 1)],
     {"u1": {"a": 1, "b": 2, "c": 3}}),
    ([("$set", "u1", {"a": 1, "b": 1}, 0), ("$unset", "u1", {"b": None}, 1)],
     {"u1": {"a": 1}}),
    ([("$set", "u1", {"a": 1}, 0), ("$unset", "u1", {"a": None}, 1),
      ("$set", "u1", {"a": 9}, 2)], {"u1": {"a": 9}}),
    ([("$set", "u1", {"a": 1}, 0), ("$delete", "u1", {}, 1)], {}),
    ([("$set", "u1", {"a": 1, "b": 2}, 0), ("$delete", "u1", {}, 1),
      ("$set", "u1", {"c": 3}, 2)], {"u1": {"c": 3}}),
    ([("$unset", "u2", {"x": None}, 0)], {}),
], ids=["set_merge", "unset", "unset_then_set", "delete", "delete_then_set",
        "never_set"])
def test_aggregate_semantics(pkg, case):
    S = pkg.storage
    events, want = case
    out = S.aggregate_properties([special(S, *e) for e in events])
    assert {k: v.to_dict() for k, v in out.items()} == want


def test_aggregate_ignores_plain_events(pkg):
    S = pkg.storage
    out = S.aggregate_properties([
        special(S, "$set", "u1", {"a": 1}, 0),
        S.Event(event="view", entity_type="user", entity_id="u1",
                event_time=T0 + timedelta(minutes=5))])
    assert out["u1"].to_dict() == {"a": 1}
    assert out["u1"].last_updated == T0


def _random_stream(S, seed, n=600):
    rnd = random.Random(seed)
    out = []
    for i in range(n):
        eid = f"u{rnd.randrange(25)}"
        kind = rnd.choices(["$set", "$unset", "$delete"], [6, 2, 1])[0]
        keys = rnd.sample("abcdef", rnd.randint(1, 3))
        props = ({k: rnd.randint(0, 9) for k in keys} if kind == "$set"
                 else {k: None for k in keys} if kind == "$unset" else {})
        out.append(special(S, kind, eid, props, rnd.randrange(10_000)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregate_port_equals_reference(seed, tmp_path):
    """Row fold, frame fold and a shard-merged fold of the port give the
    reference's properties and update times, entity by entity."""
    ref = importlib.import_module("predictionio_tpu.storage")
    port = importlib.import_module("predictionio_tpu_torch.storage")
    want = ref.aggregate_properties(_random_stream(ref, seed))
    got = port.aggregate_properties(_random_stream(port, seed))
    be = port.SQLiteEvents({"path": str(tmp_path / "agg.db")})
    be.init_app(APP)
    be.insert_batch(_random_stream(port, seed), APP)
    framed = be.aggregate_properties(APP, entity_type="user")
    be.close()
    assert set(got) == set(want) == set(framed)
    for eid, pm in want.items():
        for mine in (got[eid], framed[eid]):
            assert mine.to_dict() == pm.to_dict()
            assert mine.first_updated == pm.first_updated
            assert mine.last_updated == pm.last_updated


def test_partition_hash_matches_reference():
    ref = importlib.import_module("predictionio_tpu.storage")
    port = importlib.import_module("predictionio_tpu_torch.storage")
    keys = [f"user-u{i}" for i in range(300)] + ["", "é", "x" * 200]
    for seed in (0, 7):
        np.testing.assert_array_equal(port.hash64(keys, seed),
                                      ref.hash64(keys, seed))
    for n in (1, 3, 8):
        assert ([port.shard_of("user", f"u{i}", n) for i in range(50)]
                == [ref.shard_of("user", f"u{i}", n) for i in range(50)])


def test_batch_view_is_deprecated_and_reads(pkg):
    S = pkg.storage
    bv = importlib.import_module(f"{pkg.root}.storage.batch_view")
    app = S.Storage.get_metadata().app_insert("bv")
    S.Storage.get_events().init_app(app.id)
    S.Storage.get_events().insert(
        special(S, "$set", "u1", {"a": 1}, 0), app.id)
    cls = next(getattr(bv, n) for n in dir(bv)
               if n.endswith("BatchView") and isinstance(getattr(bv, n), type))
    with pytest.warns(DeprecationWarning):
        view = cls(app.id)
    props = view.aggregate_properties(entity_type="user")
    assert props["u1"].to_dict() == {"a": 1}


def test_port_storage_imports_no_reference():
    """Loading the port's storage in a fresh interpreter loads neither jax
    nor the reference package."""
    import subprocess

    code = ("import sys; import predictionio_tpu_torch.storage, "
            "predictionio_tpu_torch.store; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('predictionio_tpu.')]; "
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
