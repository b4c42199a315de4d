"""Train to storage and deploy from it, on the port, against the JAX package.

The semantics of ``tests/test_workflow.py`` on the port
(``predictionio_tpu_torch.workflow.core_workflow``): ``run_train``'s
lifecycle, its abort and retry, the ``prepare_deploy`` round trip, the
retrain of an unserializable model and the custom-persisted one; then the
storage-backed server: the blob checksum, the fallback walk over older
COMPLETED instances, ``reload_latest`` and ``GET /reload``, and the
unpickler's refusal of the JAX package's classes. ``train_als`` without an
``init=`` is held against the reference's ``train_als`` (the seeded init
is the reference's own, ``predictionio_tpu_torch/prng.py``), and the same
events and ``engine.json`` go through both packages' ``run_train`` ->
``prepare_deploy`` -> query. Seqrec trains from events stored in SQLite
through the port's ``run_train`` and answers from the stored blob.
Everything runs on the CPU (``device="cpu"``).
"""

from __future__ import annotations

import json
import pickle
import sqlite3
import urllib.request
from dataclasses import dataclass
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from predictionio_tpu_torch import storage as pstorage  # noqa: E402
from predictionio_tpu_torch.controller import (Algorithm, DataSource,  # noqa: E402
                                               Engine, EngineParams,
                                               FirstServing, Params,
                                               Preparator, SanityCheck)
from predictionio_tpu_torch.controller.components import (  # noqa: E402
    LocalFileSystemPersistentModel)
from predictionio_tpu_torch.templates.recommendation import (  # noqa: E402
    engine as rec)
from predictionio_tpu_torch.templates.seqrec import engine as seq  # noqa: E402
from predictionio_tpu_torch.workflow import core_workflow as cw  # noqa: E402
from predictionio_tpu_torch.workflow import serialization as ser  # noqa: E402
from predictionio_tpu_torch.workflow.context import Context  # noqa: E402
from predictionio_tpu_torch.workflow.create_server import (  # noqa: E402
    EngineServer, serve)
from predictionio_tpu_torch.workflow.faults import FaultInjected  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
T0 = datetime(2020, 1, 1, tzinfo=timezone.utc)
Storage = pstorage.Storage


@pytest.fixture(autouse=True)
def port_storage(tmp_path, monkeypatch):
    """The port's storage on SQLite under a fresh PIO_HOME."""
    home = tmp_path / "pio"
    monkeypatch.setenv("PIO_HOME", str(home))
    Storage.reset()
    Storage.configure("METADATA", "sqlite", path=str(home / "meta.db"))
    Storage.configure("EVENTDATA", "sqlite", path=str(home / "events.db"))
    Storage.configure("MODELDATA", "sqlite", path=str(home / "models.db"))
    yield home
    Storage.reset()


def cpu_ctx(**kw) -> Context:
    return Context(device="cpu", **kw)


# -- a sample engine on the port (the role of testing/sample_engine.py) ------


@dataclass(frozen=True)
class DSParams(Params):
    id: int = 0
    error: bool = False
    flaky: int = 0  # raise a transient fault this many times


@dataclass(frozen=True)
class AlgoParams(Params):
    id: int = 0


@dataclass(frozen=True)
class TD(SanityCheck):
    ds_id: int
    error: bool = False

    def sanity_check(self) -> None:
        if self.error:
            raise ValueError("TrainingData sanity check failed")


@dataclass(frozen=True)
class SampleQuery:
    q: int


@dataclass
class SampleModel:
    ds_id: int
    algo_id: int
    tensor: object = None


_FLAKY = {"left": 0}


class SampleDS(DataSource):
    params_class = DSParams

    def read_training(self, ctx):
        if _FLAKY["left"] > 0:
            _FLAKY["left"] -= 1
            raise FaultInjected("train.step")
        return TD(self.params.id, self.params.error)


class SamplePrep(Preparator):
    def prepare(self, ctx, td):
        return td


class SampleAlgo(Algorithm):
    params_class = AlgoParams
    query_class = SampleQuery

    def train(self, ctx, td):
        return SampleModel(td.ds_id, self.params.id,
                           torch.arange(4, dtype=torch.float32))

    def predict(self, model, q):
        return q.q * 10 + model.algo_id


class UnserAlgo(SampleAlgo):
    persist_model = False


class PModel(LocalFileSystemPersistentModel):
    def __init__(self, v):
        self.v = v


class PersistAlgo(SampleAlgo):
    def train(self, ctx, td):
        return PModel(td.ds_id * 100 + self.params.id)

    def predict(self, model, q):
        return model.v


def sample_engine() -> Engine:
    return Engine(data_source_classes=SampleDS,
                  preparator_classes=SamplePrep,
                  algorithm_classes={"sample": SampleAlgo,
                                     "unser": UnserAlgo,
                                     "persist": PersistAlgo},
                  serving_classes=FirstServing)


def sample_params(ds_id=1, algo="sample", algo_id=1, **ds) -> EngineParams:
    return EngineParams(data_source_params=("", DSParams(id=ds_id, **ds)),
                        algorithm_params_list=((algo, AlgoParams(algo_id)),))


# -- run_train and prepare_deploy (tests/test_workflow.py) -------------------


def test_run_train_lifecycle():
    iid = cw.run_train(sample_engine(), sample_params(ds_id=2), cpu_ctx(),
                       engine_factory="x.y.Z")
    meta = Storage.get_metadata()
    inst = meta.engine_instance_get(iid)
    assert inst.status == "COMPLETED" and inst.engine_factory == "x.y.Z"
    assert json.loads(inst.phase_times)
    blob = Storage.get_models().get(iid)
    assert blob is not None and len(blob.models) > 0
    assert blob.checksum == pstorage.Model.compute_checksum(blob.models)
    latest = meta.engine_instance_get_latest_completed("default", "1",
                                                       "default")
    assert latest.id == iid


def test_run_train_abort_on_error():
    with pytest.raises(ValueError):
        cw.run_train(sample_engine(), sample_params(error=True), cpu_ctx())
    insts = Storage.get_metadata().engine_instance_get_all()
    assert len(insts) == 1 and insts[0].status == "ABORTED"


def test_run_train_retries_a_transient_fault():
    _FLAKY["left"] = 1
    try:
        iid = cw.run_train(sample_engine(), sample_params(), cpu_ctx(),
                           max_retries=1, retry_backoff_s=0.0)
    finally:
        _FLAKY["left"] = 0
    inst = Storage.get_metadata().engine_instance_get(iid)
    assert inst.status == "COMPLETED"


def test_prepare_deploy_roundtrip():
    engine = sample_engine()
    iid = cw.run_train(engine, sample_params(ds_id=4, algo_id=3), cpu_ctx())
    inst = Storage.get_metadata().engine_instance_get(iid)
    result = cw.prepare_deploy(engine, inst, cpu_ctx())
    model = result.models[0]
    assert model.ds_id == 4 and model.algo_id == 3
    # the tensor the model held went into the blob as host numpy
    assert isinstance(model.tensor, np.ndarray)
    np.testing.assert_array_equal(model.tensor, np.arange(4))
    assert result.algorithms[0].predict(model, SampleQuery(2)) == 23


def test_prepare_deploy_retrains_unserializable():
    engine = sample_engine()
    iid = cw.run_train(engine, sample_params(algo="unser", algo_id=5),
                       cpu_ctx())
    stored = ser.deserialize_models(Storage.get_models().get(iid).models)
    assert isinstance(stored[0], ser.RetrainMarker)
    inst = Storage.get_metadata().engine_instance_get(iid)
    assert cw.prepare_deploy(engine, inst, cpu_ctx()).models[0].algo_id == 5


def test_prepare_deploy_loads_a_custom_persisted_model():
    engine = sample_engine()
    iid = cw.run_train(engine, sample_params(ds_id=2, algo="persist",
                                             algo_id=7), cpu_ctx())
    stored = ser.deserialize_models(Storage.get_models().get(iid).models)
    assert isinstance(stored[0], ser.PersistentModelManifest)
    assert (Storage.home() / "pmodels" / f"PModel-{iid}.pkl").exists()
    inst = Storage.get_metadata().engine_instance_get(iid)
    assert cw.prepare_deploy(engine, inst, cpu_ctx()).models[0].v == 207


def test_engine_params_from_instance_roundtrip():
    engine = sample_engine()
    ep = sample_params(ds_id=6, algo_id=2)
    iid = cw.run_train(engine, ep, cpu_ctx())
    inst = Storage.get_metadata().engine_instance_get(iid)
    back = cw.engine_params_from_instance(engine, inst)
    assert back.data_source_params == ep.data_source_params
    assert back.algorithm_params_list == ep.algorithm_params_list


def test_resolve_engine_factory(tmp_path):
    engine = cw.resolve_engine_factory(
        "predictionio_tpu_torch.templates.recommendation.engine:"
        "engine_factory")
    assert engine.data_source_classes[""] is rec.RecommendationDataSource
    # an engine dir's own module, imported under a dir-scoped name
    d = tmp_path / "myengine"
    d.mkdir()
    (d / "engine.py").write_text(
        "from predictionio_tpu_torch.templates.seqrec.engine import *\n"
        "from predictionio_tpu_torch.templates.seqrec.engine import "
        "engine_factory\n")
    scoped = cw.resolve_engine_factory("engine:engine_factory", engine_dir=d)
    assert "seqrec" in scoped.algorithm_classes


# -- serialization -----------------------------------------------------------


def test_blob_holds_no_tensor():
    blob = ser.serialize_models([{"a": torch.ones(2, 3),
                                  "b": [torch.zeros(2, dtype=torch.bfloat16)]},
                                 SampleModel(1, 2, torch.ones(3))])
    back = ser.deserialize_models(blob)
    assert isinstance(back[0]["a"], np.ndarray)
    assert back[0]["b"][0].dtype == np.float32
    assert isinstance(back[1].tensor, np.ndarray)
    assert b"_rebuild_tensor" not in blob and b"torch._utils" not in blob


def test_als_model_blob_drops_device_state():
    from predictionio_tpu_torch.convert import als_model_from_numpy

    rng = np.random.default_rng(0)
    model = als_model_from_numpy(
        rng.standard_normal((5, 4)).astype(np.float32),
        rng.standard_normal((9, 4)).astype(np.float32),
        [f"u{i}" for i in range(5)], [f"i{j}" for j in range(9)],
        rank=4, lambda_=0.1, device="cpu")
    model.attach_pipeline()
    assert model._retriever is not None and model._pipeline is not None
    back = ser.deserialize_models(ser.serialize_models([model]))[0]
    assert getattr(back, "_retriever", None) is None
    assert getattr(back, "_pipeline", None) is None
    np.testing.assert_array_equal(back.item_factors, model.item_factors)


def test_unpickler_refuses_the_jax_package():
    from predictionio_tpu.workflow.serialization import RetrainMarker

    blob = pickle.dumps([RetrainMarker("x")])
    with pytest.raises(pickle.UnpicklingError, match="JAX package"):
        ser.deserialize_models(blob)


# -- storage-backed deploy ---------------------------------------------------


def _corrupt(iid: str, home: Path) -> None:
    conn = sqlite3.connect(str(home / "models.db"))
    conn.execute("UPDATE models SET blob = ? WHERE id = ?",
                 (b"\x80\x05garbage", iid))
    conn.commit()
    conn.close()


def test_checksum_mismatch_raises_when_pinned(port_storage):
    """A pinned instance's corrupt blob fails loud in ``prepare_deploy``;
    a server whose walk finds no loadable instance raises the same."""
    engine = sample_engine()
    iid = cw.run_train(engine, sample_params(), cpu_ctx())
    _corrupt(iid, port_storage)
    inst = Storage.get_metadata().engine_instance_get(iid)
    with pytest.raises(cw.ModelIntegrityError):
        cw.prepare_deploy(engine, inst, cpu_ctx())
    with pytest.raises(cw.ModelIntegrityError):
        EngineServer(engine, inst, device="cpu", batch_window_ms=0)


def test_fallback_walk_skips_a_corrupt_newest_blob(port_storage):
    engine = sample_engine()
    good = cw.run_train(engine, sample_params(algo_id=1), cpu_ctx())
    bad = cw.run_train(engine, sample_params(algo_id=2), cpu_ctx())
    _corrupt(bad, port_storage)
    latest = Storage.get_metadata().engine_instance_get(bad)
    server = EngineServer(engine, latest, device="cpu", batch_window_ms=0)
    assert server.engine_instance_id == good
    assert [s["engineInstanceId"] for s in server.deploy_skips] == [bad]
    assert "ModelIntegrityError" in server.deploy_skips[0]["error"]
    assert server.serve_query({"q": 3}) == 31
    assert server.status()["deploySkips"] == server.deploy_skips


def test_fallback_walk_skips_a_reference_blob():
    """A blob pickled by the JAX package is unloadable here: the walk
    skips it like a corrupt one and never imports the reference."""
    from predictionio_tpu.workflow.serialization import RetrainMarker

    engine = sample_engine()
    good = cw.run_train(engine, sample_params(algo_id=4), cpu_ctx())
    ref = cw.run_train(engine, sample_params(algo_id=5), cpu_ctx())
    blob = pickle.dumps([RetrainMarker("SampleAlgo")])
    Storage.get_models().insert(pstorage.Model(
        id=ref, models=blob, checksum=pstorage.Model.compute_checksum(blob)))
    server = EngineServer(engine, Storage.get_metadata().engine_instance_get(
        ref), device="cpu", batch_window_ms=0)
    assert server.engine_instance_id == good
    assert "JAX package" in server.deploy_skips[0]["error"]


def test_every_candidate_failing_raises_the_first_error(port_storage):
    engine = sample_engine()
    iid = cw.run_train(engine, sample_params(), cpu_ctx())
    _corrupt(iid, port_storage)
    with pytest.raises(cw.ModelIntegrityError):
        EngineServer(engine, Storage.get_metadata().engine_instance_get(iid),
                     device="cpu", batch_window_ms=0)


def test_reload_swaps_to_the_newest_and_skips_corrupt(port_storage):
    engine = sample_engine()
    first = cw.run_train(engine, sample_params(algo_id=1), cpu_ctx())
    server = EngineServer(engine,
                          Storage.get_metadata().engine_instance_get(first),
                          device="cpu", batch_max=8)
    with serve(server, "127.0.0.1", 0) as front:
        base = f"http://127.0.0.1:{front.port}"

        def get(path):
            return json.loads(urllib.request.urlopen(base + path,
                                                     timeout=30).read())

        def query(q):
            req = urllib.request.Request(base + "/queries.json",
                                         data=json.dumps({"q": q}).encode(),
                                         method="POST")
            return json.loads(urllib.request.urlopen(req, timeout=30).read())

        assert get("/")["engineInstanceId"] == first and query(1) == 11
        second = cw.run_train(engine, sample_params(algo_id=2), cpu_ctx())
        body = get("/reload")
        assert body == {"message": "Reloaded", "engineInstanceId": second}
        assert get("/")["engineInstanceId"] == second and query(1) == 12
        third = cw.run_train(engine, sample_params(algo_id=3), cpu_ctx())
        _corrupt(third, port_storage)
        assert get("/reload")["engineInstanceId"] == second
        status = get("/")
        assert status["engineInstanceId"] == second
        assert [s["engineInstanceId"] for s in status["deploySkips"]] == [third]
        assert query(2) == 22


def test_reload_needs_a_storage_backed_server():
    engine = sample_engine()
    result = engine.train(cpu_ctx(), sample_params())
    server = EngineServer(engine, result, "mem", device="cpu",
                          batch_window_ms=0)
    with pytest.raises(RuntimeError, match="storage"):
        server.reload_latest()
    with pytest.raises(ValueError, match="instance_id"):
        EngineServer(engine, result, device="cpu", batch_window_ms=0)


def test_context_binds_the_event_store():
    meta = Storage.get_metadata()
    app = meta.app_insert("Bound")
    Storage.get_events().init_app(app.id)
    Storage.get_events().insert(pstorage.Event(
        event="rate", entity_type="user", entity_id="u1",
        target_entity_type="item", target_entity_id="i1",
        properties=pstorage.DataMap({"rating": 2.0})), app.id)
    ctx = Context(device="cpu", mode="Train", app_name="Bound")
    assert len(ctx.event_store().find_frame()) == 1
    assert "mode='Train'" in repr(ctx)


# -- the recommendation path from events -------------------------------------


def _events(S, nu=300, ni=120, n=6000, n_buy=300, seed=11):
    """The e2e quickstart's shape at a small size: ``rate`` events in steps
    of 0.5, plus ``buy`` events (rating 4 through ``rating_of``)."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, nu, n + n_buy)
    items = rng.integers(0, ni, n + n_buy)
    vals = np.round(rng.random(n) * 9 + 1) / 2
    out = []
    for k in range(n + n_buy):
        rate = k < n
        out.append(S.Event(
            event="rate" if rate else "buy", entity_type="user",
            entity_id=f"u{users[k]}", target_entity_type="item",
            target_entity_id=f"i{items[k]}",
            properties=S.DataMap({"rating": float(vals[k])} if rate else {}),
            event_time=T0 + timedelta(seconds=k)))
    return out


def _load_app(S, name="qbench", **kw):
    app = S.Storage.get_metadata().app_insert(name)
    S.Storage.get_events().init_app(app.id)
    S.Storage.get_events().insert_batch(_events(S, **kw), app.id)
    return app


def _variant(app_name="qbench"):
    variant = json.loads((REPO / "templates" / "recommendation"
                          / "engine.json").read_text())
    variant["datasource"]["params"]["app_name"] = app_name
    return variant


def test_data_source_reads_rate_and_buy():
    _load_app(pstorage, n=50, n_buy=10)
    ds = rec.RecommendationDataSource(rec.DataSourceParams(app_name="qbench"))
    ratings = ds.read_training(Context(device="cpu")).ratings
    assert len(ratings) == 60
    # every buy reads as rating 4; rates are multiples of 0.5 in [0.5, 5]
    assert (ratings.ratings == 4.0).sum() >= 10
    assert np.all(np.mod(ratings.ratings * 2, 1) == 0)


def test_train_als_without_init_matches_reference():
    from predictionio_tpu.models import als as jals
    from predictionio_tpu.parallel.mesh import make_mesh
    from predictionio_tpu.storage.frame import Ratings as JRatings
    from predictionio_tpu_torch.models.als import ALSConfig, train_als
    from predictionio_tpu_torch.storage.frame import Ratings

    rng = np.random.default_rng(2)
    nu, ni, n = 80, 50, 1500
    u = rng.integers(0, nu, n)
    i = rng.integers(0, ni, n)
    v = (np.round(rng.random(n) * 9 + 1) / 2).astype(np.float32)
    us = np.asarray([f"u{x}" for x in u], dtype=object)
    its = np.asarray([f"i{x}" for x in i], dtype=object)
    cfg = dict(rank=10, iterations=10, lambda_=0.01, seed=3)
    want = jals.train_als(JRatings.from_triples(us, its, v),
                          jals.ALSConfig(**cfg), mesh=make_mesh())
    got = train_als(Ratings.from_triples(us, its, v), ALSConfig(**cfg),
                    device="cpu")

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    assert rel(got.item_factors, want.item_factors) <= 1e-3
    assert rel(got.user_factors, want.user_factors) <= 1e-3


def _top10_agree(port_scores, ref_scores):
    """Equal top-10 lists except where the reference's neighbouring scores
    are within 1e-3 of its largest score (a near-tie)."""
    tol = 1e-3 * float(np.abs(ref_scores).max())
    order = np.argsort(-ref_scores, kind="stable")[:10]
    mine = np.argsort(-port_scores, kind="stable")[:10]
    s = ref_scores[order]
    for k in np.nonzero(order != mine)[0]:
        assert any(abs(s[k] - s[j]) < tol for j in (k - 1, k + 1)
                   if 0 <= j < len(s)), (order, mine)


def _e2e_both_packages(seed):
    """The same events (drawn from ``seed``) and engine.json through both
    packages' run_train -> prepare_deploy -> query. Factors within 1e-3 of
    the reference, and equal top-10 lists except at near-ties.

    At the template's lambda 0.01 and 10 iterations, f32 CG rounding moves
    single entries of either package's factors up to ~3e-3 of the largest
    from the float64 sweeps (the same ALS, ``_als64``). So the whole
    matrices are held to 1e-3 (Frobenius), the largest entry error against
    the reference to max(1e-3, twice the reference's own float64 gap), and
    the port's float64 gap to max(1e-4, twice the reference's). The last
    takes the larger side of each: each half-step solves against the other
    side's factors, so rounding moves between them, and one side's gap is a
    single noisy sample of the run's (on events seed 14 the reference's
    item factors read 0.64e-3 from float64, its user factors 1.52e-3, the
    port's 1.71e-3 and 2.78e-3). The readings are printed (``pytest -rP``
    shows them)."""
    import predictionio_tpu.storage as jstorage
    from predictionio_tpu.workflow import core_workflow as jcw

    _load_app(pstorage, seed=seed)
    _load_app(jstorage, seed=seed)
    jengine = jcw.resolve_engine_factory(
        "engine:engine_factory", engine_dir=REPO / "templates"
        / "recommendation")
    jiid = jcw.run_train(jengine, jengine.engine_params_from_json(_variant()))
    jinst = jstorage.Storage.get_metadata().engine_instance_get(jiid)
    jmodel = jcw.prepare_deploy(jengine, jinst).models[0]

    engine = rec.engine_factory()
    iid = cw.run_train(engine, engine.engine_params_from_json(_variant()),
                       cpu_ctx())
    inst = Storage.get_metadata().engine_instance_get(iid)
    assert inst.status == "COMPLETED"
    stored = cw.prepare_deploy(engine, inst, cpu_ctx()).models[0]
    assert stored.item_factors.shape[1] == 10  # engine.json's rank

    # same id maps, so rows line up
    assert list(stored.user_ids.inverse[k] for k in range(5)) == \
        list(jmodel.user_ids.inverse[k] for k in range(5))

    from tests.test_torch_als_train import _als64

    from predictionio_tpu_torch import prng

    ratings = rec.RecommendationDataSource(
        rec.DataSourceParams(app_name="qbench")).read_training(
            cpu_ctx()).ratings
    k_u, k_v = prng.split(prng.PRNGKey(3))
    v0 = np.abs(prng.normal(k_v, (ratings.num_items, 10))) / np.sqrt(10)
    u0 = np.abs(prng.normal(k_u, (ratings.num_users, 10))) / np.sqrt(10)
    u64, v64 = _als64(ratings.user_indices, ratings.item_indices,
                      ratings.ratings, ratings.num_users, ratings.num_items,
                      u0, v0, iters=10, lambda_=0.01, cg_iters=4)

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    def fro(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    gaps = {}
    for side, mine, ref, exact in (
            ("user", stored.user_factors, jmodel.user_factors, u64),
            ("item", stored.item_factors, jmodel.item_factors, v64)):
        gaps[side] = {"fro_port_ref": fro(mine, ref),
                      "max_port_ref": rel(mine, ref),
                      "max_port_f64": rel(mine, exact),
                      "max_ref_f64": rel(ref, exact)}
        print(f"events seed {seed} {side} factors:", json.dumps(gaps[side]))
        assert gaps[side]["fro_port_ref"] <= 1e-3
        assert gaps[side]["max_port_ref"] <= max(
            1e-3, 2 * gaps[side]["max_ref_f64"])
    assert max(g["max_port_f64"] for g in gaps.values()) <= max(
        1e-4, 2 * max(g["max_ref_f64"] for g in gaps.values()))

    server = EngineServer(engine, inst, device="cpu", batch_window_ms=0)
    ref_all = jmodel.user_factors @ jmodel.item_factors.T
    for user in ("u0", "u7", "u42", "u299"):
        got = server.serve_query({"user": user, "num": 10})["itemScores"]
        assert len(got) == 10
        row = jmodel.user_ids[user]
        port_scores = np.full(ref_all.shape[1], -np.inf)
        for rank_i, s in enumerate(got):  # the port's order as scores
            port_scores[jmodel.item_ids[s["item"]]] = 1e9 - rank_i
        _top10_agree(port_scores, ref_all[row])


def test_e2e_events_to_answers_match_the_reference():
    _e2e_both_packages(11)


@pytest.mark.parametrize("seed", [12, 13, 14])
def test_e2e_factor_gaps_on_more_event_seeds(seed):
    _e2e_both_packages(seed)


def test_training_the_same_events_twice_is_bitwise_equal():
    _load_app(pstorage, n=3000, n_buy=100)
    engine = rec.engine_factory()
    ep = engine.engine_params_from_json(_variant())
    a = cw.run_train(engine, ep, cpu_ctx())
    b = cw.run_train(engine, ep, cpu_ctx())
    ma = cw.prepare_deploy(engine, Storage.get_metadata().engine_instance_get(
        a), cpu_ctx()).models[0]
    mb = cw.prepare_deploy(engine, Storage.get_metadata().engine_instance_get(
        b), cpu_ctx()).models[0]
    np.testing.assert_array_equal(ma.user_factors, mb.user_factors)
    np.testing.assert_array_equal(ma.item_factors, mb.item_factors)


def test_storage_deployed_answers_equal_host_top_n_of_stored_factors():
    _load_app(pstorage, n=3000, n_buy=100)
    engine = rec.engine_factory()
    iid = cw.run_train(engine, engine.engine_params_from_json(_variant()),
                       cpu_ctx())
    inst = Storage.get_metadata().engine_instance_get(iid)
    blob = ser.deserialize_models(Storage.get_models().get(iid).models)[0]
    server = EngineServer(engine, inst, device="cpu", batch_max=8)
    with serve(server, "127.0.0.1", 0) as front:
        for user in ("u1", "u5", "u100"):
            req = urllib.request.Request(
                f"http://127.0.0.1:{front.port}/queries.json",
                data=json.dumps({"user": user, "num": 5}).encode(),
                method="POST")
            got = json.loads(urllib.request.urlopen(req, timeout=30).read())
            scores = blob.item_factors @ blob.user_factors[
                blob.user_ids[user]]
            top = np.argsort(-scores, kind="stable")[:5]
            want = [blob.item_ids.inverse[int(t)] for t in top]
            assert [s["item"] for s in got["itemScores"]] == want
            np.testing.assert_allclose(
                [s["score"] for s in got["itemScores"]], scores[top],
                rtol=1e-5, atol=1e-5)


# -- seqrec from storage -----------------------------------------------------


def test_seqrec_trains_from_stored_events_and_deploys(monkeypatch):
    from predictionio_tpu_torch import prng
    from predictionio_tpu_torch.models import seq_attention as sa

    S = pstorage
    app = S.Storage.get_metadata().app_insert("seq")
    S.Storage.get_events().init_app(app.id)
    evs = []
    for u in range(12):
        for t in range(6):
            evs.append(S.Event(
                event="view", entity_type="user", entity_id=f"s{u}",
                target_entity_type="item",
                target_entity_id=f"i{(u + t) % 9}",
                event_time=T0 + timedelta(minutes=t)))
    evs.append(S.Event(event="$set", entity_type="user", entity_id="s0",
                       properties=S.DataMap({"a": 1})))
    S.Storage.get_events().insert_batch(evs, app.id)

    seen: dict = {}
    real_init, real_perm = sa._default_init, prng.permutation

    def spy_init(n_items, cfg, seed):
        seen["init"] = real_init(n_items, cfg, seed)
        return seen["init"]

    def spy_perm(key, n):
        out = real_perm(key, n)
        seen.setdefault("orders", []).append((np.array(key), n, out))
        return out

    monkeypatch.setattr(sa, "_default_init", spy_init)
    monkeypatch.setattr(sa.prng, "permutation", spy_perm)
    engine = seq.engine_factory()
    variant = {"datasource": {"params": {"app_name": "seq"}},
               "algorithms": [{"name": "seqrec", "params": {
                   "max_len": 6, "embed_dim": 16, "num_heads": 2,
                   "num_blocks": 1, "epochs": 2, "batch_size": 4,
                   "seed": 4}}]}
    iid = cw.run_train(engine, engine.engine_params_from_json(variant),
                       cpu_ctx())
    inst = Storage.get_metadata().engine_instance_get(iid)
    assert inst.status == "COMPLETED"

    # the first epoch's shuffle and the init are the reference trainer's
    jkey = jax.random.split(jax.random.PRNGKey(4))[1]
    jkey, jsub = jax.random.split(jkey)
    key, n, order = seen["orders"][0]
    np.testing.assert_array_equal(key, np.asarray(jsub))
    np.testing.assert_array_equal(order,
                                  np.asarray(jax.random.permutation(jsub, n)))
    from predictionio_tpu.models import seq_attention as jsa

    jcfg = jsa.SeqRecConfig(max_len=6, embed_dim=16, num_heads=2,
                            num_blocks=1, seed=4)
    want = jsa._make_model(9, jcfg).init(
        jax.random.split(jax.random.PRNGKey(4))[0],
        jax.numpy.zeros((2, 6), jax.numpy.int32))
    got = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_leaves_with_path(seen["init"])}
    for k, w in jax.tree_util.tree_leaves_with_path(want):
        g = got[jax.tree_util.keystr(k)]
        np.testing.assert_allclose(g, np.asarray(w), rtol=2.4e-7, atol=0)

    server = EngineServer(engine, inst, device="cpu", batch_window_ms=0)
    out = server.serve_query({"user": "s3", "num": 3})["itemScores"]
    assert len(out) == 3 and all(s["item"].startswith("i") for s in out)
    stored = ser.deserialize_models(Storage.get_models().get(iid).models)[0]
    assert getattr(stored, "_net", None) is None
