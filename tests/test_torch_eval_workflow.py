"""``pio eval`` on the port, against the JAX package, on the CPU.

The workflow level of evaluation: ``run_evaluation``'s records (INIT to
EVALCOMPLETED with the one-liner, HTML and JSON; ABORTED on any
``BaseException``, Ctrl-C included; the result stamped onto an engine
record by ``engine_instance_id``), the ``eval`` verb with
``PIO_PLATFORM=cpu`` (plain and ``--fast``) and its refusal without it on
a machine with no card; then both templates' evaluations through both
packages' consoles on the same events:

- the recommendation template (``RecommendationEvaluation``: 3 folds x
  rank {5, 10} x lambda {0.01, 0.1}, HitRate@10) on the e2e quickstart's
  shape at a small size (``tests/test_torch_cli.py``'s events, seed 11);
- the movielensevaluation template (``MovieLensEvaluation``: 2 folds x
  rank {4, 8} x lambda {0.02, 0.1}; HitRate@10, MRR(hits), MSE(hits)) on
  ``data/gen_movielens.py``'s events at its defaults (400 users, 200
  items, 20,000 ratings).

What must hold: ``read_eval``'s folds equal (the same training ratings,
the same ``(query, actual)`` lists in order); the fold rule, whose
yardstick is the float64 sweeps of the same ALS from the same init
(``tests/torch_als64.py``), never one f32 trajectory of the reference,
with every tolerance from the reference's own float64 error: per
variant, the port's largest-entry gap to float64 over all its folds and
both sides at most max(1e-4, 4 x the reference's same statistic), and
each fold's and side's at most 1e-2 of the largest entry; every eval
prediction equal to the reference's item for item except at near-ties,
a property of the reference's row alone (neighbouring reference scores
within the row's width max(1e-3 x max|row|, 5 x the row's largest
reference-to-float64 score gap)): where the lists differ, the
reference's scores there have a neighbour within the width, and an item
only the port lists lies within it of the reference's 10th score;
HitRate@10 within (queries whose hit can move at such a tie) /
(queries) of the reference's, MRR(hits) within the share of the hits
whose rank can move; MSE(hits) on the hits both packages share within
1e-3 relative; the rule rejects a port with a defect in its ALS (CG
depth 3, a plain λ ridge, the init from another key); the leaderboard
order and best.json the reference's
wherever two variants' reference scores differ by more than that
bound; ``--fast`` bitwise equal to the plain run, with the
reference's FastEval hit counts; two evaluations of the same grid bitwise
equal. Then the walkthrough's last step on the port: ``pio train
--engine-json best.json`` trains the winner, and ``EngineServer`` answers
with the host exact top-N of its factors.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import predictionio_tpu.storage as jstorage  # noqa: E402
from predictionio_tpu.controller.fast_eval import (  # noqa: E402
    FastEvalEngine as JFastEval)
from predictionio_tpu.tools.cli import main as ref_pio  # noqa: E402
from predictionio_tpu.workflow import core_workflow as jcw  # noqa: E402
from predictionio_tpu.workflow.context import Context as JContext  # noqa: E402

import predictionio_tpu_torch.controller as pc  # noqa: E402
import predictionio_tpu_torch.storage as pstorage  # noqa: E402
from predictionio_tpu_torch import prng  # noqa: E402
from predictionio_tpu_torch.controller.fast_eval import (  # noqa: E402
    FastEvalEngine)
from predictionio_tpu_torch.templates.recommendation import (  # noqa: E402
    engine as prec)
from predictionio_tpu_torch.tools import cli as port_cli  # noqa: E402
from predictionio_tpu_torch.workflow import core_workflow as pcw  # noqa: E402
from predictionio_tpu_torch.workflow.context import Context  # noqa: E402
from predictionio_tpu_torch.workflow.create_server import (  # noqa: E402
    EngineServer)
from tests.torch_als64 import als64 as _als64  # noqa: E402
from tests.test_torch_cli import _env, _events_lines, _run  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
GEN = (REPO / "predictionio_tpu_torch" / "templates" / "movielensevaluation"
       / "data" / "gen_movielens.py")
TEMPLATES = {
    "recommendation": ("MyApp", "RecommendationEvaluation"),
    "movielensevaluation": ("mlapp", "MovieLensEvaluation"),
}
CLIS = {"reference": (ref_pio, jstorage), "port": (port_cli.main, pstorage)}


# -- run_evaluation's records --------------------------------------------------


@pytest.fixture
def port_storage(tmp_path, monkeypatch):
    home = tmp_path / "pio"
    monkeypatch.setenv("PIO_HOME", str(home))
    pstorage.Storage.reset()
    for repo, name in (("METADATA", "meta"), ("EVENTDATA", "events"),
                       ("MODELDATA", "models")):
        pstorage.Storage.configure(repo, "sqlite",
                                   path=str(home / f"{name}.db"))
    yield pstorage.Storage
    pstorage.Storage.reset()


class _Ctx:
    checkpoint_dir = None
    checkpoint_every = 0


def _tiny_evaluation(pkg, *, raise_with=None):
    """An engine that evaluates without training anything real: the
    datasource gives two folds of integer queries, the model is the
    variant's weight, a prediction is query x weight; the metric is the
    mean prediction."""

    @dataclasses.dataclass(frozen=True)
    class AP(pkg.Params):
        w: int = 1

    class DS(pkg.DataSource):
        def read_training(self, ctx):
            return None

        def read_eval(self, ctx):
            if raise_with is not None:
                raise raise_with
            return [(None, {"fold": f}, [(q, q) for q in range(4)])
                    for f in range(2)]

    class Algo(pkg.Algorithm):
        params_class = AP

        def train(self, ctx, pd):
            return self.params.w

        def predict(self, model, q):
            return q * model

    class Mean(pkg.AverageMetric):
        def calculate_qpa(self, q, p, a):
            return float(p)

    class Eval(pkg.Evaluation):
        engine = pkg.Engine(DS, pkg.IdentityPreparator, {"a": Algo},
                            pkg.FirstServing)
        metric = Mean()

    grid = [pkg.EngineParams(algorithm_params_list=(("a", AP(w=w)),))
            for w in (1, 3, 2)]
    return Eval(), grid


def _run_records(pkg, cw, storage, **kw):
    evaluation, grid = _tiny_evaluation(pkg)
    iid, result = cw.run_evaluation(evaluation, grid, _Ctx(),
                                    evaluation_class="x:Eval", batch="b",
                                    **kw)
    inst = storage.get_metadata().evaluation_instance_get(iid)
    return iid, result, inst


def test_run_evaluation_records_match_the_reference(port_storage):
    _, got, inst = _run_records(pc, pcw, port_storage)
    import predictionio_tpu.controller as jc

    _, want, jinst = _run_records(jc, jcw, jstorage.Storage)
    assert inst.status == jinst.status == "EVALCOMPLETED"
    assert inst.end_time is not None
    assert (inst.evaluation_class, inst.batch) == ("x:Eval", "b")
    for field in ("evaluator_results", "evaluator_results_html",
                  "evaluator_results_json"):
        assert getattr(inst, field) == getattr(jinst, field)
    assert inst.evaluator_results == got.to_one_liner()
    assert inst.evaluator_results_json == got.to_json()
    assert got.best_idx == want.best_idx == 1  # weight 3: mean 4.5
    assert got.pretty_print() == want.pretty_print()


@pytest.mark.parametrize("exc", [KeyboardInterrupt(), ValueError("bad")],
                         ids=["KeyboardInterrupt", "ValueError"])
def test_run_evaluation_aborts_on_any_base_exception(port_storage, exc):
    evaluation, grid = _tiny_evaluation(pc, raise_with=exc)
    with pytest.raises(type(exc)):
        pcw.run_evaluation(evaluation, grid, _Ctx())
    (inst,) = port_storage.get_metadata().evaluation_instance_get_all()
    assert inst.status == "ABORTED" and inst.end_time is not None
    assert port_storage.get_metadata() \
        .evaluation_instance_get_completed() == []


def test_run_evaluation_stamps_the_engine_instance(port_storage):
    meta = port_storage.get_metadata()
    eid = meta.engine_instance_insert(pstorage.EngineInstance(
        status="COMPLETED", engine_id="e", engine_version="1",
        engine_variant="default", phase_times="[[\"train\", 1.0]]"))
    _, result, _ = _run_records(pc, pcw, port_storage,
                                engine_instance_id=eid)
    stamped = meta.engine_instance_get(eid)
    assert stamped.evaluator_results == result.to_one_liner()
    assert stamped.evaluator_results_json == result.to_json()
    assert stamped.evaluator_class == "x:Eval"
    assert stamped.phase_times == "[[\"train\", 1.0]]"  # the rest kept
    pcw.stamp_evaluator_results(eid, result, tuning_json="{}")
    assert meta.engine_instance_get(eid).tuning == "{}"
    # a missing instance is a no-op: the evaluation itself succeeded
    pcw.stamp_evaluator_results("ei_missing", result)
    _, _, inst = _run_records(pc, pcw, port_storage,
                              engine_instance_id="ei_missing")
    assert inst.status == "EVALCOMPLETED"


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA card is present: nothing to refuse")
def test_run_evaluation_without_a_context_trains_on_cuda(port_storage):
    """``ctx=None`` makes a Context whose device is None (CUDA): without a
    card the first fold's training raises, and the record is ABORTED."""
    app = port_storage.get_metadata().app_insert("MyApp")
    port_storage.get_events().init_app(app.id)
    port_storage.get_events().insert_batch([pstorage.Event(
        event="rate", entity_type="user", entity_id=f"u{k % 5}",
        target_entity_type="item", target_entity_id=f"i{k % 7}",
        properties=pstorage.DataMap({"rating": 3.0})) for k in range(40)],
        app.id)
    evaluation = prec.RecommendationEvaluation()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pcw.run_evaluation(evaluation, evaluation.engine_params_list[:1])
    (inst,) = port_storage.get_metadata().evaluation_instance_get_all()
    assert inst.status == "ABORTED"


# -- the two templates through both consoles ---------------------------------


def _event_lines(template: str) -> list[str]:
    if template == "recommendation":
        return _events_lines()
    proc = subprocess.run([sys.executable, str(GEN)], capture_output=True,
                          text=True, check=True, timeout=120)
    return proc.stdout.splitlines()


def _engine_dir(name: str, template: str, root: Path) -> Path:
    d = root / f"{name}-engine"
    if name == "reference":
        shutil.copytree(REPO / "templates" / template, d)
    else:
        assert port_cli.main(["template", "get", template, str(d)]) == 0
    return d


def _ctx(name: str):
    return (Context(device="cpu", mode="Evaluation") if name == "port"
            else JContext(mode="Evaluation"))


def _plain_folds(folds) -> list:
    return [(ei, [(q.user, q.num, [(s.item, s.score) for s in p.itemScores],
                   a) for q, p, a in qpa]) for ei, qpa in folds]


def _console_eval(name: str, template: str, root: Path, events: Path) -> dict:
    """One package's evaluation of ``template``: the plain and ``--fast``
    verbs (and, on the port, the plain verb again), their printed
    leaderboards, best.json and records; then the same evaluation in
    process through a FastEvalEngine, whose cache keeps each fold's
    model; everything as plain data."""
    pio, S = CLIS[name]
    app_name, evaluation_name = TEMPLATES[template]
    out: dict = {}
    home = root / f"home-{name}"
    home.mkdir()
    with _env(PIO_HOME=str(home), PIO_PLATFORM="cpu"):
        S.Storage.reset()
        try:
            assert _run(pio, ["app", "new", app_name])[0] == 0
            app = S.Storage.get_metadata().app_get_by_name(app_name)
            assert _run(pio, ["import", "--appid", str(app.id), "--input",
                              str(events)])[0] == 0
            d = _engine_dir(name, template, root)
            argv = ["eval", "--engine-dir", str(d),
                    f"engine:{evaluation_name}"]
            runs = ["plain", "fast"] + (["again"] if name == "port" else [])
            for run in runs:
                extra = ["--fast"] if run == "fast" else []
                rc, text, notes = _run(pio, argv[:1] + extra + argv[1:])
                assert rc == 0, notes
                out[run] = {"text": text,
                            "best": json.loads((d / "best.json").read_text())}
            out["records"] = [
                (i.status, i.evaluator_results, i.evaluator_results_json)
                for i in sorted(
                    S.Storage.get_metadata().evaluation_instance_get_all(),
                    key=lambda i: i.id)]
            out["engine_dir"] = d

            # in process: the models of every fold, and the folds
            if name == "port":
                evaluation = pcw.resolve_attr(
                    f"predictionio_tpu_torch.templates.{template}.engine:"
                    f"{evaluation_name}")()
                fast = FastEvalEngine.wrap(evaluation.engine)
                cw = pcw
            else:
                evaluation = jcw.resolve_attr(f"engine:{evaluation_name}",
                                              engine_dir=d)()
                fast = JFastEval.wrap(evaluation.engine)
                cw = jcw
            grid = evaluation.engine_params_list
            evaluation.engine = fast
            ctx = _ctx(name)
            _, result = cw.run_evaluation(evaluation, grid, ctx)
            out["inproc_scores"] = [ms.to_row()
                                    for _, ms in result.engine_params_scores]
            out["hit_counts"] = dict(fast.hit_counts)
            results = fast.batch_eval(ctx, grid)  # every prefix cached now
            out["folds"] = [
                (td.ratings.user_indices.copy(),
                 td.ratings.item_indices.copy(), td.ratings.ratings.copy(),
                 ei, [(q.user, q.num, a) for q, a in qa])
                for td, ei, qa in fast._folds(ctx, grid[0])]
            out["ids"] = fast._folds(ctx, grid[0])[0][0].ratings
            out["predictions"] = [_plain_folds([(f.eval_info, f.qpa)
                                                for f in folds])
                                  for _, folds in results]
            out["models"] = [
                [(m.user_factors.copy(), m.item_factors.copy())
                 for m in fast._algo_cache[fast._algo_key(
                     ep, ep.algorithm_params_list[0])]]
                for ep in grid]
            out["configs"] = [dict(rank=ep.algorithm_params_list[0][1].rank,
                                   iters=ep.algorithm_params_list[0][1]
                                   .num_iterations,
                                   lambda_=ep.algorithm_params_list[0][1]
                                   .lambda_,
                                   seed=ep.algorithm_params_list[0][1].seed)
                              for ep in grid]
            out["headers"] = [m.header() for m in evaluation.all_metrics]
            out["lower"] = [m.lower_is_better for m in evaluation.all_metrics]
            if name == "port":
                out["walkthrough"] = _train_best_and_serve(d)
        finally:
            S.Storage.reset()
    return out


def _train_best_and_serve(engine_dir: Path) -> dict:
    """The walkthrough's last step on the port: train best.json's variant,
    then serve it; each answer against a host exact top-N."""
    rc, text, notes = _run(port_cli.main, ["train", "--engine-dir",
                                           str(engine_dir), "--engine-json",
                                           "best.json"])
    assert rc == 0, notes
    meta = pstorage.Storage.get_metadata()
    (inst,) = meta.engine_instance_get_completed("default", "1", "default")
    variant = json.loads((engine_dir / "engine.json").read_text())
    engine = pcw.resolve_engine_factory(variant["engineFactory"])
    server = EngineServer(engine, inst, device="cpu", batch_window_ms=0)
    model = server.deployed.result.models[0]
    answers = []
    for u in ("u0", "u3", "u17", "u41"):
        got = server.serve_query({"user": u, "num": 10})["itemScores"]
        scores = model.item_factors @ model.user_factors[model.user_ids[u]]
        answers.append(([s["item"] for s in got], [s["score"] for s in got],
                        scores, model.item_ids))
    return {"algo_params": json.loads(inst.algorithms_params),
            "answers": answers}


@pytest.fixture(scope="module", params=sorted(TEMPLATES))
def both(request, tmp_path_factory):
    template = request.param
    root = tmp_path_factory.mktemp(f"eval-{template}")
    events = root / "events.jsonl"
    events.write_text("\n".join(_event_lines(template)) + "\n")
    out = {name: _console_eval(name, template, root, events)
           for name in CLIS}
    out["template"] = template
    return out


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def _fro(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_read_eval_folds_match_the_reference(both):
    port, ref = both["port"]["folds"], both["reference"]["folds"]
    assert len(port) == len(ref) == {"recommendation": 3,
                                     "movielensevaluation": 2}[
                                         both["template"]]
    for got, want in zip(port, ref):
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3]
        assert got[4] == want[4]  # (user, num, actual) in order
    # every rating is held out exactly once
    n = sum(len(f[4]) for f in port)
    assert all(len(f[0]) + len(f[4]) == n for f in port)


def _f64(both, v: int, f: int):
    """The float64 sweeps of variant ``v`` on fold ``f`` (the same ALS from
    the same init, ``tests/torch_als64.py``), computed once per fixture."""
    cache = both.setdefault("f64", {})
    if (v, f) not in cache:
        ids, cfg = both["port"]["ids"], both["port"]["configs"][v]
        rank = cfg["rank"]
        k_u, k_v = prng.split(prng.PRNGKey(cfg["seed"]))
        v0 = np.abs(prng.normal(k_v, (ids.num_items, rank))) / np.sqrt(rank)
        u0 = np.abs(prng.normal(k_u, (ids.num_users, rank))) / np.sqrt(rank)
        fold = both["port"]["folds"][f]
        cache[(v, f)] = _als64(fold[0], fold[1], fold[2], ids.num_users,
                               ids.num_items, u0, v0, iters=cfg["iters"],
                               lambda_=cfg["lambda_"], cg_iters=4)
    return cache[(v, f)]


def _factor_rule(both, v: int, models) -> dict:
    """The fold rule on variant ``v`` for ``models`` (per fold, the port's
    ``(user_factors, item_factors)``): the yardstick is the float64
    sweeps of the same ALS from the same init, and every tolerance comes
    from the reference's own float64 error. ``port``/``ref``: the largest
    entry gap to float64 over the folds and both sides, relative to the
    largest entry (pooling takes away one fold's noise); ``pooled_ok``:
    port <= max(1e-4, 4 x ref), 4 above the largest single-training
    ratio measured (2.97 over 30 trainings,
    ``test_float64_drift_matches_the_references_over_seeds``);
    ``ceiling_ok``: each fold's and side's port gap <= 1e-2. The two
    packages are then within the sum of their float64 gaps of each
    other, by the triangle inequality."""
    port = ref = 0.0
    ceiling_ok = True
    for f, (uf, itf) in enumerate(models):
        u64, v64 = _f64(both, v, f)
        ru, ri = both["reference"]["models"][v][f]
        for mine, theirs, exact in ((uf, ru, u64), (itf, ri, v64)):
            gap = _rel(mine, exact)
            ceiling_ok &= gap <= 1e-2
            port, ref = max(port, gap), max(ref, _rel(theirs, exact))
    return {"port": port, "ref": ref, "ratio": port / ref,
            "pooled_ok": port <= max(1e-4, 4 * ref),
            "ceiling_ok": bool(ceiling_ok)}


@pytest.mark.parametrize("v", range(4), ids=lambda v: f"variant{v}")
def test_fold_factors_meet_the_e2e_rule(both, v):
    """Variant ``v``'s folds under the fold rule (``_factor_rule``). The
    readings, each fold's and the pooled ratio, are printed (``pytest
    -rP`` shows them)."""
    port, ref = both["port"], both["reference"]
    cfg = port["configs"][v]
    for f in range(len(port["folds"])):
        u64, v64 = _f64(both, v, f)
        for side, mine, theirs, exact in (
                ("user", port["models"][v][f][0], ref["models"][v][f][0],
                 u64),
                ("item", port["models"][v][f][1], ref["models"][v][f][1],
                 v64)):
            print(f"{both['template']} {cfg} fold {f} {side}:", json.dumps(
                {"fro_port_ref": _fro(mine, theirs),
                 "max_port_ref": _rel(mine, theirs),
                 "max_port_f64": _rel(mine, exact),
                 "max_ref_f64": _rel(theirs, exact)}))
    rule = _factor_rule(both, v, port["models"][v])
    print(f"{both['template']} variant {v}: pooled float64 gap port "
          f"{rule['port']:.3g}, reference {rule['ref']:.3g}, ratio "
          f"{rule['ratio']:.2f} (bound 4)")
    assert rule["pooled_ok"] and rule["ceiling_ok"], rule


@pytest.mark.parametrize("seed", [0, 1])
def test_one_sweep_is_as_accurate_as_the_references(seed):
    """Where the per-fold rule is tight (Queue 3 of ROADMAP.md): one ALS
    sweep from the same f32 mid-training state, through both packages'
    ``make_train_step`` on the reference's layout (the movielens
    template's shape: 400 users, 200 items, 10,000 ratings, rank 8,
    lambda 0.1, warm CG depth 4), against the float64 sweep. The port's
    largest row error is within twice the reference's, and both within
    1e-4 of the factors' largest entry: what the eval folds show after 8
    or 10 sweeps is rounding grown by the dynamics, not a sweep that
    rounds worse. The readings are printed."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import predictionio_tpu.models.als as jals
    from predictionio_tpu.ops.neighbors import build_bilinear_layout
    from predictionio_tpu.parallel.mesh import make_mesh

    import predictionio_tpu_torch.models.als as tals
    from predictionio_tpu_torch.convert import als_train_state_from_numpy

    rng = np.random.default_rng(seed)
    nu, ni, n, rank, lam = 400, 200, 10_000, 8, 0.1
    rows, cols = rng.integers(0, nu, n), rng.integers(0, ni, n)
    vals = (np.round(rng.random(n) * 9 + 1) / 2).astype(np.float32)
    u_lay, i_lay = build_bilinear_layout(rows, cols, vals, nu, ni, seed=3,
                                         align=8)
    u0 = np.abs(rng.standard_normal((nu, rank))) / np.sqrt(rank)
    v0 = np.abs(rng.standard_normal((ni, rank))) / np.sqrt(rank)
    u3, v3 = (x.astype(np.float32) for x in _als64(
        rows, cols, vals, nu, ni, u0, v0, iters=3, lambda_=lam, cg_iters=4))
    kw = dict(rank=rank, lambda_=lam, implicit=False, alpha=1.0,
              compute_dtype="float32", solver="cg", cg_iters=4)

    def slots(x, lay):
        out = np.zeros((lay.slots, x.shape[1]), np.float32)
        out[lay.pos] = x
        return out

    mesh = make_mesh()
    put = NamedSharding(mesh, P(None, None))
    uj, vj = (np.asarray(x) for x in jals.make_train_step(
        mesh, u_lay, i_lay, **kw)(
            jals.put_layout(u_lay, mesh), jals.put_layout(i_lay, mesh),
            jax.device_put(slots(u3, u_lay), put),
            jax.device_put(slots(v3, i_lay), put)))
    ut, vt = (x.numpy() for x in tals.make_train_step(u_lay, i_lay, **kw)(
        *als_train_state_from_numpy(u_lay, i_lay, u3, v3, device="cpu")))
    u64, v64 = _als64(rows, cols, vals, nu, ni, u3, v3, iters=1,
                      lambda_=lam, cg_iters=4)
    for side, mine, theirs, exact, lay in (
            ("user", ut, uj, u64, u_lay), ("item", vt, vj, v64, i_lay)):
        scale = np.abs(exact).max()
        port = float(np.abs(mine[lay.pos] - exact).max() / scale)
        ref = float(np.abs(theirs[lay.pos] - exact).max() / scale)
        print(f"seed {seed} {side}: port {port:.3g}, reference {ref:.3g} "
              f"from float64")
        assert port <= 2 * ref and max(port, ref) <= 1e-4, (side, port, ref)


@pytest.mark.parametrize("shape", [
    # (users, items, ratings, rank, lambda, iterations): the fold shapes
    # and variants where test_fold_factors_meet_the_e2e_rule reads gaps
    # past its bounds
    (400, 200, 10_000, 8, 0.1, 8),
    (300, 120, 6_300, 5, 0.01, 10),
    (300, 120, 6_300, 10, 0.1, 10),
    # the tuning grid's trial at rank 10, lambda 0.01, whose single-run
    # gap read 5.1 times the reference's
    (300, 120, 6_300, 10, 0.01, 10),
], ids=["movielens_rank8", "rec_rank5", "rec_rank10", "rec_rank10_lam001"])
def test_float64_drift_matches_the_references_over_seeds(shape):
    """Both packages' ``train_als`` on 10 seeds of random ratings, each
    against the float64 sweeps from the same init: the geometric mean
    over the seeds of (port's float64 gap) / (reference's), for the
    largest entry and for the median user row, lies within a factor of
    two of 1. The per-fold rule compares one such ratio to 2; this is
    its distribution. The ratios are printed."""
    from predictionio_tpu.models import als as jals
    from predictionio_tpu.parallel.mesh import make_mesh
    from predictionio_tpu.storage.frame import Ratings as JRatings

    from predictionio_tpu_torch.models.als import ALSConfig, train_als
    from predictionio_tpu_torch.storage.frame import Ratings

    nu, ni, n, rank, lam, iters = shape
    mesh = make_mesh()
    cfg = dict(rank=rank, iterations=iters, lambda_=lam, seed=3)
    k_u, k_v = prng.split(prng.PRNGKey(3))
    ratios = []
    for seed in range(10):
        rng = np.random.default_rng(100 + seed)
        users = np.asarray([f"u{x}" for x in rng.integers(0, nu, n)],
                           dtype=object)
        items = np.asarray([f"i{x}" for x in rng.integers(0, ni, n)],
                           dtype=object)
        vals = (np.round(rng.random(n) * 9 + 1) / 2).astype(np.float32)
        r = Ratings.from_triples(users, items, vals)
        port = train_als(r, ALSConfig(**cfg), device="cpu")
        ref = jals.train_als(JRatings.from_triples(users, items, vals),
                             jals.ALSConfig(**cfg), mesh=mesh)
        v0 = np.abs(prng.normal(k_v, (r.num_items, rank))) / np.sqrt(rank)
        u0 = np.abs(prng.normal(k_u, (r.num_users, rank))) / np.sqrt(rank)
        u64, v64 = _als64(r.user_indices, r.item_indices, r.ratings,
                          r.num_users, r.num_items, u0, v0, iters=iters,
                          lambda_=lam, cg_iters=4)

        def gap(m):
            return (max(_rel(m.user_factors, u64), _rel(m.item_factors, v64)),
                    float(np.median(np.abs(m.user_factors - u64).max(1))))

        ratios.append(np.divide(gap(port), gap(ref)))
    ratios = np.asarray(ratios)
    geo = np.exp(np.log(ratios).mean(0))
    print(f"{shape}: port / reference float64 gap, largest entry "
          f"{np.round(ratios[:, 0], 2).tolist()} (geometric mean "
          f"{geo[0]:.3f}), median row geometric mean {geo[1]:.3f}")
    assert np.all((0.5 <= geo) & (geo <= 2.0)), geo


def _near_ties(both):
    """Per variant, per (fold, query), computed once per fixture from the
    reference's row alone: the reference's scores of every item
    (``row``), the near-tie width (``tol``) max(1e-3 x the row's largest
    |score|, 5 x ε_ref), ε_ref the row's largest |reference score -
    float64 score| (the float64 sweeps' factors, ``_f64``; 5 is 1 plus
    the fold rule's 4: two runs each within their float64 gap of the
    exact scores can swap only items whose exact scores lie within the
    sum of the gaps), the row's k+1 best scores (``best``), and whether
    the query's hit (``hit``) and reciprocal rank (``rr``) can move under
    the near-tie rule. Lists may change members only at a tie at their
    boundary (the reference's k-th and k+1-th scores within ``tol``), and
    then only by items within ``tol`` of the k-th score: the hit moves
    only there, with the held-out item in the reference's list or within
    ``tol`` of its k-th score. The rank moves there too, or where the
    held-out item's reference score has a neighbour within ``tol``."""
    if "ties" in both:
        return both["ties"]
    ids = both["port"]["ids"]
    ref = both["reference"]
    out = []
    for v, folds in enumerate(ref["predictions"]):
        per = []
        for f, (_, qpa) in enumerate(folds):
            uf, itf = ref["models"][v][f]
            u64, v64 = _f64(both, v, f)
            for user, num, pred, a in qpa:
                row = itf @ uf[ids.user_ids[user]]
                eps = float(np.abs(row - v64 @ u64[ids.user_ids[user]]).max())
                tol = max(1e-3 * float(np.abs(row).max()), 5 * eps)
                best = np.sort(row)[::-1][:num + 1]
                near = np.abs(np.diff(best)) < tol  # [j]: ranks j, j+1
                names = [i for i, _ in pred]
                at = names.index(a["item"]) if a["item"] in names else None
                hit = bool(near[num - 1]) and (at is not None or abs(
                    row[ids.item_ids[a["item"]]] - best[num - 1]) < tol)
                rr = hit or (at is not None and bool(
                    near[at] or (at > 0 and near[at - 1])))
                per.append({"row": row, "tol": tol, "best": best,
                            "hit": hit, "rr": rr})
        out.append(per)
    both["ties"] = out
    return out


def _broken_lists(both, v: int, lists) -> tuple[int, list]:
    """The list rule on variant ``v`` for ``lists`` (per fold, per query,
    the port's listed item names, in the reference's query order):
    ``(differing lists, lists beyond a near-tie)``. A list may differ
    from the reference's only among near-tied items (``_near_ties``): at
    each position where they differ and the port's item is in the
    reference's list, the reference's score there has a neighbour within
    the width, and an item only the port lists lies within it of the
    reference's last listed score."""
    ids = both["port"]["ids"]
    ties = iter(_near_ties(both)[v])
    differ, broken = 0, []
    for got_q, (_, want_q) in zip(lists,
                                  both["reference"]["predictions"][v]):
        for g_items, want in zip(got_q, want_q):
            t = next(ties)
            w_items = [i for i, _ in want[2]]
            assert len(g_items) == len(w_items)
            if g_items == w_items:
                continue
            differ += 1
            s, tol, row = t["best"], t["tol"], t["row"]
            ok = all(
                any(abs(s[j] - s[n]) < tol for n in (j - 1, j + 1)
                    if 0 <= n < len(s))
                for j in np.nonzero(np.asarray(g_items) !=
                                    np.asarray(w_items))[0]
                if g_items[j] in w_items)  # a membership change: below
            ok &= all(abs(row[ids.item_ids[item]] - s[-2]) < tol
                      for item in set(g_items) - set(w_items))
            if not ok:
                broken.append((want[0], g_items, w_items))
    return differ, broken


@pytest.mark.parametrize("v", range(4), ids=lambda v: f"variant{v}")
def test_eval_predictions_match_the_reference(both, v):
    """Variant ``v``'s predictions, query by query, against the
    reference's under the list rule (``_broken_lists``). The lists that
    differ and those that break the rule are counted and printed."""
    for (_, got_q), (_, want_q) in zip(both["port"]["predictions"][v],
                                       both["reference"]["predictions"][v]):
        for got, want in zip(got_q, want_q):
            assert got[:2] == want[:2] and got[3] == want[3]
    differ, broken = _broken_lists(both, v, [
        [[i for i, _ in got[2]] for got in got_q]
        for _, got_q in both["port"]["predictions"][v]])
    print(f"{both['template']} variant {v}: {differ} differing lists, "
          f"{len(broken)} beyond a near-tie")
    assert not broken, broken[:3]


#: defects of the port's ALS the fold rule must reject, each applied to
#: the port's ``train_als`` by patching its module
DEFECTS = {
    # CG depth 3 instead of 4 (the warm depth of every sweep here)
    "cg_depth_3": lambda mp, tals: mp.setattr(tals, "DEFAULT_CG_ITERS_WARM",
                                              3),
    # the ALS-WR shift λ·max(n, 1) replaced by a plain λ
    "plain_lambda": lambda mp, tals: mp.setattr(
        tals, "_ridge", lambda other_c, n, *, lambda_, implicit: (
            lambda_, None)),
    # the init drawn from another key
    "init_key": lambda mp, tals: mp.setattr(tals, "prng", type(
        "OtherKey", (), {"PRNGKey": staticmethod(
            lambda seed: prng.PRNGKey(seed + 1)),
            "split": staticmethod(prng.split),
            "normal": staticmethod(prng.normal)})),
}


def _caught(both, monkeypatch, defect: str | None) -> list:
    """The variants whose folds, retrained through the port's
    ``train_als`` with ``defect`` applied (None: as it is), fail the
    factor rule or the list rule (each list the retrained factors' top-k,
    ties to the lowest id). Which rule caught a variant, and by how much,
    is printed."""
    import predictionio_tpu_torch.models.als as tals
    from predictionio_tpu_torch.storage.frame import Ratings

    port = both["port"]
    ids = port["ids"]
    names = ids.item_ids.inverse
    n_folds = len(port["folds"])
    for v in range(4):  # every cache filled before the patch
        for f in range(n_folds):
            _f64(both, v, f)
    _near_ties(both)
    if defect is not None:
        DEFECTS[defect](monkeypatch, tals)
    caught = []
    for v, cfg in enumerate(port["configs"]):
        models, lists = [], []
        for f, (users, items, vals, _ei, qa) in enumerate(port["folds"]):
            m = tals.train_als(Ratings(
                user_indices=users, item_indices=items, ratings=vals,
                user_ids=ids.user_ids, item_ids=ids.item_ids),
                tals.ALSConfig(rank=cfg["rank"], iterations=cfg["iters"],
                               lambda_=cfg["lambda_"], seed=cfg["seed"]),
                device="cpu")
            models.append((m.user_factors, m.item_factors))
            lists.append([
                [names[int(i)] for i in np.argsort(-(
                    m.item_factors @ m.user_factors[ids.user_ids[u]]),
                    kind="stable")[:num]] for u, num, _a in qa])
        rule = _factor_rule(both, v, models)
        differ, broken = _broken_lists(both, v, lists)
        held = rule["pooled_ok"] and rule["ceiling_ok"]
        print(f"{both['template']} {defect or 'no defect'} variant {v}: "
              f"factor rule {'held' if held else 'FAILED'}"
              f" (port {rule['port']:.3g} against 4 x {rule['ref']:.3g}, "
              f"ratio {rule['ratio']:.1f}), list rule "
              f"{'FAILED' if broken else 'held'} ({len(broken)} of "
              f"{differ} differing lists beyond a near-tie)")
        if not held or broken:
            caught.append(v)
    return caught


@pytest.mark.parametrize("defect", sorted(DEFECTS))
def test_the_fold_rule_rejects_a_defective_port(both, defect, monkeypatch):
    """The port's folds retrained with ``defect`` applied to its
    ``train_als``: some variant must fail the factor rule or the list
    rule."""
    assert _caught(both, monkeypatch, defect), \
        f"{defect} passed the fold rule in every variant"


def test_the_fold_rule_accepts_the_retrained_port(both, monkeypatch):
    """The control of the defects' test: the same retraining with nothing
    patched passes both rules in every variant."""
    assert _caught(both, monkeypatch, None) == []


def _per_query(metric: str, preds: list) -> list:
    out = []
    for _, qpa in preds:
        for _u, _n, items, a in qpa:
            names = [i for i, _ in items]
            if metric == "hit":
                out.append(1.0 if a["item"] in names else 0.0)
            elif metric == "rr":
                out.append(1.0 / (names.index(a["item"]) + 1)
                           if a["item"] in names else None)
            else:
                out.append(next(((s - a["rating"]) ** 2 for i, s in items
                                 if i == a["item"]), None))
    return out


def _bounds(both) -> list:
    """Per variant: {metric header prefix: bound}. HitRate moves by at
    most (queries whose hit can move) / (queries). MRR(hits) averages
    the reciprocal rank over the hits: with t queries whose rank can move
    and n fixed hits (reference hits outside those t), each of the t
    adds a value in [0, 1] or nothing, so the mean moves by at most
    t / (n + t)."""
    out = []
    ref = both["reference"]["predictions"]
    for v, per in enumerate(_near_ties(both)):
        rr = _per_query("rr", ref[v])
        t = sum(q["rr"] for q in per)
        fixed = sum(r is not None and not q["rr"] for r, q in zip(rr, per))
        out.append({"HitRate": sum(q["hit"] for q in per) / len(per),
                    "MRR": t / max(fixed + t, 1)})
    return out


def test_eval_metrics_match_the_reference(both):
    port, ref = both["port"], both["reference"]
    assert port["headers"] == ref["headers"]
    assert port["lower"] == ref["lower"]
    for v, bounds in enumerate(_bounds(both)):
        got, want = port["inproc_scores"][v], ref["inproc_scores"][v]
        print(f"{both['template']} variant {v}: {got} against {want}, "
              f"bounds {bounds}")
        for h, g, w in zip(port["headers"], got, want):
            if h.startswith("MSE"):
                continue
            bound = bounds[h.split("@")[0].split("(")[0]]
            assert abs(g - w) <= bound, (v, h, g, w, bound)
        # the in-process run scores exactly what the console printed
        assert f"{port['headers'][0]}={got[0]}]" in port["plain"]["text"]
        if "MSE(hits)" in port["headers"]:
            mine = _per_query("mse", port["predictions"][v])
            theirs = _per_query("mse", ref["predictions"][v])
            shared = [(a, b) for a, b in zip(mine, theirs)
                      if a is not None and b is not None]
            a = np.mean([x for x, _ in shared])
            b = np.mean([y for _, y in shared])
            assert abs(a - b) <= 1e-3 * abs(b), (v, a, b)
        # the primary metric recomputed from the predictions
        hits = _per_query("hit", port["predictions"][v])
        assert np.mean(hits) == got[0]


def test_leaderboard_and_best_json_match_the_reference(both):
    port, ref = both["port"], both["reference"]
    bounds = [b["HitRate"] for b in _bounds(both)]
    want = [s[0] for s in ref["inproc_scores"]]
    got = [s[0] for s in port["inproc_scores"]]
    for i in range(len(want)):
        for j in range(len(want)):
            if want[i] - want[j] > bounds[i] + bounds[j]:
                assert got[i] > got[j], (i, j, got, want)
    best = int(np.argmax(want))
    margin = min((want[best] - w for k, w in enumerate(want) if k != best),
                 default=1.0)
    if margin > 2 * max(bounds):
        assert port["plain"]["best"] == ref["plain"]["best"]
    assert set(port["plain"]["best"]) == set(ref["plain"]["best"])


def test_fast_eval_is_bitwise_the_plain_run(both):
    for name in CLIS:
        run = both[name]
        plain = run["plain"]["text"].split("FastEval")[0]
        fast = run["fast"]["text"].split("FastEval")[0]
        board = plain.split("Evaluation completed")[0]
        assert board == fast.split("Evaluation completed")[0]
        assert run["plain"]["best"] == run["fast"]["best"]
        assert [r[1:] for r in run["records"][:2]] == [run["records"][0][1:]] * 2
    port, ref = both["port"], both["reference"]
    assert port["hit_counts"] == ref["hit_counts"] == {
        "preparator": len(port["configs"]) - 1}
    line = f"FastEval prefix cache hits: {port['hit_counts']}"
    assert line in port["fast"]["text"] and line in ref["fast"]["text"]


def test_two_evaluations_are_bitwise_equal(both):
    port = both["port"]
    assert port["again"]["text"].split("Instance:")[0] == \
        port["plain"]["text"].split("Instance:")[0]
    assert port["again"]["best"] == port["plain"]["best"]
    statuses = [r[0] for r in port["records"]]
    assert statuses == ["EVALCOMPLETED"] * 3
    assert port["records"][2][1:] == port["records"][0][1:]


def test_best_json_variant_trains_and_serves(both):
    """``pio train --engine-json best.json``: the winner's params, and its
    answers the host exact top-N of the stored factors."""
    walk = both["port"]["walkthrough"]
    best = both["port"]["plain"]["best"]["algorithmsParams"][0]
    assert walk["algo_params"] == [best]
    for items, scores, row, item_ids in walk["answers"]:
        top = np.argsort(-row, kind="stable")[:10]
        assert len(items) == 10
        np.testing.assert_allclose(scores, row[top], rtol=1e-5, atol=1e-5)
        for j, i in enumerate(items):
            assert abs(row[item_ids[i]] - row[top[j]]) <= 1e-5 * max(
                1.0, abs(row[top[j]]))


# -- the verb's device rules ----------------------------------------------------


@pytest.fixture
def port_home(tmp_path):
    with _env(PIO_HOME=str(tmp_path / "pio"), PIO_PLATFORM=None):
        pstorage.Storage.reset()
        yield tmp_path
        pstorage.Storage.reset()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA card is present: eval runs there")
def test_eval_without_a_card_exits_1(port_home):
    d = port_home / "eng"
    assert port_cli.main(["template", "get", "recommendation", str(d)]) == 0
    rc, out, notes = _run(port_cli.main, ["eval", "--engine-dir", str(d),
                                          "engine:RecommendationEvaluation"])
    assert rc == 1
    assert "CUDA is not available" in notes and "PIO_PLATFORM=cpu" in notes
    assert not (d / "best.json").exists()
    assert pstorage.Storage.get_metadata().evaluation_instance_get_all() == []


@pytest.mark.parametrize("argv,message", [
    (["engine:RecommendationEvaluation", "engine:NoSuchGrid"], None),
    (["engine:RecommendationEvaluation", "engine:EmptyGrid"],
     "no EngineParams to evaluate"),
    (["--fast", "engine:CustomEvaluation"], "fast_eval_compatible"),
])
def test_eval_refusals(port_home, monkeypatch, argv, message):
    monkeypatch.setenv("PIO_PLATFORM", "cpu")
    d = port_home / "eng"
    assert port_cli.main(["template", "get", "recommendation", str(d)]) == 0
    (d / "engine.py").write_text(
        "from predictionio_tpu_torch.templates.recommendation.engine import *\n"
        "from predictionio_tpu_torch.controller import Engine\n"
        "class EmptyGrid:\n    engine_params_list = []\n"
        "class Custom(Engine):\n    pass\n"
        "class CustomEvaluation(RecommendationEvaluation):\n"
        "    def __init__(self):\n"
        "        super().__init__()\n"
        "        e = self.engine\n"
        "        self.engine = Custom(e.data_source_classes,\n"
        "            e.preparator_classes, e.algorithm_classes,\n"
        "            e.serving_classes)\n")
    if message is None:
        with pytest.raises(AttributeError):
            port_cli.main(["eval", "--engine-dir", str(d), *argv])
        return
    rc, _, notes = _run(port_cli.main, ["eval", "--engine-dir", str(d),
                                        *argv])
    assert rc == 1 and message in notes


@pytest.mark.parametrize("template,attr", [
    ("recommendation", "RecommendationEvaluation"),
    ("movielensevaluation", "MovieLensEvaluation"),
])
def test_template_get_writes_an_engine_py_of_the_template(port_home,
                                                          template, attr):
    """``pio template get`` writes an ``engine.py`` that re-exports the
    template's module, so ``engine:<Attr>`` resolves in the engine dir to
    the package's own object, as in a reference template dir."""
    d = port_home / "eng"
    assert port_cli.main(["template", "get", template, str(d)]) == 0
    assert sorted(p.name for p in d.iterdir()) == ["engine.json",
                                                   "engine.py"]
    module = __import__(
        f"predictionio_tpu_torch.templates.{template}.engine",
        fromlist=[attr])
    assert pcw.resolve_attr(f"engine:{attr}", engine_dir=d) is getattr(
        module, attr)


def test_best_json_variant_takes_engine_json_factory_and_ids(port_home):
    d = port_home / "eng"
    assert port_cli.main(["template", "get", "recommendation", str(d)]) == 0
    grid = prec._params_grid(eval_k=2)
    (d / "best.json").write_text(json.dumps(grid[3].to_json_dict()))
    variant = port_cli._load_variant(d, "best.json")
    base = json.loads((d / "engine.json").read_text())
    assert variant["engineFactory"] == base["engineFactory"]
    assert variant["id"] == base["id"]
    engine = prec.engine_factory()
    assert engine.engine_params_from_json(variant).to_json_dict() == \
        grid[3].to_json_dict()
