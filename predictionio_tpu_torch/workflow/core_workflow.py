"""CoreWorkflow: orchestrate one training or evaluation run.

Analog of reference ``CoreWorkflow`` (core/src/main/scala/io/prediction/
workflow/CoreWorkflow.scala:42-150) + the engine-factory resolution part of
``CreateWorkflow``/``WorkflowUtils`` (workflow/CreateWorkflow.scala:141-277,
WorkflowUtils.scala:60-127): write the instance record (INIT), run the
engine, persist models, flip status to COMPLETED.

The port of ``predictionio_tpu/workflow/core_workflow.py``: engine
resolution, ``run_train`` and ``prepare_deploy``, copied with only their
imports changed (and no ``jax.profiler`` trace around the train).
``run_evaluation`` and ``stamp_evaluator_results`` come with the
evaluation slice.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import logging
import sys
import traceback
from datetime import datetime, timezone
from typing import Any, Sequence

from ..controller.components import PersistentModel
from ..controller.engine import Engine, TrainResult
from ..controller.params import EngineParams, params_to_json
from ..obs.training import TRAINING
from ..storage import EngineInstance, Model, Storage
from .context import Context
from .faults import FAULTS
from .supervisor import DEFAULT_STALE_AFTER_S, TrainSupervisor, reap_orphans
from .serialization import (
    PersistentModelManifest,
    RetrainMarker,
    deserialize_models,
    plain_module_name,
    serialize_models,
)

log = logging.getLogger("predictionio_tpu_torch.workflow")

#: engine dir -> its sibling .py stems, registered on first scoped load —
#: the basis for the (once-per-pair) sibling-name collision warning
_SCOPED_ENGINE_DIRS: dict = {}

__all__ = [
    "resolve_attr", "resolve_engine_factory", "run_train", "prepare_deploy",
    "engine_params_from_instance", "ModelIntegrityError",
]


class ModelIntegrityError(RuntimeError):
    """A stored model blob failed its checksum at deploy time."""


def _import_engine_scoped(engine_dir, mod_name: str):
    """Import ``mod_name`` from ``engine_dir`` under a dir-unique FLAT
    module name (``_pio_engine_<dirhash>_<name>``), so that two engines
    whose modules share a name — every template calls its module
    ``engine`` — coexist in one process. This replaces the old permanent
    ``sys.path`` prepend, which made a second engine's ``import engine``
    silently resolve to the first engine's code.

    The flat (dot-free) name keeps pickle round-trips working: classes
    defined in the module carry it as ``__module__``, and unpickling
    re-imports it straight from ``sys.modules`` with no parent package
    needed (serialization.py additionally re-resolves names against the
    engine dir, so blobs survive a moved project). Returns None when
    ``engine_dir`` has no such module (caller falls back to a regular
    import).

    Sibling-module semantics: imports the module body makes eagerly are
    engine-correct (the dir is FIRST on sys.path during exec, and the
    plain-named entries are evicted afterwards); the dir then stays
    APPENDED to sys.path so lazy imports at predict/serve time still
    resolve. With several engines whose *siblings* share names, a lazy
    sibling import binds by sys.path order — that hazard is DETECTED at
    load time: when a newly loaded engine dir carries sibling .py names
    that an earlier-loaded engine dir also has, a warning names the
    collisions so engine authors move those imports into the module body
    (eager imports are always engine-correct).
    """
    import hashlib
    import importlib.util
    from pathlib import Path

    top, _, rest = mod_name.partition(".")
    d = Path(engine_dir).resolve()
    file = d / f"{top}.py"
    pkg = d / top / "__init__.py"
    if not file.exists() and not pkg.exists():
        return None
    if d not in _SCOPED_ENGINE_DIRS:
        # one glob per NEW dir; collision pairs warn once (repeat resolves
        # of already-registered engines cost nothing and stay quiet)
        siblings = frozenset(p.stem for p in d.glob("*.py")) - {top}
        for prev, prev_sibs in _SCOPED_ENGINE_DIRS.items():
            clash = siblings & prev_sibs
            if clash:
                log.warning(
                    "engine dirs %s and %s both define sibling module(s) "
                    "%s: a LAZY `import <name>` at predict/serve time "
                    "binds by sys.path order and may load the other "
                    "engine's file — import siblings at engine-module "
                    "top level instead", d, prev, sorted(clash))
        _SCOPED_ENGINE_DIRS[d] = siblings
    key = hashlib.sha1(str(d).encode()).hexdigest()[:10]
    uniq_top = f"_pio_engine_{key}_{top}"
    if uniq_top not in sys.modules:
        if file.exists():
            spec = importlib.util.spec_from_file_location(uniq_top, file)
        else:
            spec = importlib.util.spec_from_file_location(
                uniq_top, pkg, submodule_search_locations=[str(d / top)])
        module = importlib.util.module_from_spec(spec)
        sys.modules[uniq_top] = module
        # engine-dir on sys.path ONLY while the module body executes, so
        # it can import sibling helper files
        sys.path.insert(0, str(d))
        try:
            spec.loader.exec_module(module)
        except BaseException:
            sys.modules.pop(uniq_top, None)
            raise
        finally:
            try:
                sys.path.remove(str(d))
            except ValueError:
                pass
            if str(d) not in sys.path:
                sys.path.append(str(d))  # lazy serve-time imports
            # sibling modules the body imported by plain name (e.g.
            # `from data_source import X`) were cached under that plain
            # name — evict them so another engine's same-named sibling
            # loads ITS file; the importer keeps its direct references
            for name, m in list(sys.modules.items()):
                f = getattr(m, "__file__", None)
                if (f and "." not in name
                        and not name.startswith("_pio_engine_")
                        and Path(f).parent == d):
                    sys.modules.pop(name, None)
    if rest:
        return importlib.import_module(f"{uniq_top}.{rest}")
    return sys.modules[uniq_top]


def resolve_attr(path: str, *, engine_dir=None) -> Any:
    """'pkg.module.Attr' or 'pkg.module:Attr' -> attribute. The analog of
    WorkflowUtils.getEngine's object/class reflection (WorkflowUtils.scala:
    60-99) with explicit module paths instead of classpath scanning.

    With ``engine_dir``, modules found in that directory are imported
    under a dir-unique name (see _import_engine_scoped) so multiple
    engines coexist in-process; other module paths import normally."""
    if ":" in path:
        mod_name, attr = path.split(":", 1)
    else:
        mod_name, _, attr = path.rpartition(".")
    if not mod_name:
        raise ValueError(f"cannot resolve {path!r}: need 'module.Attr'")
    module = None
    if engine_dir is not None:
        module = _import_engine_scoped(engine_dir, mod_name)
    if module is None:
        module = importlib.import_module(mod_name)
    obj = module
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def resolve_engine_factory(path: str, *, engine_dir=None) -> Engine:
    """Resolve an engineFactory string to an Engine instance. Accepts: an
    EngineFactory subclass, an instance, a function returning an Engine,
    or an Engine object."""
    obj = resolve_attr(path, engine_dir=engine_dir)
    if isinstance(obj, Engine):
        return obj
    candidates = []
    apply = getattr(obj, "apply", None)
    if apply is not None:
        candidates.append(apply)  # EngineFactory class w/ static apply, or instance
        if isinstance(obj, type):
            candidates.append(lambda: obj().apply())
    if callable(obj):
        candidates.append(obj)
    for make in candidates:
        try:
            result = make()
        except TypeError:
            continue
        if isinstance(result, Engine):
            return result
    raise TypeError(f"{path!r} did not yield an Engine (got {obj!r})")


def _now() -> datetime:
    return datetime.now(timezone.utc)


def _params_field(pair: tuple[str, Any]) -> str:
    name, params = pair
    return json.dumps({"name": name, "params": json.loads(params_to_json(params))})


def _algo_params_field(pairs: Sequence[tuple[str, Any]]) -> str:
    return json.dumps(
        [{"name": n, "params": json.loads(params_to_json(p))} for n, p in pairs]
    )


def _persistable(result: TrainResult, instance_id: str) -> list[Any]:
    """Apply the three persistence paths per algorithm
    (Engine.makeSerializableModels, Engine.scala:260-278)."""
    out = []
    for algo, model, name in zip(result.algorithms, result.models, result.algorithm_names):
        if isinstance(model, PersistentModel):
            saved = model.save(instance_id, algo.params)
            if saved:
                out.append(
                    PersistentModelManifest(
                        class_name=type(model).__name__,
                        # plain name: the dir-scoped prefix embeds the
                        # engine dir's path hash, which must not leak
                        # into durable blobs (serialization.py)
                        module=plain_module_name(type(model).__module__),
                    )
                )
            else:
                out.append(RetrainMarker(algorithm_class=type(algo).__name__))
        elif algo.persist_model:
            out.append(model)
        else:
            out.append(RetrainMarker(algorithm_class=type(algo).__name__))
    return out


def run_train(
    engine: Engine,
    engine_params: EngineParams,
    ctx: Context | None = None,
    *,
    engine_id: str = "default",
    engine_version: str = "1",
    engine_variant: str = "default",
    engine_factory: str = "",
    batch: str = "",
    env: dict | None = None,
    max_retries: int = 0,
    retry_backoff_s: float = 1.0,
    train_budget_s: float | None = None,
    heartbeat_s: float = 5.0,
    reap_stale_after_s: float = DEFAULT_STALE_AFTER_S,
    process_id: int = 0,
    num_processes: int = 1,
) -> str:
    """Train and persist; returns the engine instance id
    (CoreWorkflow.runTrain, CoreWorkflow.scala:42-94).

    The body runs under a ``TrainSupervisor``: transient failures
    (preemption / device-lost / injected chaos faults) are retried up to
    ``max_retries`` times with jittered backoff, resuming from the
    latest ``TrainCheckpointer`` step; a heartbeat stamps
    ``last_heartbeat``/``attempt`` into the instance record; and
    ``train_budget_s`` (None = unlimited) bounds the whole run's wall
    clock, aborting cleanly (status ABORTED) instead of hanging. Stale
    INIT orphans from previous dead runs are reaped first.

    Elastic multi-host runs pass ``process_id``/``num_processes``: every
    heartbeat then also stamps this process's entry in the instance's
    per-host ``host_heartbeats`` map (the liveness record peers and
    ``pio status`` read; ``supervisor.check_peer_liveness`` turns a
    stale entry into a transient ``HostLostError``).
    """
    ctx = ctx or Context(mode="Train", batch=batch)
    meta = Storage.get_metadata()
    if reap_stale_after_s and reap_stale_after_s > 0:
        reap_orphans(meta, stale_after_s=reap_stale_after_s)
    instance = EngineInstance(
        status="INIT",
        start_time=_now(),
        engine_id=engine_id,
        engine_version=engine_version,
        engine_variant=engine_variant,
        engine_factory=engine_factory,
        batch=batch,
        env=env or {},
        data_source_params=_params_field(engine_params.data_source_params),
        preparator_params=_params_field(engine_params.preparator_params),
        algorithms_params=_algo_params_field(engine_params.algorithm_params_list),
        serving_params=_params_field(engine_params.serving_params),
    )
    instance_id = meta.engine_instance_insert(instance)
    log.info("EngineInstance %s created; training starts", instance_id)
    # fresh convergence channel per run: attempt summaries from a
    # previous run in this process must not ride this instance's record
    TRAINING.reset_source("train")

    def _stamp(status: str, **extra) -> EngineInstance:
        """Final status flip over the FRESHEST record, so the
        heartbeat's last_heartbeat/attempt stamps survive. ``extra``
        fields (e.g. the phase-time breakdown) ride the same write."""
        cur = meta.engine_instance_get(instance_id) or dataclasses.replace(
            instance, id=instance_id)
        done = dataclasses.replace(cur, status=status, end_time=_now(), **extra)
        meta.engine_instance_update(done)
        return done

    def _on_heartbeat(iso: str, attempt: int) -> None:
        cur = meta.engine_instance_get(instance_id)
        if cur is not None and cur.status == "INIT":  # never clobber a final status
            extra = {}
            if num_processes > 1:
                try:
                    beats = json.loads(cur.host_heartbeats or "{}")
                except ValueError:
                    beats = {}
                beats[str(process_id)] = {"ts": iso, "attempt": attempt}
                extra["host_heartbeats"] = json.dumps(beats)
            meta.engine_instance_update(dataclasses.replace(
                cur, last_heartbeat=iso, attempt=attempt, **extra))

    def _body() -> tuple[int, int]:
        from .tracing import phase_report, reset_phases

        # each supervised attempt re-runs every phase; without the reset
        # a retried run's persisted breakdown would double-count
        reset_phases(ctx)
        result = engine.train(ctx, engine_params)
        log.info("training phases: %s", phase_report(ctx))
        models = _persistable(result, instance_id)
        blob = serialize_models(models)
        FAULTS.fire("train.persist")
        Storage.get_models().insert(Model(
            id=instance_id, models=blob,
            checksum=Model.compute_checksum(blob)))
        return len(models), len(blob)

    supervisor = TrainSupervisor(
        max_retries=max_retries,
        retry_backoff_s=retry_backoff_s,
        train_budget_s=train_budget_s,
        heartbeat_s=heartbeat_s,
        on_heartbeat=_on_heartbeat,
    )
    try:
        n_models, n_bytes = supervisor.run(_body)
        from .tracing import phase_times_json

        TRAINING.finish("train", "COMPLETED")
        _stamp("COMPLETED", phase_times=phase_times_json(ctx),
               convergence=json.dumps(TRAINING.summaries("train")))
        log.info("Training completed: instance %s (%d model(s), %d bytes, "
                 "%d attempt(s))",
                 instance_id, n_models, n_bytes, supervisor.attempts)
    except BaseException:
        # BaseException, not Exception: Ctrl-C / SystemExit must not
        # leave the instance stuck at INIT forever
        _stamp("ABORTED")
        log.error("Training aborted:\n%s", traceback.format_exc())
        raise
    return instance_id


def prepare_deploy(
    engine: Engine, instance: EngineInstance, ctx: Context | None = None,
    *, engine_dir=None,
) -> TrainResult:
    """Rehydrate models for serving (Engine.prepareDeploy, Engine.scala:
    174-243): deserialize stored models; PersistentModelManifest -> call
    the class's ``load``; RetrainMarker -> retrain from the stored params.

    ``engine_dir`` lets classes referenced by the blob or a manifest be
    re-resolved from the deploying engine's directory, so blobs survive a
    moved/renamed project or a different host (the reference re-resolves
    via its registered jar classpath, CreateServer.scala:61-75)."""
    ctx = ctx or Context(mode="Serving")
    engine_params = engine_params_from_instance(engine, instance)
    names, algos = engine.make_algorithms(engine_params)
    serving = engine.make_serving(engine_params)

    # chaos site: a poisoned/unreachable blob pull. Fires
    # before the fetch so a fallback-mode deploy quarantines this
    # instance exactly like a corrupt checksum would.
    FAULTS.fire("replica.blob_pull")
    blob = Storage.get_models().get(instance.id)
    if blob is None:
        raise RuntimeError(f"no model blob for engine instance {instance.id}")
    if blob.checksum:  # pre-integrity blobs have no checksum to check
        actual = Model.compute_checksum(blob.models)
        if actual != blob.checksum:
            raise ModelIntegrityError(
                f"model blob for engine instance {instance.id} is corrupt: "
                f"stored checksum {blob.checksum} != computed {actual}")
    stored = deserialize_models(blob.models, engine_dir=engine_dir)

    models: list[Any] = []
    needs_retrain = any(isinstance(m, RetrainMarker) for m in stored)
    retrained: TrainResult | None = None
    if needs_retrain:
        log.info("Some models are not serializable; retraining at deploy "
                 "(reference Engine.scala:186-208 path)")
        retrained = engine.train(ctx, engine_params)
    for i, (m, algo) in enumerate(zip(stored, algos)):
        if isinstance(m, PersistentModelManifest):
            mod = None
            if engine_dir is not None:  # engine-dir module, scoped import
                mod = _import_engine_scoped(engine_dir, m.module)
            if mod is None:
                # a library module, or (legacy/scoped) already registered
                mod = sys.modules.get(m.module) or importlib.import_module(m.module)
            cls = getattr(mod, m.class_name)
            models.append(cls.load(instance.id, algo.params, ctx))
        elif isinstance(m, RetrainMarker):
            assert retrained is not None
            models.append(retrained.models[i])
        else:
            models.append(m)
    return TrainResult(models=models, algorithms=algos, serving=serving,
                       algorithm_names=names)


def engine_params_from_instance(engine: Engine, instance: EngineInstance) -> EngineParams:
    """Rebuild EngineParams from the instance's stored JSON fields
    (Engine.engineInstanceToEngineParams, Engine.scala:387-440)."""
    def one(js: str, classes) -> tuple[str, Any]:
        d = json.loads(js) if js else {"name": "", "params": {}}
        name = d.get("name", "")
        cls = engine._pick(classes, name, "component")
        pcls = getattr(cls, "params_class", None)
        raw = d.get("params", {})
        from ..controller.params import parse_params

        return (name, parse_params(pcls, raw) if pcls is not None else (raw or None))

    algo_pairs = []
    for d in json.loads(instance.algorithms_params or "[]"):
        name = d.get("name", "")
        cls = engine._pick(engine.algorithm_classes, name, "algorithm")
        pcls = getattr(cls, "params_class", None)
        raw = d.get("params", {})
        from ..controller.params import parse_params

        algo_pairs.append((name, parse_params(pcls, raw) if pcls is not None else (raw or None)))

    return EngineParams(
        data_source_params=one(instance.data_source_params, engine.data_source_classes),
        preparator_params=one(instance.preparator_params, engine.preparator_classes),
        algorithm_params_list=tuple(algo_pairs),
        serving_params=one(instance.serving_params, engine.serving_classes),
    )
