"""The Engine: a named registry of DASE components.

Analog of the reference ``Engine`` (reference: core/src/main/scala/io/
prediction/controller/Engine.scala:78-784): holds maps of named
datasource/preparator/algorithm/serving classes and builds them from
engine params.

Copied from ``predictionio_tpu/controller/engine.py``: the registry, the
``make_*`` component constructors, ``Engine.train`` (read, sanity check,
prepare, train each algorithm) with its stop-after exceptions,
``engine_params_from_json`` and ``TrainResult``. ``Engine.eval`` comes with
the evaluation slice of the port.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Generic, Mapping, TypeVar

from .components import (Algorithm, DataSource, Doer, Preparator,
                         SanityCheck, Serving)
from .params import EngineParams, parse_params

log = logging.getLogger("predictionio_tpu_torch.engine")

TD = TypeVar("TD")
EI = TypeVar("EI")
PD = TypeVar("PD")
Q = TypeVar("Q")
P = TypeVar("P")
A = TypeVar("A")

__all__ = ["Engine", "StopAfterPrepareInterruption",
           "StopAfterReadInterruption", "TrainResult"]


def _params_class_of(cls: type) -> type | None:
    return getattr(cls, "params_class", None)


def _maybe_sanity_check(obj: Any, skip: bool, what: str) -> None:
    """(reference Engine.scala:610-666)"""
    if skip:
        return
    if isinstance(obj, SanityCheck):
        log.info("%s supports data sanity check. Performing check.", what)
        obj.sanity_check()


@dataclasses.dataclass
class TrainResult:
    """Models plus the component instances that made them (the deploy path
    needs the algorithm instances for predict)."""

    models: list[Any]
    algorithms: list[Algorithm]
    serving: Serving
    algorithm_names: list[str]


class Engine(Generic[TD, EI, PD, Q, P, A]):
    """DASE container. ``*_classes`` map component names ("" = default) to
    classes (reference Engine.scala:78-133's four class maps)."""

    def __init__(
        self,
        data_source_classes: Mapping[str, type] | type,
        preparator_classes: Mapping[str, type] | type,
        algorithm_classes: Mapping[str, type] | type,
        serving_classes: Mapping[str, type] | type,
    ):
        def as_map(x) -> dict[str, type]:
            return {"": x} if isinstance(x, type) else dict(x)

        self.data_source_classes = as_map(data_source_classes)
        self.preparator_classes = as_map(preparator_classes)
        self.algorithm_classes = as_map(algorithm_classes)
        self.serving_classes = as_map(serving_classes)

    # -- component instantiation -----------------------------------------
    def _pick(self, classes: Mapping[str, type], name: str, role: str) -> type:
        if name in classes:
            return classes[name]
        if name == "" and len(classes) == 1:
            return next(iter(classes.values()))
        raise KeyError(
            f"{role} {name!r} not found; available: {sorted(classes)}"
        )

    def make_data_source(self, ep: EngineParams) -> DataSource:
        name, params = ep.data_source_params
        return Doer(self._pick(self.data_source_classes, name, "datasource"), params)

    def make_preparator(self, ep: EngineParams) -> Preparator:
        name, params = ep.preparator_params
        return Doer(self._pick(self.preparator_classes, name, "preparator"), params)

    def make_algorithms(self, ep: EngineParams) -> tuple[list[str], list[Algorithm]]:
        names, algos = [], []
        for name, params in ep.algorithm_params_list or (("", None),):
            names.append(name)
            algos.append(Doer(self._pick(self.algorithm_classes, name, "algorithm"), params))
        return names, algos

    def make_serving(self, ep: EngineParams) -> Serving:
        name, params = ep.serving_params
        return Doer(self._pick(self.serving_classes, name, "serving"), params)

    # -- training (object Engine.train, Engine.scala:583-670) -------------
    def train(self, ctx, engine_params: EngineParams) -> TrainResult:
        wp = getattr(ctx, "workflow_params", None)
        skip_sanity = bool(getattr(wp, "skip_sanity_check", False))
        stop_after_read = bool(getattr(wp, "stop_after_read", False))
        stop_after_prepare = bool(getattr(wp, "stop_after_prepare", False))

        from ..workflow.tracing import phase_timer

        data_source = self.make_data_source(engine_params)
        with phase_timer(ctx, "datasource.read_training"):
            td = data_source.read_training(ctx)
        _maybe_sanity_check(td, skip_sanity, "TrainingData")
        if stop_after_read:
            log.info("Stopping here because --stop-after-read is set.")
            raise StopAfterReadInterruption()

        preparator = self.make_preparator(engine_params)
        with phase_timer(ctx, "preparator.prepare"):
            pd = preparator.prepare(ctx, td)
        _maybe_sanity_check(pd, skip_sanity, "PreparedData")
        if stop_after_prepare:
            log.info("Stopping here because --stop-after-prepare is set.")
            raise StopAfterPrepareInterruption()

        names, algos = self.make_algorithms(engine_params)
        models = []
        for i, (name, algo) in enumerate(zip(names, algos)):
            log.info("Training algorithm %r (%s)", name, type(algo).__name__)
            with phase_timer(ctx, f"train[{name or type(algo).__name__}#{i}]"):
                m = algo.train(ctx, pd)
            _maybe_sanity_check(m, skip_sanity, f"Model of {type(algo).__name__}")
            models.append(m)
        serving = self.make_serving(engine_params)
        return TrainResult(models, algos, serving, names)

    # -- engine.json parsing (Engine.jValueToEngineParams, :328-384) -------
    def engine_params_from_json(self, variant: Mapping[str, Any]) -> EngineParams:
        def one(key: str, classes: Mapping[str, type]) -> tuple[str, Any]:
            block = variant.get(key)
            if block is None:
                return ("", None)
            name = block.get("name", "")
            cls = self._pick(classes, name, key)
            pcls = _params_class_of(cls)
            raw = block.get("params", {})
            params = parse_params(pcls, raw) if pcls is not None else (raw or None)
            return (name, params)

        algo_list = []
        for block in variant.get("algorithms", []):
            name = block.get("name", "")
            cls = self._pick(self.algorithm_classes, name, "algorithm")
            pcls = _params_class_of(cls)
            raw = block.get("params", {})
            params = parse_params(pcls, raw) if pcls is not None else (raw or None)
            algo_list.append((name, params))

        return EngineParams(
            data_source_params=one("datasource", self.data_source_classes),
            preparator_params=one("preparator", self.preparator_classes),
            algorithm_params_list=tuple(algo_list),
            serving_params=one("serving", self.serving_classes),
        )


class StopAfterReadInterruption(Exception):
    """(reference WorkflowParams.stopAfterRead flow, Engine.scala:617-621)"""


class StopAfterPrepareInterruption(Exception):
    """(Engine.scala:633-638)"""
