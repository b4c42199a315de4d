"""DASE component protocols: DataSource, Preparator, Algorithm, Serving.

The reference splits every role into P (parallel/RDD) and L (local)
variants plus P2L (reference: core/src/main/scala/io/prediction/controller/
{PDataSource,LDataSource,PPreparator,LPreparator,PAlgorithm,LAlgorithm,
P2LAlgorithm,LServing}.scala). That split exists because Spark draws a hard
line between RDDs and values local to the main process. JAX does not: training data is
host/device arrays either way, and "parallel" is a property of how an
algorithm's train step is sharded over the mesh, not of the data's type.
So there is ONE set of protocols; the P/L distinction that still matters —
whether a trained model can be serialized as-is or must be reconstructed at
deploy (PAlgorithm.makePersistentModel vs LAlgorithm, PAlgorithm.scala:
96-121) — is carried by ``Algorithm.persist_model`` + the
``PersistentModel`` protocol.

Every component takes its params object in ``__init__`` (the reference's
``Doer`` ctor contract, core/AbstractDoer.scala:280-306) and gets the
workflow ``Context`` (mesh, rng, workflow params — the SparkContext analog)
as the first argument of its work methods.

Copied from ``predictionio_tpu/controller/components.py``; the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import abc
from typing import Any, Generic, Sequence, TypeVar

TD = TypeVar("TD")  # training data
EI = TypeVar("EI")  # evaluation info
PD = TypeVar("PD")  # prepared data
Q = TypeVar("Q")  # query
P = TypeVar("P")  # predicted result
A = TypeVar("A")  # actual result
M = TypeVar("M")  # model

__all__ = [
    "DataSource", "Preparator", "IdentityPreparator", "Algorithm", "Serving",
    "FirstServing", "AverageServing", "PersistentModel", "SanityCheck", "Doer",
]


class DataSource(abc.ABC, Generic[TD, EI, Q, A]):
    """Reads training and evaluation data from the event store
    (reference: controller/PDataSource.scala)."""

    def __init__(self, params: Any = None):
        self.params = params

    @abc.abstractmethod
    def read_training(self, ctx) -> TD:
        ...

    def read_eval(self, ctx) -> list[tuple[TD, EI, list[tuple[Q, A]]]]:
        """k evaluation folds: (training data, eval info, (query, actual)
        pairs) per fold (PDataSource.readEval, PDataSource.scala:48-70)."""
        return []


class Preparator(abc.ABC, Generic[TD, PD]):
    """TD -> PD transform (reference: controller/PPreparator.scala)."""

    def __init__(self, params: Any = None):
        self.params = params

    @abc.abstractmethod
    def prepare(self, ctx, td: TD) -> PD:
        ...


class IdentityPreparator(Preparator[TD, TD]):
    """Pass-through (reference: controller/IdentityPreparator.scala)."""

    def prepare(self, ctx, td: TD) -> TD:
        return td


class Algorithm(abc.ABC, Generic[PD, M, Q, P]):
    """Train on prepared data; predict per query
    (reference: controller/PAlgorithm.scala:45-121).

    ``train`` should build jit/pjit-compiled steps internally and return a
    model pytree (device or host arrays). ``predict`` must be cheap — it
    runs on the serving hot path.
    """

    def __init__(self, params: Any = None):
        self.params = params

    #: whether the model pytree is serialized into the model store after
    #: training. False = the reference's "parallel model persisted as Unit,
    #: retrain at deploy" path (Engine.scala:186-208) unless the model
    #: implements PersistentModel.
    persist_model: bool = True

    @abc.abstractmethod
    def train(self, ctx, pd: PD) -> M:
        ...

    @abc.abstractmethod
    def predict(self, model: M, query: Q) -> P:
        ...

    def batch_predict(self, model: M, queries: Sequence[tuple[int, Q]]) -> list[tuple[int, P]]:
        """Indexed batch prediction for evaluation (PAlgorithm.batchPredict,
        PAlgorithm.scala:59-72). Override with a vectorized/vmapped version
        where possible; the default maps ``predict``."""
        return [(i, self.predict(model, q)) for i, q in queries]


class Serving(abc.ABC, Generic[Q, P]):
    """Combine per-algorithm predictions into the served result
    (reference: controller/LServing.scala)."""

    def __init__(self, params: Any = None):
        self.params = params

    @abc.abstractmethod
    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        ...


class FirstServing(Serving[Q, P]):
    """Head of the list (reference: controller/LFirstServing.scala)."""

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        return predictions[0]


class AverageServing(Serving[Q, float]):
    """Mean of numeric predictions (reference: controller/LAverageServing.scala)."""

    def serve(self, query: Q, predictions: Sequence[float]) -> float:
        return sum(predictions) / len(predictions)


class PersistentModel(abc.ABC):
    """User-controlled model persistence (reference: controller/
    PersistentModel.scala): ``save`` returns True if stored; the companion
    ``load`` classmethod rehydrates at deploy."""

    @abc.abstractmethod
    def save(self, instance_id: str, params: Any) -> bool:
        ...

    @classmethod
    @abc.abstractmethod
    def load(cls, instance_id: str, params: Any, ctx) -> "PersistentModel":
        ...


class LocalFileSystemPersistentModel(PersistentModel):
    """Pickle-to-disk PersistentModel helper (reference: controller/
    LocalFileSystemPersistentModel.scala saves via the local FS; here the
    path is ``$PIO_HOME/pmodels/<class>-<instance_id>.pkl``).

    Trust model: ``load`` unpickles, and unpickling executes code — the
    same assumption the reference makes Kryo-deserializing MODELDATA
    blobs (CreateServer.scala:61-75): the model store is as trusted as
    the code deploying it. The pmodels directory is created 0o700 so
    other local users cannot plant a model file; do not point PIO_HOME at
    storage writable by less-trusted principals."""

    @classmethod
    def _path(cls, instance_id: str):
        from ..storage.registry import Storage

        d = Storage.home() / "pmodels"
        d.mkdir(parents=True, exist_ok=True, mode=0o700)
        return d / f"{cls.__name__}-{instance_id}.pkl"

    def save(self, instance_id: str, params: Any) -> bool:
        import pickle

        with open(self._path(instance_id), "wb") as f:
            pickle.dump(self, f)
        return True

    @classmethod
    def load(cls, instance_id: str, params: Any, ctx) -> "LocalFileSystemPersistentModel":
        import pickle

        with open(cls._path(instance_id), "rb") as f:
            return pickle.load(f)


class CustomQuerySerializer:
    """Opt-in query-decoding override (reference: controller/
    CustomQuerySerializer.scala lets engines register json4s serializers
    for exotic query shapes). An Algorithm defining ``decode_query(self,
    query_json) -> Q`` takes over JSON->Query conversion on the serving
    hot path instead of the default dataclass parse.

    Deliberately a pure marker with NO default ``decode_query``: the
    server detects the hook with getattr, and an inherited always-raising
    stub would turn a forgotten override into a serving outage instead of
    the default parse."""


class SanityCheck(abc.ABC):
    """Opt-in data sanity hook called on TD/PD/models during train
    (reference: controller/SanityCheck.scala; invoked Engine.scala:610-666)."""

    @abc.abstractmethod
    def sanity_check(self) -> None:
        """Raise on broken data."""


def Doer(cls: type, params: Any):
    """Instantiate a component with params, or without if it takes none —
    the reference's reflective two-ctor protocol (AbstractDoer.scala:280-306)
    reduced to a try-params-first call."""
    if params is None:
        try:
            return cls()
        except TypeError:
            return cls(None)
    return cls(params)
