"""Recommendation engine template on the port.

The port of ``templates/recommendation/engine.py``: the parameters, the
query and result types, ``TrainingData``, ``RecommendationDataSource``
(``rate`` and ``buy`` events of the context's event store become
``Ratings``), ``RecommendationPreparator``, ``ALSAlgorithm`` (``train``
runs blocked WALS through ``models/als.py::train_als`` on the context's
device, with the context's checkpointer; ``predict`` and
``batch_predict`` serve the factors through the hand-written top-k
kernel) and the engine factory. The evaluation half (``read_eval``, the
metric and the params grid) comes with the evaluation slice.

Query:  {"user": "u1", "num": 4}
Result: {"itemScores": [{"item": "i1", "score": 3.2}, ...]}
"""

from __future__ import annotations

from dataclasses import dataclass

from ...controller import (Algorithm, DataSource, Engine, FirstServing,
                           Params, Preparator, SanityCheck)
from ...models.als import ALSConfig, ALSModel, train_als
from ...storage.frame import Ratings


@dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = "MyApp"


@dataclass(frozen=True)
class AlgorithmParams(Params):
    """(reference ALSAlgorithm.scala:96-120: rank, numIterations, lambda, seed)"""

    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    seed: int = 3


@dataclass(frozen=True)
class Query:
    user: str
    num: int = 10


@dataclass(frozen=True)
class ItemScore:
    item: str
    score: float


@dataclass(frozen=True)
class PredictedResult:
    itemScores: tuple = ()


class TrainingData(SanityCheck):
    def __init__(self, ratings: Ratings):
        self.ratings = ratings

    def sanity_check(self) -> None:
        if len(self.ratings) == 0:
            raise ValueError(
                "No rate/buy events found. Import data before training "
                "(reference DataSource error path)."
            )


class RecommendationDataSource(DataSource):
    """Reads rate (explicit rating property) and buy (implicit 4.0) events
    (reference DataSource.scala:25-54)."""

    params_class = DataSourceParams

    def _ratings(self, ctx) -> Ratings:
        store = ctx.event_store()
        frame = store.find_frame(
            app_name=self.params.app_name,
            entity_type="user",
            event_names=("rate", "buy"),
            target_entity_type="item",
        )

        def rating_of(name, props):
            if name == "rate":
                v = props.get("rating")
                return float(v) if v is not None else None
            return 4.0  # "buy" treated as rating 4 (reference :45-49)

        return frame.to_ratings(rating_of=rating_of)

    def read_training(self, ctx) -> TrainingData:
        return TrainingData(self._ratings(ctx))


class RecommendationPreparator(Preparator):
    def prepare(self, ctx, td: TrainingData) -> Ratings:
        return td.ratings


class ALSAlgorithm(Algorithm):
    params_class = AlgorithmParams
    query_class = Query

    def als_config(self) -> ALSConfig:
        """The exact ALSConfig ``train`` uses."""
        return ALSConfig(
            rank=self.params.rank,
            iterations=self.params.num_iterations,
            lambda_=self.params.lambda_,
            seed=self.params.seed,
        )

    def train(self, ctx, ratings: Ratings) -> ALSModel:
        return train_als(
            ratings, self.als_config(), device=getattr(ctx, "device", None),
            checkpointer=ctx.checkpointer("als"),
            checkpoint_every=ctx.checkpoint_every,
        )

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        recs = model.recommend_products(query.user, query.num)
        return PredictedResult(
            itemScores=tuple(ItemScore(item=i, score=s) for i, s in recs)
        )

    def batch_predict(self, model: ALSModel, queries) -> list:
        """Micro-batched serving: one kernel call for the whole batch (the
        dispatcher in workflow/microbatch.py feeds this)."""
        recs = model.batch_recommend([q.user for _, q in queries],
                                     [q.num for _, q in queries])
        return [
            (i, PredictedResult(itemScores=tuple(
                ItemScore(item=t, score=s) for t, s in rec)))
            for (i, _q), rec in zip(queries, recs)
        ]


def engine_factory() -> Engine:
    """The recommendation engine: events from the event store, blocked
    WALS, top-k serving."""
    return Engine(
        data_source_classes=RecommendationDataSource,
        preparator_classes=RecommendationPreparator,
        algorithm_classes={"als": ALSAlgorithm},
        serving_classes=FirstServing,
    )
