"""Recommendation engine template on the port.

The port of ``templates/recommendation/engine.py``: the algorithm
parameters, the query and result types, ``TrainingData``,
``RecommendationPreparator``, ``ALSAlgorithm`` (``train`` runs blocked
WALS through ``models/als.py::train_als`` on the context's device, with
the context's checkpointer; ``predict`` and ``batch_predict`` serve the
factors through the hand-written top-k kernel) and the engine factory.
The data source reads the event store, which comes with the storage
slice: until then a caller registers a ``DataSource`` of its own that
returns ``TrainingData`` (``engine.data_source_classes``), or builds a
model with ``convert.als_model_from_numpy``.

Query:  {"user": "u1", "num": 4}
Result: {"itemScores": [{"item": "i1", "score": 3.2}, ...]}
"""

from __future__ import annotations

from dataclasses import dataclass

from ...controller import (Algorithm, Engine, FirstServing, Params,
                           Preparator, SanityCheck)
from ...models.als import ALSConfig, ALSModel, train_als
from ...storage.frame import Ratings


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
    """The recommendation engine. Its data source reads the event store,
    which comes with the storage slice; until then the data-source map is
    empty and a caller registers its own."""
    return Engine(
        data_source_classes={},
        preparator_classes=RecommendationPreparator,
        algorithm_classes={"als": ALSAlgorithm},
        serving_classes=FirstServing,
    )
