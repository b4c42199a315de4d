"""Sequential recommendation engine template — serving on the port.

The port of ``templates/seqrec/engine.py``'s serving half: the algorithm
parameters, the query and result types, ``SeqRecAlgorithm.predict`` and
``batch_predict``, and the engine factory. A causal-attention model
(``models/seq_attention.py``) predicts each user's next item through the
hand-written flash-attention kernel. ``SeqRecAlgorithm.train`` comes with
the seqrec training slice; until then a model reaches the template through
``convert.seqrec_model_from_numpy``.

Query:  {"user": "u1", "num": 4}
Result: {"itemScores": [{"item": "i1", "score": 3.2}, ...]}
"""

from __future__ import annotations

from dataclasses import dataclass

from ...controller import Algorithm, Engine, FirstServing, Params
from ...models.seq_attention import SeqRecModel


@dataclass(frozen=True)
class AlgorithmParams(Params):
    max_len: int = 64
    embed_dim: int = 48
    num_heads: int = 2
    num_blocks: int = 2
    epochs: int = 10
    batch_size: int = 256
    lr: float = 1e-3
    seq_parallel: bool = False
    seed: int = 0


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


class SeqRecAlgorithm(Algorithm):
    params_class = AlgorithmParams
    query_class = Query

    def train(self, ctx, td) -> SeqRecModel:
        raise NotImplementedError(
            "seqrec training is not ported yet; build the model with "
            "predictionio_tpu_torch.convert.seqrec_model_from_numpy")

    def predict(self, model: SeqRecModel, query: Query) -> PredictedResult:
        recs = model.recommend_products(query.user, query.num)
        return PredictedResult(
            itemScores=tuple(ItemScore(item=i, score=s) for i, s in recs)
        )

    def batch_predict(self, model: SeqRecModel, queries) -> list:
        """One forward pass for the whole micro-batch (the dispatcher in
        workflow/microbatch.py feeds this)."""
        recs = model.batch_recommend([q.user for _, q in queries],
                                     [q.num for _, q in queries])
        return [
            (i, PredictedResult(itemScores=tuple(
                ItemScore(item=t, score=s) for t, s in rec)))
            for (i, _q), rec in zip(queries, recs)
        ]


def engine_factory() -> Engine:
    """The serving engine. Its data source and preparator read the event
    store, which comes with the storage slice; the maps stay empty."""
    return Engine(
        data_source_classes={},
        preparator_classes={},
        algorithm_classes={"seqrec": SeqRecAlgorithm},
        serving_classes=FirstServing,
    )
