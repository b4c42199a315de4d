"""Sequential recommendation engine template on the port.

The port of ``templates/seqrec/engine.py``: the algorithm parameters, the
query and result types, ``TrainingData``, ``SeqPreparator``,
``SeqRecAlgorithm`` (``train`` builds each user's time-ordered history and
trains the causal-attention model of ``models/seq_attention.py`` on the
context's device; ``predict`` and ``batch_predict`` serve it through the
hand-written flash-attention kernel) and the engine factory. The data
source reads the event store, which comes with the storage slice: until
then a caller registers a ``DataSource`` of its own that returns
``TrainingData`` (``engine.data_source_classes``), or builds a model with
``convert.seqrec_model_from_numpy``.

Query:  {"user": "u1", "num": 4}
Result: {"itemScores": [{"item": "i1", "score": 3.2}, ...]}
"""

from __future__ import annotations

from dataclasses import dataclass

from ...controller import (Algorithm, Engine, FirstServing, Params,
                           Preparator, SanityCheck)
from ...models.seq_attention import (SeqRecConfig, SeqRecModel,
                                     build_sequences, train_seq_rec)


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


class TrainingData(SanityCheck):
    """Interaction events as parallel arrays: user ids, item ids and event
    times (float epoch seconds)."""

    def __init__(self, users, items, times):
        self.users = users
        self.items = items
        self.times = times

    def sanity_check(self) -> None:
        if len(self.users) == 0:
            raise ValueError("No interaction events found; import data first.")


class SeqPreparator(Preparator):
    def prepare(self, ctx, td: TrainingData) -> TrainingData:
        return td


class SeqRecAlgorithm(Algorithm):
    params_class = AlgorithmParams
    query_class = Query

    def train(self, ctx, td: TrainingData) -> SeqRecModel:
        p = self.params
        cfg = SeqRecConfig(
            max_len=p.max_len, embed_dim=p.embed_dim, num_heads=p.num_heads,
            num_blocks=p.num_blocks, epochs=p.epochs, batch_size=p.batch_size,
            lr=p.lr, seq_parallel=p.seq_parallel, seed=p.seed,
        )
        seqs, uids, iids = build_sequences(
            td.users, td.items, td.times, max_len=cfg.max_len
        )
        return train_seq_rec(seqs, uids, iids, cfg,
                             device=getattr(ctx, "device", None))

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
    """The seqrec engine. Its data source reads the event store, which comes
    with the storage slice; until then the data-source map is empty and a
    caller registers its own."""
    return Engine(
        data_source_classes={},
        preparator_classes=SeqPreparator,
        algorithm_classes={"seqrec": SeqRecAlgorithm},
        serving_classes=FirstServing,
    )
