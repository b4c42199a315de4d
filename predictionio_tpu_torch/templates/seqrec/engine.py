"""Sequential recommendation engine template on the port.

The port of ``templates/seqrec/engine.py``: the parameters, the query
and result types, ``TrainingData``, ``SeqDataSource`` (user-item events
of the context's event store, with their times), ``SeqPreparator``,
``SeqRecAlgorithm`` (``train`` builds each user's time-ordered history and
trains the causal-attention model of ``models/seq_attention.py`` on the
context's device; ``predict`` and ``batch_predict`` serve it through the
hand-written flash-attention kernel) and the engine factory.

Query:  {"user": "u1", "num": 4}
Result: {"itemScores": [{"item": "i1", "score": 3.2}, ...]}
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...controller import (Algorithm, DataSource, Engine, FirstServing,
                           Params, Preparator, SanityCheck)
from ...models.seq_attention import (SeqRecConfig, SeqRecModel,
                                     build_sequences, train_seq_rec)


@dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = "MyApp"
    event_names: tuple = ("view", "buy", "rate")


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


class SeqDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx) -> TrainingData:
        frame = ctx.event_store().find_frame(
            app_name=self.params.app_name,
            entity_type="user",
            event_names=tuple(self.params.event_names),
            target_entity_type="item",
        )
        has_target = np.asarray(
            [t is not None for t in frame.target_entity_id], dtype=bool
        )
        frame = frame.select(has_target)
        return TrainingData(frame.entity_id, frame.target_entity_id,
                            frame.event_time)


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
    """The seqrec engine: events from the event store, the causal-attention
    model, top-k serving."""
    return Engine(
        data_source_classes=SeqDataSource,
        preparator_classes=SeqPreparator,
        algorithm_classes={"seqrec": SeqRecAlgorithm},
        serving_classes=FirstServing,
    )
