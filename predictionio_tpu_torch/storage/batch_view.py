"""Deprecated batch-view API kept for engine-code compatibility.

Analog of the reference's pre-0.9.2 ``LBatchView``/``PBatchView`` classes
(reference: data/src/main/scala/io/prediction/data/view/LBatchView.scala:
28-134, PBatchView.scala:34), which the reference itself ships
``@deprecated`` in favor of the event store + aggregation API. Provided so
ported engine code keeps running; new code should call
``EventStore.find``/``aggregate_properties`` directly.

Copied from ``predictionio_tpu/storage/batch_view.py``; the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from datetime import datetime
from typing import Any, Callable

from ..annotation import deprecated
from .aggregate import aggregate_properties
from .datamap import PropertyMap
from .event import Event
from .events_base import EventQuery
from .registry import Storage

__all__ = ["LBatchView", "PBatchView"]


class _BatchViewBase:
    def __init__(self, app_id: int, start_time: datetime | None = None,
                 until_time: datetime | None = None,
                 channel_id: int | None = None):
        self.app_id = app_id
        self.start_time = start_time
        self.until_time = until_time
        self.channel_id = channel_id

    def _events(self, entity_type: str | None = None) -> list[Event]:
        return list(Storage.get_events().find(EventQuery(
            app_id=self.app_id, channel_id=self.channel_id,
            start_time=self.start_time, until_time=self.until_time,
            entity_type=entity_type,
        )))

    # LBatchView.aggregateProperties (LBatchView.scala:94-107)
    def aggregate_properties(self, entity_type: str) -> dict[str, PropertyMap]:
        # entity_type filters at the store level, not over the full app
        return aggregate_properties(self._events(entity_type))

    # LBatchView.events + filtering convenience (LBatchView.scala:44-77)
    def events(self, predicate: Callable[[Event], bool] | None = None) -> list[Event]:
        evs = self._events()
        return [e for e in evs if predicate(e)] if predicate else evs

    # LBatchView.aggregateByEntityOrdered (LBatchView.scala:109-134)
    def aggregate_by_entity_ordered(
        self, predicate: Callable[[Event], bool],
        init: Any, op: Callable[[Any, Event], Any],
    ) -> dict[str, Any]:
        per_entity: dict[str, list[Event]] = {}
        for e in self.events(predicate):
            per_entity.setdefault(e.entity_id, []).append(e)
        out = {}
        for eid, evs in per_entity.items():
            acc = init
            for e in sorted(evs, key=lambda e: e.event_time):
                acc = op(acc, e)
            out[eid] = acc
        return out


@deprecated("use EventStore.find / aggregate_properties")
class LBatchView(_BatchViewBase):
    """Local (iterator-backed) batch view."""


@deprecated("use EventStore.find_frame / aggregate_properties")
class PBatchView(_BatchViewBase):
    """'Parallel' batch view — in the TPU build both views read the same
    columnar store; this alias mirrors the reference's P/L split."""
