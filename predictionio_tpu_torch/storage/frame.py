"""Columnar event batches — the device-feeding representation.

The reference moves events through training as ``RDD[Event]`` (JVM objects
shuffled between executors). A device framework wants events as contiguous
columns: ids reindexed to dense ints, times as float64 epochs, so a whole
training read is a handful of numpy arrays that go to the device in one
call. ``EventFrame`` is that representation;
``frame.to_ratings()`` is the one-liner that replaces the reference
templates' per-event ``map``s (e.g. examples/scala-parallel-recommendation/
custom-serving/src/main/scala/DataSource.scala:25-54).

Copied from ``predictionio_tpu/storage/frame.py``; the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime, timezone
from typing import Any, Callable, Iterable, Sequence

import numpy as np

from .bimap import BiMap
from .datamap import DataMap
from .event import Event

__all__ = ["EventFrame", "Ratings"]


@dataclass
class Ratings:
    """Dense-indexed (user, item, rating) triples plus the id maps —
    ready for sharded COO construction in the ALS path."""

    user_indices: np.ndarray  # int32 [n]
    item_indices: np.ndarray  # int32 [n]
    ratings: np.ndarray  # float32 [n]
    user_ids: BiMap  # str -> int
    item_ids: BiMap  # str -> int

    @property
    def num_users(self) -> int:
        return len(self.user_ids)

    @property
    def num_items(self) -> int:
        return len(self.item_ids)

    def __len__(self) -> int:
        return int(self.ratings.shape[0])

    @classmethod
    def from_triples(cls, users: Sequence[str], items: Sequence[str],
                     ratings: Sequence[float]) -> "Ratings":
        """String-id (user, item, rating) triples -> dense-indexed
        Ratings — the custom-datasource entry point (the reference's
        BiMap.stringInt reindex, BiMap.scala:72-126, for data that never
        went through the event store). Same vectorized reindex as
        ``EventFrame.to_ratings``."""
        u_map, uidx = BiMap.from_array(np.asarray(users, dtype=object))
        i_map, iidx = BiMap.from_array(np.asarray(items, dtype=object))
        return cls(
            user_indices=uidx.astype(np.int64),
            item_indices=iidx.astype(np.int64),
            ratings=np.asarray(ratings, np.float32),
            user_ids=u_map,
            item_ids=i_map,
        )


class EventFrame:
    """A batch of events in columnar (struct-of-arrays) form.

    String columns are object-dtype numpy arrays (zero-copy slicing,
    vectorized ``np.unique`` reindexing); times are float64 UTC epoch
    seconds; properties stay as a list of dicts (only touched by
    property-reading paths, which are not hot).
    """

    __slots__ = ("event", "entity_type", "entity_id", "target_entity_type",
                 "target_entity_id", "event_time", "properties")

    def __init__(
        self,
        event: np.ndarray,
        entity_type: np.ndarray,
        entity_id: np.ndarray,
        target_entity_type: np.ndarray,
        target_entity_id: np.ndarray,
        event_time: np.ndarray,
        properties: list[dict[str, Any]],
    ):
        self.event = event
        self.entity_type = entity_type
        self.entity_id = entity_id
        self.target_entity_type = target_entity_type
        self.target_entity_id = target_entity_id
        self.event_time = event_time
        self.properties = properties

    def __len__(self) -> int:
        return int(self.event.shape[0])

    @staticmethod
    def from_events(events: Iterable[Event]) -> "EventFrame":
        ev, et, ei, tt, ti, tm, pr = [], [], [], [], [], [], []
        for e in events:
            ev.append(e.event)
            et.append(e.entity_type)
            ei.append(e.entity_id)
            tt.append(e.target_entity_type)
            ti.append(e.target_entity_id)
            tm.append(e.event_time.timestamp())
            pr.append(e.properties.to_dict())
        return EventFrame(
            event=np.asarray(ev, dtype=object),
            entity_type=np.asarray(et, dtype=object),
            entity_id=np.asarray(ei, dtype=object),
            target_entity_type=np.asarray(tt, dtype=object),
            target_entity_id=np.asarray(ti, dtype=object),
            event_time=np.asarray(tm, dtype=np.float64),
            properties=pr,
        )

    def to_events(self) -> list[Event]:
        out = []
        for i in range(len(self)):
            out.append(
                Event(
                    event=self.event[i],
                    entity_type=self.entity_type[i],
                    entity_id=self.entity_id[i],
                    target_entity_type=self.target_entity_type[i],
                    target_entity_id=self.target_entity_id[i],
                    properties=DataMap.from_dict(self.properties[i]),
                    event_time=datetime.fromtimestamp(
                        float(self.event_time[i]), tz=timezone.utc
                    ),
                )
            )
        return out

    def select(self, mask: np.ndarray) -> "EventFrame":
        idx = np.nonzero(mask)[0]
        return EventFrame(
            event=self.event[idx],
            entity_type=self.entity_type[idx],
            entity_id=self.entity_id[idx],
            target_entity_type=self.target_entity_type[idx],
            target_entity_id=self.target_entity_id[idx],
            event_time=self.event_time[idx],
            properties=[self.properties[i] for i in idx],
        )

    def where_event(self, names: Sequence[str]) -> "EventFrame":
        return self.select(np.isin(self.event, list(names)))

    # -- dense reindexing (the BiMap/ALS path) ----------------------------
    def to_ratings(
        self,
        rating_of: Callable[[str, dict[str, Any]], float | None] | None = None,
        user_ids: BiMap | None = None,
        item_ids: BiMap | None = None,
        dedup_latest: bool = True,
    ) -> Ratings:
        """Vectorized events -> dense-indexed rating triples.

        ``rating_of(event_name, properties)`` returns the rating value or
        None to skip the event (default: ``properties["rating"]`` for
        "rate" events, 1.0 otherwise — the recommendation template's rule,
        reference DataSource.scala:31-49). When ``dedup_latest`` is set,
        duplicate (user, item) pairs keep the latest-by-event-time value
        (reference MLlibRating dedup in templates).
        """
        if rating_of is None:
            def rating_of(name: str, props: dict[str, Any]) -> float | None:
                if name == "rate":
                    v = props.get("rating")
                    return float(v) if v is not None else None
                return 1.0

        vals = np.empty(len(self), dtype=np.float64)
        keep = np.zeros(len(self), dtype=bool)
        for i in range(len(self)):
            if self.target_entity_id[i] is None:
                continue  # no target entity => not a (user, item) interaction
            r = rating_of(self.event[i], self.properties[i])
            if r is not None:
                vals[i] = r
                keep[i] = True
        idx = np.nonzero(keep)[0]
        users = self.entity_id[idx]
        items = self.target_entity_id[idx]
        times = self.event_time[idx]
        vals = vals[idx]

        if user_ids is None:
            user_ids, uidx = BiMap.from_array(users)
        else:
            uidx = user_ids.map_array(list(users))
        if item_ids is None:
            item_ids, iidx = BiMap.from_array(items)
        else:
            iidx = item_ids.map_array(list(items))
        valid = (uidx >= 0) & (iidx >= 0)
        uidx, iidx, vals, times = uidx[valid], iidx[valid], vals[valid], times[valid]

        if dedup_latest and len(vals):
            # stable sort by (pair, time); keep last per pair
            pair = uidx.astype(np.int64) * len(item_ids) + iidx
            order = np.lexsort((times, pair))
            pair_sorted = pair[order]
            last = np.ones(len(order), dtype=bool)
            last[:-1] = pair_sorted[1:] != pair_sorted[:-1]
            sel = order[last]
            sel.sort()
            uidx, iidx, vals = uidx[sel], iidx[sel], vals[sel]

        return Ratings(
            user_indices=uidx.astype(np.int32),
            item_indices=iidx.astype(np.int32),
            ratings=vals.astype(np.float32),
            user_ids=user_ids,
            item_ids=item_ids,
        )
