"""Property aggregation: folding ``$set``/``$unset``/``$delete`` event
streams into per-entity ``PropertyMap``s.

Reference semantics (data/src/main/scala/io/prediction/data/storage/
LEventAggregator.scala:22-123 and PEventAggregator.scala:35-209):

- events are processed in ``event_time`` order per entity;
- ``$set`` merges properties (later wins per key);
- ``$unset`` removes the named keys (only if the entity currently exists);
- ``$delete`` erases the entity (it may be re-created by a later ``$set``);
- entities whose fold ends with no live DataMap are dropped;
- first/last updated times span all special events seen for the entity.

The parallel version in the reference is an ``aggregateByKey`` over a
commutative monoid (``EventOp ++``). Here the same monoid is implemented so
aggregation can run as an associative merge over event shards — the
host-side analog of a segment reduce — and is therefore safe to parallelize
over processes or to fold incrementally as events stream in.

Copied from ``predictionio_tpu/storage/aggregate.py``; the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Iterable, Iterator

import numpy as np

from .datamap import PropertyMap
from .event import Event

__all__ = ["EventOp", "aggregate_properties", "aggregate_properties_frame",
           "aggregate_properties_single"]


def _millis(t: datetime) -> float:
    return t.timestamp()


@dataclass
class _PropTime:
    value: Any
    t: float


@dataclass
class EventOp:
    """The aggregation monoid (reference PEventAggregator.scala:95-190).

    Tracks, independently: last-write-wins ``$set`` fields, latest ``$unset``
    time per key, latest ``$delete`` time, and first/last updated times.
    ``merge`` is associative and commutative, so shard-level partial
    aggregates combine in any order.
    """

    set_fields: dict[str, _PropTime] = field(default_factory=dict)
    set_t: float | None = None  # latest $set time (fields may be empty)
    unset_fields: dict[str, float] = field(default_factory=dict)
    delete_t: float | None = None
    first_updated: datetime | None = None
    last_updated: datetime | None = None

    @staticmethod
    def from_event(e: Event) -> "EventOp":
        op = EventOp()
        t = _millis(e.event_time)
        if e.event == "$set":
            op.set_fields = {k: _PropTime(v, t) for k, v in e.properties.items()}
            op.set_t = t
        elif e.event == "$unset":
            op.unset_fields = {k: t for k in e.properties.key_set()}
        elif e.event == "$delete":
            op.delete_t = t
        else:
            return op  # non-special events do not touch properties
        op.first_updated = e.event_time
        op.last_updated = e.event_time
        return op

    def merge(self, other: "EventOp") -> "EventOp":
        out = EventOp()
        # $set: per-key last-write-wins; ties broken deterministically on the
        # serialized value so merge stays commutative even at equal timestamps
        # (bulk imports often stamp a whole batch with one eventTime)
        out.set_fields = dict(self.set_fields)
        for k, pt in other.set_fields.items():
            cur = out.set_fields.get(k)
            if cur is None or pt.t > cur.t or (
                pt.t == cur.t and _value_key(pt.value) > _value_key(cur.value)
            ):
                out.set_fields[k] = pt
        out.set_t = _max_opt(self.set_t, other.set_t)
        # $unset: latest unset time per key
        out.unset_fields = dict(self.unset_fields)
        for k, t in other.unset_fields.items():
            out.unset_fields[k] = max(t, out.unset_fields.get(k, float("-inf")))
        out.delete_t = _max_opt(self.delete_t, other.delete_t)
        out.first_updated = _min_opt_dt(self.first_updated, other.first_updated)
        out.last_updated = _max_opt_dt(self.last_updated, other.last_updated)
        return out

    def to_property_map(self) -> PropertyMap | None:
        """Resolve the monoid into the final entity state (reference
        PEventAggregator.scala:150-190 ``toPropertyMap``)."""
        if self.set_t is None:
            return None
        if self.delete_t is not None and self.delete_t >= self.set_t:
            # entity deleted after (or at) the last $set
            return None
        fields: dict[str, Any] = {}
        for k, pt in self.set_fields.items():
            if self.delete_t is not None and self.delete_t >= pt.t:
                continue
            unset_t = self.unset_fields.get(k)
            if unset_t is not None and unset_t >= pt.t:
                continue
            fields[k] = pt.value
        assert self.first_updated is not None and self.last_updated is not None
        return PropertyMap(fields, self.first_updated, self.last_updated)


def _value_key(v: Any) -> str:
    import json

    return json.dumps(v, sort_keys=True, default=str)


def _max_opt(a: float | None, b: float | None) -> float | None:
    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)


def _min_opt_dt(a: datetime | None, b: datetime | None) -> datetime | None:
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)


def _max_opt_dt(a: datetime | None, b: datetime | None) -> datetime | None:
    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)


def aggregate_properties(events: Iterable[Event]) -> dict[str, PropertyMap]:
    """Fold special events into per-entity PropertyMaps
    (reference LEventAggregator.aggregateProperties, LEventAggregator.scala:24-44).
    Entities whose final state is deleted/never-set are dropped."""
    ops: dict[str, EventOp] = {}
    for e in events:
        if e.event not in ("$set", "$unset", "$delete"):
            continue
        op = EventOp.from_event(e)
        prev = ops.get(e.entity_id)
        ops[e.entity_id] = op if prev is None else prev.merge(op)
    out: dict[str, PropertyMap] = {}
    for entity_id, op in ops.items():
        pm = op.to_property_map()
        if pm is not None:
            out[entity_id] = pm
    return out


def aggregate_properties_single(events: Iterator[Event]) -> PropertyMap | None:
    """Single-entity variant (LEventAggregator.scala:46-64)."""
    acc: EventOp | None = None
    for e in events:
        if e.event not in ("$set", "$unset", "$delete"):
            continue
        op = EventOp.from_event(e)
        acc = op if acc is None else acc.merge(op)
    return acc.to_property_map() if acc is not None else None


def aggregate_properties_frame(frame) -> dict[str, PropertyMap]:
    """Columnar-input fold: ``aggregate_properties`` over an
    ``EventFrame`` (the train-side read pushdown).

    The pre-pass is vectorized — mask the special events, one stable
    numpy argsort groups each entity's rows contiguously, boundary
    detection yields the per-entity segments — so the Python loop runs
    once per ENTITY over plain floats/dicts instead of once per EVENT
    over ``Event``/``EventOp`` objects. The per-segment accumulation is
    the ``EventOp`` monoid inlined: identical comparisons (per-key
    last-write-wins with the ``_value_key`` tie-break, latest ``$unset``
    per key, latest ``$delete``, min/max updated times), so the result
    is bit-identical to folding ``EventOp.from_event``/``merge`` — the
    parity tests in tests/test_aggregate.py pin that.
    """
    if len(frame) == 0:
        return {}
    names = frame.event
    mask = (names == "$set") | (names == "$unset") | (names == "$delete")
    idx = np.nonzero(mask)[0]
    if idx.size == 0:
        return {}
    ids = frame.entity_id[idx]
    order = np.argsort(ids, kind="stable")
    sel = idx[order]
    sorted_ids = ids[order]
    bounds = np.nonzero(sorted_ids[1:] != sorted_ids[:-1])[0] + 1
    starts = np.concatenate(([0], bounds))
    ends = np.concatenate((bounds, [sorted_ids.size]))
    # plain-list views: per-event numpy scalar indexing in the fold loop
    # costs more than the fold itself at 200k events
    sel_l = sel.tolist()
    names_l = names.tolist()
    times_l = frame.event_time.tolist()
    props = frame.properties
    out: dict[str, PropertyMap] = {}
    inf = float("inf")
    for s0, s1 in zip(starts.tolist(), ends.tolist()):
        set_fields: dict[str, tuple[float, Any]] = {}  # k -> (t, value)
        set_t: float | None = None
        unset: dict[str, float] = {}
        delete_t: float | None = None
        first_t, last_t = inf, -inf
        for j in sel_l[s0:s1]:
            name = names_l[j]
            t = times_l[j]
            if name == "$set":
                for k, v in props[j].items():
                    cur = set_fields.get(k)
                    if cur is None or t > cur[0] or (
                        t == cur[0] and _value_key(v) > _value_key(cur[1])
                    ):
                        set_fields[k] = (t, v)
                set_t = t if set_t is None else max(set_t, t)
            elif name == "$unset":
                for k in props[j]:
                    prev = unset.get(k)
                    unset[k] = t if prev is None else max(prev, t)
            else:  # $delete
                delete_t = t if delete_t is None else max(delete_t, t)
            if t < first_t:
                first_t = t
            if t > last_t:
                last_t = t
        if set_t is None or (delete_t is not None and delete_t >= set_t):
            continue  # never set, or deleted after the last $set
        fields: dict[str, Any] = {}
        for k, (t, v) in set_fields.items():
            if delete_t is not None and delete_t >= t:
                continue
            ut = unset.get(k)
            if ut is not None and ut >= t:
                continue
            fields[k] = v
        out[sorted_ids[s0]] = PropertyMap(
            fields,
            datetime.fromtimestamp(first_t, tz=timezone.utc),
            datetime.fromtimestamp(last_t, tz=timezone.utc))
    return out
