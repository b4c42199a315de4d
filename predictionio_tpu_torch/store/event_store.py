"""Event store facade — the app-*name*-based API engine templates call.

Analog of reference ``PEventStore``/``LEventStore`` (reference: data/src/
main/scala/io/prediction/data/store/PEventStore.scala:30-114,
LEventStore.scala:147-250): resolves app name -> (appId, channelId) via the
metadata store (store/Common.scala appNameToId) and delegates to the event
backend. One facade serves both roles; the "parallel" read returns a
columnar ``EventFrame`` ready for device sharding, the "local" reads
return iterators (used on the serving hot path, e.g. the ecommerce
template's seen-events filter).

Copied from ``predictionio_tpu/store/event_store.py``; the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from datetime import datetime
from typing import Any, Iterator, Sequence


from ..storage import EventQuery, PropertyMap, Storage
from ..storage.event import Event
from ..storage.events_base import ANY, StorageError
from ..storage.frame import EventFrame

__all__ = ["EventStore", "app_name_to_id"]


def _validate_host_shard(index: int, count: int) -> None:
    # validate BEFORE any single-host shortcut: a misconfigured launch
    # (e.g. (3, 1)) must fail loudly, not silently ingest the full stream
    # on several processes at once
    if count < 1 or not (0 <= index < count):
        raise ValueError(
            f"host_shard ({index}, {count}) invalid: need count >= 1 and "
            f"0 <= index < count")


def app_name_to_id(app_name: str, channel_name: str | None = None) -> tuple[int, int | None]:
    """(reference: data/.../store/Common.scala:31-56)"""
    meta = Storage.get_metadata()
    app = meta.app_get_by_name(app_name)
    if app is None:
        raise StorageError(f"Invalid app name {app_name!r}")
    if channel_name is None:
        return app.id, None
    for ch in meta.channel_get_by_appid(app.id):
        if ch.name == channel_name:
            return app.id, ch.id
    raise StorageError(f"Invalid channel name {channel_name!r} for app {app_name!r}")


class EventStore:
    """Facade bound (optionally) to a default app/channel from the Context."""

    def __init__(self, default_app_name: str | None = None,
                 default_channel_name: str | None = None):
        self._default_app = default_app_name
        self._default_channel = default_channel_name

    def _resolve(self, app_name: str | None, channel_name: str | None) -> tuple[int, int | None]:
        app = app_name or self._default_app
        if app is None:
            raise StorageError("no app name given and Context has no app binding")
        return app_name_to_id(app, channel_name or self._default_channel)

    # -- parallel reads (PEventStore.scala:54-114) -------------------------
    def find_frame(
        self,
        app_name: str | None = None,
        channel_name: str | None = None,
        *,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: Any = ANY,
        target_entity_id: Any = ANY,
        host_shard: tuple[int, int] | None = None,
    ) -> EventFrame:
        """Columnar scan for training (PEventStore.find analog).

        ``host_shard=(index, count)`` keeps only the entities hashing to
        this host's shard — the multi-host data-loading contract: each
        process of a ``jax.distributed`` job passes
        ``(process_index, process_count)`` and ingests a disjoint slice of
        the event stream with every entity's full history on one host
        (deterministic splitmix64 entity hash, the HBase row-key-prefix
        analog — storage/partition.py). Pass None on single-host.
        """
        app_id, channel_id = self._resolve(app_name, channel_name)
        query = EventQuery(
            app_id=app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            entity_id=entity_id,
            event_names=tuple(event_names) if event_names else None,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
        )
        if host_shard is not None:
            index, count = host_shard
            _validate_host_shard(index, count)
            if count > 1:
                # stream-filter BEFORE materializing columns: per-host
                # peak memory is this host's slice (+ one hash chunk),
                # not the full dataset
                from ..storage.partition import iter_host_shard

                events = Storage.get_events().find(query)
                return EventFrame.from_events(
                    iter_host_shard(events, index, count))
        return Storage.get_events().find_frame(query)

    def aggregate_properties(
        self,
        app_name: str | None = None,
        entity_type: str = "",
        channel_name: str | None = None,
        *,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        required: Sequence[str] | None = None,
    ) -> dict[str, PropertyMap]:
        """(PEventStore.aggregateProperties, PEventStore.scala:78-114)"""
        app_id, channel_id = self._resolve(app_name, channel_name)
        return Storage.get_events().aggregate_properties(
            app_id,
            entity_type=entity_type,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            required=required,
        )

    # -- local reads (LEventStore.scala:46-250; the serving hot path) ------
    def find(
        self,
        app_name: str | None = None,
        channel_name: str | None = None,
        *,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: Any = ANY,
        target_entity_id: Any = ANY,
        limit: int | None = None,
        latest: bool = True,
    ) -> Iterator[Event]:
        app_id, channel_id = self._resolve(app_name, channel_name)
        return Storage.get_events().find(
            EventQuery(
                app_id=app_id,
                channel_id=channel_id,
                start_time=start_time,
                until_time=until_time,
                entity_type=entity_type,
                entity_id=entity_id,
                event_names=tuple(event_names) if event_names else None,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id,
                limit=limit,
                reversed=latest,
            )
        )

    def find_by_entity(
        self,
        entity_type: str,
        entity_id: str,
        app_name: str | None = None,
        **kwargs,
    ) -> Iterator[Event]:
        """(LEventStore.findByEntity, LEventStore.scala:46-100)"""
        return self.find(
            app_name=app_name, entity_type=entity_type, entity_id=entity_id, **kwargs
        )
