"""Storage layer: events, metadata, models — the L1 of the framework.

Mirrors the capability of the reference's ``data/.../storage`` package
(Storage SPI + HBase/ES/MongoDB/localfs backends) with in-process,
sqlite and filesystem backends behind the same repository registry.

Copied from ``predictionio_tpu/storage/__init__.py``; the port imports
nothing of the JAX package. Two modules of the reference are not here
yet: ``journal`` (the event server's write-ahead journal) comes with the
event server, and ``backup`` with the fleet and recovery tools.
"""

from .aggregate import (EventOp, aggregate_properties,
                        aggregate_properties_frame,
                        aggregate_properties_single)
from .bimap import BiMap, string_int_bimap
from .datamap import DataMap, DataMapError, PropertyMap
from .event import (
    Event,
    SPECIAL_EVENTS,
    ValidationError,
    event_from_api_dict,
    event_from_json,
    event_to_api_dict,
    event_to_json,
    validate_event,
)
from .events_base import ANY, EventBackend, EventQuery, StorageError, TableNotInitialized
from .frame import EventFrame, Ratings
from .memory import MemoryEvents
from .partition import entity_key, hash64, iter_host_shard, partition_events, shard_of
from .metadata import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EngineManifest,
    EvaluationInstance,
    MetadataStore,
    Model,
)
from .registry import Storage
from .sqlite import SQLiteEvents

__all__ = [
    "ANY", "AccessKey", "App", "BiMap", "Channel", "DataMap", "DataMapError",
    "EngineInstance", "EngineManifest", "EvaluationInstance", "Event",
    "EventBackend", "EventFrame", "EventOp", "EventQuery",
    "MemoryEvents", "MetadataStore", "Model", "PropertyMap",
    "Ratings", "SPECIAL_EVENTS", "SQLiteEvents", "Storage", "StorageError",
    "TableNotInitialized", "ValidationError",
    "aggregate_properties", "aggregate_properties_frame",
    "aggregate_properties_single",
    "event_from_api_dict", "event_from_json", "event_to_api_dict",
    "entity_key", "hash64", "iter_host_shard", "partition_events", "shard_of",
    "event_to_json", "string_int_bimap", "validate_event",
]
