"""Entity hash-sharding — the HBase row-key prefix, TPU-native.

The reference spreads event rows across HBase regions with an 8-byte MD5
prefix of ``entityType + "-" + entityId`` (reference: data/src/main/scala/
io/prediction/data/storage/hbase/HBEventsUtil.scala:74-134 ``RowKey``).
Here the same role — deterministic, uniform placement of an entity's
events onto a shard — is played by a 64-bit FNV-1a/splitmix64 hash,
computed by the native C++ kernel (``pio_hash64_batch``) when built, with
a bit-identical pure-Python fallback. Multi-host data loading partitions
event streams by ``shard_of(...) == host_index`` so every host ingests a
disjoint slice before ``device_put`` onto its local mesh slice.

Copied from ``predictionio_tpu/storage/partition.py``; the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from .. import native
from .event import Event

__all__ = ["entity_key", "hash64", "iter_host_shard", "partition_events", "shard_of"]

_M = 0xFFFFFFFFFFFFFFFF


def _fnv1a64(data: bytes, seed: int) -> int:
    h = 0xCBF29CE484222325 ^ seed
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & _M
    return int(native.splitmix64_np(np.array([h], dtype=np.uint64))[0])


def entity_key(entity_type: str, entity_id: str) -> bytes:
    """Same composition as the reference row key: type ‖ '-' ‖ id."""
    return f"{entity_type}-{entity_id}".encode()


def hash64(keys: Sequence[bytes] | Sequence[str], seed: int = 0) -> np.ndarray:
    """Batch 64-bit hashes; native kernel when available, else pure Python
    (identical output)."""
    out = native.hash64_batch(list(keys), seed)
    if out is not None:
        return out
    bs = [k.encode() if isinstance(k, str) else k for k in keys]
    return np.array([_fnv1a64(b, seed) for b in bs], dtype=np.uint64)


def shard_of(entity_type: str, entity_id: str, num_shards: int, seed: int = 0) -> int:
    return int(hash64([entity_key(entity_type, entity_id)], seed)[0] % num_shards)


def iter_host_shard(
    events: Iterable[Event], index: int, count: int, seed: int = 0,
    _chunk: int = 8192,
) -> Iterable[Event]:
    """Stream only the events whose entity hashes to shard ``index`` of
    ``count`` — chunked so the native batch hash does the work while peak
    memory stays one chunk, not the full stream."""
    if count < 1 or not (0 <= index < count):
        raise ValueError(f"invalid shard ({index}, {count})")
    buf: list[Event] = []

    def flush():
        hs = hash64([entity_key(e.entity_type, e.entity_id) for e in buf], seed)
        for e, h in zip(buf, hs):
            if int(h % np.uint64(count)) == index:
                yield e

    for e in events:
        buf.append(e)
        if len(buf) >= _chunk:
            yield from flush()
            buf = []
    if buf:
        yield from flush()


def partition_events(
    events: Iterable[Event], num_shards: int, seed: int = 0
) -> list[list[Event]]:
    """Split an event stream into ``num_shards`` disjoint lists by entity
    hash, keeping each entity's full history on one shard (the property a
    $set/$unset/$delete fold needs to run shard-locally — see
    storage/aggregate.py)."""
    evs = list(events)
    if not evs:
        return [[] for _ in range(num_shards)]
    hs = hash64([entity_key(e.entity_type, e.entity_id) for e in evs], seed)
    shards: list[list[Event]] = [[] for _ in range(num_shards)]
    for e, h in zip(evs, hs):
        shards[int(h % num_shards)].append(e)
    return shards
