"""The universal event schema and its validation rules.

Analog of the reference's ``Event`` case class and ``EventValidation``
(reference: data/src/main/scala/io/prediction/data/storage/Event.scala:37-115).

Every interaction recorded by the framework — a rating, a page view, a
``$set`` of entity properties — is one ``Event``. Events are immutable;
the event store assigns ``event_id`` at insert time.

Copied from ``predictionio_tpu/storage/event.py``; the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import copy
import json
import uuid
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Mapping, Sequence

from .datamap import DataMap

__all__ = [
    "Event",
    "ValidationError",
    "validate_event",
    "event_to_api_dict",
    "event_from_api_dict",
    "SPECIAL_EVENTS",
]

#: Single-entity reserved events (Event.scala:68).
SPECIAL_EVENTS = frozenset({"$set", "$unset", "$delete"})

#: Built-in entity types allowed despite the reserved prefix (Event.scala:106).
BUILTIN_ENTITY_TYPES = frozenset({"pio_pr"})


class ValidationError(ValueError):
    """An event failed schema validation."""


def _utcnow() -> datetime:
    return datetime.now(timezone.utc)


@dataclass(frozen=True)
class Event:
    """One immutable event record. Field names follow the REST API's JSON
    (camelCase on the wire; snake_case here)."""

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: str | None = None
    target_entity_id: str | None = None
    properties: DataMap = field(default_factory=DataMap)
    event_time: datetime = field(default_factory=_utcnow)
    tags: Sequence[str] = ()
    pr_id: str | None = None
    event_id: str | None = None
    creation_time: datetime = field(default_factory=_utcnow)

    def with_id(self, event_id: str | None = None) -> "Event":
        # copy + setattr instead of dataclasses.replace: replace() rebuilds
        # the full kwargs dict and re-runs __post_init__ validation the
        # source event already passed — ~7x slower on the bulk-import path
        # where every parsed event gets an id stamped
        new = copy.copy(self)
        object.__setattr__(new, "event_id", event_id or uuid.uuid4().hex)
        return new

    def __post_init__(self):
        if self.event_time.tzinfo is None:
            object.__setattr__(
                self, "event_time", self.event_time.replace(tzinfo=timezone.utc)
            )
        if self.creation_time.tzinfo is None:
            object.__setattr__(
                self, "creation_time", self.creation_time.replace(tzinfo=timezone.utc)
            )
        if not isinstance(self.properties, DataMap):
            object.__setattr__(self, "properties", DataMap.from_dict(self.properties))


def is_reserved_prefix(name: str) -> bool:
    return name.startswith("$") or name.startswith("pio_")


def validate_event(e: Event) -> None:
    """Enforce the reference's validation rules (Event.scala:70-115):
    non-empty names, paired target entity, reserved ``$``/``pio_`` prefixes,
    non-empty properties for ``$unset``, no target on special events.
    """
    def check(cond: bool, msg: str) -> None:
        if not cond:
            raise ValidationError(msg)

    check(bool(e.event), "event must not be empty.")
    check(bool(e.entity_type), "entityType must not be empty string.")
    check(bool(e.entity_id), "entityId must not be empty string.")
    check(e.target_entity_type != "", "targetEntityType must not be empty string")
    check(e.target_entity_id != "", "targetEntityId must not be empty string.")
    check(
        (e.target_entity_type is None) == (e.target_entity_id is None),
        "targetEntityType and targetEntityId must be specified together.",
    )
    check(
        not (e.event == "$unset" and e.properties.is_empty),
        "properties cannot be empty for $unset event",
    )
    check(
        not is_reserved_prefix(e.event) or e.event in SPECIAL_EVENTS,
        f"{e.event} is not a supported reserved event name.",
    )
    check(
        e.event not in SPECIAL_EVENTS
        or (e.target_entity_type is None and e.target_entity_id is None),
        f"Reserved event {e.event} cannot have targetEntity",
    )
    check(
        not is_reserved_prefix(e.entity_type) or e.entity_type in BUILTIN_ENTITY_TYPES,
        f"The entityType {e.entity_type} is not allowed. "
        "'pio_' is a reserved name prefix.",
    )
    if e.target_entity_type is not None:
        check(
            not is_reserved_prefix(e.target_entity_type)
            or e.target_entity_type in BUILTIN_ENTITY_TYPES,
            f"The targetEntityType {e.target_entity_type} is not allowed. "
            "'pio_' is a reserved name prefix.",
        )
    for k in e.properties.key_set():
        check(
            not is_reserved_prefix(k),
            f"The property {k} is not allowed. 'pio_' is a reserved name prefix.",
        )


# ---------------------------------------------------------------------------
# Wire format — the REST API JSON shape (reference: EventJson4sSupport.scala
# APISerializer, data/.../storage/EventJson4sSupport.scala:40-130).
# ---------------------------------------------------------------------------

def _dt_to_wire(t: datetime) -> str:
    return t.astimezone(timezone.utc).isoformat().replace("+00:00", "Z")


def _dt_from_wire(s: str) -> datetime:
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    t = datetime.fromisoformat(s)
    if t.tzinfo is None:
        t = t.replace(tzinfo=timezone.utc)
    return t


def event_to_api_dict(e: Event) -> dict[str, Any]:
    d: dict[str, Any] = {
        "event": e.event,
        "entityType": e.entity_type,
        "entityId": e.entity_id,
        "properties": e.properties.to_dict(),
        "eventTime": _dt_to_wire(e.event_time),
        "creationTime": _dt_to_wire(e.creation_time),
    }
    if e.event_id is not None:
        d["eventId"] = e.event_id
    if e.target_entity_type is not None:
        d["targetEntityType"] = e.target_entity_type
        d["targetEntityId"] = e.target_entity_id
    if e.tags:
        d["tags"] = list(e.tags)
    if e.pr_id is not None:
        d["prId"] = e.pr_id
    return d


def event_from_api_dict(d: Mapping[str, Any]) -> Event:
    try:
        event = d["event"]
        entity_type = d["entityType"]
        entity_id = d["entityId"]
    except KeyError as err:
        raise ValidationError(f"field {err.args[0]} is required") from err
    for name in ("event", "entityType", "entityId"):
        if not isinstance(d[name], str):
            raise ValidationError(f"field {name} must be a string")
    for name in ("targetEntityType", "targetEntityId", "prId", "eventId"):
        if d.get(name) is not None and not isinstance(d[name], str):
            raise ValidationError(f"field {name} must be a string")
    tags = d.get("tags", ())
    if isinstance(tags, str) or not isinstance(tags, (list, tuple)):
        raise ValidationError("field tags must be a JSON array of strings")
    if any(not isinstance(t, str) for t in tags):
        raise ValidationError("field tags must be a JSON array of strings")
    props = d.get("properties", {})
    if not isinstance(props, Mapping):
        raise ValidationError("field properties must be a JSON object")
    kwargs: dict[str, Any] = {}
    for wire, attr in (("eventTime", "event_time"), ("creationTime", "creation_time")):
        if wire in d:
            try:
                kwargs[attr] = _dt_from_wire(d[wire])
            except (ValueError, TypeError) as err:
                raise ValidationError(f"field {wire} must be ISO8601: {err}") from err
    e = Event(
        event=event,
        entity_type=entity_type,
        entity_id=entity_id,
        target_entity_type=d.get("targetEntityType"),
        target_entity_id=d.get("targetEntityId"),
        properties=DataMap.from_dict(props),
        tags=tuple(d.get("tags", ())),
        pr_id=d.get("prId"),
        event_id=d.get("eventId"),
        **kwargs,
    )
    validate_event(e)
    return e


def event_to_json(e: Event) -> str:
    return json.dumps(event_to_api_dict(e), sort_keys=True)


def event_from_json(s: str) -> Event:
    return event_from_api_dict(json.loads(s))
