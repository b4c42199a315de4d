"""Typed JSON property bags.

``DataMap`` is the universal property container attached to every event and
aggregated entity — the analog of the reference's immutable json4s-backed
``DataMap`` (reference: data/src/main/scala/io/prediction/data/storage/
DataMap.scala:38-193) and ``PropertyMap`` (PropertyMap.scala:33).

Values are plain JSON-compatible Python values (str, int, float, bool, None,
list, dict). The map is immutable: mutating operations return new maps.

Copied from ``predictionio_tpu/storage/datamap.py``; the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import json
from datetime import datetime
from typing import Any, Iterable, Iterator, Mapping

__all__ = ["DataMap", "PropertyMap", "DataMapError"]


class DataMapError(KeyError):
    """Raised when a required field is missing or has the wrong type."""


_JSON_TYPES = (str, int, float, bool, list, dict, type(None))


def _check_json(value: Any) -> Any:
    if isinstance(value, datetime):
        return value.isoformat()
    if not isinstance(value, _JSON_TYPES):
        raise TypeError(f"DataMap values must be JSON-compatible, got {type(value)!r}")
    return value


class DataMap:
    """An immutable map of field name -> JSON value.

    Mirrors the accessor surface of the reference DataMap: ``get`` (required,
    raises on absence), ``get_opt`` (optional), ``get_or_else``, set-algebra
    ``union``/``difference`` (the reference's ``++``/``--``,
    DataMap.scala:134-145), and typed extraction.

    Deliberately NOT a ``collections.abc.Mapping``: ``get(name, cls)`` here
    is the reference's typed required accessor (raises on absence), which
    contradicts ``Mapping.get(key, default)`` — registering as a Mapping
    would hand that trap to any generic code. Iteration/len/`in`/`==dict`
    still work structurally.
    """

    __slots__ = ("_fields",)

    def __init__(self, fields: Mapping[str, Any] | None = None):
        self._fields: dict[str, Any] = dict(fields) if fields else {}

    # -- structural mapping protocol --------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._fields[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, key: object) -> bool:
        return key in self._fields

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return self._fields == dict(other)
        return NotImplemented

    def __hash__(self) -> int:  # stable enough for memo keys
        return hash(json.dumps(self._fields, sort_keys=True, default=str))

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"

    def keys(self):
        return self._fields.keys()

    def values(self):
        return self._fields.values()

    def items(self):
        return self._fields.items()

    # -- accessors --------------------------------------------------------
    @property
    def fields(self) -> dict[str, Any]:
        return dict(self._fields)

    def require(self, name: str) -> None:
        if name not in self._fields:
            raise DataMapError(f"The field {name} is required.")

    def contains(self, name: str) -> bool:
        return name in self._fields

    def get(self, name: str, cls: type | None = None) -> Any:
        """Required typed accessor. Raises ``DataMapError`` if absent or null.

        If ``cls`` is given, the value is coerced/validated to that type
        (int/float interconversion allowed, as JSON does not distinguish).
        """
        if cls is not None and not isinstance(cls, type):
            raise TypeError(
                "DataMap.get(name, cls) takes a type, not a default value; "
                "use get_or_else(name, default)"
            )
        self.require(name)
        value = self._fields[name]
        if value is None:
            raise DataMapError(f"The required field {name} cannot be null.")
        return _coerce(name, value, cls)

    def get_opt(self, name: str, cls: type | None = None) -> Any | None:
        if name not in self._fields or self._fields[name] is None:
            return None
        return _coerce(name, self._fields[name], cls)

    def get_or_else(self, name: str, default: Any) -> Any:
        value = self.get_opt(name)
        return default if value is None else value

    def get_string_list(self, name: str) -> list[str]:
        value = self.get(name, list)
        return [str(v) for v in value]

    def get_double(self, name: str) -> float:
        return float(self.get(name))

    # -- algebra (reference DataMap.scala:134-151) ------------------------
    def union(self, other: "DataMap | Mapping[str, Any]") -> "DataMap":
        merged = dict(self._fields)
        merged.update(dict(other))
        return DataMap(merged)

    def __add__(self, other: "DataMap | Mapping[str, Any]") -> "DataMap":
        return self.union(other)

    def difference(self, keys: Iterable[str]) -> "DataMap":
        drop = set(keys)
        return DataMap({k: v for k, v in self._fields.items() if k not in drop})

    def __sub__(self, keys: Iterable[str]) -> "DataMap":
        return self.difference(keys)

    @property
    def is_empty(self) -> bool:
        return not self._fields

    def key_set(self) -> set[str]:
        return set(self._fields)

    # -- (de)serialization ------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return dict(self._fields)

    def to_json(self) -> str:
        return json.dumps(self._fields, sort_keys=True)

    @staticmethod
    def from_dict(d: Mapping[str, Any] | None) -> "DataMap":
        if d is None:
            return DataMap()
        return DataMap({k: _check_json(v) for k, v in d.items()})

    @staticmethod
    def from_json(s: str) -> "DataMap":
        parsed = json.loads(s)
        if not isinstance(parsed, dict):
            raise DataMapError(f"DataMap JSON must be an object, got {type(parsed)}")
        return DataMap(parsed)


def _coerce(name: str, value: Any, cls: type | None) -> Any:
    if cls is None:
        return value
    if cls is float and isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    if cls is int and isinstance(value, (int, float)) and not isinstance(value, bool):
        if isinstance(value, float) and not value.is_integer():
            raise DataMapError(f"Field {name}={value!r} is not an integer.")
        return int(value)
    if cls is datetime and isinstance(value, str):
        return datetime.fromisoformat(value)
    if not isinstance(value, cls):
        raise DataMapError(
            f"Field {name} has type {type(value).__name__}, expected {cls.__name__}."
        )
    return value


class PropertyMap(DataMap):
    """DataMap plus first/last update times — the output of ``$set``/``$unset``
    aggregation (reference: PropertyMap.scala:33-99).
    """

    __slots__ = ("first_updated", "last_updated")

    def __init__(
        self,
        fields: Mapping[str, Any] | None,
        first_updated: datetime,
        last_updated: datetime,
    ):
        super().__init__(fields)
        self.first_updated = first_updated
        self.last_updated = last_updated

    def __repr__(self) -> str:
        return (
            f"PropertyMap({self._fields!r}, firstUpdated={self.first_updated}, "
            f"lastUpdated={self.last_updated})"
        )

    def __eq__(self, other: object) -> bool:
        if isinstance(other, PropertyMap):
            return (
                self._fields == other._fields
                and self.first_updated == other.first_updated
                and self.last_updated == other.last_updated
            )
        return super().__eq__(other)

    __hash__ = DataMap.__hash__
