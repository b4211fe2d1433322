"""Schema: typed field metadata + Python-native reflection (carried over
from knoxdb_tpu/schema/schema.py).

Fields carry a stable id, logical type, pk flag, index kind, per-field
pack filter (bloom/bits/bfuse), decimal scale and fixed byte width.
Schemas are built explicitly with Builder, or reflected from Python
dataclasses with typing annotations and per-field metadata (field_meta,
the analog of the upstream `knox:"..."` struct tag).
"""

from __future__ import annotations

import dataclasses
import datetime
import enum
from dataclasses import dataclass, field as dc_field
from typing import Any, get_type_hints

import numpy as np

from ..types import FieldType, FilterType, IndexType

__all__ = ["Field", "Schema", "Builder", "field_meta", "schema_of"]

# system/meta columns (reference pkg/schema/meta.go: $rid/$xmin/$xmax)
META_RID = "$rid"
META_XMIN = "$xmin"
META_XMAX = "$xmax"
META_FIELDS = (META_RID, META_XMIN, META_XMAX)


@dataclass(frozen=True)
class Field:
    name: str
    type: FieldType
    id: int = 0
    is_pk: bool = False
    index: IndexType = IndexType.NONE
    filter: FilterType = FilterType.NONE
    scale: int = 0          # decimal digits after the point
    fixed: int = 0          # fixed byte width for bytes/string (0 = var)
    is_meta: bool = False
    is_enum: bool = False
    enum_name: str = ""

    def __post_init__(self):
        # accept string kinds ("bfuse8", "bloom2b", ...) at the Builder API
        if isinstance(self.filter, str):
            s = self.filter.lower()
            if s and s not in _FILTER_NAMES:
                raise ValueError(f"field {self.name}: unknown pack filter "
                                 f"kind {self.filter!r}")
            object.__setattr__(self, "filter",
                               _FILTER_NAMES[s] if s else FilterType.NONE)
        if isinstance(self.index, str):
            object.__setattr__(
                self, "index",
                IndexType[self.index.upper()] if self.index
                else IndexType.NONE)

    @property
    def is_visible(self) -> bool:
        return not self.is_meta

    def validate(self) -> None:
        if not self.name:
            raise ValueError("field name required")
        if self.type == FieldType.INVALID:
            raise ValueError(f"field {self.name}: invalid type")
        if self.is_pk and self.type != FieldType.UINT64:
            raise ValueError(f"pk field {self.name} must be UINT64")
        if self.scale and self.type.decimal_scale_type is None:
            raise ValueError(f"field {self.name}: scale on non-decimal type")


def field_meta(*, pk: bool = False, index: str | IndexType = IndexType.NONE,
               filter: str | FilterType = FilterType.NONE, scale: int = 0,
               fixed: int = 0, type: FieldType | None = None,
               enum: str = "") -> dict:
    """Metadata dict for dataclasses.field(metadata=...) — the analog of the
    reference's `knox:"..."` struct tag."""
    if isinstance(index, str):
        index = IndexType[index.upper()] if index else IndexType.NONE
    if isinstance(filter, str):
        if filter and filter.lower() not in _FILTER_NAMES:
            raise ValueError(f"unknown pack filter kind {filter!r}; one "
                             f"of {sorted(_FILTER_NAMES)}")
        filter = _FILTER_NAMES[filter.lower()] if filter else FilterType.NONE
    return {"knox": dict(pk=pk, index=index, filter=filter, scale=scale,
                         fixed=fixed, type=type, enum=enum)}


_FILTER_NAMES = {
    # reference filter kind names (internal/types/filter.go:26-28):
    # bits, bloom2b..5b, bfuse8/16 (+ short aliases)
    "bloom": FilterType.BLOOM_2B, "bloom1": FilterType.BLOOM_1B,
    "bloom2": FilterType.BLOOM_2B, "bloom3": FilterType.BLOOM_3B,
    "bloom4": FilterType.BLOOM_4B, "bloom5": FilterType.BLOOM_5B,
    "bloom2b": FilterType.BLOOM_2B, "bloom3b": FilterType.BLOOM_3B,
    "bloom4b": FilterType.BLOOM_4B, "bloom5b": FilterType.BLOOM_5B,
    "bits": FilterType.BITS,
    "bfuse8": FilterType.BFUSE8, "bfuse16": FilterType.BFUSE16,
    "fuse": FilterType.BFUSE8,
}

_PY_TYPES: dict[Any, FieldType] = {
    int: FieldType.INT64, float: FieldType.FLOAT64, bool: FieldType.BOOLEAN,
    str: FieldType.STRING, bytes: FieldType.BYTES,
    datetime.datetime: FieldType.TIMESTAMP,
    np.int64: FieldType.INT64, np.uint64: FieldType.UINT64,
    np.int32: FieldType.INT32, np.uint32: FieldType.UINT32,
    np.int16: FieldType.INT16, np.uint16: FieldType.UINT16,
    np.int8: FieldType.INT8, np.uint8: FieldType.UINT8,
    np.float64: FieldType.FLOAT64, np.float32: FieldType.FLOAT32,
}


class Schema:
    """Ordered field collection with stable ids + fast lookup."""

    def __init__(self, name: str, fields: list[Field], version: int = 0):
        self.name = name
        self.version = version
        self.fields: list[Field] = []
        next_id = 1
        seen = set()
        pk = None
        for f in fields:
            if f.name in seen:
                raise ValueError(f"duplicate field {f.name}")
            seen.add(f.name)
            if f.id == 0:
                f = dataclasses.replace(f, id=next_id)
            next_id = max(next_id, f.id) + 1
            f.validate()
            if f.is_pk:
                if pk is not None:
                    raise ValueError("multiple pk fields")
                pk = f
            self.fields.append(f)
        self._by_name = {f.name: f for f in self.fields}
        self.pk = pk

    def __len__(self):
        return len(self.fields)

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __iter__(self):
        return iter(self.fields)

    def field(self, name: str) -> Field:
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(f"schema {self.name}: no field {name!r}") from None

    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    def visible(self) -> list[Field]:
        return [f for f in self.fields if not f.is_meta]

    def with_meta(self) -> "Schema":
        """Schema extended with $rid/$xmin/$xmax system columns
        (reference pkg/schema/meta.go)."""
        if META_RID in self._by_name:
            return self
        extra = [Field(n, FieldType.UINT64, is_meta=True)
                 for n in META_FIELDS]
        return Schema(self.name, self.fields + extra, self.version)

    def select(self, names: list[str]) -> "Schema":
        return Schema(self.name, [self.field(n) for n in names], self.version)

    def indexed(self) -> list[Field]:
        return [f for f in self.fields if f.index != IndexType.NONE]

    def to_dict(self) -> dict:
        return {
            "name": self.name, "version": self.version,
            "fields": [dataclasses.asdict(f) for f in self.fields],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Schema":
        fields = []
        for fd in d["fields"]:
            fd = dict(fd)
            fd["type"] = FieldType(fd["type"])
            fd["index"] = IndexType(fd["index"])
            fd["filter"] = FilterType(fd["filter"])
            fields.append(Field(**fd))
        return cls(d["name"], fields, d.get("version", 0))

    def __repr__(self):
        cols = ", ".join(f"{f.name}:{f.type.name}{'*' if f.is_pk else ''}"
                         for f in self.fields)
        return f"Schema({self.name}: {cols})"


def schema_of(cls_or_obj, name: str | None = None) -> Schema:
    """Reflect a Schema from a dataclass (analog of reference
    pkg/schema/reflect.go + the `knox` struct tag)."""
    cls = cls_or_obj if isinstance(cls_or_obj, type) else type(cls_or_obj)
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls.__name__} is not a dataclass")
    hints = get_type_hints(cls)
    fields = []
    for df in dataclasses.fields(cls):
        meta = dict(df.metadata.get("knox", {}))
        ft = meta.pop("type", None)
        if ft is None:
            hint = hints.get(df.name, df.type)
            ft = _resolve_type(hint, df.name)
        enum_name = meta.pop("enum", "")
        if enum_name and ft == FieldType.STRING:
            ft = FieldType.UINT16    # enum columns store dictionary codes
        meta["is_pk"] = meta.pop("pk", False)
        fields.append(Field(df.name, ft, is_enum=bool(enum_name),
                            enum_name=enum_name, **meta))
    # convention: a field named "id" is the pk unless one is tagged
    if not any(f.is_pk for f in fields):
        for i, f in enumerate(fields):
            if f.name == "id" and not f.type.is_float:
                fields[i] = dataclasses.replace(f, is_pk=True,
                                                type=FieldType.UINT64)
                break
    return Schema(name or cls.__name__.lower(), fields)


def _resolve_type(hint, fname: str) -> FieldType:
    if isinstance(hint, type) and issubclass(hint, enum.Enum):
        return FieldType.UINT16  # enum dictionary code
    ft = _PY_TYPES.get(hint)
    if ft is None:
        raise TypeError(f"field {fname}: cannot map {hint!r} to a FieldType; "
                        f"use field_meta(type=...)")
    return ft


class Builder:
    """Programmatic schema construction (reference pkg/schema/builder.go)."""

    def __init__(self, name: str):
        self._name = name
        self._fields: list[Field] = []

    def add(self, name: str, type: FieldType, **kw) -> "Builder":
        self._fields.append(Field(name, type, **kw))
        return self

    def pk(self, name: str = "id") -> "Builder":
        return self.add(name, FieldType.UINT64, is_pk=True)

    def finish(self) -> Schema:
        return Schema(self._name, self._fields)
