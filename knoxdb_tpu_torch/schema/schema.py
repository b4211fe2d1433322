"""Schema: typed field metadata (Field, Schema, Builder, carried over
from knoxdb_tpu/schema/schema.py; its dataclass reflection and dict
codec wait for the engine slice).

Fields carry a stable id, logical type, pk flag, index kind, per-field
pack filter (bloom/bits), decimal scale and fixed byte width.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from ..types import FieldType, FilterType, IndexType

__all__ = ["Field", "Schema", "Builder"]


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

    def select(self, names: list[str]) -> "Schema":
        return Schema(self.name, [self.field(n) for n in names], self.version)

    def indexed(self) -> list[Field]:
        return [f for f in self.fields if f.index != IndexType.NONE]

    def __repr__(self):
        cols = ", ".join(f"{f.name}:{f.type.name}{'*' if f.is_pk else ''}"
                         for f in self.fields)
        return f"Schema({self.name}: {cols})"


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
