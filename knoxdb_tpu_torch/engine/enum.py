"""Enum registry: named string dictionaries for compact enum columns (carried over from
knoxdb_tpu/engine/enum.py).

Analog of the reference enum support (internal/engine/
enum.go + pkg/schema enum dictionaries): a field tagged with an enum name
stores u16 codes; the engine-level registry maps code <-> string and is
persisted in the catalog. The SDK translates transparently on insert and
in query constants.
"""

from __future__ import annotations

__all__ = ["EnumRegistry", "EnumDict"]


class EnumDict:
    def __init__(self, name: str, values: list[str] | None = None):
        self.name = name
        self.values: list[str] = []
        self._index: dict[str, int] = {}
        for v in values or []:
            self.add(v)

    def add(self, value: str) -> int:
        if value in self._index:
            return self._index[value]
        if len(self.values) >= 1 << 16:
            raise ValueError(f"enum {self.name}: >65535 values")
        code = len(self.values)
        self.values.append(value)
        self._index[value] = code
        return code

    def code(self, value: str) -> int:
        try:
            return self._index[value]
        except KeyError:
            raise KeyError(f"enum {self.name}: unknown value {value!r}") \
                from None

    def value(self, code: int) -> str:
        return self.values[code]

    def __len__(self):
        return len(self.values)

    def to_dict(self):
        return {"name": self.name, "values": self.values}

    @classmethod
    def from_dict(cls, d):
        return cls(d["name"], d["values"])


class EnumRegistry:
    def __init__(self):
        self._enums: dict[str, EnumDict] = {}

    def create(self, name: str, values: list[str] | None = None) -> EnumDict:
        if name in self._enums:
            raise ValueError(f"enum {name} exists")
        e = EnumDict(name, values)
        self._enums[name] = e
        return e

    def get(self, name: str) -> EnumDict:
        return self._enums[name]

    def extend(self, name: str, values: list[str]) -> None:
        e = self._enums[name]
        for v in values:
            e.add(v)

    def __contains__(self, name: str) -> bool:
        return name in self._enums

    def to_dict(self):
        return {n: e.to_dict() for n, e in self._enums.items()}

    @classmethod
    def from_dict(cls, d):
        r = cls()
        for n, ed in d.items():
            r._enums[n] = EnumDict.from_dict(ed)
        return r
