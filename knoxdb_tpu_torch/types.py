"""Core enums and logical field types (the numpy host half of
knoxdb_tpu/types.py, carried over unchanged)."""

from __future__ import annotations

import enum
from dataclasses import dataclass


class FilterMode(enum.IntEnum):
    INVALID = 0
    EQ = 1
    NE = 2
    GT = 3
    GE = 4
    LT = 5
    LE = 6
    IN = 7
    NOT_IN = 8
    RANGE = 9
    REGEXP = 10
    TRUE = 11
    FALSE = 12

    @property
    def symbol(self) -> str:
        return _MODE_SYMBOLS[self]


_MODE_SYMBOLS = {
    FilterMode.EQ: "=",
    FilterMode.NE: "!=",
    FilterMode.GT: ">",
    FilterMode.GE: ">=",
    FilterMode.LT: "<",
    FilterMode.LE: "<=",
    FilterMode.IN: "IN",
    FilterMode.NOT_IN: "NOT IN",
    FilterMode.RANGE: "RANGE",
    FilterMode.REGEXP: "~=",
    FilterMode.TRUE: "TRUE",
    FilterMode.FALSE: "FALSE",
}

_MODE_NAMES = {
    # full reference ParseFilterMode alias set (internal/types/mode.go:
    # 60-85): "" and "eq" -> EQ, "gte"/"lte" synonyms accepted
    "": FilterMode.EQ,
    "eq": FilterMode.EQ, "ne": FilterMode.NE, "gt": FilterMode.GT,
    "ge": FilterMode.GE, "gte": FilterMode.GE,
    "lt": FilterMode.LT, "le": FilterMode.LE, "lte": FilterMode.LE,
    "in": FilterMode.IN, "ni": FilterMode.NOT_IN, "nin": FilterMode.NOT_IN,
    "not_in": FilterMode.NOT_IN, "rg": FilterMode.RANGE,
    "range": FilterMode.RANGE, "re": FilterMode.REGEXP,
    "regexp": FilterMode.REGEXP,
}


def parse_filter_mode(s: str) -> FilterMode:
    """Parse an SDK mode string (reference pkg/knox condition parser).
    Raises on unknown names: returning INVALID silently let a
    cond("f", "range", ...) fall into the scalar bind path and crash
    with an unrelated broadcast error."""
    m = _MODE_NAMES.get(s.lower())
    if m is None:
        raise ValueError(f"unknown filter mode {s!r}; one of "
                         f"{sorted(set(_MODE_NAMES))}")
    return m


class FieldType(enum.IntEnum):
    INVALID = 0
    TIMESTAMP = 1  # i64 ns since epoch
    INT64 = 2
    UINT64 = 3
    FLOAT64 = 4
    BOOLEAN = 5
    STRING = 6
    BYTES = 7
    INT32 = 8
    INT16 = 9
    INT8 = 10
    UINT32 = 11
    UINT16 = 12
    UINT8 = 13
    FLOAT32 = 14
    INT256 = 15
    INT128 = 16
    DECIMAL256 = 17
    DECIMAL128 = 18
    DECIMAL64 = 19
    DECIMAL32 = 20
    BIGINT = 21  # variable-size big int (stored as bytes)
    TIME = 22    # i64 ns

    @property
    def is_numeric(self) -> bool:
        return self in _NUMERIC

    @property
    def is_signed(self) -> bool:
        return self in _SIGNED

    @property
    def is_float(self) -> bool:
        return self in (FieldType.FLOAT32, FieldType.FLOAT64)

    @property
    def is_bytes_like(self) -> bool:
        return self in (FieldType.STRING, FieldType.BYTES, FieldType.BIGINT)

    @property
    def bits(self) -> int:
        """Logical width in bits of the fixed-size representation."""
        return _BITS[self]

    @property
    def nlimbs(self) -> int:
        """Number of 32-bit keyform limbs on device."""
        return max(1, self.bits // 32)

    @property
    def decimal_scale_type(self) -> "FieldType | None":
        return _DECIMAL_BASE.get(self)


_NUMERIC = {
    FieldType.TIMESTAMP, FieldType.TIME, FieldType.INT64, FieldType.UINT64,
    FieldType.FLOAT64, FieldType.FLOAT32, FieldType.INT32, FieldType.INT16,
    FieldType.INT8, FieldType.UINT32, FieldType.UINT16, FieldType.UINT8,
    FieldType.INT128, FieldType.INT256, FieldType.DECIMAL32,
    FieldType.DECIMAL64, FieldType.DECIMAL128, FieldType.DECIMAL256,
    FieldType.BOOLEAN,
}

_SIGNED = {
    FieldType.TIMESTAMP, FieldType.TIME, FieldType.INT64, FieldType.INT32,
    FieldType.INT16, FieldType.INT8, FieldType.INT128, FieldType.INT256,
    FieldType.DECIMAL32, FieldType.DECIMAL64, FieldType.DECIMAL128,
    FieldType.DECIMAL256, FieldType.FLOAT32, FieldType.FLOAT64,
}

_BITS = {
    FieldType.INVALID: 0,
    FieldType.TIMESTAMP: 64, FieldType.TIME: 64,
    FieldType.INT64: 64, FieldType.UINT64: 64, FieldType.FLOAT64: 64,
    FieldType.BOOLEAN: 8,
    FieldType.STRING: 0, FieldType.BYTES: 0, FieldType.BIGINT: 0,
    FieldType.INT32: 32, FieldType.UINT32: 32, FieldType.FLOAT32: 32,
    FieldType.INT16: 16, FieldType.UINT16: 16,
    FieldType.INT8: 8, FieldType.UINT8: 8,
    FieldType.INT128: 128, FieldType.INT256: 256,
    FieldType.DECIMAL32: 32, FieldType.DECIMAL64: 64,
    FieldType.DECIMAL128: 128, FieldType.DECIMAL256: 256,
}

_DECIMAL_BASE = {
    FieldType.DECIMAL32: FieldType.INT32,
    FieldType.DECIMAL64: FieldType.INT64,
    FieldType.DECIMAL128: FieldType.INT128,
    FieldType.DECIMAL256: FieldType.INT256,
}


class IndexType(enum.IntEnum):
    NONE = 0
    HASH = 1       # EQ / IN only
    INT = 2        # EQ..RANGE
    COMPOSITE = 3  # multi-field prefix EQ
    PK = 4         # primary key (implicit)


class OrderType(enum.IntEnum):
    ASC = 0
    DESC = 1
    CASE_ASC = 2
    CASE_DESC = 3


class JoinType(enum.IntEnum):
    INNER = 0
    LEFT = 1
    RIGHT = 2
    FULL = 3
    CROSS = 4


class FilterType(enum.IntEnum):
    """Per-pack auxiliary filter kinds attached to stats (reference
    internal/types/filter.go:10-19: bits, bloom2b..5b, bfuse8/16)."""
    NONE = 0
    BLOOM_1B = 1   # 1 byte/entry -> ~2% fpr
    BLOOM_2B = 2   # 2 bytes/entry -> ~0.2% fpr
    BLOOM_3B = 3
    BLOOM_4B = 4
    BITS = 5       # EXACT membership (roaring set of keyform values)
    BFUSE8 = 6     # binary-fuse/xor filter, 8-bit fingerprints
    BFUSE16 = 7    # 16-bit fingerprints (~0.0015% fpr)
    BLOOM_5B = 8

    @property
    def is_bloom(self) -> bool:
        return self in (FilterType.BLOOM_1B, FilterType.BLOOM_2B,
                        FilterType.BLOOM_3B, FilterType.BLOOM_4B,
                        FilterType.BLOOM_5B)

    @property
    def is_fuse(self) -> bool:
        return self in (FilterType.BFUSE8, FilterType.BFUSE16)


@dataclass(frozen=True)
class Snapshot:
    """MVCC snapshot (reference internal/types/snapshot.go:30-37).

    xown: the reader's own xid (0 for read-only virtual xids)
    xmin: lowest xid active when the snapshot was taken
    xmax: next-to-be-assigned xid (everything >= xmax is invisible)
    xact: frozenset of xids active (uncommitted) at snapshot time
    safe: True when no concurrent writers (xact empty)
    """
    xown: int = 0
    xmin: int = 0
    xmax: int = 0
    xact: frozenset = frozenset()

    @property
    def safe(self) -> bool:
        return not self.xact

    def is_visible(self, xmin: int, xmax: int) -> bool:
        """Row version visibility under this snapshot."""
        if xmin != self.xown:
            if xmin >= self.xmax or xmin in self.xact:
                return False
        if xmax != 0:
            if xmax == self.xown:
                return False
            if xmax < self.xmax and xmax not in self.xact:
                return False
        return True


# Engine object tags, loosely following reference internal/types/hash.go.
class ObjectTag(enum.IntEnum):
    DATABASE = 1
    TABLE = 2
    INDEX = 3
    VIEW = 4
    ENUM = 5
    STORE = 6
