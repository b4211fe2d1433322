"""FSST-style static-symbol-table string compression (carried over from
knoxdb_tpu/encode/fsst.py; upstream internal/encode/fsst).

A standalone codec, wired into no path here as upstream: a symbol table
of up to 254 byte sequences (length 2..8) is trained on a sample;
compression greedily replaces the longest matching symbol with a 1-byte
code. Code 0xFF escapes a literal byte.
"""

from __future__ import annotations

from collections import Counter

__all__ = ["SymbolTable", "train", "compress", "decompress"]

_ESC = 0xFF
_MAX_SYMS = 254
_MAX_LEN = 8


class SymbolTable:
    def __init__(self, symbols: list[bytes]):
        if len(symbols) > _MAX_SYMS:
            raise ValueError("too many symbols")
        self.symbols = symbols
        # longest-match index: first byte -> [(symbol, code)] sorted by len
        self._by_first: dict[int, list[tuple[bytes, int]]] = {}
        for code, s in enumerate(symbols):
            self._by_first.setdefault(s[0], []).append((s, code))
        for lst in self._by_first.values():
            lst.sort(key=lambda t: -len(t[0]))

    def dump(self) -> bytes:
        out = [bytes([len(self.symbols)])]
        for s in self.symbols:
            out.append(bytes([len(s)]))
            out.append(s)
        return b"".join(out)

    @classmethod
    def load(cls, buf: bytes) -> tuple["SymbolTable", int]:
        n = buf[0]
        off = 1
        syms = []
        for _ in range(n):
            ln = buf[off]
            syms.append(buf[off + 1:off + 1 + ln])
            off += 1 + ln
        return cls(syms), off


def train(samples: list[bytes], max_syms: int = _MAX_SYMS) -> SymbolTable:
    """Greedy frequency-based symbol selection (upstream implements
    the full iterative FSST algorithm; frequency top-k captures most of
    the win on short-string corpora).

    Single-byte symbols matter: a literal byte whose VALUE falls inside
    the code space must be escaped (2 bytes), so every corpus byte value
    below the table size gets a 1-byte symbol slot (fixpoint loop)."""
    counts: Counter = Counter()
    singles: Counter = Counter()
    for s in samples[:4096]:
        for b in s:
            singles[b] += 1
        for ln in (2, 3, 4, 6, 8):
            for i in range(0, max(0, len(s) - ln + 1)):
                counts[s[i:i + ln]] += ln - 1     # weight by saved bytes
    multi = [sym for sym, c in counts.most_common(max_syms)
             if c >= 2 * len(sym)]
    multi = multi[:max_syms - 32]                 # leave room for singles
    need: set[int] = set()
    while True:
        cutoff = min(len(multi) + len(need), _MAX_SYMS)
        nxt = {b for b in singles if b < cutoff or b == _ESC}
        if nxt == need:
            break
        need = nxt
    while len(multi) + len(need) > max_syms:
        multi.pop()
        need = {b for b in singles
                if b < len(multi) + len(need) or b == _ESC}
    table = multi + [bytes([b]) for b in sorted(need)]
    return SymbolTable(table)


def compress(st: SymbolTable, data: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        cands = st._by_first.get(data[i])
        hit = None
        if cands:
            for sym, code in cands:
                if data.startswith(sym, i):
                    hit = (sym, code)
                    break
        if hit:
            out.append(hit[1])
            i += len(hit[0])
        else:
            b = data[i]
            if b >= len(st.symbols) and b != _ESC:
                out.append(b)        # unambiguous literal
            else:
                out.append(_ESC)
                out.append(b)
            i += 1
    return bytes(out)


def decompress(st: SymbolTable, data: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    nsyms = len(st.symbols)
    while i < n:
        b = data[i]
        if b == _ESC:
            out.append(data[i + 1])
            i += 2
        elif b < nsyms:
            out.extend(st.symbols[b])
            i += 1
        else:
            out.append(b)
            i += 1
    return bytes(out)
