"""Antithesis-style executable assertions (carried over from
knoxdb_tpu/testing/assert_.py; upstream pkg/assert).

Always/Sometimes/Reachable invariants behind an env switch. The registry
records which Sometimes/Reachable sites fired so the scenario runner can
verify coverage at the end of a run.
"""

from __future__ import annotations

import os
from collections import defaultdict

__all__ = ["always", "sometimes", "reachable", "unreachable", "report",
           "reset", "enabled"]

_ENABLED = os.environ.get("KNOX_ASSERT", "1") != "0"
_sometimes: dict[str, int] = defaultdict(int)
_reachable: dict[str, int] = defaultdict(int)
_registered: set[str] = set()


def enabled() -> bool:
    return _ENABLED


def always(cond: bool, name: str, details: object = None) -> None:
    """Must hold every time execution reaches this site."""
    if _ENABLED and not cond:
        raise AssertionError(f"always({name}) violated: {details!r}")


def sometimes(cond: bool, name: str) -> None:
    """Must hold at least once across a scenario run."""
    _registered.add(name)
    if cond:
        _sometimes[name] += 1


def reachable(name: str) -> None:
    """This site must execute at least once across a scenario run."""
    _registered.add(name)
    _reachable[name] += 1


def unreachable(name: str, details: object = None) -> None:
    if _ENABLED:
        raise AssertionError(f"unreachable({name}) hit: {details!r}")


def report() -> dict:
    """Coverage report: {site: hits}; sites never hit map to 0."""
    out = {}
    for name in _registered:
        out[name] = _sometimes.get(name, 0) + _reachable.get(name, 0)
    return out


def reset() -> None:
    _sometimes.clear()
    _reachable.clear()
    _registered.clear()
