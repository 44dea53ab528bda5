"""Named fault points — crash-injection hooks for durability testing.

Production code marks each crash window of a multi-step durable operation
with ``faults.fire("name")``.  In normal operation every call is a no-op
costing one truthiness check of an empty dict; a test arms a hook
(:func:`arm`, or the richer harness in ``tests/faultpoints.py``) that
raises at exactly that point, simulating a process killed mid-operation.
Recovery is then exercised by reopening the registry from its directory —
the same path a real crash takes.

The point names form a stable catalog (see ``tests/faultpoints.py``): a
renamed or removed call site fails the fault-matrix tests, so the crash
windows the tests cover cannot silently drift from the ones the code has.

Layering: L0 leaf — imported by ``core.registry``;
imports nothing from the package.
"""

from __future__ import annotations

from typing import Callable, Dict, List

__all__ = ["arm", "armed", "disarm", "disarm_all", "fire"]

# Armed hooks by point name.  Module-level and unlocked on purpose: tests
# arm/disarm around single-threaded crash scenarios, and the empty-dict
# fast path keeps production cost to one truthiness check.
_hooks: Dict[str, Callable[[], None]] = {}


def fire(point: str) -> None:
    """Trigger the fault point ``point`` — a no-op unless a test armed it."""
    if not _hooks:
        return
    hook = _hooks.get(point)
    if hook is not None:
        hook()


def arm(point: str, hook: Callable[[], None]) -> None:
    """Install ``hook`` to run whenever ``point`` fires (usually: raise)."""
    _hooks[point] = hook


def disarm(point: str) -> None:
    """Remove the hook for ``point`` (missing is fine)."""
    _hooks.pop(point, None)


def disarm_all() -> None:
    """Remove every armed hook — restores the zero-cost fast path."""
    _hooks.clear()


def armed() -> List[str]:
    """The currently armed point names, sorted."""
    return sorted(_hooks)
