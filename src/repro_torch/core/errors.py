"""Shared error types for the storage/delivery stack.

These live in ``repro_torch.core`` (not ``repro_torch.delivery``) so store/registry code
can raise them without an upward import; ``repro_torch.delivery`` re-exports
:class:`DeliveryError` unchanged, so existing ``from repro_torch.delivery import
DeliveryError`` call sites keep working.
"""

from __future__ import annotations


class DeliveryError(RuntimeError):
    """The delivery protocol could not complete — a required chunk is
    missing or unserved, a payload failed fingerprint verification, or a
    request named an unknown lineage/tag/fingerprint.  Always raised
    *before* any partial artifact is committed to a store."""


class JournalError(RuntimeError):
    """The registry journal (or snapshot) is unusable: a record decoded
    cleanly (checksum passed) but is inconsistent with the recorded state —
    e.g. a replayed commit reproduces a different CDMT root than the one the
    journal vouched for.  Torn tails are NOT this error; they are expected
    crash debris and are silently truncated on recovery."""
