"""Dependency-free observability: metrics, span tracing, exposition.

This package deliberately imports nothing from the rest of the repo (and
nothing beyond the stdlib): the delivery stack depends on ``repro_torch.obs``,
never the reverse.  See ``docs/OBSERVABILITY.md`` for the metric catalog
and usage patterns.
"""

from .metrics import (LATENCY_BUCKETS, SIZE_BUCKETS, HistogramView,
                      MetricsRegistry, MetricsSnapshot, NULL_REGISTRY)
from .trace import NULL_TRACER, Span, Tracer
from .export import (check_monotonic, parse_prometheus_text,
                     to_prometheus_text)

__all__ = [
    "MetricsRegistry", "MetricsSnapshot", "HistogramView", "NULL_REGISTRY",
    "LATENCY_BUCKETS", "SIZE_BUCKETS",
    "Tracer", "Span", "NULL_TRACER",
    "to_prometheus_text", "parse_prometheus_text", "check_monotonic",
]
