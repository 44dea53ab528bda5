"""Thread-safe metrics primitives — counters, gauges, latency histograms.

Dependency-free (stdlib only) by design: the delivery stack instruments
itself with these, and anything that can parse JSON or Prometheus text can
read them.  The model follows the Prometheus client-library shape without
importing it:

  * a :class:`MetricsRegistry` owns metric *families* (one per metric name);
  * a family with label names vends *children* via :meth:`~_Family.labels`
    (one child per label-value tuple); a family with no labels acts as its
    own single child;
  * reads happen through :meth:`MetricsRegistry.snapshot` — an immutable,
    mergeable, JSON-round-trippable view taken under the registry lock, so
    a scrape never observes a half-updated histogram.

Hot-path cost model: children are meant to be **pre-bound** at construction
time (``self._m_hits = reg.counter("cache_hits_total").labels()``), so an
increment is one lock acquire + one integer add.  A registry constructed
with ``enabled=False`` (or the shared :data:`NULL_REGISTRY`) vends no-op
singletons instead: an increment is then a single no-op method call, which
is what makes "metrics disabled" measurably free.

Histograms use fixed bucket upper bounds (Prometheus ``le`` semantics:
bucket *i* counts observations ``<= edges[i]``, plus one overflow bucket).
Quantiles are estimated from the cumulative bucket counts by linear
interpolation inside the containing bucket — the same estimate
``histogram_quantile`` would compute from the exposition.
"""

from __future__ import annotations

import bisect
import json
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "MetricsRegistry", "MetricsSnapshot", "HistogramView", "NULL_REGISTRY",
    "LATENCY_BUCKETS", "SIZE_BUCKETS",
]

# seconds — spans 100µs in-process calls to multi-second bulk transfers
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# bytes — chunk payloads and frames, 256 B .. 64 MiB
SIZE_BUCKETS: Tuple[float, ...] = (
    256, 1024, 4096, 16384, 65536, 262144, 1 << 20, 4 << 20,
    16 << 20, 64 << 20)


def _label_values(labelnames: Sequence[str], args: Sequence[str],
                  kwargs: Dict[str, str]) -> Tuple[str, ...]:
    if kwargs:
        if args:
            raise ValueError("pass label values positionally or by name, "
                             "not both")
        try:
            return tuple(str(kwargs[n]) for n in labelnames)
        except KeyError as e:
            raise ValueError(f"missing label {e.args[0]!r}; "
                             f"expected {list(labelnames)}") from None
    if len(args) != len(labelnames):
        raise ValueError(f"expected {len(labelnames)} label value(s) "
                         f"{list(labelnames)}, got {len(args)}")
    return tuple(str(a) for a in args)


# ------------------------------------------------------------------ children

class _Counter:
    """Monotonic counter child.  ``inc`` only accepts non-negative deltas."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    def value(self) -> float:
        with self._lock:
            return self._value


class _Gauge:
    """Settable gauge child (current level: bytes resident, lag, in-flight)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1) -> None:
        with self._lock:
            self._value -= n

    def value(self) -> float:
        with self._lock:
            return self._value


class _Histogram:
    """Fixed-bucket histogram child: counts per ``le`` bucket + sum + count."""

    __slots__ = ("_lock", "_edges", "_counts", "_sum", "_count")

    def __init__(self, lock: threading.Lock, edges: Tuple[float, ...]):
        self._lock = lock
        self._edges = edges
        self._counts = [0] * (len(edges) + 1)     # last bucket = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        idx = bisect.bisect_left(self._edges, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    def value(self) -> "HistogramView":
        with self._lock:
            return HistogramView(self._edges, tuple(self._counts),
                                 self._sum, self._count)


class _NullMetric:
    """The child every disabled registry vends: all writes are no-ops, all
    reads are zero.  One shared instance serves every family and label set,
    so a disabled hot path pays exactly one no-op method call."""

    __slots__ = ()

    def labels(self, *a, **kw) -> "_NullMetric":
        return self

    def inc(self, n: float = 1) -> None:
        pass

    def dec(self, n: float = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def value(self) -> float:
        return 0


_NULL_METRIC = _NullMetric()


# ------------------------------------------------------------------ families

_KINDS = ("counter", "gauge", "histogram")


class _Family:
    """One named metric; vends per-label children (itself when label-free)."""

    def __init__(self, kind: str, name: str, help_: str,
                 labelnames: Tuple[str, ...], lock: threading.Lock,
                 buckets: Tuple[float, ...] = ()):
        self.kind = kind
        self.name = name
        self.help = help_
        self.labelnames = labelnames
        self.buckets = buckets
        self._lock = lock
        self._children: Dict[Tuple[str, ...], object] = {}

    def _make_child(self):
        if self.kind == "counter":
            return _Counter(self._lock)
        if self.kind == "gauge":
            return _Gauge(self._lock)
        return _Histogram(self._lock, self.buckets)

    def labels(self, *args: str, **kwargs: str):
        key = _label_values(self.labelnames, args, kwargs)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
        return child

    # label-free convenience: the family is its own single child
    def inc(self, n: float = 1) -> None:
        self.labels().inc(n)

    def dec(self, n: float = 1) -> None:
        self.labels().dec(n)

    def set(self, v: float) -> None:
        self.labels().set(v)

    def observe(self, v: float) -> None:
        self.labels().observe(v)

    def value(self):
        return self.labels().value()


# ------------------------------------------------------------------ registry

class MetricsRegistry:
    """A process-local set of metric families, snapshot-consistent.

    Components each own (or are handed) a registry, so independent servers
    in one process never share counters; a deployment that wants one scrape
    endpoint hands the same registry to everything, or merges snapshots.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}  # guarded-by: _lock

    # -------------------------------------------------------- registration

    def _family(self, kind: str, name: str, help_: str,
                labelnames: Sequence[str],
                buckets: Tuple[float, ...] = ()):
        if not self.enabled:
            return _NULL_METRIC
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(
                    kind, name, help_, labelnames, self._lock, buckets)
                return fam
        if fam.kind != kind or fam.labelnames != labelnames:
            raise ValueError(
                f"metric {name!r} re-registered as {kind}{labelnames} "
                f"(was {fam.kind}{fam.labelnames})")
        return fam

    def counter(self, name: str, help_: str = "",
                labelnames: Sequence[str] = ()):
        return self._family("counter", name, help_, labelnames)

    def gauge(self, name: str, help_: str = "",
              labelnames: Sequence[str] = ()):
        return self._family("gauge", name, help_, labelnames)

    def histogram(self, name: str, help_: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS):
        edges = tuple(sorted(float(b) for b in buckets))
        if not edges:
            raise ValueError("histogram needs at least one bucket edge")
        return self._family("histogram", name, help_, labelnames, edges)

    # -------------------------------------------------------------- reading

    def snapshot(self) -> "MetricsSnapshot":
        """A consistent point-in-time copy of every series (one lock hold)."""
        fams: List[dict] = []
        with self._lock:
            for fam in self._families.values():
                series = []
                for key, child in fam._children.items():
                    entry = {"labels": dict(zip(fam.labelnames, key))}
                    if fam.kind == "histogram":
                        entry["counts"] = list(child._counts)
                        entry["sum"] = child._sum
                        entry["count"] = child._count
                    else:
                        entry["value"] = child._value
                    series.append(entry)
                fams.append({"kind": fam.kind, "name": fam.name,
                             "help": fam.help,
                             "labelnames": list(fam.labelnames),
                             "buckets": list(fam.buckets),
                             "series": series})
        return MetricsSnapshot(fams)


NULL_REGISTRY = MetricsRegistry(enabled=False)


# ------------------------------------------------------------------ snapshot

class HistogramView:
    """Immutable histogram state: bucket counts, sum, count, quantiles."""

    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: Sequence[float], counts: Sequence[int],
                 sum_: float, count: int):
        self.edges = tuple(edges)
        self.counts = tuple(counts)
        self.sum = sum_
        self.count = count

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Linear-interpolation estimate of the ``q``-quantile (0..1).

        Observations in the overflow bucket clamp to the last finite edge
        (there is no upper bound to interpolate toward) — same convention
        as Prometheus ``histogram_quantile``.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile must be in [0, 1]")
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        lo = 0.0
        for edge, n in zip(self.edges, self.counts):
            if cum + n >= target and n > 0:
                frac = (target - cum) / n
                return lo + (edge - lo) * min(1.0, max(0.0, frac))
            cum += n
            lo = edge
        return self.edges[-1]       # landed in the +Inf overflow bucket

    def merge(self, other: "HistogramView") -> "HistogramView":
        if self.edges != other.edges:
            raise ValueError("cannot merge histograms with different buckets")
        return HistogramView(self.edges,
                             [a + b for a, b in zip(self.counts,
                                                    other.counts)],
                             self.sum + other.sum, self.count + other.count)


def _series_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


class MetricsSnapshot:
    """Immutable view of a registry: mergeable, JSON-round-trippable.

    ``families`` is a list of plain dicts (the JSON shape), so a snapshot
    decoded from an :data:`~repro_torch.delivery.wire.Op.METRICS` scrape is
    indistinguishable from one taken in-process.
    """

    def __init__(self, families: Optional[List[dict]] = None):
        self.families: List[dict] = families if families is not None else []

    # ------------------------------------------------------------ accessors

    def family(self, name: str) -> Optional[dict]:
        for fam in self.families:
            if fam["name"] == name:
                return fam
        return None

    def names(self) -> List[str]:
        return [fam["name"] for fam in self.families]

    def _series(self, name: str, labels: Optional[Dict[str, str]]):
        fam = self.family(name)
        if fam is None:
            return None, None
        want = _series_key({k: str(v) for k, v in (labels or {}).items()})
        for entry in fam["series"]:
            if _series_key(entry["labels"]) == want:
                return fam, entry
        return fam, None

    def value(self, name: str, labels: Optional[Dict[str, str]] = None,
              default: float = 0) -> float:
        """Counter/gauge series value (``default`` when never incremented)."""
        fam, entry = self._series(name, labels)
        if entry is None:
            return default
        if fam["kind"] == "histogram":
            raise ValueError(f"{name} is a histogram — use .histogram()")
        return entry["value"]

    def histogram(self, name: str,
                  labels: Optional[Dict[str, str]] = None
                  ) -> Optional[HistogramView]:
        fam, entry = self._series(name, labels)
        if entry is None:
            return None
        if fam["kind"] != "histogram":
            raise ValueError(f"{name} is a {fam['kind']}, not a histogram")
        return HistogramView(fam["buckets"], entry["counts"],
                             entry["sum"], entry["count"])

    def sum_values(self, name: str, **fixed: str) -> float:
        """Sum a family's series values over every series matching the
        given label subset (e.g. all ``op`` values for one ``transport``)."""
        fam = self.family(name)
        if fam is None:
            return 0
        total = 0
        for entry in fam["series"]:
            if all(entry["labels"].get(k) == str(v)
                   for k, v in fixed.items()):
                total += entry["value"]
        return total

    # ---------------------------------------------------------------- merge

    def merge(self, other: "MetricsSnapshot") -> "MetricsSnapshot":
        """Combine two snapshots (e.g. several workers' registries) into
        one: counter and histogram series sum; gauge series sum too —
        levels like resident bytes or in-flight requests aggregate across
        shards (per-instance gauges should carry a distinguishing label)."""
        out: List[dict] = [json.loads(json.dumps(f)) for f in self.families]
        by_name = {f["name"]: f for f in out}
        for fam in other.families:
            mine = by_name.get(fam["name"])
            if mine is None:
                out.append(json.loads(json.dumps(fam)))
                continue
            if mine["kind"] != fam["kind"] or \
                    mine["buckets"] != fam["buckets"]:
                raise ValueError(f"cannot merge incompatible metric "
                                 f"{fam['name']!r}")
            index = {_series_key(e["labels"]): e for e in mine["series"]}
            for entry in fam["series"]:
                got = index.get(_series_key(entry["labels"]))
                if got is None:
                    mine["series"].append(json.loads(json.dumps(entry)))
                elif mine["kind"] == "histogram":
                    got["counts"] = [a + b for a, b in zip(got["counts"],
                                                           entry["counts"])]
                    got["sum"] += entry["sum"]
                    got["count"] += entry["count"]
                else:
                    got["value"] += entry["value"]
        return MetricsSnapshot(out)

    # ----------------------------------------------------------------- JSON

    def to_json_obj(self) -> dict:
        return {"v": 1, "families": self.families}

    def to_json(self) -> str:
        return json.dumps(self.to_json_obj(), sort_keys=True)

    @classmethod
    def from_json_obj(cls, obj: dict) -> "MetricsSnapshot":
        if not isinstance(obj, dict) or obj.get("v") != 1:
            raise ValueError("not a metrics snapshot (missing v=1)")
        return cls(obj["families"])

    @classmethod
    def from_json(cls, text: str) -> "MetricsSnapshot":
        return cls.from_json_obj(json.loads(text))
