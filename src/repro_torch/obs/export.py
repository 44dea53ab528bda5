"""Exposition: render a :class:`~repro_torch.obs.metrics.MetricsSnapshot` as
Prometheus text or JSON, parse the text form back, and validate scrapes.

The Prometheus text format is the ops-facing surface (`# HELP`/`# TYPE`
lines, one sample per series, histograms exploded into ``_bucket``/``_sum``
/``_count`` with cumulative ``le`` labels).  JSON is the wire surface: the
``Op.METRICS`` scrape ships :meth:`MetricsSnapshot.to_json` bytes, and the
decoded snapshot answers the same queries as an in-process one.

:func:`parse_prometheus_text` implements just enough of the exposition
grammar to round-trip what :func:`to_prometheus_text` emits — CI uses it
to prove a live scrape parses and that counters are monotonic between two
scrapes (:func:`check_monotonic`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from .metrics import MetricsSnapshot

__all__ = ["to_prometheus_text", "parse_prometheus_text",
           "check_monotonic"]


def _fmt_value(v: float) -> str:
    if isinstance(v, float) and math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v) == int(v):
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\"", "\\\"").replace("\n", "\\n")


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def to_prometheus_text(snapshot: MetricsSnapshot) -> str:
    """Render a snapshot in the Prometheus text exposition format."""
    lines: List[str] = []
    for fam in snapshot.families:
        name, kind = fam["name"], fam["kind"]
        if fam.get("help"):
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {kind}")
        for entry in fam["series"]:
            labels = entry["labels"]
            if kind != "histogram":
                lines.append(f"{name}{_label_str(labels)} "
                             f"{_fmt_value(entry['value'])}")
                continue
            cum = 0
            edges = list(fam["buckets"]) + [math.inf]
            for edge, n in zip(edges, entry["counts"]):
                cum += n
                le = dict(labels)
                le["le"] = _fmt_value(edge)
                lines.append(f"{name}_bucket{_label_str(le)} {cum}")
            lines.append(f"{name}_sum{_label_str(labels)} "
                         f"{_fmt_value(entry['sum'])}")
            lines.append(f"{name}_count{_label_str(labels)} "
                         f"{entry['count']}")
    return "\n".join(lines) + "\n" if lines else ""


# ------------------------------------------------------------------ parsing

Sample = Tuple[str, Tuple[Tuple[str, str], ...]]     # (name, sorted labels)


def _parse_labels(text: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    i = 0
    while i < len(text):
        eq = text.index("=", i)
        key = text[i:eq].strip().lstrip(",").strip()
        if text[eq + 1] != '"':
            raise ValueError(f"unquoted label value near {text[eq:]!r}")
        j = eq + 2
        out = []
        while text[j] != '"':
            if text[j] == "\\":
                nxt = text[j + 1]
                out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                j += 2
            else:
                out.append(text[j])
                j += 1
        labels[key] = "".join(out)
        i = j + 1
    return labels


def parse_prometheus_text(text: str) -> Dict[Sample, float]:
    """Parse exposition text into ``{(name, labels): value}``.

    Raises :class:`ValueError` on lines that don't scan — the CI smoke
    treats any exception as "the scrape does not parse".
    """
    samples: Dict[Sample, float] = {}
    types: Dict[str, str] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                types[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue
        if "{" in line:
            name = line[:line.index("{")]
            rest = line[line.index("{") + 1:]
            close = rest.rindex("}")
            labels = _parse_labels(rest[:close])
            value_text = rest[close + 1:].strip()
        else:
            name, value_text = line.split(None, 1)
            labels = {}
        value = float(value_text.replace("+Inf", "inf"))
        key = (name, tuple(sorted(labels.items())))
        if key in samples:
            raise ValueError(f"line {lineno}: duplicate sample {key}")
        samples[key] = value
    if not samples:
        raise ValueError("no samples found")
    return samples


def check_monotonic(before: MetricsSnapshot,
                    after: MetricsSnapshot) -> List[str]:
    """Counter series (and histogram cumulative counts) must never move
    backwards between two scrapes of the same server.  Returns a list of
    violation descriptions — empty means the pair is consistent."""
    bad: List[str] = []
    for fam in before.families:
        name = fam["name"]
        for entry in fam["series"]:
            labels = entry["labels"]
            if fam["kind"] == "counter":
                now = after.value(name, labels, default=-1)
                if now < entry["value"]:
                    bad.append(f"counter {name}{labels} went "
                               f"{entry['value']} -> {now}")
            elif fam["kind"] == "histogram":
                now_h = after.histogram(name, labels)
                if now_h is None or now_h.count < entry["count"]:
                    bad.append(f"histogram {name}{labels} count shrank")
    return bad
