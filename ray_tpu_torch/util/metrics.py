"""User-defined metrics: Counter, Gauge, Histogram.

A copy of ``ray_tpu/util/metrics.py`` (same names, samples and text
exposition): metrics live in a process-local registry and any process
renders the Prometheus text exposition (``export_prometheus``). The
registry here is this package's own, separate from the JAX package's,
so a process holding engines of both never mixes their series. Left
out: ``flush_to_kv`` and ``collect_cluster``, which publish through a
cluster controller this package does not have.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_registry_lock = threading.Lock()
_registry: Dict[str, "Metric"] = {}

DEFAULT_BOUNDARIES = [0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                      2.5, 5.0, 10.0]


class Metric:
    metric_type = "untyped"

    def __new__(cls, name: str, *args, **kwargs):
        # Re-registration returns the EXISTING instance (same type +
        # tag keys) instead of silently clobbering the registry entry —
        # the old behavior orphaned every prior handle: their writes
        # kept landing on the shadowed object and vanished from the
        # exposition. Shared construction is the normal pattern (every
        # engine in a process builds "its" TTFT histogram); a
        # type-mismatched reuse of a name is a programming error and
        # raises. Lookup, field init, and registry insert all happen
        # inside ONE critical section: two threads constructing the
        # same name concurrently can never both create (check-then-act
        # clobber), and a merge-path winner can never observe a
        # half-initialized instance. __init__ then runs the pure
        # compat/merge check on whichever instance came back.
        with _registry_lock:
            existing = _registry.get(name)
            if existing is not None:
                if type(existing) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}; cannot "
                        f"re-register as {cls.__name__}")
                return existing
            inst = super().__new__(cls)
            inst._init_fields(name, *args, **kwargs)
            _registry[name] = inst
            return inst

    def _init_fields(self, name: str, description: str = "",
                     tag_keys: Optional[Sequence[str]] = None) -> None:
        """First-construction initialization — runs under the registry
        lock in __new__, BEFORE the instance becomes visible."""
        if not name or not name.replace("_", "a").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        # always the merge/compat path (field init happened in
        # __new__): tag keys must agree (samples are keyed by them) —
        # trivially true for the creating caller — and description
        # backfills if the first registration left it empty
        if tuple(tag_keys or ()) != self._tag_keys:
            raise ValueError(
                f"metric {name!r} already registered with tag_keys="
                f"{self._tag_keys}; got {tuple(tag_keys or ())}")
        if description and not self._description:
            self._description = description

    # -- tags ---------------------------------------------------------------
    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple[str, ...]:
        merged = {**self._default_tags, **(tags or {})}
        missing = set(self._tag_keys) - set(merged)
        if missing:
            raise ValueError(f"missing tag(s) {sorted(missing)} for "
                             f"metric {self._name}")
        return tuple(merged.get(k, "") for k in self._tag_keys)

    # -- introspection ------------------------------------------------------
    @property
    def info(self) -> Dict[str, object]:
        return {"name": self._name, "description": self._description,
                "tag_keys": self._tag_keys,
                "default_tags": dict(self._default_tags)}

    def _samples(self) -> List[Tuple[Dict[str, str], float]]:
        with self._lock:
            return [(dict(zip(self._tag_keys, key)), val)
                    for key, val in self._values.items()]


class Counter(Metric):
    metric_type = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("counters only increase")
        key = self._key(tags)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value


class Gauge(Metric):
    metric_type = "gauge"

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[self._key(tags)] = float(value)


class Histogram(Metric):
    metric_type = "histogram"

    def _init_fields(self, name: str, description: str = "",
                     boundaries: Optional[Sequence[float]] = None,
                     tag_keys: Optional[Sequence[str]] = None) -> None:
        super()._init_fields(name, description, tag_keys)
        self.boundaries = sorted(boundaries or DEFAULT_BOUNDARIES)
        self._buckets: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._counts: Dict[Tuple[str, ...], int] = {}

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Optional[Sequence[str]] = None):
        # merge/compat path (see Metric.__init__): bucket layouts must
        # agree or the shared bucket counts would be meaningless —
        # trivially true for the creating caller
        bounds = sorted(boundaries or DEFAULT_BOUNDARIES)
        if bounds != self.boundaries:
            raise ValueError(
                f"histogram {name!r} already registered with "
                f"boundaries {self.boundaries}; got {bounds}")
        super().__init__(name, description, tag_keys)

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        key = self._key(tags)
        with self._lock:
            buckets = self._buckets.setdefault(
                key, [0] * (len(self.boundaries) + 1))
            buckets[bisect.bisect_left(self.boundaries, value)] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._counts[key] = self._counts.get(key, 0) + 1

    def _samples(self):
        with self._lock:
            out = []
            for key, buckets in self._buckets.items():
                tags = dict(zip(self._tag_keys, key))
                out.append((tags, {"buckets": list(buckets),
                                   "sum": self._sums[key],
                                   "count": self._counts[key]}))
            return out


# ----------------------------------------------------------------- export

def _esc_label(v: str) -> str:
    # Prometheus text exposition: escape backslash, double-quote, newline.
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_tags(tags: Dict[str, str], extra: str = "") -> str:
    # empty-valued labels are omitted: in the Prometheus data model a
    # label set to "" IS the label being absent, so rendering it would
    # only add noise — and lets optional tag keys (e.g. the LLM
    # telemetry's `replica`, empty outside fleets) stay invisible
    # until something sets them
    parts = [f'{k}="{_esc_label(v)}"' for k, v in tags.items()
             if str(v) != ""]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def export_prometheus() -> str:
    """This process's registry in Prometheus text exposition format."""
    lines: List[str] = []
    with _registry_lock:
        metrics = list(_registry.values())
    for m in metrics:
        lines.append(f"# HELP {m._name} {m._description}")
        lines.append(f"# TYPE {m._name} {m.metric_type}")
        if isinstance(m, Histogram):
            for tags, data in m._samples():
                cumulative = 0
                for bound, n in zip(m.boundaries + [float("inf")],
                                    data["buckets"]):
                    cumulative += n
                    le = "+Inf" if bound == float("inf") else repr(bound)
                    lines.append(
                        f"{m._name}_bucket"
                        + _fmt_tags(tags, 'le="%s"' % le)
                        + f" {cumulative}")
                lines.append(
                    f"{m._name}_sum{_fmt_tags(tags)} {data['sum']}")
                lines.append(
                    f"{m._name}_count{_fmt_tags(tags)} {data['count']}")
        else:
            for tags, val in m._samples():
                lines.append(f"{m._name}{_fmt_tags(tags)} {val}")
    return "\n".join(lines) + "\n"


def merge_expositions(texts: Sequence[str]) -> str:
    """Merge several Prometheus text expositions into ONE valid
    document. Naive concatenation is invalid twice over: in-process
    replicas each render the same process-wide registry, so every
    sample appears once per replica (Prometheus rejects duplicate
    series as a parse error), and even across processes the family
    headers repeat (all samples of a family must sit under a single
    # TYPE). Families keep first-appearance order, # HELP/# TYPE come
    from the first block declaring them, and duplicate series keep
    the FIRST value seen — dedup keys on series identity (name +
    label set), not line text, because a live counter can advance
    between two sequential renders of the same registry."""
    order: List[str] = []
    headers: Dict[str, Dict[str, str]] = {}
    samples: Dict[str, List[str]] = {}
    seen: Dict[str, set] = {}
    for text in texts:
        fam = None
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                _, kind, fam = line.split(" ", 3)[:3]
                if fam not in headers:
                    headers[fam] = {}
                    samples[fam] = []
                    seen[fam] = set()
                    order.append(fam)
                headers[fam].setdefault(kind, line)
            elif fam is not None:
                series = line.rsplit(" ", 1)[0]
                if series not in seen[fam]:
                    seen[fam].add(series)
                    samples[fam].append(line)
    lines: List[str] = []
    for fam in order:
        for kind in ("HELP", "TYPE"):
            if kind in headers[fam]:
                lines.append(headers[fam][kind])
        lines.extend(samples[fam])
    return "\n".join(lines) + "\n"


def relabel_exposition(text: str, tags: Dict[str, str]) -> str:
    """Inject labels into every sample of a Prometheus text
    exposition, returning a new document. A label already present
    with a NON-empty value wins (the series owner knew better);
    absent or empty labels are (re)written.

    This is the multi-replica scrape primitive:
    replicas in separate processes render identical series from their
    own registries, so the fleet proxy relabels each scrape with
    `replica="<id>"` before merge_expositions — otherwise the merged
    document would either collide (duplicate series, a Prometheus
    parse error) or silently attribute one replica's counts to
    another. Comment/header lines pass through untouched."""
    import re as _re

    label_re = _re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
    out: List[str] = []
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            out.append(line)
            continue
        m = _re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?"
                      r"( .+)$", line)
        if m is None:
            out.append(line)
            continue
        name, labels, value = m.group(1), m.group(2) or "", m.group(3)
        present = dict(label_re.findall(labels))
        parts = [f'{k}="{v}"' for k, v in label_re.findall(labels)
                 if v != ""]
        for k, v in tags.items():
            if present.get(k, "") == "":
                parts.append(f'{k}="{_esc_label(v)}"')
        out.append(name + ("{" + ",".join(parts) + "}" if parts else "")
                   + value)
    return "\n".join(out) + ("\n" if text.endswith("\n") else "")


def snapshot() -> Dict[str, object]:
    """JSON-able snapshot of this process's registry."""
    out = {}
    with _registry_lock:
        metrics = list(_registry.values())
    for m in metrics:
        out[m._name] = {"type": m.metric_type, "info": m.info,
                        "samples": m._samples()}
    return out


__all__ = ["Counter", "Gauge", "Histogram", "export_prometheus",
           "merge_expositions", "relabel_exposition", "snapshot"]
