"""Dependency-free Prometheus-style metrics registry.

Counterpart of `cake_tpu/obs/metrics.py`, copied as it is: the same
families render byte-identical text in both packages. Design contract
(what the JAX package's tools/lint_metrics.py enforces on the output):

  * every metric family renders one `# HELP` and one `# TYPE` line
    followed by its samples;
  * metric names match ``[a-zA-Z_:][a-zA-Z0-9_:]*``, label names match
    ``[a-zA-Z_][a-zA-Z0-9_]*``; label values are escaped (backslash,
    double quote, newline);
  * histograms expose cumulative ``_bucket{le="..."}`` series ending in
    ``le="+Inf"``, plus ``_sum`` and ``_count``, with the +Inf bucket
    equal to ``_count`` — the standard scrape contract, so any
    Prometheus/Grafana stack ingests it unchanged.

Everything is thread-safe: handler threads, the engine thread and the
health sweeper all write concurrently. Metrics live in a process-global
default registry (`REGISTRY`) so the engine, the API layer and the
health monitor need no plumbing to share one exposition; the
``counter()``/``gauge()``/``histogram()`` helpers are get-or-create, so
repeated construction (tests, engine restarts) reuses the same family
instead of colliding.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# latency buckets (seconds) sized for LLM serving: sub-ms host work up
# through multi-minute long-context prefills
DEFAULT_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


def _escape_label_value(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _labels_suffix(labelnames: Tuple[str, ...],
                   labelvalues: Tuple[str, ...],
                   extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = list(zip(labelnames, labelvalues)) + list(extra)
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in pairs)
    return "{" + body + "}"


class _Child:
    """One label set's value cell. The parent holds the lock — children
    of one family share it, so cross-label reads (render) see a
    consistent snapshot."""

    def __init__(self, parent: "MetricFamily",
                 labelvalues: Tuple[str, ...]):
        self._parent = parent
        self._labelvalues = labelvalues
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    # -- counter ----------------------------------------------------------
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0 and self._parent.typ == "counter":
            raise ValueError("counters only go up; use a Gauge")
        with self._parent._lock:
            self._value += amount

    def set_total(self, value: float) -> None:
        """Mirror an externally-maintained monotonic total (e.g.
        EngineStats counters synced at scrape time). Never moves the
        value backwards — a restarted engine's smaller total would
        otherwise break every rate() over the series."""
        with self._parent._lock:
            if value > self._value:
                self._value = float(value)

    # -- gauge ------------------------------------------------------------
    def set(self, value: float) -> None:
        with self._parent._lock:
            self._value = float(value)
            self._fn = None

    def dec(self, amount: float = 1.0) -> None:
        with self._parent._lock:
            self._value -= amount

    def set_function(self, fn: Callable[[], float]) -> None:
        """Evaluate fn() at render time instead of storing a value
        (e.g. heartbeat staleness = now - last_seen)."""
        with self._parent._lock:
            self._fn = fn

    # -- shared ------------------------------------------------------------
    @property
    def value(self) -> float:
        with self._parent._lock:
            return self._read()

    def _read(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 — a scrape must never fail
                return float("nan")
        return self._value


class _HistogramChild:
    def __init__(self, parent: "Histogram",
                 labelvalues: Tuple[str, ...]):
        self._parent = parent
        self._labelvalues = labelvalues
        self._counts = [0] * (len(parent.buckets) + 1)  # +Inf last
        self._sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        with self._parent._lock:
            self._sum += v
            for i, ub in enumerate(self._parent.buckets):
                if v <= ub:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1

    @property
    def count(self) -> int:
        with self._parent._lock:
            return sum(self._counts)

    @property
    def sum(self) -> float:
        with self._parent._lock:
            return self._sum


class MetricFamily:
    """Base: a named metric with optional labels. Unlabeled families
    proxy value methods to their single anonymous child."""

    typ = "untyped"
    _child_cls = _Child

    def __init__(self, name: str, help: str = "",
                 labelnames: Iterable[str] = (),
                 registry: Optional["Registry"] = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help or name
        self.labelnames = tuple(labelnames)
        for ln in self.labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r}")
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = self._child_cls(self, ())
        (registry if registry is not None else REGISTRY).register(self)

    def labels(self, *values, **kw):
        if kw:
            if values:
                raise ValueError("pass labels positionally OR by name")
            try:
                values = tuple(str(kw[ln]) for ln in self.labelnames)
            except KeyError as e:
                raise ValueError(f"missing label {e} for {self.name}")
            if len(kw) != len(self.labelnames):
                raise ValueError(
                    f"unexpected labels for {self.name}: "
                    f"{sorted(set(kw) - set(self.labelnames))}")
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got "
                f"{values}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._child_cls(
                    self, values)
        return child

    def samples(self) -> Dict[Tuple[str, ...], float]:
        """Snapshot of label-values -> current value for every child
        (counters/gauges; histogram children, which have no scalar
        value, are omitted). The public read path for tools that walk a
        family's children without poking registry internals."""
        with self._lock:
            children = list(self._children.items())
        out: Dict[Tuple[str, ...], float] = {}
        for labelvalues, child in children:
            value = getattr(child, "value", None)
            if value is not None:
                out[labelvalues] = value
        return out

    def _single(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; call "
                ".labels(...) first")
        return self._children[()]

    def export(self) -> Dict:
        """Structured snapshot of this family — the telemetry
        federation wire shape (the JAX package's obs/federation.py): name/type/help/
        labelnames plus per-child samples. Counters and gauges ship
        `samples: [[labelvalues], value]`; histograms override this to
        ship cumulative buckets + sum + count, so a remote collector
        can re-render the family (with a host label) exactly as the
        local renderer would."""
        return {
            "name": self.name, "type": self.typ, "help": self.help,
            "labels": list(self.labelnames),
            "samples": [[list(lv), v]
                        for lv, v in self.samples().items()],
        }

    def collect(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.typ}"]
        with self._lock:
            children = list(self._children.items())
        for labelvalues, child in children:
            lines.extend(self._render_child(labelvalues, child))
        return lines

    def _render_child(self, labelvalues, child) -> List[str]:
        suffix = _labels_suffix(self.labelnames, labelvalues)
        return [f"{self.name}{suffix} {_format_value(child.value)}"]


class Counter(MetricFamily):
    typ = "counter"

    def inc(self, amount: float = 1.0) -> None:
        self._single().inc(amount)

    def set_total(self, value: float) -> None:
        self._single().set_total(value)

    @property
    def value(self) -> float:
        return self._single().value


class Gauge(MetricFamily):
    typ = "gauge"

    def set(self, value: float) -> None:
        self._single().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._single().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._single().dec(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._single().set_function(fn)

    @property
    def value(self) -> float:
        return self._single().value


class Histogram(MetricFamily):
    typ = "histogram"
    _child_cls = _HistogramChild

    def __init__(self, name: str, help: str = "",
                 labelnames: Iterable[str] = (),
                 buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS,
                 registry: Optional["Registry"] = None):
        b = sorted(float(x) for x in buckets)
        if not b or b != sorted(set(b)):
            raise ValueError("buckets must be distinct and non-empty")
        if b and b[-1] == math.inf:
            b = b[:-1]           # +Inf is implicit
        self.buckets: Tuple[float, ...] = tuple(b)
        super().__init__(name, help, labelnames, registry)

    def observe(self, value: float) -> None:
        self._single().observe(value)

    @property
    def count(self) -> int:
        return self._single().count

    @property
    def sum(self) -> float:
        return self._single().sum

    def child_samples(self) -> Dict[Tuple[str, ...], Dict]:
        """{labelvalues: {"buckets": [(le, cumulative), ..., (inf, n)],
        "sum": s, "count": n}} — the histogram half of export():
        cumulative counts in increasing le order ending at +Inf, the
        exact series the text renderer emits."""
        with self._lock:
            children = list(self._children.items())
        out: Dict[Tuple[str, ...], Dict] = {}
        for lv, child in children:
            with self._lock:
                counts, s = list(child._counts), child._sum
            cum = 0
            buckets = []
            for ub, c in zip(self.buckets, counts):
                cum += c
                buckets.append((ub, cum))
            cum += counts[-1]
            buckets.append((math.inf, cum))
            out[lv] = {"buckets": buckets, "sum": s, "count": cum}
        return out

    def export(self) -> Dict:
        return {
            "name": self.name, "type": self.typ, "help": self.help,
            "labels": list(self.labelnames),
            "hist": [{"values": list(lv), **hs}
                     for lv, hs in self.child_samples().items()],
        }

    def _render_child(self, labelvalues, child) -> List[str]:
        lines = []
        with self._lock:
            counts, total_sum = list(child._counts), child._sum
        cum = 0
        for ub, c in zip(self.buckets, counts):
            cum += c
            suffix = _labels_suffix(self.labelnames, labelvalues,
                                    extra=(("le", _format_value(ub)),))
            lines.append(f"{self.name}_bucket{suffix} {cum}")
        cum += counts[-1]
        suffix = _labels_suffix(self.labelnames, labelvalues,
                                extra=(("le", "+Inf"),))
        lines.append(f"{self.name}_bucket{suffix} {cum}")
        base = _labels_suffix(self.labelnames, labelvalues)
        lines.append(f"{self.name}_sum{base} {_format_value(total_sum)}")
        lines.append(f"{self.name}_count{base} {cum}")
        return lines


class Registry:
    """Thread-safe metric family registry rendering the text exposition.
    Registration order is preserved (stable scrapes diff cleanly)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, MetricFamily] = {}

    def register(self, metric: MetricFamily) -> MetricFamily:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None and existing is not metric:
                raise ValueError(
                    f"metric {metric.name!r} already registered; use "
                    "the counter()/gauge()/histogram() helpers for "
                    "get-or-create semantics")
            self._metrics[metric.name] = metric
        return metric

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def families(self) -> List[MetricFamily]:
        """Registered families in registration order — the public walk
        for exporters (the JAX package's obs/federation.py ships every family's
        export()) and for callers that need the local family-name set
        without parsing the text exposition."""
        with self._lock:
            return list(self._metrics.values())

    def render(self) -> str:
        with self._lock:
            families = list(self._metrics.values())
        lines: List[str] = []
        for fam in families:
            lines.extend(fam.collect())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()


def _get_or_create(cls, name: str, help: str, labelnames, registry,
                   **kw):
    reg = registry if registry is not None else REGISTRY
    existing = reg.get(name)
    if existing is not None:
        if not isinstance(existing, cls):
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{existing.typ}, not {cls.typ}")
        if existing.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered with labels "
                f"{existing.labelnames}, not {tuple(labelnames)}")
        return existing
    return cls(name, help, labelnames=labelnames, registry=reg, **kw)


def counter(name: str, help: str = "", labelnames: Iterable[str] = (),
            registry: Optional[Registry] = None) -> Counter:
    return _get_or_create(Counter, name, help, tuple(labelnames),
                          registry)


def gauge(name: str, help: str = "", labelnames: Iterable[str] = (),
          registry: Optional[Registry] = None) -> Gauge:
    return _get_or_create(Gauge, name, help, tuple(labelnames), registry)


def histogram(name: str, help: str = "",
              labelnames: Iterable[str] = (),
              buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS,
              registry: Optional[Registry] = None) -> Histogram:
    return _get_or_create(Histogram, name, help, tuple(labelnames),
                          registry, buckets=buckets)
