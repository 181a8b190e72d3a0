"""Observability of the port's serving engine: the core of
`cake_tpu/obs`, with the same metric names and JSON shapes.

  * `obs.metrics` — the Prometheus-style registry (`Counter`, `Gauge`,
    `Histogram`, with labels) rendering the text exposition served at
    `/metrics` and `/api/v1/metrics`.
  * `obs.tracing` — per-request lifecycle traces in a bounded ring
    (`GET /api/v1/requests`, `--trace-ring`), optionally streamed to a
    JSONL event log (`--trace-events PATH`).
  * `obs.steps` — the step flight recorder (`GET /api/v1/steps`,
    `--step-ring`, `--step-log PATH`) with a FLOP and byte count of the
    port's own (`step_cost`) for MFU / HBM utilization, graph-capture
    counters and the card's HBM gauges.
  * `obs.events` — the typed, request-linked event bus
    (`GET /api/v1/events`, `--event-ring`, `--event-log PATH`).
  * `obs.slo` — SLO attainment and goodput accounting
    (`--slo-targets`).
  * `obs.jsonl` — the append-only, fail-open JSONL writer and the
    corrupt-tail-tolerant reader the logs share.

Not ported yet: the timeline, sentinel, actions and federation planes.
"""

from cake_tpu_torch.obs.events import EVENT_TYPES, Event, EventBus  # noqa: F401
from cake_tpu_torch.obs.jsonl import JsonlAppender, read_jsonl  # noqa: F401
from cake_tpu_torch.obs.metrics import (  # noqa: F401
    REGISTRY, Counter, Gauge, Histogram, Registry, counter, gauge,
    histogram,
)
from cake_tpu_torch.obs.slo import (  # noqa: F401
    DEFAULT_TARGETS, SLOAccountant, SLOTarget, parse_slo_targets,
)
from cake_tpu_torch.obs.tracing import RequestTracer, TraceRecord  # noqa: F401
