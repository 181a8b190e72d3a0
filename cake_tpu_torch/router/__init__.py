"""Front-door router: prefix-affinity load balancing over N engine
replicas (a replicated data plane).

Counterpart of `cake_tpu/router/`, a third process role that holds no
weights and touches no card. Its wire contract (lite health,
SSE bytes, announce frames, hop records) is the JAX router's, so either
package's router fronts either package's replicas.

One thin process in front of N independent `--api` engine servers:

  * `affinity.py` — consistent-hash ring keyed by the request's
    page-aligned prefix fingerprint (the same rounding rule as the
    paged engine's register_prefix), so every conversation sharing a
    system prompt lands on the replica that already holds its prefix
    pages — the engine's per-engine prefix sharing becomes a fleet-level
    cache.
  * `replicas.py` — a per-replica poller of `GET /api/v1/health?lite=1`
    (queue depths, SLO attainment, autotune epoch, draining, breaker)
    with staleness-based ejection and jittered re-probe backoff.
  * `policy.py` — weighted pick: sticky idempotency keys, then
    affinity with a bounded-load spill, then least-loaded healthy.
  * `proxy.py` — streaming SSE pass-through preserving `id:` fields
    and Retry-After headers verbatim, with typed mid-stream error
    mapping.
  * `tracing.py` — router-side distributed tracing: per-request hop
    records (admit, pick + affinity verdict, connect, first byte,
    failover resume, retire) keyed by the minted/propagated
    `x-cake-trace` id; the front-door half of the federated
    `GET /api/v1/requests/{rid}/timeline`.
  * `discovery.py` — fleet discovery (`--router-announce`): replicas
    self-register over a token-gated announce channel (the
    telemetry framing), pushed frames supersede polling while fresh,
    departures drain-then-forget, and pushed headroom/attainment
    compose into placement weight factors with provenance
    (`GET /api/v1/fleet`).
  * `server.py` — the HTTP front door (`cake-tpu --router
    --replicas host:port,...`) with the router-tier event ring,
    federated timeline endpoint and `--sentinel` anomaly detectors
    (obs/sentinel.py).
"""

from cake_tpu_torch.router.affinity import (          # noqa: F401
    HashRing, prefix_fingerprint, text_fingerprint,
)
from cake_tpu_torch.router.discovery import (         # noqa: F401
    AnnounceListener, FleetDiscovery, ReplicaAnnouncer,
)
from cake_tpu_torch.router.policy import NoReplicaError, RoutingPolicy  # noqa: F401
from cake_tpu_torch.router.replicas import ReplicaState, ReplicaTracker  # noqa: F401
from cake_tpu_torch.router.server import RouterServer, start_router  # noqa: F401
from cake_tpu_torch.router.tracing import HopRecord, HopTracer  # noqa: F401
