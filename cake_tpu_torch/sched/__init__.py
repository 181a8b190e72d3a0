"""SLO-aware scheduling for the port's serving engine.

Counterpart of `cake_tpu/sched`. It wraps the engine's scheduler seam,
with the FIFO (`native/scheduler.py`) as the priority-free fallback:

  1. **Priority classes** (``classes.py``): ``interactive`` /
     ``standard`` / ``batch`` queues with weighted anti-starvation
     aging, so ``plan()`` admits by class, not arrival order.
  2. **Recompute-style preemption** (``slo.py`` victim selection +
     the engine's fold): when a higher class is slot- or page-starved,
     the youngest lowest-class decoding slot is preempted — its
     generated tokens fold into its prompt, its pages release through
     the refcounted allocator, and it requeues with its seniority to
     re-prefill later, with a per-request preemption budget
     guaranteeing progress.
  3. **Load shedding** (``shed.py``): per-class admission probability
     from measured service rate and queue depth, surfaced as HTTP 429
     with an honest computed ``Retry-After``.
"""

from __future__ import annotations

from typing import Optional

from cake_tpu_torch.sched.classes import (  # noqa: F401
    CLASS_RANK, DEFAULT_PRIORITY, PRIORITY_CLASSES, ClassPolicy,
    SchedConfig, validate_priority,
)
from cake_tpu_torch.sched.shed import (  # noqa: F401
    ShedController, ShedDecision, ShedError,
)
from cake_tpu_torch.sched.slo import SLOScheduler  # noqa: F401


def make_scheduler(max_slots: int, max_queue: int = 1024, *,
                   priority_classes: bool = False,
                   config: Optional[SchedConfig] = None):
    """The scheduler seam: the SLO scheduler when priority classes are
    on, else the FIFO fallback unchanged."""
    if priority_classes:
        return SLOScheduler(max_slots, max_queue, config=config)
    from cake_tpu_torch.native.scheduler import make_scheduler as _fifo
    return _fifo(max_slots, max_queue)
