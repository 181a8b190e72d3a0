"""Deterministic fault injection for the serving stack.

Counterpart of `cake_tpu/faults`. A ``--fault-plan`` spec names WHERE
(sites threaded through the engine), WHEN (nth call / step count /
seeded probability / always) and WHAT (transient, simulated OOM,
simulated wedge, process abort) should fail, so a chaos experiment is
reproducible from its command line. Without a plan the plane is one
``is not None`` test per site.

See plan.py for the spec grammar and injector.py for runtime semantics.
"""

from cake_tpu_torch.faults.injector import FaultInjector, build_injector
from cake_tpu_torch.faults.plan import (
    ABORT_EXIT_CODE, ERRORS, SITES, TRIGGERS, FaultPlan, FaultRule,
    InjectedFault, InjectedOOM, InjectedTransient, InjectedWedge,
)

__all__ = [
    "ABORT_EXIT_CODE", "ERRORS", "SITES", "TRIGGERS",
    "FaultInjector", "FaultPlan", "FaultRule",
    "InjectedFault", "InjectedOOM", "InjectedTransient", "InjectedWedge",
    "build_injector",
]
