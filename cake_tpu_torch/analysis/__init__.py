"""cakelint over the port: AST-level concurrency & capture-discipline
analyzer.

Counterpart of `cake_tpu/analysis/`. Static half:
`python -m cake_tpu_torch.tools.cakelint cake_tpu_torch/` drives
`analyze()` with four checkers (affinity, guards, locks, capture-purity)
plus a shared suppression/baseline core; see core.py for the in-source
declaration vocabulary. Runtime half: the `@engine_thread_only`
decorator (annotations.py), armed by CAKE_THREAD_ASSERTS, backstops the
affinity rule dynamically.

This package import stays cheap (stdlib only) because serving code
imports the decorator from here.
"""

from cake_tpu_torch.analysis.annotations import (  # noqa: F401
    ASSERT_ENV, WrongThreadError, engine_thread_only,
    thread_asserts_enabled,
)

__all__ = ["engine_thread_only", "WrongThreadError", "ASSERT_ENV",
           "thread_asserts_enabled", "analyze"]


def analyze(paths, rules=None, baseline=None):
    """Lazy alias for core.analyze (keeps ast/tokenize out of the
    serving import path)."""
    from cake_tpu_torch.analysis import core
    return core.analyze(paths, rules=rules, baseline=baseline)
