"""Typed request-failure errors for the engine.

Counterpart of `cake_tpu/serve/errors.py` (the part the port's engine
raises). Every request failed by the engine carries an
``EngineRequestError`` with an explicit ``retryable`` flag: the API maps
retryable failures (an engine reset or stop) to 503 + Retry-After and
non-retryable ones to a terminal 500.
"""

from __future__ import annotations


class EngineRequestError(RuntimeError):
    """Base class for engine-originated request failures.

    retryable: True when the SAME request can reasonably be resubmitted
    (the failure was the engine's state, not the request)."""

    retryable = False

    def __init__(self, msg: str, *, retryable=None):
        super().__init__(msg)
        if retryable is not None:
            self.retryable = bool(retryable)


class EngineResetError(EngineRequestError):
    """The engine failed and reset (or stopped) out from under this
    request — transient from the client's point of view: retry."""

    retryable = True


def as_engine_error(err: Exception) -> EngineRequestError:
    """Wrap an arbitrary step failure in the typed, retryable-flagged
    form clients see — idempotent for already-typed errors."""
    if isinstance(err, EngineRequestError):
        return err
    return EngineResetError(
        f"engine failure: {type(err).__name__}: {err}")
