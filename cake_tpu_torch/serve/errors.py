"""Typed request-failure errors and recovery tuning for the engine.

Counterpart of `cake_tpu/serve/errors.py`. Every request failed
by the engine carries an ``EngineRequestError`` with an explicit
``retryable`` flag: the API maps retryable failures (an engine reset or
a storm-breaker stop) to 503 + Retry-After and non-retryable ones (a
poison request that kept crashing the step it was in) to a terminal 500.
A refused admission while draining is a ``DrainingError`` (429), and a
live config switch asked for while another runs a
``SwitchInFlightError`` (409).
"""

from __future__ import annotations

from dataclasses import dataclass


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


class PoisonRequestError(EngineRequestError):
    """This request was implicated in `implication_budget` consecutive
    failed steps and quarantined so the rest of the batch could
    recover. NOT retryable: resubmitting the same request would crash
    the engine again."""

    retryable = False

    def __init__(self, rid: int, crashes: int, cause: str):
        super().__init__(
            f"request {rid} quarantined after being implicated in "
            f"{crashes} consecutive failed engine steps (poison "
            f"request; last failure: {cause})")
        self.rid = rid
        self.crashes = crashes


class DrainingError(Exception):
    """Admission refused because the server is draining (POST
    /api/v1/drain or a SIGTERM in flight). Not an EngineRequestError:
    the request was never admitted; the API maps it to HTTP 429 with the
    computed seconds until the drain completes as Retry-After."""

    def __init__(self, retry_after: float = 1.0):
        super().__init__("server draining: admissions are closed")
        self.retry_after = retry_after


class SwitchInFlightError(RuntimeError):
    """A live config switch (serve/engine.reconfigure) was requested
    while another switch is still folding and rebuilding. Not an
    EngineRequestError: no request failed — the API maps it to HTTP 409
    and the caller retries after the in-flight switch lands."""


def as_engine_error(err: Exception) -> EngineRequestError:
    """Wrap an arbitrary step failure in the typed, retryable-flagged
    form clients see — idempotent for already-typed errors."""
    if isinstance(err, EngineRequestError):
        return err
    return EngineResetError(
        f"engine failure: {type(err).__name__}: {err}")


@dataclass(frozen=True)
class RecoveryConfig:
    """Knobs for the crash-recovery loop (serve/engine._attempt_recovery).

    implication_budget: a request implicated in this many CONSECUTIVE
      failed steps is quarantined as poison (2 = one retry: the first
      failure could be anyone's; a second with the same request in the
      blast radius is on it).
    backoff_base_s/backoff_cap_s: exponential backoff between
      consecutive resets (the first reset is immediate; the k-th waits
      min(base * 2^(k-2), cap)).
    storm_resets/storm_window_s: the reset-storm breaker: this many
      resets inside the window means the fault is not transient, so the
      engine snapshots its in-flight requests and stops cleanly.
    """

    implication_budget: int = 2
    backoff_base_s: float = 0.5
    backoff_cap_s: float = 10.0
    storm_resets: int = 5
    storm_window_s: float = 60.0
