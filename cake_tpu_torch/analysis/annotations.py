"""Runtime half of the cakelint thread-affinity vocabulary.

Counterpart of `cake_tpu/analysis/annotations.py`. The static checker
(analysis/affinity.py, driven by `python -m cake_tpu_torch.tools.cakelint`)
proves that declared handler-thread entry points only
reach engine-thread-only state through `_run_on_engine_thread` or a
declared lock. This module is the *dynamic backstop*: methods decorated
`@engine_thread_only` assert — when CAKE_THREAD_ASSERTS is set, as
tier-1 does via tests/conftest.py — that they are actually executing on
their owner's engine thread. Off (the production default) the decorator
returns the function unchanged, so the backstop costs nothing: not a
wrapper frame, not an env read per call.

The ownership probe is `self._thread` (the engine's thread handle, see
serve/engine.py start()). A dead or not-yet-started owner passes: the
pre-start direct-drive paths (tests, checkpoint restore) and the
post-join inline teardown in stop()/cancel() are single-threaded by
construction, which is exactly the affinity claim.
"""

from __future__ import annotations

import functools
import os
import threading

# set to any non-empty value other than 0/false/off to arm the asserts
ASSERT_ENV = "CAKE_THREAD_ASSERTS"

# marker the static checker keys on; also set on the wrapper so
# introspection works in both modes
MARKER = "__engine_thread_only__"


def thread_asserts_enabled() -> bool:
    return os.environ.get(ASSERT_ENV, "").lower() not in (
        "", "0", "false", "off")


# every violation raised in this process, "Class.method on thread": a
# driver whose engines run on threads it does not watch reads it (the
# engine's loop may catch the raise as a step fault)
VIOLATIONS: list = []


class WrongThreadError(AssertionError):
    """An @engine_thread_only method ran on a foreign thread while the
    engine thread was alive (a thread-affinity violation the static
    checker could not see — e.g. a call through getattr)."""


def engine_thread_only(fn):
    """Declare a method engine-thread-only.

    Statically: cakelint's affinity checker flags any call to this
    method from a declared handler-thread entry point that is not routed
    through `_run_on_engine_thread` (suppressible with a written
    reason). Dynamically (CAKE_THREAD_ASSERTS): raises WrongThreadError
    when invoked off the owner thread while that thread is alive.
    """
    setattr(fn, MARKER, True)
    if not thread_asserts_enabled():
        # zero-cost no-op: the undecorated function itself
        return fn

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        owner = getattr(self, "_thread", None)
        if owner is not None and owner.is_alive():
            cur = threading.current_thread()
            if cur is not owner:
                VIOLATIONS.append(f"{type(self).__name__}.{fn.__name__} "
                                  f"on {cur.name}")
                raise WrongThreadError(
                    f"{type(self).__name__}.{fn.__name__} is "
                    f"engine-thread-only but ran on {cur.name!r} while "
                    f"engine thread {owner.name!r} is alive (route it "
                    "through _run_on_engine_thread or a declared lock)")
        return fn(self, *args, **kwargs)

    setattr(wrapper, MARKER, True)
    return wrapper
