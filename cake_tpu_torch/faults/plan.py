"""Fault-plan spec: named sites, seeded triggers, typed injected errors.

Counterpart of `cake_tpu/faults/plan.py`, copied as it is: the same
grammar, the same `SITES`, the same parse errors, so one ``--fault-plan``
spec means the same thing to both packages. ``control.publish`` fires in
the coordinator's op publish and ``control.recv`` in a follower's op
receive (serve/control.py, multi-process serving). ``spec.verify`` fires at the
paged engine's speculative round (serve/engine._do_spec_paged), and
``kv.ship`` / ``kv.adopt`` at the disaggregated engines' capture and
adoption seams (serve/engine._capture_shipment, _adopt_install), as in
JAX.

A fault plan is a deterministic description of *where* and *when* the
serving stack should fail, written as a compact spec string
(``--fault-plan``) so every chaos experiment is reproducible from its
command line — no monkeypatching of engine internals:

    seed=42;engine.decode:nth=12:transient;control.publish:p=0.01:oom

Grammar (rules separated by ``;``, fields inside a rule by ``:``)::

    plan  := [ 'seed=N' ';' ] rule ( ';' rule )*
    rule  := site ':' field ( ':' field )*
    field := trigger | error | option
    trigger := 'nth=N'       fire on the Nth matching call to the site
             | 'step=N'      fire once the engine step counter reaches N
             | 'p=F'         fire each matching call with probability F
                             (seeded — same plan+seed => same firings)
             | 'always'      fire on every matching call
    error  := 'transient'    a generic retryable step failure (XLA-ish)
             | 'oom'         a simulated RESOURCE_EXHAUSTED
             | 'wedge'       hold the calling thread for `secs`, then
                             raise (a hung device/tunnel, compressed)
             | 'abort'       hard process death via os._exit
                             (ABORT_EXIT_CODE) — a staged kill -9 for
                             restart/journal-replay crash drills
    option := 'times=N'      total injections this rule may perform (1)
             | 'match_len=N' only calls whose context carries
                             n_tokens == N match (content-keyed faults:
                             a specific request's prefill)
             | 'secs=F'      wedge hold seconds (default 2.0)

Each rule needs exactly one trigger and one error type. Sites are the
fixed names threaded through the hot paths (``SITES`` below); an
unknown site is a loud plan error, not a silent no-op.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

# the injection points threaded through the serving stack; keep in sync
# with the call sites (engine step dispatch, control channel, host KV
# tier, page allocator) and the README "Fault tolerance" table
SITES = frozenset({
    "engine.step",        # top of every engine iteration
    "engine.prefill",     # one admission's prefill (ctx: n_tokens)
    "engine.decode",      # a ragged decode / scan / spec dispatch
    "engine.mixed",       # a mixed (decode+prefill-chunk) dispatch
    "control.publish",    # coordinator -> follower op publish
    "control.recv",       # follower op receive
    "host_tier.fetch",    # device -> host KV page spill
    "host_tier.install",  # host -> device KV page restore
    "pager.alloc",        # page-pool allocation
    "journal.append",     # write-ahead journal record append
    "journal.fsync",      # journal durability barrier (fsync)
    "journal.replay",     # startup journal replay (serve/journal.py)
    "kv.ship",            # disagg prefill host: page-shipment capture
    "kv.adopt",           # disagg decode host: shipped-page adoption
    "spec.verify",        # paged speculative verify round (absorbed:
                          # rows degrade to plain decode, never wedge)
})

TRIGGERS = ("nth", "step", "p", "always")
ERRORS = ("transient", "oom", "wedge", "abort")

# `abort` kills the PROCESS (os._exit — no atexit, no flushes beyond
# what already hit the OS): the in-tree way to stage a kill -9 crash
# drill. The distinctive exit code lets a drill driver (bench.py
# --restart, tests) tell a planned abort from an organic death.
ABORT_EXIT_CODE = 86

# context each call site actually supplies. A rule keyed on context
# its site never passes would parse cleanly and then never fire — a
# silently-inert chaos plan, the exact failure mode the loud-parse
# contract exists to prevent — so parsing rejects the combination.
NO_STEP_SITES = frozenset({"control.publish", "control.recv",
                           "journal.append", "journal.fsync",
                           "journal.replay"})
MATCH_LEN_SITES = frozenset({"engine.prefill"})


class InjectedFault(RuntimeError):
    """Base class for plan-injected failures (site + kind attached so
    logs and classifiers can tell injected chaos from organic faults)."""

    kind = "fault"

    def __init__(self, site: str, detail: str = ""):
        super().__init__(
            f"injected {self.kind} at {site}" + (f": {detail}" if detail
                                                 else ""))
        self.site = site


class InjectedTransient(InjectedFault):
    """A generic retryable step failure (the XLA-error shape)."""

    kind = "transient"


class InjectedOOM(InjectedFault):
    """A simulated RESOURCE_EXHAUSTED allocation failure."""

    kind = "oom"

    def __init__(self, site: str):
        super().__init__(site, "RESOURCE_EXHAUSTED: out of memory "
                               "(simulated)")


class InjectedWedge(InjectedFault):
    """Raised after a wedge rule's hold expires — the compressed form
    of a hung accelerator/tunnel (block, then fail)."""

    kind = "wedge"


@dataclass(frozen=True)
class FaultRule:
    """One parsed plan rule (see the module grammar)."""

    site: str
    trigger: str                    # nth | step | p | always
    value: float = 0.0              # N for nth/step, F for p
    error: str = "transient"        # transient | oom | wedge
    times: int = 1                  # total injections this rule allows
    match_len: Optional[int] = None  # only ctx n_tokens == this matches
    secs: float = 2.0               # wedge hold seconds

    def describe(self) -> str:
        trig = (self.trigger if self.trigger == "always"
                else f"{self.trigger}={self.value:g}")
        extra = "" if self.match_len is None \
            else f":match_len={self.match_len}"
        if self.error == "wedge":
            # keep the echo a faithful spec: a re-parsed describe()
            # must hold the same wedge duration
            extra += f":secs={self.secs:g}"
        return f"{self.site}:{trig}:{self.error}:times={self.times}{extra}"


@dataclass
class FaultPlan:
    """A parsed --fault-plan: rules + the determinism seed."""

    rules: List[FaultRule] = field(default_factory=list)
    seed: int = 0

    @classmethod
    def parse(cls, spec: Optional[str]) -> Optional["FaultPlan"]:
        """Parse a spec string; None/empty => no plan (the injection
        plane stays a no-op). Raises ValueError on any malformed rule —
        a chaos experiment that silently injects nothing is worse than
        a loud config error."""
        if spec is None:
            return None
        spec = spec.strip()
        if not spec:
            return None
        seed = 0
        rules: List[FaultRule] = []
        parts = [p.strip() for p in spec.split(";") if p.strip()]
        if not parts:
            return None
        if parts and parts[0].startswith("seed="):
            seed = _parse_int(parts[0][5:], "seed")
            parts = parts[1:]
        if not parts:
            raise ValueError("fault plan has a seed but no rules")
        for raw in parts:
            rules.append(_parse_rule(raw))
        return cls(rules=rules, seed=seed)

    def describe(self) -> str:
        return f"seed={self.seed};" + ";".join(r.describe()
                                               for r in self.rules)


def _parse_int(s: str, what: str) -> int:
    try:
        v = int(s)
    except ValueError:
        raise ValueError(f"fault plan: {what} takes an integer, "
                         f"got {s!r}")
    return v


def _parse_float(s: str, what: str) -> float:
    try:
        return float(s)
    except ValueError:
        raise ValueError(f"fault plan: {what} takes a number, got {s!r}")


def _parse_rule(raw: str) -> FaultRule:
    fields = [f.strip() for f in raw.split(":") if f.strip()]
    if len(fields) < 2:
        raise ValueError(
            f"fault rule {raw!r} needs at least site:trigger:error "
            "(see cake_tpu_torch/faults/plan.py for the grammar)")
    site = fields[0]
    if site not in SITES:
        raise ValueError(
            f"fault rule {raw!r}: unknown site {site!r} "
            f"(known: {', '.join(sorted(SITES))})")
    trigger: Optional[str] = None
    value = 0.0
    error: Optional[str] = None
    times = 1
    match_len: Optional[int] = None
    secs = 2.0
    for f in fields[1:]:
        key, _, val = f.partition("=")
        if key in ("nth", "step", "p", "always"):
            if trigger is not None:
                raise ValueError(
                    f"fault rule {raw!r}: more than one trigger "
                    f"({trigger!r} and {key!r})")
            trigger = key
            if key == "always":
                if val:
                    raise ValueError(
                        f"fault rule {raw!r}: 'always' takes no value")
            elif key == "p":
                value = _parse_float(val, "p")
                if not 0.0 < value <= 1.0:
                    raise ValueError(
                        f"fault rule {raw!r}: p must be in (0, 1]")
            else:
                value = _parse_int(val, key)
                if value < 1:
                    raise ValueError(
                        f"fault rule {raw!r}: {key} must be >= 1")
        elif key in ERRORS:
            if val:
                raise ValueError(
                    f"fault rule {raw!r}: error kind {key!r} takes no "
                    "value")
            if error is not None:
                raise ValueError(
                    f"fault rule {raw!r}: more than one error kind "
                    f"({error!r} and {key!r})")
            error = key
        elif key == "times":
            times = _parse_int(val, "times")
            if times < 1:
                raise ValueError(
                    f"fault rule {raw!r}: times must be >= 1")
        elif key == "match_len":
            match_len = _parse_int(val, "match_len")
            if match_len < 0:
                raise ValueError(
                    f"fault rule {raw!r}: match_len must be >= 0")
        elif key == "secs":
            secs = _parse_float(val, "secs")
            if secs < 0:
                raise ValueError(
                    f"fault rule {raw!r}: secs must be >= 0")
        else:
            raise ValueError(
                f"fault rule {raw!r}: unknown field {f!r}")
    if trigger is None:
        raise ValueError(
            f"fault rule {raw!r}: needs a trigger "
            "(nth=N | step=N | p=F | always)")
    if error is None:
        raise ValueError(
            f"fault rule {raw!r}: needs an error kind "
            "(transient | oom | wedge)")
    if trigger == "step" and site in NO_STEP_SITES:
        raise ValueError(
            f"fault rule {raw!r}: site {site!r} carries no engine "
            "step counter — a step= trigger there would never fire "
            "(use nth=, p= or always)")
    if match_len is not None and site not in MATCH_LEN_SITES:
        raise ValueError(
            f"fault rule {raw!r}: only "
            f"{', '.join(sorted(MATCH_LEN_SITES))} carries n_tokens "
            "context — match_len= on this site would never fire")
    return FaultRule(site=site, trigger=trigger, value=value, error=error,
                     times=times, match_len=match_len, secs=secs)
