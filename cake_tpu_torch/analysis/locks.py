"""cakelint `locks`: lock ordering and hold-time discipline.

Driven by two declarations (serve/engine.py):

    LOCK_ORDER = ("_switch_lock", "_rid_lock", "_ckpt_lock")
    NO_BLOCKING_UNDER = ("_rid_lock",)

Enforced, lexically per function plus one level of same-class calls:

  * nested `with` acquires must follow the declared order — taking an
    earlier (or the same — threading.Lock is not reentrant) lock while
    holding a later one is flagged;
  * calling a same-class method that itself acquires lock M while
    lexically holding lock H with rank(M) <= rank(H) is flagged (the
    one-level call-graph closure that catches `submit -> helper` nests);
  * known blocking calls — time.sleep, device_get / block_until_ready
    fetches, socket recv/send/accept/connect, Event.wait / Thread.join,
    select, and the port's torch.cuda / stream / event synchronize() —
    are banned while holding any NO_BLOCKING_UNDER lock: that
    lock sits on the submit/emit hot path and a sleeper under it stalls
    every handler thread.

Lock identity is by attribute NAME (any owner object): the declared
names are distinctive by convention, which also lets the checker see
`with engine._ckpt_lock:` from the checkpoint module.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from cake_tpu_torch.analysis.astutil import dotted, func_symbol
from cake_tpu_torch.analysis.core import Finding, Vocabulary

RULE = "locks"

# (first segment, last segment) exact pairs
_BLOCKING_CHAINS = {("time", "sleep"), ("select", "select")}
# any call whose final attribute is one of these
_BLOCKING_ATTRS = {"device_get", "block_until_ready", "recv", "recvfrom",
                   "accept", "connect", "sendall", "wait", "join",
                   # the port's device fetch: torch.cuda.synchronize(),
                   # a stream's or an event's synchronize()
                   "synchronize"}


def _lock_name(expr: ast.AST, ranks: Dict[str, int]) -> Optional[str]:
    if isinstance(expr, ast.Attribute) and expr.attr in ranks:
        return expr.attr
    if isinstance(expr, ast.Name) and expr.id in ranks:
        return expr.id
    return None


def _blocking_call(node: ast.Call) -> Optional[str]:
    chain = dotted(node.func)
    if chain is None:
        return None
    if len(chain) >= 2 and (chain[0], chain[-1]) in _BLOCKING_CHAINS:
        return ".".join(chain)
    if len(chain) >= 2 and chain[-1] in _BLOCKING_ATTRS:
        return ".".join(chain)
    return None


def _method_acquires(fn: ast.AST, ranks: Dict[str, int]) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                name = _lock_name(item.context_expr, ranks)
                if name:
                    out.add(name)
    return out


class _Walker:
    def __init__(self, path: str, symbol: str, vocab: Vocabulary,
                 acquires: Dict[str, Set[str]], findings: List[Finding]):
        self.path = path
        self.symbol = symbol
        self.ranks = vocab.lock_rank
        self.no_block = vocab.no_blocking_under
        self.acquires = acquires     # same-class method -> locks taken
        self.findings = findings
        self.sites = 0

    def walk(self, node: ast.AST, held: Tuple[str, ...]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # a nested def does not run under the enclosing with; it is
            # walked separately by the top-level pass
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new_held = held
            for item in node.items:
                name = _lock_name(item.context_expr, self.ranks)
                self.walk(item.context_expr, held)
                if name is None:
                    continue
                self.sites += 1
                for h in new_held:
                    if self.ranks[name] == self.ranks[h]:
                        self.findings.append(Finding(
                            RULE, self.path, item.context_expr.lineno,
                            item.context_expr.col_offset,
                            f"re-acquiring held lock {name} "
                            "(threading.Lock is not reentrant: this "
                            "deadlocks)", symbol=self.symbol))
                        break
                    if self.ranks[name] < self.ranks[h]:
                        self.findings.append(Finding(
                            RULE, self.path, item.context_expr.lineno,
                            item.context_expr.col_offset,
                            f"lock order violation: acquiring {name} "
                            f"while holding {h} (declared order: "
                            f"{' -> '.join(sorted(self.ranks, key=self.ranks.get))})",
                            symbol=self.symbol))
                        break
                new_held = new_held + (name,)
            for stmt in node.body:
                self.walk(stmt, new_held)
            return
        if isinstance(node, ast.Call) and held:
            blocked = [h for h in held if h in self.no_block]
            if blocked:
                what = _blocking_call(node)
                if what is not None:
                    self.findings.append(Finding(
                        RULE, self.path, node.lineno, node.col_offset,
                        f"blocking call {what}() while holding "
                        f"{blocked[-1]} (hot-path lock: no sleeps, "
                        "device fetches or socket I/O under it)",
                        symbol=self.symbol))
            # one-level call closure: self.m() where m acquires locks
            fn = node.func
            if isinstance(fn, ast.Attribute) \
                    and isinstance(fn.value, ast.Name) \
                    and fn.value.id == "self" \
                    and fn.attr in self.acquires:
                for lock in sorted(self.acquires[fn.attr]):
                    worst = None
                    for h in held:
                        if self.ranks[lock] <= self.ranks[h]:
                            worst = h
                            break
                    if worst is not None:
                        kind = ("re-acquires" if self.ranks[lock]
                                == self.ranks[worst] else
                                "acquires out of order")
                        self.findings.append(Finding(
                            RULE, self.path, node.lineno,
                            node.col_offset,
                            f"call to self.{fn.attr}() {kind} lock "
                            f"{lock} while holding {worst}",
                            symbol=self.symbol))
        for child in ast.iter_child_nodes(node):
            self.walk(child, held)


def check(vocab: Vocabulary, units) -> Tuple[List[Finding], int]:
    findings: List[Finding] = []
    sites = 0
    if not vocab.lock_rank:
        return findings, sites
    for unit in units:
        # same-class one-level call map
        class_of: Dict[int, Optional[str]] = {}
        acquires_by_class: Dict[Optional[str], Dict[str, Set[str]]] = {}
        for node in ast.walk(unit.tree):
            if isinstance(node, ast.ClassDef):
                table: Dict[str, Set[str]] = {}
                for fn in node.body:
                    if isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                        class_of[id(fn)] = node.name
                        locks = _method_acquires(fn, vocab.lock_rank)
                        if locks:
                            table[fn.name] = locks
                acquires_by_class[node.name] = table

        def top_funcs(tree):
            for node in ast.walk(tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    yield node

        for fn in top_funcs(unit.tree):
            cls = class_of.get(id(fn))
            w = _Walker(unit.path, func_symbol(cls, fn.name), vocab,
                        acquires_by_class.get(cls, {}), findings)
            for stmt in fn.body:
                w.walk(stmt, ())
            sites += w.sites
    return findings, sites
