"""cakelint `guards`: optional-plane access discipline.

A class that declares `OPTIONAL_PLANES = ("_faults", "events", ...)`
promises that each named attribute is either a live subsystem or None
(disabled plane), and that *every* dereference — `self._faults.check()`,
`self.events.publish()`, `self._journal.path`, `self._host_tier[...]` —
is dominated by an `is not None` test on the same attribute, so a
disabled plane costs exactly one attribute read per site.

Recognized guard shapes (lexical, per function):

    if self.P is not None: <use>
    if self.P is None: return/raise/continue/break
    ... <use>                      # after the terminal early-exit
    if self.P is None or other: return
    assert self.P is not None
    self.P.x if self.P is not None else y
    self.P is not None and self.P.x(...)
    self.P is None or self.P.x(...)
    while self.P is not None: <use>

`__init__` is exempt: construction is where planes are wired, and its
assignments (`self._journal.owner = self`) happen in the arm that just
created the plane. Aliased uses (`ev = self.events; ev.publish(...)`)
are invisible to this rule by design — the discipline is *direct dotted
access under a visible guard*, which is what keeps the convention
greppable and the disabled-plane cost one attribute test.
"""

from __future__ import annotations

import ast
from typing import List, Set, Tuple

from cake_tpu_torch.analysis.astutil import (
    block_terminates, func_symbol, is_self_attr,
)
from cake_tpu_torch.analysis.core import Finding, Vocabulary

RULE = "guards"


def _plane_of(node: ast.AST, planes: frozenset):
    if isinstance(node, ast.Attribute) and is_self_attr(node) \
            and node.attr in planes:
        return node.attr
    return None


class _FuncChecker:
    def __init__(self, path: str, symbol: str, planes: frozenset,
                 findings: List[Finding]):
        self.path = path
        self.symbol = symbol
        self.planes = planes
        self.findings = findings
        self.sites = 0

    # -- guard extraction ---------------------------------------------------

    def _pos_guards(self, test: ast.AST) -> Set[str]:
        """Planes proven non-None when `test` is truthy."""
        out: Set[str] = set()
        if isinstance(test, ast.Compare) and len(test.ops) == 1 \
                and isinstance(test.ops[0], ast.IsNot) \
                and isinstance(test.comparators[0], ast.Constant) \
                and test.comparators[0].value is None:
            p = _plane_of(test.left, self.planes)
            if p:
                out.add(p)
        elif isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
            for op in test.values:
                out |= self._pos_guards(op)
        return out

    def _neg_guards(self, test: ast.AST) -> Set[str]:
        """Planes proven non-None when `test` is FALSY (i.e. the test
        checked `P is None`, possibly inside an or-chain)."""
        out: Set[str] = set()
        if isinstance(test, ast.Compare) and len(test.ops) == 1 \
                and isinstance(test.ops[0], ast.Is) \
                and isinstance(test.comparators[0], ast.Constant) \
                and test.comparators[0].value is None:
            p = _plane_of(test.left, self.planes)
            if p:
                out.add(p)
        elif isinstance(test, ast.BoolOp) and isinstance(test.op, ast.Or):
            for op in test.values:
                out |= self._neg_guards(op)
        return out

    # -- walking ------------------------------------------------------------

    def run(self, body: List[ast.stmt]) -> None:
        self._block(body, set())

    def _block(self, body: List[ast.stmt], guards: Set[str]) -> None:
        acc = set(guards)
        for stmt in body:
            self._stmt(stmt, acc)
            # a terminal `if P is None:` arm proves P for the rest of
            # the block; assert likewise
            if isinstance(stmt, ast.If) and block_terminates(stmt.body) \
                    and not stmt.orelse:
                acc |= self._neg_guards(stmt.test)
            elif isinstance(stmt, ast.Assert):
                acc |= self._pos_guards(stmt.test)

    def _stmt(self, stmt: ast.stmt, guards: Set[str]) -> None:
        if isinstance(stmt, ast.If):
            self._expr(stmt.test, guards)
            self._block(stmt.body, guards | self._pos_guards(stmt.test))
            self._block(stmt.orelse, guards | self._neg_guards(stmt.test))
        elif isinstance(stmt, ast.While):
            self._expr(stmt.test, guards)
            self._block(stmt.body, guards | self._pos_guards(stmt.test))
            self._block(stmt.orelse, guards)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter, guards)
            self._expr(stmt.target, guards)
            self._block(stmt.body, guards)
            self._block(stmt.orelse, guards)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._expr(item.context_expr, guards)
            self._block(stmt.body, guards)
        elif isinstance(stmt, ast.Try):
            self._block(stmt.body, guards)
            for h in stmt.handlers:
                self._block(h.body, guards)
            self._block(stmt.orelse, guards)
            self._block(stmt.finalbody, guards)
        elif isinstance(stmt, ast.Assert):
            self._expr(stmt.test, guards)
            if stmt.msg is not None:
                self._expr(stmt.msg, guards | self._pos_guards(stmt.test))
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested function: no dominating-guard inheritance — it may
            # run later, when the plane has been swapped
            self._block(stmt.body, set())
        elif isinstance(stmt, ast.ClassDef):
            self._block(stmt.body, set())
        else:
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._expr(child, guards)

    def _expr(self, node: ast.AST, guards: Set[str]) -> None:
        if isinstance(node, ast.BoolOp):
            live = set(guards)
            for op in node.values:
                self._expr(op, live)
                if isinstance(node.op, ast.And):
                    live |= self._pos_guards(op)
                else:
                    live |= self._neg_guards(op)
            return
        if isinstance(node, ast.IfExp):
            self._expr(node.test, guards)
            self._expr(node.body, guards | self._pos_guards(node.test))
            self._expr(node.orelse, guards | self._neg_guards(node.test))
            return
        if isinstance(node, ast.Lambda):
            self._expr(node.body, set())
            return
        # the dereference itself: self.P.attr / self.P[...] / self.P(...)
        inner = None
        if isinstance(node, (ast.Attribute, ast.Subscript)):
            inner = _plane_of(node.value, self.planes)
        elif isinstance(node, ast.Call):
            inner = _plane_of(node.func, self.planes)
        if inner is not None:
            self.sites += 1
            if inner not in guards:
                ref = node.value if isinstance(
                    node, (ast.Attribute, ast.Subscript)) else node.func
                use = (node.attr if isinstance(node, ast.Attribute)
                       else "[...]" if isinstance(node, ast.Subscript)
                       else "(…)")
                self.findings.append(Finding(
                    RULE, self.path, ref.lineno, ref.col_offset,
                    f"self.{inner}.{use}: optional plane {inner!r} "
                    "dereferenced without a dominating `is not None` "
                    "guard (a disabled plane must cost one attribute "
                    "test per site)",
                    symbol=self.symbol))
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.expr, ast.keyword)):
                self._expr(child, guards)
            elif isinstance(child, ast.comprehension):
                self._expr(child.iter, guards)
                for cond in child.ifs:
                    self._expr(cond, guards)


def check(vocab: Vocabulary, units) -> Tuple[List[Finding], int]:
    findings: List[Finding] = []
    sites = 0
    declared = {(c.path, c.name): c for c in vocab.classes if c.planes}
    for unit in units:
        for node in ast.walk(unit.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            decl = declared.get((unit.path, node.name))
            if decl is None:
                continue
            planes = frozenset(decl.planes)
            for fn in node.body:
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                if fn.name in ("__init__", "__post_init__"):
                    continue
                fc = _FuncChecker(unit.path,
                                  func_symbol(node.name, fn.name),
                                  planes, findings)
                fc.run(fn.body)
                sites += fc.sites
    return findings, sites
