"""cakelint `affinity`: thread-affinity discipline.

A class that declares

    ENGINE_THREAD_ATTRS = {"_slot_req": None, "_pager": "_switch_lock"}
    HANDLER_THREAD_METHODS = ("submit", "cancel", ...)

promises that the named attributes are single-writer engine-thread
state. The checker then enforces, statically:

  * inside each HANDLER_THREAD_METHODS entry point, a declared attr may
    only be reached (read OR written) under `with self.<declared lock>:`
    for attrs mapped to a lock, or inside a closure handed to
    `self._run_on_engine_thread(...)` (which executes it on the engine
    thread); attrs mapped to None have no lock that legalizes them;
  * a handler entry point may not call an `@engine_thread_only` method
    directly — only via `_run_on_engine_thread`;
  * every OTHER analyzed module (API server, scrape refreshers,
    checkpoint, tools): any dotted access `<obj>.<declared attr>` on a
    non-self object is flagged unless it sits under
    `with <obj>.<declared lock>:` on the same object.

Methods of the owning class outside HANDLER_THREAD_METHODS are treated
as engine-thread context and not checked — the guarantee is that every
declared non-engine entry surface is clean, with the runtime assert
mode (analysis/annotations.py, CAKE_THREAD_ASSERTS) backstopping
paths the lexical analysis cannot see.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from cake_tpu_torch.analysis.astutil import (
    expr_key, func_symbol, is_self_attr,
)
from cake_tpu_torch.analysis.core import ClassDecl, Finding, Vocabulary

RULE = "affinity"

ROUTER = "_run_on_engine_thread"


def _exempt_subtrees(fn: ast.AST) -> Tuple[Set[int], Set[str]]:
    """AST node ids of closures routed to the engine thread, plus names
    of nested defs so routed."""
    nodes: Set[int] = set()
    names: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and is_self_attr(node.func, ROUTER) \
                and node.args:
            target = node.args[0]
            if isinstance(target, ast.Lambda):
                nodes.add(id(target))
            elif isinstance(target, ast.Name):
                names.add(target.id)
            elif isinstance(target, ast.Call):
                # partial(fn, ...) / functools.partial(fn, ...)
                for arg in target.args:
                    if isinstance(arg, ast.Name):
                        names.add(arg.id)
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in names:
            nodes.add(id(node))
    return nodes, names


class _HandlerWalker:
    """Walk one handler-thread method, tracking held locks."""

    def __init__(self, path: str, symbol: str, decl: ClassDecl,
                 vocab: Vocabulary, findings: List[Finding]):
        self.path = path
        self.symbol = symbol
        self.decl = decl
        self.vocab = vocab
        self.findings = findings
        self.sites = 0
        self.exempt: Set[int] = set()
        self.thread_only = (set(decl.thread_only_methods)
                            | set(vocab.thread_only_methods))

    def run(self, fn: ast.FunctionDef) -> None:
        self.exempt, _names = _exempt_subtrees(fn)
        for stmt in fn.body:
            self._visit(stmt, frozenset())

    def _visit(self, node: ast.AST, held: frozenset) -> None:
        if id(node) in self.exempt:
            return                       # runs on the engine thread
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and held:
            # a closure defined under a lock does NOT run under it: it
            # may fire later on any thread, so its body is checked with
            # no locks held (mirrors guards.py's nested-def reset)
            body = (node.body if isinstance(node.body, list)
                    else [node.body])
            for stmt in body:
                self._visit(stmt, frozenset())
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = set(held)
            for item in node.items:
                if is_self_attr(item.context_expr):
                    acquired.add(item.context_expr.attr)
                self._visit(item.context_expr, held)
            for stmt in node.body:
                self._visit(stmt, frozenset(acquired))
            return
        if isinstance(node, ast.Attribute) and is_self_attr(node) \
                and node.attr in self.decl.engine_attrs:
            self.sites += 1
            lock = self.decl.engine_attrs[node.attr]
            if lock is None or lock not in held:
                want = (f"`with self.{lock}:`" if lock
                        else "no lock grants handler access")
                self.findings.append(Finding(
                    RULE, self.path, node.lineno, node.col_offset,
                    f"self.{node.attr} is engine-thread state touched "
                    f"from handler entry point {self.symbol} ({want}; "
                    "route it through _run_on_engine_thread)",
                    symbol=self.symbol))
        if isinstance(node, ast.Call) and is_self_attr(node.func) \
                and node.func.attr in self.thread_only \
                and node.func.attr != ROUTER:
            self.sites += 1
            self.findings.append(Finding(
                RULE, self.path, node.lineno, node.col_offset,
                f"handler entry point {self.symbol} calls "
                f"@engine_thread_only method {node.func.attr} directly "
                "(route it through _run_on_engine_thread)",
                symbol=self.symbol))
        for child in ast.iter_child_nodes(node):
            self._visit(child, held)


def _foreign_scan(unit, vocab: Vocabulary, owner_spans: List[Tuple[int, int]],
                  findings: List[Finding]) -> int:
    """Flag `<obj>.<engine attr>` on non-self objects anywhere outside
    the owning class bodies, unless under `with <obj>.<lock>:` for the
    attr's declared lock."""
    sites = 0

    def in_owner(line: int) -> bool:
        return any(a <= line <= b for a, b in owner_spans)

    def visit(node: ast.AST, held: Dict[str, Set[str]]) -> None:
        nonlocal sites
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and held:
            # closures do not inherit their definition site's locks
            body = (node.body if isinstance(node.body, list)
                    else [node.body])
            for stmt in body:
                visit(stmt, {})
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new = {k: set(v) for k, v in held.items()}
            for item in node.items:
                ce = item.context_expr
                if isinstance(ce, ast.Attribute):
                    base = expr_key(ce.value)
                    new.setdefault(base, set()).add(ce.attr)
                visit(ce, held)
            for stmt in node.body:
                visit(stmt, new)
            return
        if isinstance(node, ast.Attribute) \
                and node.attr in vocab.engine_attrs \
                and not (isinstance(node.value, ast.Name)
                         and node.value.id == "self") \
                and not in_owner(node.lineno):
            sites += 1
            lock = vocab.engine_attrs[node.attr]
            base = expr_key(node.value)
            if lock is None or lock not in held.get(base, ()):
                want = (f"`with <obj>.{lock}:`" if lock
                        else "engine-thread only; no lock grants access")
                findings.append(Finding(
                    RULE, unit.path, node.lineno, node.col_offset,
                    f".{node.attr} is engine-thread state of another "
                    f"object reached outside its owner ({want})"))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    visit(unit.tree, {})
    return sites


def check(vocab: Vocabulary, units) -> Tuple[List[Finding], int]:
    findings: List[Finding] = []
    sites = 0
    owners = {(c.path, c.name): c for c in vocab.classes
              if c.engine_attrs or c.thread_only_methods
              or c.handler_methods}
    if not owners:
        return findings, sites
    for unit in units:
        spans: List[Tuple[int, int]] = []
        for node in ast.walk(unit.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            decl = owners.get((unit.path, node.name))
            if decl is None:
                continue
            spans.append((node.lineno,
                          getattr(node, "end_lineno", node.lineno)))
            handler: Optional[Set[str]] = set(decl.handler_methods)
            for fn in node.body:
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and fn.name in handler:
                    w = _HandlerWalker(unit.path,
                                       func_symbol(node.name, fn.name),
                                       decl, vocab, findings)
                    w.run(fn)
                    sites += w.sites
        sites += _foreign_scan(unit, vocab, spans, findings)
    return findings, sites
