"""Tiny AST helpers shared by the cakelint checkers."""

from __future__ import annotations

import ast
from typing import Optional, Tuple


def dotted(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """('a','b','c') for `a.b.c`, None for anything not a pure
    Name/Attribute chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def is_self_attr(node: ast.AST, attr: Optional[str] = None) -> bool:
    """True for `self.X` (optionally a specific X)."""
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and (attr is None or node.attr == attr))


def expr_key(node: ast.AST) -> str:
    """Structural identity for comparing small expressions (e.g. the
    lock owner in `with eng._switch_lock:` vs the accessed object)."""
    return ast.dump(node)


def is_terminal(stmt: ast.stmt) -> bool:
    """Statement unconditionally leaves the current block."""
    if isinstance(stmt, (ast.Return, ast.Raise, ast.Continue, ast.Break)):
        return True
    if isinstance(stmt, ast.If):
        return (bool(stmt.orelse)
                and block_terminates(stmt.body)
                and block_terminates(stmt.orelse))
    return False


def block_terminates(body) -> bool:
    return bool(body) and is_terminal(body[-1])


def func_symbol(class_name: Optional[str], func_name: str) -> str:
    return f"{class_name}.{func_name}" if class_name else func_name
