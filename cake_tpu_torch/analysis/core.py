"""cakelint core: findings, suppressions, baselines, declarations.

Counterpart of `cake_tpu/analysis/core.py`, with the same declaration
vocabulary, suppression grammar, content-addressed baselines and report;
its fourth rule is `capture-purity` (analysis/purity.py), the port's
counterpart of JAX's `jit-purity`. The analyzer is dependency-free (stdlib ast/tokenize only) and runs in
two passes over a file set:

  1. collect — every file is parsed and scanned for *declarations*, the
     in-source vocabulary that drives the checkers:

       ENGINE_THREAD_ATTRS   class attr: dict {attr: lock-or-None} (or a
                             tuple, meaning every attr maps to None) —
                             single-writer engine-thread state; a mapped
                             lock name is the one lock whose holder may
                             touch the attr from a handler thread
       HANDLER_THREAD_METHODS class attr: tuple of method names that run
                             on handler/API/scrape/signal threads
       OPTIONAL_PLANES       class attr: tuple of attr names that hold
                             optional subsystems (None = disabled plane);
                             every dotted use must be `is not None`-guarded
       LOCK_ORDER            class attr: tuple of lock attr names,
                             outermost first — the only legal nesting order
       NO_BLOCKING_UNDER     class attr: tuple of lock attr names under
                             which blocking calls are banned

     plus `@engine_thread_only`-decorated methods (the runtime-assert
     marker from cake_tpu_torch.analysis.annotations).

  2. check — each checker (affinity, guards, locks, capture-purity) walks
     the ASTs against the collected vocabulary and emits Findings.

Suppression grammar (same line as the finding, comment):

    # cakelint: skip[rule] reason text
    # cakelint: skip[rule1,rule2] reason text
    # cakelint: skip[*] reason text

A skip with no reason is itself a finding (`bad-suppression`), as is an
unknown rule name. Baselines store content-addressed fingerprints
(rule + path + normalized source line + duplicate index) so they
survive unrelated line drift.
"""

from __future__ import annotations

import ast
import hashlib
import io
import json
import os
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

RULES = ("affinity", "guards", "locks", "capture-purity")
# core-owned rules (not suppressible targets of themselves)
META_RULES = ("bad-suppression", "parse")

DECL_NAMES = ("ENGINE_THREAD_ATTRS", "HANDLER_THREAD_METHODS",
              "OPTIONAL_PLANES", "LOCK_ORDER", "NO_BLOCKING_UNDER")


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    symbol: str = ""          # class.method or function the finding is in

    def fingerprint(self, src_lines: Sequence[str],
                    dup_index: int = 0) -> str:
        text = ""
        if 1 <= self.line <= len(src_lines):
            text = src_lines[self.line - 1].strip()
        # normalize the path so `pkg/`, `./pkg` and the
        # absolute spelling all fingerprint identically (baselines are
        # written and checked from the repo root either way)
        path = os.path.relpath(os.path.abspath(self.path))
        h = hashlib.sha1()
        h.update("\x1f".join(
            (self.rule, path.replace(os.sep, "/"), self.symbol,
             text, str(dup_index))).encode())
        return h.hexdigest()[:16]

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "symbol": self.symbol}


@dataclass
class ClassDecl:
    """Vocabulary declared by one class (collect pass)."""
    path: str
    name: str
    engine_attrs: Dict[str, Optional[str]] = field(default_factory=dict)
    handler_methods: Tuple[str, ...] = ()
    planes: Tuple[str, ...] = ()
    lock_order: Tuple[str, ...] = ()
    no_blocking_under: Tuple[str, ...] = ()
    thread_only_methods: Tuple[str, ...] = ()


@dataclass
class FileUnit:
    path: str                 # as reported (relative to the scan root)
    tree: ast.Module
    src_lines: List[str]
    suppressions: Dict[int, Tuple[Tuple[str, ...], str]]  # line -> (rules, reason)


@dataclass
class Vocabulary:
    """Merged cross-file view the checkers consume."""
    classes: List[ClassDecl] = field(default_factory=list)
    # attr -> lock-or-None, merged across every ENGINE_THREAD_ATTRS
    engine_attrs: Dict[str, Optional[str]] = field(default_factory=dict)
    # method names carrying @engine_thread_only anywhere
    thread_only_methods: frozenset = frozenset()
    # lock name -> rank (0 = outermost)
    lock_rank: Dict[str, int] = field(default_factory=dict)
    no_blocking_under: frozenset = frozenset()

    def owner_classes(self) -> List[ClassDecl]:
        return [c for c in self.classes
                if c.engine_attrs or c.thread_only_methods]


def _literal_tuple(node: ast.AST) -> Optional[Tuple[str, ...]]:
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out = []
        for el in node.elts:
            if not (isinstance(el, ast.Constant)
                    and isinstance(el.value, str)):
                return None
            out.append(el.value)
        return tuple(out)
    return None


def _literal_attr_map(node: ast.AST) -> Optional[Dict[str, Optional[str]]]:
    tup = _literal_tuple(node)
    if tup is not None:
        return {a: None for a in tup}
    if isinstance(node, ast.Dict):
        out: Dict[str, Optional[str]] = {}
        for k, v in zip(node.keys, node.values):
            if not (isinstance(k, ast.Constant)
                    and isinstance(k.value, str)):
                return None
            if isinstance(v, ast.Constant) and (
                    v.value is None or isinstance(v.value, str)):
                out[k.value] = v.value
            else:
                return None
        return out
    return None


def _is_thread_only_decorator(dec: ast.AST) -> bool:
    if isinstance(dec, ast.Name):
        return dec.id == "engine_thread_only"
    if isinstance(dec, ast.Attribute):
        return dec.attr == "engine_thread_only"
    return False


def collect_class_decls(path: str, tree: ast.Module) -> List[ClassDecl]:
    decls = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        d = ClassDecl(path=path, name=node.name)
        thread_only = []
        for stmt in node.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                name = stmt.targets[0].id
                if name == "ENGINE_THREAD_ATTRS":
                    d.engine_attrs = _literal_attr_map(stmt.value) or {}
                elif name == "HANDLER_THREAD_METHODS":
                    d.handler_methods = _literal_tuple(stmt.value) or ()
                elif name == "OPTIONAL_PLANES":
                    d.planes = _literal_tuple(stmt.value) or ()
                elif name == "LOCK_ORDER":
                    d.lock_order = _literal_tuple(stmt.value) or ()
                elif name == "NO_BLOCKING_UNDER":
                    d.no_blocking_under = _literal_tuple(stmt.value) or ()
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(_is_thread_only_decorator(dc)
                       for dc in stmt.decorator_list):
                    thread_only.append(stmt.name)
        d.thread_only_methods = tuple(thread_only)
        if (d.engine_attrs or d.handler_methods or d.planes
                or d.lock_order or d.no_blocking_under
                or d.thread_only_methods):
            decls.append(d)
    return decls


def build_vocabulary(units: Sequence[FileUnit]) -> Tuple[Vocabulary,
                                                         List[Finding]]:
    vocab = Vocabulary()
    findings: List[Finding] = []
    orders: List[Tuple[str, Tuple[str, ...]]] = []
    thread_only: set = set()
    no_block: set = set()
    for u in units:
        for d in collect_class_decls(u.path, u.tree):
            vocab.classes.append(d)
            vocab.engine_attrs.update(d.engine_attrs)
            thread_only.update(d.thread_only_methods)
            no_block.update(d.no_blocking_under)
            if d.lock_order:
                orders.append((u.path, d.lock_order))
    # merge lock orders; two declarations that disagree on relative
    # order are a configuration error worth failing loudly on
    merged: List[str] = []
    for path, order in orders:
        for name in order:
            if name not in merged:
                merged.append(name)
        ranks = {n: i for i, n in enumerate(merged)}
        prev = -1
        for name in order:
            if ranks[name] < prev:
                findings.append(Finding(
                    "locks", path, 1, 0,
                    f"conflicting LOCK_ORDER declarations: {order!r} "
                    f"disagrees with previously declared order "
                    f"{tuple(merged)!r}"))
                break
            prev = ranks[name]
    vocab.lock_rank = {n: i for i, n in enumerate(merged)}
    vocab.thread_only_methods = frozenset(thread_only)
    vocab.no_blocking_under = frozenset(no_block)
    return vocab, findings


# -- suppressions ------------------------------------------------------------

_SKIP_PREFIX = "cakelint:"


def parse_suppressions(src: str, path: str):
    """(line -> (rules, reason), findings-for-malformed-skips)."""
    supp: Dict[int, Tuple[Tuple[str, ...], str]] = {}
    findings: List[Finding] = []
    try:
        toks = tokenize.generate_tokens(io.StringIO(src).readline)
        comments = [(t.start[0], t.string) for t in toks
                    if t.type == tokenize.COMMENT]
    except (tokenize.TokenError, SyntaxError, IndentationError):
        comments = []
    for line, text in comments:
        body = text.lstrip("#").strip()
        if not body.startswith(_SKIP_PREFIX):
            continue
        directive = body[len(_SKIP_PREFIX):].strip()
        if not directive.startswith("skip["):
            findings.append(Finding(
                "bad-suppression", path, line, 0,
                f"unrecognized cakelint directive {directive!r} "
                "(grammar: `# cakelint: skip[rule] reason`)"))
            continue
        end = directive.find("]")
        if end < 0:
            findings.append(Finding(
                "bad-suppression", path, line, 0,
                "unterminated rule list in cakelint skip"))
            continue
        rules = tuple(r.strip() for r in directive[5:end].split(",")
                      if r.strip())
        reason = directive[end + 1:].strip()
        bad = [r for r in rules if r != "*" and r not in RULES]
        if not rules or bad:
            findings.append(Finding(
                "bad-suppression", path, line, 0,
                f"unknown rule(s) {bad or ['<empty>']} in cakelint skip "
                f"(known: {', '.join(RULES)}, or *)"))
            continue
        if not reason:
            findings.append(Finding(
                "bad-suppression", path, line, 0,
                f"cakelint skip[{','.join(rules)}] carries no reason — "
                "every suppression must say why the exception is safe"))
            continue
        supp[line] = (rules, reason)
    return supp, findings


def _suppressed(f: Finding, unit: FileUnit) -> bool:
    # a directive covers its own line (trailing comment) and the line
    # below it (standalone comment line, where long reasons fit)
    for ent in (unit.suppressions.get(f.line),
                unit.suppressions.get(f.line - 1)):
        if ent is not None:
            rules, _reason = ent
            if "*" in rules or f.rule in rules:
                return True
    return False


# -- baseline ----------------------------------------------------------------

def load_baseline(path: str) -> set:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    if not isinstance(data, dict) or data.get("version") != 1:
        raise ValueError(f"unsupported baseline format in {path}")
    return set(data.get("fingerprints", ()))


def write_baseline(path: str, fingerprints: Sequence[str]) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": 1,
                   "fingerprints": sorted(set(fingerprints))},
                  fh, indent=1, sort_keys=True)
        fh.write("\n")


def assign_fingerprints(findings: Sequence[Finding],
                        units: Dict[str, FileUnit]) -> List[str]:
    """Stable content fingerprints; duplicates on identical lines get an
    occurrence index so a baseline can hold N-of-a-kind."""
    seen: Dict[str, int] = {}
    out = []
    for f in findings:
        u = units.get(f.path)
        lines = u.src_lines if u is not None else []
        base = f.fingerprint(lines, 0)
        idx = seen.get(base, 0)
        seen[base] = idx + 1
        out.append(f.fingerprint(lines, idx) if idx else base)
    return out


# -- driver ------------------------------------------------------------------

def iter_python_files(paths: Sequence[str]) -> List[Tuple[str, str]]:
    """[(display_path, abs_path)] for .py files under the given paths,
    skipping caches/hidden dirs."""
    out = []
    for p in paths:
        if os.path.isfile(p):
            out.append((p, os.path.abspath(p)))
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if not d.startswith(".")
                             and d != "__pycache__")
            for fn in sorted(files):
                if fn.endswith(".py"):
                    full = os.path.join(root, fn)
                    out.append((full, os.path.abspath(full)))
    return out


def analyze(paths: Sequence[str], rules: Optional[Sequence[str]] = None,
            baseline: Optional[set] = None) -> dict:
    """Run the collect+check passes. Returns a report dict:

      findings      unsuppressed, unbaselined Finding objects
      fingerprints  aligned with findings
      suppressed / baselined   counts
      sites         per-rule count of checked use sites (a checker that
                    saw zero sites cannot vacuously pass a gate test)
      files         number of files parsed
    """
    from cake_tpu_torch.analysis import affinity, guards, locks, purity
    checkers = {"affinity": affinity, "guards": guards,
                "locks": locks, "capture-purity": purity}
    active = list(rules) if rules else list(RULES)
    for r in active:
        if r not in checkers:
            raise ValueError(f"unknown rule {r!r} (known: "
                             f"{', '.join(RULES)})")

    units: Dict[str, FileUnit] = {}
    findings: List[Finding] = []
    for disp, full in iter_python_files(paths):
        try:
            src = open(full, encoding="utf-8").read()
            tree = ast.parse(src, filename=disp)
        except (OSError, SyntaxError, ValueError) as e:
            findings.append(Finding(
                "parse", disp, getattr(e, "lineno", 1) or 1, 0,
                f"could not parse: {e}"))
            continue
        supp, supp_findings = parse_suppressions(src, disp)
        findings.extend(supp_findings)
        units[disp] = FileUnit(path=disp, tree=tree,
                               src_lines=src.splitlines(),
                               suppressions=supp)

    ordered = list(units.values())
    vocab, vocab_findings = build_vocabulary(ordered)
    findings.extend(vocab_findings)

    sites: Dict[str, int] = {}
    for rule in active:
        mod = checkers[rule]
        got, n_sites = mod.check(vocab, ordered)
        sites[rule] = n_sites
        findings.extend(got)

    kept: List[Finding] = []
    n_supp = 0
    for f in findings:
        u = units.get(f.path)
        if u is not None and f.rule not in META_RULES \
                and _suppressed(f, u):
            n_supp += 1
            continue
        kept.append(f)

    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    fps = assign_fingerprints(kept, units)
    n_base = 0
    if baseline:
        filtered, ffps = [], []
        for f, fp in zip(kept, fps):
            if fp in baseline:
                n_base += 1
            else:
                filtered.append(f)
                ffps.append(fp)
        kept, fps = filtered, ffps

    counts: Dict[str, int] = {}
    for f in kept:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return {"findings": kept, "fingerprints": fps, "counts": counts,
            "suppressed": n_supp, "baselined": n_base,
            "sites": sites, "files": len(units)}
