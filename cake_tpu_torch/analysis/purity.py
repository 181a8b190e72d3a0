"""cakelint `capture-purity`: host hygiene inside captured CUDA-graph steps.

The port's counterpart of JAX's `jit-purity` (cake_tpu/analysis/
purity.py). The port has no jit: what runs once and is then replayed is
the Python a CUDA-graph capture runs, the `step` body of every runner
that derives from `serve/graphs._Graphs` (the engine's decode, mixed
and prefill runners, the generator's, the spec runners, the SD UNet
step), run once on a side stream to warm up and once under
`torch.cuda.graph`; every later call replays the recorded kernels and
runs no Python. Its `_idle` body is checked as well: it runs inside the
same capture bracket, just before the warm-up, and what it leaves in the
static buffers is what the captured step reads. In either body these
break a capture or bake a value in:

  * `.item()`, `.cpu()`, `.tolist()`, `.numpy()`: a device-to-host copy,
    which syncs the stream (a capture fails on it) and turns a device
    value into a Python constant of the first run;
  * `torch.cuda.synchronize()` (any `.synchronize()`): illegal on a
    capturing stream;
  * `print(...)`, `time.*`, `random.*`, `np.random.*`: run at capture
    only, so a replay prints nothing and reuses the capture's clock
    reading or draw (draw on the device from a generator instead);
  * `global` declarations (module state mutated at capture only).

JAX's `self.X = ...` check is left out on purpose: a runner keeps its
static output tensors on self, and the tensors a capture allocates and
stores there are the graph's outputs, which every replay rewrites and
the caller reads after it. That is the design of a captured step, not
a hazard.

Closures handed to `on_replay` (run on the host after every replay) or
`segment_cut` (run with no capture open, at a hop) are exempt: they are
host code by design, as JAX exempts its host callbacks.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from cake_tpu_torch.analysis.astutil import dotted, func_symbol
from cake_tpu_torch.analysis.core import Finding, Vocabulary

RULE = "capture-purity"

ROOT_CLASS = "_Graphs"
CAPTURED_METHODS = ("step", "_idle")
_FETCH_ATTRS = ("item", "cpu", "tolist", "numpy")
_HOST_HOOKS = ("on_replay", "segment_cut")


def _base_names(node: ast.ClassDef) -> List[str]:
    out = []
    for b in node.bases:
        chain = dotted(b)
        if chain:
            out.append(chain[-1])
    return out


def _runner_classes(units) -> Set[str]:
    """Names of the classes that derive from `_Graphs`, transitively,
    across every analyzed file (by name: the runners live in several
    modules)."""
    bases: Dict[str, Set[str]] = {}
    for unit in units:
        for node in ast.walk(unit.tree):
            if isinstance(node, ast.ClassDef):
                bases.setdefault(node.name, set()).update(_base_names(node))
    runners: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for name, bs in bases.items():
            if name not in runners and (ROOT_CLASS in bs or bs & runners):
                runners.add(name)
                changed = True
    return runners


def _hook_exempt_ids(fn: ast.AST) -> Set[int]:
    """Subtrees handed to the host-side hooks."""
    out: Set[int] = set()
    names: Set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        chain = dotted(node.func)
        if not chain or chain[-1] not in _HOST_HOOKS:
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Lambda):
                out.add(id(arg))
            elif isinstance(arg, ast.Name):
                names.add(arg.id)
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in names:
            out.add(id(node))
    return out


class _BodyChecker:
    def __init__(self, path: str, symbol: str, findings: List[Finding]):
        self.path = path
        self.symbol = symbol
        self.findings = findings

    def _flag(self, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(
            RULE, self.path, node.lineno, node.col_offset,
            f"{msg} inside captured {self.symbol} (runs at capture "
            "only; a replay runs no Python and reuses what the capture "
            "saw)", symbol=self.symbol))

    def run(self, fn: ast.AST) -> None:
        exempt = _hook_exempt_ids(fn)

        def visit(node: ast.AST) -> None:
            if id(node) in exempt:
                return
            if isinstance(node, ast.Global):
                self._flag(node, "`global " + ", ".join(node.names)
                           + "` mutation")
            elif isinstance(node, ast.Call):
                chain = dotted(node.func)
                attr = (node.func.attr
                        if isinstance(node.func, ast.Attribute) else None)
                if chain == ("print",):
                    self._flag(node, "print() call")
                elif attr in _FETCH_ATTRS:
                    self._flag(node, f".{attr}() device-to-host fetch")
                elif attr == "synchronize":
                    self._flag(node, f"{'.'.join(chain or ('?',))}() "
                               "sync (illegal on a capturing stream)")
                elif chain and chain[0] == "time":
                    self._flag(node, f"{'.'.join(chain)}() call")
                elif chain and (chain[0] == "random" or (
                        len(chain) >= 2 and chain[0] in ("np", "numpy")
                        and chain[1] == "random")):
                    self._flag(node, f"{'.'.join(chain)}() call (draw "
                               "on the device from a torch.Generator)")
            for child in ast.iter_child_nodes(node):
                visit(child)

        for stmt in fn.body:
            visit(stmt)


def check(vocab: Vocabulary, units) -> Tuple[List[Finding], int]:
    findings: List[Finding] = []
    sites = 0
    runners = _runner_classes(units)
    if not runners:
        return findings, sites
    for unit in units:
        for node in ast.walk(unit.tree):
            if not (isinstance(node, ast.ClassDef) and node.name in runners):
                continue
            for fn in node.body:
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and fn.name in CAPTURED_METHODS:
                    sites += 1
                    _BodyChecker(unit.path, func_symbol(node.name, fn.name),
                                 findings).run(fn)
    return findings, sites
