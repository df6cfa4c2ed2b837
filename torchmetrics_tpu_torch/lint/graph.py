# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Package-wide module graphs for the cross-file metriclint rules
(counterpart of ``torchmetrics_tpu/lint/graph.py``).

Two structures, both built once per lint run (stdlib-only, like the rest of
the package):

- :class:`ModuleSet` — a rel-path-keyed registry of parsed modules, seeded
  from the run's parsed trees and able to lazily parse further files under
  the lint root, so linting a single file still resolves its imports
  package-wide (the ``--diff`` contract: the REPORT set shrinks, the graphs
  never do).
- :class:`ImportGraph` — module-level import edges with the loader
  semantics the by-path surfaces actually use: an absolute package import
  executes every parent ``__init__`` (edges to each), a relative import
  inside a by-path-loaded package executes only the sibling file, and a
  ``spec_from_file_location`` load is a deliberate boundary break that
  creates no edge at all (the metricscope / ``_reduction_names`` idiom).
- :class:`CallGraph` — every function/method def keyed by
  ``(rel_path, qualname)`` with best-effort call resolution: lexical nested
  defs, module-level defs, ``from X import f`` aliases, and ``self.method``
  within the lexically enclosing class. Unresolvable calls resolve to
  ``None`` — a ratchet linter prefers missing a finding over inventing one.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

#: sentinel targets for an import edge that reaches a module outside the
#: lint root the port's contracts name: jax/jaxlib, the JAX package, torch
#: and numpy
JAX = "<jax>"
JAX_PACKAGE = "<torchmetrics_tpu>"
TORCH = "<torch>"
NUMPY = "<numpy>"

#: what the port itself must never reach at module level
PORT_FORBIDDEN = frozenset((JAX, JAX_PACKAGE))
#: what a stdlib-only surface must never reach at module level
STDLIB_FORBIDDEN = frozenset((JAX, JAX_PACKAGE, TORCH, NUMPY))


def external_target(top: str) -> Optional[str]:
    """The sentinel for a top-level module name, or None for anything else."""
    if top == "jaxlib" or top.startswith("jax"):
        return JAX
    if top == "torchmetrics_tpu":
        return JAX_PACKAGE
    if top == "torch":
        return TORCH
    if top == "numpy":
        return NUMPY
    return None


def _is_type_checking_test(test: ast.expr) -> bool:
    return (isinstance(test, ast.Name) and test.id == "TYPE_CHECKING") or (
        isinstance(test, ast.Attribute) and test.attr == "TYPE_CHECKING"
    )


def iter_module_level_imports(tree: ast.Module) -> Iterator[ast.stmt]:
    """Module-level ``import``/``from`` statements, descending into
    module-level ``if``/``try``/``with`` blocks but never into function or
    class bodies, and skipping ``if TYPE_CHECKING:`` bodies (annotations-only
    imports never execute)."""
    stack: List[ast.stmt] = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield node
        elif isinstance(node, ast.If):
            if not _is_type_checking_test(node.test):
                stack.extend(node.body)
            stack.extend(node.orelse)
        elif isinstance(node, ast.Try):
            stack.extend(node.body)
            stack.extend(node.orelse)
            stack.extend(node.finalbody)
            for handler in node.handlers:
                stack.extend(handler.body)
        elif isinstance(node, ast.With):
            stack.extend(node.body)


class ModuleSet:
    """Parsed modules by repo-relative posix path, lazily extended from disk.

    The lint run seeds it with every tree it already parsed; import
    resolution may need files outside the lint set (a tools CLI pulling a
    ``torchmetrics_tpu`` module), which are parsed on first touch and cached
    (including negative results)."""

    def __init__(self, root: str, trees: Dict[str, ast.Module]) -> None:
        self.root = root
        self._trees: Dict[str, Optional[ast.Module]] = dict(trees)

    def tree(self, rel: str) -> Optional[ast.Module]:
        if rel in self._trees:
            return self._trees[rel]
        path = os.path.join(self.root, rel.replace("/", os.sep))
        result: Optional[ast.Module] = None
        if os.path.isfile(path):
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    result = ast.parse(fh.read(), filename=path)
            except (OSError, SyntaxError):
                result = None
        self._trees[rel] = result
        return result

    def exists(self, rel: str) -> bool:
        if rel in self._trees:
            return self._trees[rel] is not None
        return os.path.isfile(os.path.join(self.root, rel.replace("/", os.sep)))

    def resolve_file(self, slash_path: str) -> Optional[str]:
        """``a/b/c`` -> ``a/b/c.py`` or ``a/b/c/__init__.py``, whichever exists."""
        for candidate in (slash_path + ".py", slash_path + "/__init__.py"):
            if self.exists(candidate):
                return candidate
        return None

    def resolve_module(self, dotted: str) -> Optional[str]:
        """Dotted module name -> rel path under the lint root, or None."""
        return self.resolve_file(dotted.replace(".", "/"))


@dataclasses.dataclass(frozen=True)
class ImportHop:
    """One edge in a reachability chain: ``source`` imports ``target``
    (a rel path, or a sentinel such as :data:`JAX`) at ``lineno`` (as
    ``spelled`` in source)."""

    source: str
    target: str
    lineno: int
    spelled: str


class ImportGraph:
    """Module-level import edges over a :class:`ModuleSet`."""

    def __init__(self, modules: ModuleSet) -> None:
        self._modules = modules
        self._edges_cache: Dict[str, List[ImportHop]] = {}

    def edges(self, rel: str) -> List[ImportHop]:
        if rel in self._edges_cache:
            return self._edges_cache[rel]
        out: List[ImportHop] = []
        tree = self._modules.tree(rel)
        if tree is not None:
            for node in iter_module_level_imports(tree):
                out.extend(self._stmt_edges(rel, node))
        self._edges_cache[rel] = out
        return out

    def _stmt_edges(self, rel: str, node: ast.stmt) -> Iterator[ImportHop]:
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield from self._absolute_edges(rel, alias.name, (), node.lineno)
        elif isinstance(node, ast.ImportFrom):
            names = tuple(a.name for a in node.names)
            if node.level == 0:
                yield from self._absolute_edges(rel, node.module or "", names, node.lineno)
            else:
                yield from self._relative_edges(rel, node, names)

    def _absolute_edges(
        self, rel: str, module: str, names: Sequence[str], lineno: int
    ) -> Iterator[ImportHop]:
        parts = [p for p in module.split(".") if p]
        if not parts:
            return
        sentinel = external_target(parts[0])
        if sentinel is not None:
            yield ImportHop(rel, sentinel, lineno, module)
            return
        emitted = False
        # importing a.b.c executes a/__init__, a/b/__init__ AND a/b/c
        for i in range(1, len(parts) + 1):
            target = self._modules.resolve_file("/".join(parts[:i]))
            if target is not None and target != rel:
                emitted = True
                yield ImportHop(rel, target, lineno, ".".join(parts[:i]))
        # ``from a.b import c`` may name the submodule a/b/c.py
        for name in names:
            target = self._modules.resolve_file("/".join(parts + [name]))
            if target is not None and target != rel:
                emitted = True
                yield ImportHop(rel, target, lineno, module + "." + name)
        if not emitted:
            # script semantics: a __main__-run file has its OWN directory on
            # sys.path, so `import sibling` resolves next to it (file-wise,
            # no parent-__init__ edges — nothing else executes)
            base_parts = rel.split("/")[:-1]
            target = self._modules.resolve_file("/".join(base_parts + parts))
            if target is not None and target != rel:
                yield ImportHop(rel, target, lineno, module)
            for name in names:
                sub = self._modules.resolve_file("/".join(base_parts + parts + [name]))
                if sub is not None and sub != rel:
                    yield ImportHop(rel, sub, lineno, module + "." + name)

    def _relative_edges(
        self, rel: str, node: ast.ImportFrom, names: Sequence[str]
    ) -> Iterator[ImportHop]:
        # relative imports resolve file-wise WITHOUT parent-__init__ edges:
        # inside a by-path-loaded package no parent init runs, and inside a
        # normally-imported one the parent is already on the chain that got us
        # here — either way the only NEW execution is the sibling file itself
        pkg_parts = rel.split("/")[:-1]
        if node.level - 1 > len(pkg_parts):
            return
        base_parts = pkg_parts[: len(pkg_parts) - (node.level - 1)]
        mod_parts = [p for p in (node.module or "").split(".") if p]
        dots = "." * node.level
        if node.module:
            base = "/".join(base_parts + mod_parts)
            target = self._modules.resolve_file(base)
            if target is not None and target != rel:
                yield ImportHop(rel, target, node.lineno, dots + node.module)
            for name in names:
                sub = self._modules.resolve_file(base + "/" + name)
                if sub is not None and sub != rel:
                    yield ImportHop(rel, sub, node.lineno, f"{dots}{node.module}.{name}")
        else:
            for name in names:
                target = self._modules.resolve_file("/".join(base_parts + [name]))
                if target is not None and target != rel:
                    yield ImportHop(rel, target, node.lineno, dots + name)

    def chain_to(self, start: str, targets: frozenset) -> Optional[List[ImportHop]]:
        """Shortest module-level import chain from ``start`` to one of the
        sentinel ``targets``, or ``None`` when none is reachable. The first
        hop belongs to ``start`` itself (its lineno anchors the violation)."""
        parent: Dict[str, ImportHop] = {}
        visited = {start}
        frontier = [start]
        while frontier:
            nxt: List[str] = []
            for rel in frontier:
                for hop in self.edges(rel):
                    if hop.target in targets:
                        chain = [hop]
                        cur = rel
                        while cur != start:
                            chain.append(parent[cur])
                            cur = parent[cur].source
                        return list(reversed(chain))
                    if hop.target.startswith("<"):
                        continue  # another external module: not followed
                    if hop.target not in visited:
                        visited.add(hop.target)
                        parent[hop.target] = hop
                        nxt.append(hop.target)
            frontier = nxt
        return None


# ------------------------------------------------------------- call graph


@dataclasses.dataclass
class FuncInfo:
    rel: str
    qualname: str
    node: ast.FunctionDef
    class_name: Optional[str]  # lexically enclosing class, when a method
    parent: Optional[str]  # qualname of the lexically enclosing function


class CallGraph:
    """Every def in the parsed set, with best-effort call resolution."""

    def __init__(self, modules: ModuleSet, trees: Dict[str, ast.Module]) -> None:
        self._modules = modules
        self.funcs: Dict[Tuple[str, str], FuncInfo] = {}
        #: module-level def name -> FuncInfo, per file
        self.toplevel: Dict[str, Dict[str, FuncInfo]] = {}
        #: (rel, class name) -> method name -> FuncInfo
        self.methods: Dict[Tuple[str, str], Dict[str, FuncInfo]] = {}
        #: (rel, enclosing qualname) -> nested def name -> FuncInfo
        self.children: Dict[Tuple[str, str], Dict[str, FuncInfo]] = {}
        #: local name -> (target rel, remote def name) from module-level
        #: ``from X import f`` statements, per file
        self.from_imports: Dict[str, Dict[str, Tuple[str, str]]] = {}
        #: every call expression with its enclosing function (None at module
        #: level) — the seed scan for ML011 walks this
        self.calls: List[Tuple[str, Optional[FuncInfo], ast.Call]] = []
        self._resolved: Dict[Tuple[int, int], Optional[FuncInfo]] = {}
        for rel, tree in trees.items():
            self._index_file(rel, tree)

    def _index_file(self, rel: str, tree: ast.Module) -> None:
        self.toplevel.setdefault(rel, {})
        self.from_imports.setdefault(rel, {})
        for node in iter_module_level_imports(tree):
            if not isinstance(node, ast.ImportFrom):
                continue
            if node.level == 0:
                target = self._modules.resolve_module(node.module or "")
            else:
                pkg_parts = rel.split("/")[:-1]
                if node.level - 1 > len(pkg_parts):
                    continue
                base = pkg_parts[: len(pkg_parts) - (node.level - 1)]
                mod = [p for p in (node.module or "").split(".") if p]
                target = self._modules.resolve_file("/".join(base + mod)) if (base or mod) else None
            if target is None:
                continue
            for alias in node.names:
                self.from_imports[rel][alias.asname or alias.name] = (target, alias.name)
        self._index_body(rel, tree.body, class_name=None, parent=None, prefix="", encl=None)

    def _index_body(
        self,
        rel: str,
        body: Sequence[ast.stmt],
        class_name: Optional[str],
        parent: Optional[str],
        prefix: str,
        encl: Optional[FuncInfo],
    ) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if isinstance(stmt, ast.AsyncFunctionDef):
                    continue  # no async on the jit path; skip rather than mis-model
                qual = prefix + stmt.name
                info = FuncInfo(rel, qual, stmt, class_name, parent)
                self.funcs[(rel, qual)] = info
                if parent is None and class_name is None:
                    self.toplevel[rel][stmt.name] = info
                if class_name is not None and parent is None:
                    self.methods.setdefault((rel, class_name), {})[stmt.name] = info
                if parent is not None:
                    self.children.setdefault((rel, parent), {})[stmt.name] = info
                # decorator expressions run in the ENCLOSING scope; the body
                # itself is recorded by the recursion below (encl=info)
                for dec in stmt.decorator_list:
                    if isinstance(dec, ast.Call):
                        self.calls.append((rel, encl, dec))
                    self._record_calls(rel, dec, encl)
                self._index_body(
                    rel, stmt.body, class_name=None, parent=qual, prefix=qual + ".", encl=info
                )
            elif isinstance(stmt, ast.ClassDef):
                self._index_body(
                    rel, stmt.body, class_name=stmt.name, parent=None,
                    prefix=prefix + stmt.name + ".", encl=encl,
                )
            else:
                self._record_calls(rel, stmt, encl)

    def _record_calls(self, rel: str, node: ast.AST, encl: Optional[FuncInfo]) -> None:
        # calls lexically in this scope; nested defs record their own
        stack: List[ast.AST] = list(ast.iter_child_nodes(node))
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if isinstance(sub, ast.Call):
                self.calls.append((rel, encl, sub))
            stack.extend(ast.iter_child_nodes(sub))

    def resolve_name(self, rel: str, caller: Optional[FuncInfo], name: str) -> Optional[FuncInfo]:
        """A bare callable name, resolved lexically: nested defs of the
        caller chain, then module-level defs, then ``from X import f``."""
        cur = caller
        while cur is not None:
            hit = self.children.get((rel, cur.qualname), {}).get(name)
            if hit is not None:
                return hit
            cur = self.funcs.get((rel, cur.parent)) if cur.parent else None
        hit = self.toplevel.get(rel, {}).get(name)
        if hit is not None:
            return hit
        imported = self.from_imports.get(rel, {}).get(name)
        if imported is not None:
            return self.toplevel.get(imported[0], {}).get(imported[1])
        return None

    def resolve_call(self, rel: str, caller: Optional[FuncInfo], call: ast.Call) -> Optional[FuncInfo]:
        key = (id(call), id(caller))
        if key not in self._resolved:
            self._resolved[key] = self._resolve_call(rel, caller, call)
        return self._resolved[key]

    def _resolve_call(self, rel: str, caller: Optional[FuncInfo], call: ast.Call) -> Optional[FuncInfo]:
        func = call.func
        if isinstance(func, ast.Name):
            return self.resolve_name(rel, caller, func.id)
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "self"
        ):
            # the lexically enclosing class; name-based cross-class dispatch
            # is deliberately not attempted (conservative resolution)
            cur = caller
            while cur is not None and cur.class_name is None:
                cur = self.funcs.get((rel, cur.parent)) if cur.parent else None
            if cur is not None and cur.class_name is not None:
                return self.methods.get((rel, cur.class_name), {}).get(func.attr)
        return None
