# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Cross-layer dataflow rules (ML009-ML012) over the module graphs
(counterpart of ``torchmetrics_tpu/lint/dataflow.py``).

These rules consume the package-wide structures built once per run by
:mod:`graph` — the import graph and the call graph — so a per-file report
can still prove cross-file properties (``--diff`` lints only changed files;
the graphs never shrink).

- **ML009** donation/alias safety: a value produced by an aliasing
  constructor (``torch.from_numpy``/``as_tensor``/``asarray``/``frombuffer``,
  ``from_dlpack``, ``np.frombuffer`` of a pre-existing buffer) must not flow
  into a state-install surface (``_install_state_tree``/``load_state_tree``/
  ``setattr``/``_defaults`` writes) or into a step built by
  ``make_jit_update(..., donate=True)``, which updates its carry in place.
- **ML010** import closure: no module of the port reaches ``jax``/``jaxlib``
  or the JAX package at module level, and the stdlib-only surfaces reach
  neither ``torch`` nor ``numpy``. By-path loads (``spec_from_file_location``)
  create no import edge and are recognized as intentional boundary breaks.
- **ML011** transitive host reads: walk the call graph from the captured
  entries (a fusable metric's ``update``, callables passed to ``_record`` or
  run inside ``torch.cuda.graph``, functions mapped by ``torch.func.vmap``)
  and run the ML002/ML004 predicates in CALLEES with call-site-induced taint.
- **ML012** serve-plane lock discipline: no blocking operation (sleep, file
  I/O, ``atomic_write``, timed queue waits) lexically under a declared lock
  in ``serve/`` and ``obs/live.py``, and no counter mutation outside the
  lock that otherwise guards it.

Everything resolves conservatively: an unresolvable call, an unprovable
buffer origin, or a name collision yields NO finding — the ratchet linter
prefers missing a finding over inventing one.
"""
from __future__ import annotations

import ast
from typing import Dict, FrozenSet, Iterator, List, Optional, Sequence, Set, Tuple

from .graph import PORT_FORBIDDEN, STDLIB_FORBIDDEN, CallGraph, FuncInfo, ImportGraph
from .rules import (
    ClassIndex,
    Taint,
    Violation,
    _callee_name,
    _coercion_violations,
    _dotted,
    _is_tensor_annotation,
    _numpy_violations,
    _root_module,
    _walk_device,
    _walk_no_nested_fns,
    concrete_predicates,
    is_captured_update,
    is_host_path_fn,
)

# ------------------------------------------------------------------- ML009


_ALIAS_CTORS = {
    "torch": ("from_numpy", "as_tensor", "asarray", "frombuffer", "from_dlpack"),
    "np": ("frombuffer",),
}


def _alias_ctor(call: ast.Call) -> bool:
    """A call that can return a zero-copy view of its first argument."""
    func = call.func
    if isinstance(func, ast.Name):
        if func.id not in ("from_dlpack",):
            return False
    elif isinstance(func, ast.Attribute):
        if func.attr not in _ALIAS_CTORS.get(_root_module(func) or "", ()):
            return False
    else:
        return False
    if not call.args:
        return False
    arg = call.args[0]
    # only a pre-existing value can be aliased: literals, displays,
    # comprehensions and other calls produce fresh buffers (as_tensor of a
    # python list ALWAYS copies), so they stay quiet
    if isinstance(arg, ast.Starred):
        arg = arg.value
    return isinstance(arg, (ast.Name, ast.Attribute, ast.Subscript))


def _is_asarray_ref(node: ast.expr) -> bool:
    """A bare reference to an aliasing constructor (``torch.as_tensor``
    passed as a tree-map callback)."""
    return (
        isinstance(node, ast.Attribute)
        and node.attr in _ALIAS_CTORS.get(_root_module(node) or "", ())
    )


class _AliasScan:
    """Alias taint within one function, resolving calls through the call
    graph's aliasing-function set (a function whose RETURN is alias-tainted
    makes its call sites alias-producing — the ``_to_device`` pattern)."""

    def __init__(
        self,
        info: FuncInfo,
        callgraph: CallGraph,
        aliasing: Set[Tuple[str, str]],
    ) -> None:
        self.info = info
        self.callgraph = callgraph
        self.aliasing = aliasing
        self.names: Set[str] = set()
        #: whether any call in the body can produce an alias at all; a body
        #: without one holds no aliased value (the common case, skipped)
        self.live = any(
            isinstance(n, ast.Call) and self._call_aliases(n) for n in _walk_no_nested_fns(info.node)
        )
        for _ in range(3 if self.live else 0):
            before = len(self.names)
            for stmt in _walk_no_nested_fns(info.node):
                if isinstance(stmt, ast.Assign) and self.aliased(stmt.value):
                    for tgt in stmt.targets:
                        self._mark(tgt)
                elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                    if self.aliased(stmt.value):
                        self._mark(stmt.target)
            if len(self.names) == before:
                break

    def _mark(self, tgt: ast.expr) -> None:
        if isinstance(tgt, ast.Name):
            self.names.add(tgt.id)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:
                self._mark(elt)

    def _call_aliases(self, call: ast.Call) -> bool:
        if _alias_ctor(call):
            return True
        # tree_map(torch.as_tensor, x) / tree_map(<aliasing fn>, x)
        if _callee_name(call) in ("tree_map", "map") and call.args:
            cb = call.args[0]
            if _is_asarray_ref(cb):
                return True
            if isinstance(cb, ast.Name):
                target = self.callgraph.resolve_name(self.info.rel, self.info, cb.id)
                if target is not None and (target.rel, target.qualname) in self.aliasing:
                    return True
            return False
        resolved = self.callgraph.resolve_call(self.info.rel, self.info, call)
        return resolved is not None and (resolved.rel, resolved.qualname) in self.aliasing

    def aliased(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Call):
            return self._call_aliases(node)
        if isinstance(node, ast.Dict):
            return any(v is not None and self.aliased(v) for v in node.values)
        if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
            return any(self.aliased(elt) for elt in node.elts)
        if isinstance(node, ast.DictComp):
            return self.aliased(node.value)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self.aliased(node.elt)
        if isinstance(node, ast.IfExp):
            return self.aliased(node.body) or self.aliased(node.orelse)
        if isinstance(node, ast.Subscript):
            return self.aliased(node.value)
        if isinstance(node, ast.Attribute):
            return self.aliased(node.value)
        if isinstance(node, ast.Starred):
            return self.aliased(node.value)
        if isinstance(node, ast.NamedExpr):
            return self.aliased(node.value)
        # BinOp/UnaryOp/Compare/other calls produce fresh tensors — the alias
        # dies there (torch.stack([torch.as_tensor(b)]) is safe)
        return False

    def returns_alias(self) -> bool:
        if not self.live:
            return False
        for stmt in _walk_no_nested_fns(self.info.node):
            if isinstance(stmt, ast.Return) and stmt.value is not None:
                if self.aliased(stmt.value):
                    return True
        return False


def _compute_aliasing_functions(callgraph: CallGraph) -> Set[Tuple[str, str]]:
    """Fixpoint over every def: functions whose return value carries alias
    taint, so their call sites become alias sources."""
    aliasing: Set[Tuple[str, str]] = set()
    for _ in range(6):
        changed = False
        for key, info in callgraph.funcs.items():
            if key in aliasing:
                continue
            if _AliasScan(info, callgraph, aliasing).returns_alias():
                aliasing.add(key)
                changed = True
        if not changed:
            break
    return aliasing


_INSTALL_SINKS = ("_install_state_tree", "load_state_tree")


def _donating_step(call: ast.Call) -> bool:
    """``make_jit_update(..., donate=True)``: the step it returns updates the
    carry it is given in place (``parallel/sharded.py``)."""
    if _callee_name(call) != "make_jit_update":
        return False
    donate = next((kw.value for kw in call.keywords if kw.arg == "donate"), None)
    if donate is None and len(call.args) > 3:
        donate = call.args[3]
    return isinstance(donate, ast.Constant) and donate.value is True


_ML009_WHY = (
    " — torch.from_numpy/as_tensor/frombuffer/from_dlpack share the caller's buffer,"
    " so the metric (or a donated step, which updates its carry in place) writes into"
    " memory the caller still owns; copy with torch.tensor(x) or x.clone() first"
)


def _ml009_function(
    info: FuncInfo, callgraph: CallGraph, aliasing: Set[Tuple[str, str]]
) -> Iterator[Violation]:
    scan = _AliasScan(info, callgraph, aliasing)
    if not scan.live:
        return  # no alias evidence anywhere in this body
    # names bound to donating steps in this body (``step, state =
    # make_jit_update(m, donate=True)``): the carry is their first argument
    donated: Dict[str, int] = {}
    for stmt in _walk_no_nested_fns(info.node):
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call) and _donating_step(stmt.value):
            for tgt in stmt.targets:
                if isinstance(tgt, (ast.Tuple, ast.List)) and tgt.elts:
                    tgt = tgt.elts[0]
                if isinstance(tgt, ast.Name):
                    donated[tgt.id] = 0
    for node in _walk_no_nested_fns(info.node):
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr in _INSTALL_SINKS and node.args:
                if scan.aliased(node.args[0]):
                    yield Violation(
                        "ML009", info.rel, node.lineno, node.col_offset, info.qualname,
                        f"`{func.attr}` receives a value built by an aliasing constructor"
                        + _ML009_WHY,
                    )
            elif isinstance(func, ast.Name) and func.id == "setattr" and len(node.args) == 3:
                if scan.aliased(node.args[2]):
                    yield Violation(
                        "ML009", info.rel, node.lineno, node.col_offset, info.qualname,
                        "`setattr` state install receives a value built by an aliasing"
                        " constructor" + _ML009_WHY,
                    )
            elif isinstance(func, ast.Name) and func.id in donated:
                pos = donated[func.id]
                args: Sequence[ast.expr] = node.args
                hits = (
                    [args[pos]] if 0 <= pos < len(args) else list(args)
                )
                if any(scan.aliased(a) for a in hits):
                    yield Violation(
                        "ML009", info.rel, node.lineno, node.col_offset, info.qualname,
                        f"aliased value passed as the carry of `{func.id}`, a step built by"
                        " make_jit_update(..., donate=True)" + _ML009_WHY,
                    )
            if any(
                kw.arg == "donate" and isinstance(kw.value, ast.Constant) and kw.value.value is True
                for kw in node.keywords
            ) and any(scan.aliased(a) for a in node.args):
                yield Violation(
                    "ML009", info.rel, node.lineno, node.col_offset, info.qualname,
                    "aliased value passed to a call that requests donation (donate=True)"
                    + _ML009_WHY,
                )
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (
                    isinstance(tgt, ast.Subscript)
                    and isinstance(tgt.value, ast.Attribute)
                    and tgt.value.attr == "_defaults"
                    and scan.aliased(node.value)
                ):
                    yield Violation(
                        "ML009", info.rel, node.lineno, node.col_offset, info.qualname,
                        "`_defaults[...]` write receives a value built by an aliasing"
                        " constructor" + _ML009_WHY,
                    )


def check_ml009(callgraph: CallGraph) -> List[Violation]:
    aliasing = _compute_aliasing_functions(callgraph)
    out: List[Violation] = []
    for info in callgraph.funcs.values():
        out.extend(_ml009_function(info, callgraph, aliasing))
    return out


# ------------------------------------------------------------------- ML010


#: the stdlib-only surfaces: loaded by file path on hosts without torch
_STDLIB_FILES = ("serve/chaos.py", "serve/wire.py", "robustness/store_format.py", "_reduction_names.py")


def is_stdlib_surface(rel: str) -> bool:
    """The files whose torch- and numpy-free import closure is a declared
    contract (``tests/test_torch_import_boundary.py`` pins them at run
    time): the chaos harness, the wire schema, the store format, the
    reduction names, the obs host modules (all of ``obs/`` but
    ``device.py``) and this lint package."""
    parts = rel.split("/")
    if any(rel == f or rel.endswith("/" + f) for f in _STDLIB_FILES):
        return True
    if len(parts) >= 2 and parts[-2] == "obs" and parts[-1] != "device.py":
        return True
    return len(parts) >= 2 and parts[-2] == "lint"


def check_ml010(rel: str, tree: ast.Module, importgraph: ImportGraph) -> Iterator[Violation]:
    stdlib = is_stdlib_surface(rel)
    chain = importgraph.chain_to(rel, STDLIB_FORBIDDEN if stdlib else PORT_FORBIDDEN)
    if chain is None:
        return
    rendered = " -> ".join(
        f"{hop.source}:{hop.lineno} imports {hop.spelled if hop.target.startswith('<') else hop.target}"
        for hop in chain
    )
    contract = (
        "this stdlib-only surface loads by file path on hosts without torch or numpy"
        if stdlib else "the port imports neither jax nor the JAX package"
    )
    yield Violation(
        "ML010", rel, chain[0].lineno, 0, "import-closure",
        f"{chain[-1].target.strip('<>')} is reachable at module level: {rendered} — {contract};"
        " import lazily inside the function that needs it, or load the module by file path"
        " (spec_from_file_location)",
    )


# ------------------------------------------------------------------- ML011


def _all_params(fn: ast.FunctionDef) -> FrozenSet[str]:
    """Every parameter but ``self``/``cls``: what a capture hands a body."""
    a = fn.args
    names = {p.arg for p in list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs) if p.arg not in ("self", "cls")}
    if a.vararg is not None:
        names.add(a.vararg.arg)
    return frozenset(names)


def _is_capture_context(expr: ast.expr) -> bool:
    """``torch.cuda.graph(...)`` (or ``cuda.graph``/``graph`` of torch.cuda)."""
    if not isinstance(expr, ast.Call):
        return False
    parts = _dotted(expr.func)
    return parts[-2:] == ["cuda", "graph"]


def _is_vmap(func: ast.expr) -> bool:
    parts = _dotted(func)
    return bool(parts) and parts[-1] == "vmap"


def _find_capture_seeds(callgraph: CallGraph, index: ClassIndex) -> List[Tuple[FuncInfo, FrozenSet[str]]]:
    """The captured entries: a fusable metric's ``update``; callables passed
    to ``_record`` or mapped by ``vmap``; what runs inside a
    ``torch.cuda.graph`` block. Lambdas seed the calls they make."""
    seeds: Dict[Tuple[str, str], FuncInfo] = {}

    def seed_callable(rel: str, encl: Optional[FuncInfo], node: ast.expr) -> None:
        if isinstance(node, ast.Name):
            target = callgraph.resolve_name(rel, encl, node.id)
            if target is not None:
                seeds[(target.rel, target.qualname)] = target
        elif isinstance(node, ast.Lambda):
            for sub in ast.walk(node.body):
                if isinstance(sub, ast.Call):
                    target = callgraph.resolve_call(rel, encl, sub)
                    if target is not None:
                        seeds[(target.rel, target.qualname)] = target

    for (rel, qual), info in callgraph.funcs.items():
        if info.class_name is not None and info.node.name == "update" and not is_host_path_fn(info.node):
            cinfo = next((c for c in index.classes_in_file(rel) if c.name == info.class_name), None)
            if cinfo is not None and index.is_metric_class(cinfo.name) and is_captured_update(cinfo, index):
                seeds[(rel, qual)] = info
        for node in _walk_no_nested_fns(info.node):
            if isinstance(node, ast.With) and any(_is_capture_context(i.context_expr) for i in node.items):
                for stmt in node.body:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Call):
                            target = callgraph.resolve_call(rel, info, sub)
                            if target is not None:
                                seeds[(target.rel, target.qualname)] = target
    for rel, encl, call in callgraph.calls:
        if (_callee_name(call) == "_record" or _is_vmap(call.func)) and call.args:
            seed_callable(rel, encl, call.args[0])
    out: List[Tuple[FuncInfo, FrozenSet[str]]] = []
    for info in seeds.values():
        params = _all_params(info.node)
        if params:
            out.append((info, params))
    return out


def _call_induced_params(
    call: ast.Call, callee: ast.FunctionDef, is_method_call: bool, tainted
) -> FrozenSet[str]:
    """Map tainted call-site arguments onto callee parameter names."""
    params = [p.arg for p in list(callee.args.posonlyargs) + list(callee.args.args)]
    if params and params[0] in ("self", "cls") and is_method_call:
        params = params[1:]
    induced: Set[str] = set()
    for i, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            if tainted(arg.value) and callee.args.vararg is not None:
                induced.add(callee.args.vararg.arg)
            continue
        if tainted(arg):
            if i < len(params):
                induced.add(params[i])
            elif callee.args.vararg is not None:
                induced.add(callee.args.vararg.arg)
    kw_names = {p.arg for p in callee.args.kwonlyargs} | set(params)
    for kw in call.keywords:
        if kw.arg is not None and kw.arg in kw_names and tainted(kw.value):
            induced.add(kw.arg)
    return frozenset(induced)


def _self_states_for(info: FuncInfo, index: ClassIndex) -> Optional[Set[str]]:
    if info.class_name is None:
        return None
    for cinfo in index.classes_in_file(info.rel):
        if cinfo.name == info.class_name:
            states, counters, _dynamic, _host = index.resolved_states(cinfo)
            return states | counters
    return None


def _checked_by_ml002(info: FuncInfo, index: ClassIndex) -> bool:
    """Whether ML002 checks this def directly (a captured ``update``, or a
    functional update kernel), so its annotation-proven hits are ML002's."""
    from .rules import is_functional_update_kernel

    if info.class_name is None:
        return info.parent is None and is_functional_update_kernel(info.node)
    if info.node.name != "update" or info.parent is not None:
        return False
    cinfo = next((c for c in index.classes_in_file(info.rel) if c.name == info.class_name), None)
    return cinfo is not None and index.is_metric_class(cinfo.name) and is_captured_update(cinfo, index)


def check_ml011(callgraph: CallGraph, index: ClassIndex) -> List[Violation]:
    work: List[Tuple[FuncInfo, FrozenSet[str], str, int]] = [
        (info, params, info.qualname, 0) for info, params in _find_capture_seeds(callgraph, index)
    ]
    visited: Set[Tuple[str, str, FrozenSet[str]]] = {
        (info.rel, info.qualname, params) for info, params, _, _ in work
    }
    predicates: Dict[str, Set[str]] = {}
    out: Dict[Tuple[str, int, int], Violation] = {}
    while work:
        info, induced_params, entry, depth = work.pop()
        fn = info.node
        if is_host_path_fn(fn):
            continue  # host-path by contract (str-annotated data params)
        if info.rel not in predicates:
            tree = callgraph._modules.tree(info.rel)
            predicates[info.rel] = concrete_predicates(tree) if tree is not None else set()
        preds = predicates[info.rel]
        states = _self_states_for(info, index)
        base = Taint(fn, self_states=states)
        induced = Taint(fn, self_states=states, extra_names=induced_params)
        base_hits = set()
        if _checked_by_ml002(info, index):
            base_hits = {
                (v.line, v.col)
                for v in list(_coercion_violations(fn, base, info.rel, info.qualname, preds))
                + list(_numpy_violations(fn, base, info.rel, info.qualname, preds))
            }
        for v in list(_coercion_violations(fn, induced, info.rel, info.qualname, preds)) + list(
            _numpy_violations(fn, induced, info.rel, info.qualname, preds)
        ):
            if (v.line, v.col) in base_hits:
                continue  # ML002's finding already (annotation-proven)
            key = (v.path, v.line, v.col)
            if key not in out:
                out[key] = Violation(
                    "ML011", v.path, v.line, v.col, v.scope,
                    v.message.rstrip() + f" [a device tensor reaches this callee from the captured"
                    f" entry `{entry}`]",
                )
        if depth >= 8:
            continue
        for node in _walk_device(fn, preds):
            if not isinstance(node, ast.Call):
                continue
            callee = callgraph.resolve_call(info.rel, info, node)
            if callee is None or (callee.rel, callee.qualname) == (info.rel, info.qualname):
                continue
            is_method_call = isinstance(node.func, ast.Attribute)
            params = _call_induced_params(node, callee.node, is_method_call, induced.is_tainted)
            if not params and not any(_is_tensor_annotation(p.annotation) for p in callee.node.args.args):
                continue  # nothing proves a tensor reaches the callee
            key2 = (callee.rel, callee.qualname, params)
            if key2 in visited:
                continue
            visited.add(key2)
            work.append((callee, params, entry, depth + 1))
    return sorted(out.values(), key=lambda v: (v.path, v.line, v.col))


# ------------------------------------------------------------------- ML012


def _walk_skip_fns(node: ast.AST) -> Iterator[ast.AST]:
    """Walk an AST without descending into nested function/lambda bodies —
    code in a nested def does not run while the lock is held."""
    stack: List[ast.AST] = [node]
    while stack:
        sub = stack.pop()
        yield sub
        if not isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(sub))


def _serve_plane(rel: str) -> bool:
    return "serve" in rel.split("/") or rel.endswith("obs/live.py")


def _is_lock_ctor(node: ast.expr) -> bool:
    if not isinstance(node, ast.Call):
        return False
    func = node.func
    name = func.id if isinstance(func, ast.Name) else func.attr if isinstance(func, ast.Attribute) else None
    return name in ("Lock", "RLock")


def _blocking_call_reason(call: ast.Call) -> Optional[str]:
    func = call.func
    if isinstance(func, ast.Name):
        if func.id == "open":
            return "file I/O (`open`)"
        if func.id == "sleep":
            return "`sleep`"
        if func.id == "atomic_write":
            return "file I/O (`atomic_write`)"
        return None
    if not isinstance(func, ast.Attribute):
        return None
    root = _root_module(func)
    if func.attr == "sleep" and root == "time":
        return "`time.sleep`"
    if root == "os" and func.attr in ("replace", "fsync", "fdatasync"):
        return f"file I/O (`os.{func.attr}`)"
    if func.attr == "atomic_write":
        return "file I/O (`atomic_write`)"
    if func.attr in ("wait", "acquire"):
        return f"`.{func.attr}()` (blocks on another thread)"
    has_timeout = any(kw.arg == "timeout" for kw in call.keywords)
    blocks_kw = any(
        kw.arg == "block" and isinstance(kw.value, ast.Constant) and kw.value.value is True
        for kw in call.keywords
    )
    if func.attr in ("put", "get", "join") and (has_timeout or blocks_kw):
        return f"blocking `.{func.attr}(timeout=...)` queue/thread wait"
    return None


def _method_blocks(fn: ast.FunctionDef) -> Optional[str]:
    """A blocking op anywhere in this method's own body (one transitive
    level for ``self._helper()`` calls under a lock)."""
    for node in _walk_no_nested_fns(fn):
        if isinstance(node, ast.Call):
            reason = _blocking_call_reason(node)
            if reason is not None:
                return reason
    return None


class _Ml012ClassScan:
    def __init__(self, rel: str, cls: ast.ClassDef, module_locks: Set[str]) -> None:
        self.rel = rel
        self.cls = cls
        self.module_locks = module_locks
        self.lock_attrs: Set[str] = set()
        self.methods: Dict[str, ast.FunctionDef] = {}
        for item in cls.body:
            if isinstance(item, ast.FunctionDef):
                self.methods[item.name] = item
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
                for tgt in node.targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                    ):
                        self.lock_attrs.add(tgt.attr)

    def _lock_name(self, expr: ast.expr) -> Optional[str]:
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
            if expr.value.id == "self" and expr.attr in self.lock_attrs:
                return f"self.{expr.attr}"
        if isinstance(expr, ast.Name) and expr.id in self.module_locks:
            return expr.id
        return None

    def _scan_stmts(
        self, stmts: Sequence[ast.stmt], lock: Optional[str], scope: str
    ) -> Iterator[Violation]:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if isinstance(stmt, ast.With):
                held = lock
                for item in stmt.items:
                    name = self._lock_name(item.context_expr)
                    if name is not None:
                        held = name
                    elif lock is not None:
                        # `with open(...)` under a held lock is itself a
                        # blocking op — the body recursion never sees it
                        for node in _walk_skip_fns(item.context_expr):
                            if isinstance(node, ast.Call):
                                reason = _blocking_call_reason(node)
                                if reason is not None:
                                    yield Violation(
                                        "ML012", self.rel, node.lineno, node.col_offset, scope,
                                        f"blocking operation {reason} while holding `{lock}` — every"
                                        " reader/ingest thread contending on this lock stalls behind"
                                        " the I/O; move the blocking work outside the critical section",
                                    )
                yield from self._scan_stmts(stmt.body, held, scope)
                continue
            if lock is not None:
                for node in _walk_skip_fns(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    reason = _blocking_call_reason(node)
                    if reason is None and isinstance(node.func, ast.Attribute):
                        func = node.func
                        if (
                            isinstance(func.value, ast.Name)
                            and func.value.id == "self"
                            and func.attr in self.methods
                        ):
                            inner = _method_blocks(self.methods[func.attr])
                            if inner is not None:
                                reason = f"`self.{func.attr}()` which performs {inner}"
                    if reason is not None:
                        yield Violation(
                            "ML012", self.rel, node.lineno, node.col_offset, scope,
                            f"blocking operation {reason} while holding `{lock}` — every"
                            " reader/ingest thread contending on this lock stalls behind"
                            " the I/O; move the blocking work outside the critical section",
                        )
            for seq in (
                getattr(stmt, "body", None),
                getattr(stmt, "orelse", None),
                getattr(stmt, "finalbody", None),
            ):
                if seq and lock is None:
                    # descend into if/try/loop bodies looking for with-lock
                    # blocks; the lock-held walk above already covered the
                    # held case via ast.walk
                    yield from self._scan_stmts(seq, lock, scope)
            for handler in getattr(stmt, "handlers", []) or []:
                if lock is None:
                    yield from self._scan_stmts(handler.body, lock, scope)

    def _held_lock_label(self) -> str:
        """Display name for the lock a ``*_locked`` method's caller holds."""
        if len(self.lock_attrs) == 1:
            return f"self.{next(iter(self.lock_attrs))}"
        if len(self.module_locks) == 1 and not self.lock_attrs:
            return next(iter(self.module_locks))
        return "the caller-held lock"

    def _locked_attr_accesses(self) -> Set[str]:
        """self attributes touched inside any with-lock body of the class,
        or anywhere in a ``*_locked``-named method (the convention: such
        methods run with the lock already held by the caller)."""
        touched: Set[str] = set()

        def visit(stmts: Sequence[ast.stmt], lock: bool) -> None:
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                    if isinstance(stmt, ast.FunctionDef):
                        visit(stmt.body, stmt.name.endswith("_locked"))
                    continue
                if isinstance(stmt, ast.With):
                    inner = lock or any(
                        self._lock_name(i.context_expr) is not None for i in stmt.items
                    )
                    visit(stmt.body, inner)
                    continue
                if lock:
                    for node in ast.walk(stmt):
                        if (
                            isinstance(node, ast.Attribute)
                            and isinstance(node.value, ast.Name)
                            and node.value.id == "self"
                        ):
                            touched.add(node.attr)
                else:
                    for seq in (
                        getattr(stmt, "body", None),
                        getattr(stmt, "orelse", None),
                        getattr(stmt, "finalbody", None),
                    ):
                        if seq:
                            visit(seq, lock)
                    for handler in getattr(stmt, "handlers", []) or []:
                        visit(handler.body, lock)

        visit(self.cls.body, False)
        return touched - self.lock_attrs

    def _unlocked_mutations(self) -> Iterator[Violation]:
        locked = self._locked_attr_accesses()
        if not locked:
            return

        def visit(stmts: Sequence[ast.stmt], lock: bool, scope: str) -> Iterator[Violation]:
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                    continue
                if isinstance(stmt, ast.With):
                    inner = lock or any(
                        self._lock_name(i.context_expr) is not None for i in stmt.items
                    )
                    yield from visit(stmt.body, inner, scope)
                    continue
                if not lock and isinstance(stmt, ast.AugAssign):
                    tgt = stmt.target
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                        and tgt.attr in locked
                    ):
                        yield Violation(
                            "ML012", self.rel, stmt.lineno, stmt.col_offset, scope,
                            f"`self.{tgt.attr}` mutated outside the lock that guards its"
                            " other accesses — a concurrent reader under the lock can see"
                            " a torn/stale counter; move the mutation under the lock",
                        )
                for seq in (
                    getattr(stmt, "body", None),
                    getattr(stmt, "orelse", None),
                    getattr(stmt, "finalbody", None),
                ):
                    if seq:
                        yield from visit(seq, lock, scope)
                for handler in getattr(stmt, "handlers", []) or []:
                    yield from visit(handler.body, lock, scope)

        for name, fn in self.methods.items():
            if name.endswith("_locked"):
                continue  # convention: caller already holds the lock
            yield from visit(fn.body, False, f"{self.cls.name}.{name}")

    def violations(self) -> Iterator[Violation]:
        if not self.lock_attrs and not self.module_locks:
            return
        for name, fn in self.methods.items():
            # a `*_locked` method runs with the lock held by its caller, so
            # its whole body is a critical section for the blocking-op scan
            entry_lock = self._held_lock_label() if name.endswith("_locked") else None
            yield from self._scan_stmts(fn.body, entry_lock, f"{self.cls.name}.{name}")
        if self.lock_attrs:
            yield from self._unlocked_mutations()


def check_ml012(rel: str, tree: ast.Module) -> Iterator[Violation]:
    if not _serve_plane(rel):
        return
    module_locks: Set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and _is_lock_ctor(stmt.value):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name):
                    module_locks.add(tgt.id)
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            yield from _Ml012ClassScan(rel, node, module_locks).violations()
    # module-level functions guarding module-level locks (the obs/live.py
    # shape: a module ``_lock`` with free functions)
    if module_locks:
        dummy = ast.ClassDef(
            name="<module>", bases=[], keywords=[], body=[
                n for n in tree.body if isinstance(n, ast.FunctionDef)
            ], decorator_list=[],
        )
        scan = _Ml012ClassScan(rel, dummy, module_locks)
        for name, fn in scan.methods.items():
            yield from scan._scan_stmts(fn.body, None, name)
