# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Rule implementations for the port's metriclint (stdlib-only AST analysis;
counterpart of ``torchmetrics_tpu/lint/rules.py``).

The checks are deliberately conservative: a value is treated as a tensor
("tainted") only when the source proves it — a ``Tensor``-annotated
parameter, the result of a ``torch.``/``F.`` call that returns a tensor, or
a registered metric state — so host-side tokenization/numpy code does not
flood the report. A function whose signature mentions ``str`` on a data
parameter is classified host-path and is exempt from ML002/ML004, and so is
every branch that runs only where ``_is_concrete`` holds (the port's value
checks, which never run while a CUDA graph is being captured).

The port captures ``update`` (``make_jit_update``, the fused and sliced
plans) and runs ``compute`` eagerly, so ML002/ML004 check what is captured:
the ``update`` of a metric the fused plan accepts, and the functional
update kernels (``*_update`` functions with a ``Tensor`` data parameter).
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

RULES: Dict[str, str] = {
    "ML001": "attribute assigned in update() is not registered via add_state",
    "ML002": "host read or capture breaker on a device tensor in a captured body",
    "ML003": "add_state reduction/default contract violation",
    "ML004": "numpy op on a device tensor where a torch equivalent exists",
    "ML005": "Metric stored in a container _walk_metrics cannot traverse",
    "ML006": "unbounded cat-list state on a metric claiming full_state_update=False",
    "ML007": "fusion-ineligible metric constructed inside a MetricCollection",
    "ML008": "sliced-plane contract violation at a SlicedPlan construction site",
    "ML009": "aliased buffer (torch.from_numpy/as_tensor/frombuffer/from_dlpack) flows into a state install or donated step",
    "ML010": "module reaches jax or the JAX package (or a stdlib-only surface reaches torch/numpy) at module level",
    "ML011": "host read or capture breaker on a device tensor in a callee of a captured entry",
    "ML012": "serve-plane lock discipline: blocking op under a lock, or counter mutated outside it",
    "ML013": "float-prediction update() with no registered StateGuard domain contract",
    "ML014": "reduction over a computed dim with no emptiness guard (sum(dim=()) reduces every dim)",
    "ML015": "torch.prod/Tensor.prod on a device tensor (its kernel compiles at run time)",
}

#: long-form rationale + fix pattern per rule, printed by
#: ``python -m torchmetrics_tpu_torch.lint explain ML0xx``
EXPLANATIONS: Dict[str, str] = {
    "ML001": (
        "Every attribute assigned in update() must be registered via add_state\n"
        "(or declared in _host_counters). An unregistered attribute is invisible\n"
        "to reset/snapshot/restore and is not part of the fused plan's carry.\n"
        "Fix: self.add_state(\"name\", default, dist_reduce_fx=...) in __init__,\n"
        "or add the name to _host_counters if it is deliberate host bookkeeping."
    ),
    "ML002": (
        "update() is captured as a CUDA graph (make_jit_update, the fused and\n"
        "sliced plans). A host read of a device value inside it —\n"
        "float()/int()/bool()/.item()/.tolist()/.cpu()/.numpy()/`if t:` — syncs\n"
        "the stream and ends the capture with an error; so do the ops whose\n"
        "output shape depends on values: torch.bincount (reads its max),\n"
        "torch.nonzero/argwhere/where(c), torch.unique, masked_select,\n"
        "boolean-mask indexing and repeat_interleave with tensor repeats and no\n"
        "output_size.\n"
        "Fix: keep the value on the device (torch.where, the port's _bincount,\n"
        "a fixed-size scatter), or run the host read only where\n"
        "_is_concrete(x) holds (eager updates), as the port's value checks do."
    ),
    "ML003": (
        "add_state contracts: dist_reduce_fx must be a valid reduction literal\n"
        "(see _reduction_names.py), list defaults must be empty, and 'cat'\n"
        "states must default to [] so per-batch appends keep their identity.\n"
        "Fix: match the default's type to the reduction."
    ),
    "ML004": (
        "np.* on a device tensor copies it to the host (a sync that ends a\n"
        "capture) or raises for a CUDA tensor, where a torch equivalent exists.\n"
        "Fix: use the torch op on the tensor."
    ),
    "ML005": (
        "Metrics stored in set/frozenset are invisible to _walk_metrics (no\n"
        "stable order), so the deep snapshot/reset/restore silently skips them.\n"
        "Fix: use a list, tuple, or dict."
    ),
    "ML006": (
        "A dist_reduce_fx='cat' list state grows without bound, which\n"
        "contradicts a class claiming full_state_update=False (the 'my state\n"
        "folds cheaply' contract).\n"
        "Fix: use a bounded sketch state (torchmetrics_tpu_torch.sketch,\n"
        "dist_reduce_fx='merge')."
    ),
    "ML007": (
        "MetricCollection.fused() refuses members whose update cannot be\n"
        "captured positionally: host-state metrics (_sharded_update_unsupported,\n"
        "_host_counters), metrics with no registered state, wrappers of child\n"
        "metrics and kwargs-only update signatures. The rule flags them at the\n"
        "construction site with the static mirror of parallel/fused.py's\n"
        "fusion_ineligibility.\n"
        "Fix: give update() a positional batch signature, or keep the metric\n"
        "out of fused collections."
    ),
    "ML008": (
        "The slice table is a fixed shape: num_cells must be a static positive\n"
        "python int (no floats, no tensor-derived sizing) and cohort keys must\n"
        "be integer tensors (a float key is a new cohort every batch).\n"
        "Fix: size with a static int; bucket/hash float features to ints."
    ),
    "ML009": (
        "torch.from_numpy / torch.as_tensor / torch.asarray / torch.frombuffer /\n"
        "from_dlpack (and np.frombuffer) return a ZERO-COPY view of a foreign\n"
        "buffer. If that view flows into a state install (_install_state_tree,\n"
        "load_state_tree, setattr, _defaults writes) or into a step built with\n"
        "make_jit_update(..., donate=True) (it updates its carry in place), the\n"
        "metric writes into memory the caller still owns.\n"
        "Fix: copy at the trust boundary — torch.tensor(x) or x.clone().\n"
        "Suppress with a written reason when the source is provably owned by\n"
        "the metric or the consumer never writes it."
    ),
    "ML010": (
        "The port imports neither jax/jaxlib nor the JAX package\n"
        "(torchmetrics_tpu), and its stdlib-only surfaces (serve/chaos.py,\n"
        "serve/wire.py, robustness/store_format.py, _reduction_names.py, the obs\n"
        "host modules, lint/) import neither torch nor numpy: they load by file\n"
        "path on hosts without them. This rule computes the transitive\n"
        "MODULE-LEVEL import closure and names the chain that breaks the\n"
        "contract.\n"
        "Fix: import lazily inside the function that needs it, or load the\n"
        "module by file path (importlib.util.spec_from_file_location) — by-path\n"
        "loads create no import edge."
    ),
    "ML011": (
        "ML002/ML004 check captured bodies directly, but a capture records\n"
        "every function it CALLS. This rule walks the call graph from the\n"
        "captured entries (a fusable metric's update, callables passed to\n"
        "_record or run inside torch.cuda.graph, functions mapped by\n"
        "torch.func.vmap), propagates which parameters hold tensors at each\n"
        "call site, and runs the same predicates in the callees.\n"
        "Fix: as ML002 — keep values on the device in anything reachable from\n"
        "a capture, or read them only where _is_concrete holds."
    ),
    "ML012": (
        "The serve plane (serve/, obs/live.py) is lock-disciplined: a blocking\n"
        "operation (time.sleep, file I/O, atomic_write, timed queue waits,\n"
        ".wait()/.acquire()) inside a `with <lock>:` block stalls every thread\n"
        "contending on that lock; and a counter mutated OUTSIDE the lock that\n"
        "guards its other accesses races its readers.\n"
        "Fix: move blocking work outside the critical section (stage under the\n"
        "lock, write after releasing); move counter mutations under the lock.\n"
        "Locks that exist purely to serialize writers (not to guard readers)\n"
        "are legitimate — suppress with a written reason."
    ),
    "ML013": (
        "A Metric whose update() consumes float predictions (first batch\n"
        "parameter named `preds`) but whose ancestry registers no\n"
        "domain_contract() (metric.py) cannot be guarded: enable_guard() has no\n"
        "contract to mask/reject invalid rows with, so NaN/Inf/out-of-domain\n"
        "rows flow straight into state on the serve plane.\n"
        "Fix: override domain_contract() returning a\n"
        "robustness.guard.DomainContract (per-argument ArgSpec bounds) — see\n"
        "classification/stat_scores.py for the family pattern. Pre-existing\n"
        "offenders are ratcheted in the baseline."
    ),
    "ML014": (
        "Tensor.sum(dim=()) (and torch.sum, mean, amax, amin, prod, any, all)\n"
        "reduces EVERY dim, where jnp.sum(axis=()) reduces none. A dim that is\n"
        "computed (a comprehension, tuple()/list()/range(), a Sequence[int]\n"
        "parameter) can be empty, and then the result silently changes shape.\n"
        "Fix: test the value for emptiness in the same function before the\n"
        "reduction, as functional/regression/csi.py's _count does."
    ),
    "ML015": (
        "torch.prod (and Tensor.prod) on a CUDA tensor compiles its kernel at\n"
        "run time the first time in a process (1-1.6 s on a first SSIM update).\n"
        "Fix: multiply rows in a loop (_prod_rows), or take the product of\n"
        "static sizes on the host with math.prod."
    ),
}


def _load_valid_reductions() -> tuple:
    """The accepted-literal list for ML003, read from the port's canonical
    ``_reduction_names.py`` — loaded BY FILE PATH so the linter keeps its
    stdlib-only guarantee (a package import would execute the port's
    ``__init__``, which imports torch). Falls back to the last-known list only
    if the file is gone (a partial checkout)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "_reduction_names.py")
    try:
        spec = importlib.util.spec_from_file_location("_tm_tpu_torch_reduction_names", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return tuple(module.VALID_REDUCTION_NAMES)
    except Exception:  # pragma: no cover - partial checkouts only
        return ("sum", "mean", "cat", "min", "max", "merge")


_VALID_REDUCTIONS = _load_valid_reductions()

#: numpy functions with a torch counterpart, for ML004 — hardcoded so the
#: linter never has to import torch
_TORCH_EQUIVALENTS = frozenset(
    """abs absolute add all allclose amax amin any arange argmax argmin argsort
    around atleast_1d atleast_2d bincount broadcast_to ceil clip column_stack
    concatenate cos cosh count_nonzero cumprod cumsum diag diff divide dot
    einsum empty equal exp expand_dims eye flip floor full full_like histogram
    hstack isclose isfinite isinf isnan linspace log log10 log2 logical_and
    logical_not logical_or matmul max maximum mean median min minimum moveaxis
    multiply nan_to_num nanmean nanmedian nansum nonzero ones ones_like outer
    pad power prod quantile ravel repeat reshape roll round searchsorted sign
    sin sinh sort split sqrt square squeeze stack std subtract sum take tanh
    tensordot tile trace transpose tril triu unique var vstack where zeros
    zeros_like""".split()
)

#: ``torch.<name>`` calls that return host values (or objects), not tensors
_TORCH_HOST_FUNCS = frozenset(
    """finfo iinfo is_tensor is_floating_point is_complex is_nonzero numel
    get_default_dtype promote_types result_type can_cast device Size dtype
    broadcast_shapes Generator manual_seed initial_seed seed no_grad
    enable_grad inference_mode is_grad_enabled is_inference_mode_enabled
    set_grad_enabled autocast are_deterministic_algorithms_enabled
    use_deterministic_algorithms get_num_threads set_num_threads
    is_storage typename""".split()
)

#: ``torch.<module>.*`` namespaces whose calls return host values
_TORCH_HOST_MODULES = frozenset(
    ("cuda", "backends", "_C", "distributed", "jit", "compiler", "testing", "version", "hub", "_dynamo", "multiprocessing")
)

#: tensor attributes and methods whose result is a plain host value
#: (static under a capture: shapes, dtypes, devices, layouts)
_STATIC_ATTRS = frozenset(
    ("shape", "ndim", "dtype", "device", "is_cuda", "is_cpu", "is_sparse", "layout", "requires_grad", "is_leaf", "names")
)
_STATIC_METHODS = frozenset(
    ("size", "dim", "numel", "nelement", "element_size", "stride", "is_floating_point", "is_complex",
     "is_contiguous", "data_ptr", "get_device", "storage_offset", "type", "ndimension", "untyped_storage")
)

#: the reductions ML014 reads a ``dim`` of
_DIM_REDUCTIONS = frozenset(("sum", "mean", "amax", "amin", "prod", "any", "all"))

#: the ``_is_concrete`` predicates: a branch that runs only where one holds
#: is host path by construction (``utilities/checks.py``)
_CONCRETE_PREDICATES = frozenset(("_is_concrete",))


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str  # repo-relative posix path
    line: int
    col: int
    scope: str  # "Class.method" or "function" — the baseline fingerprint unit
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} [{self.scope}] {self.message}"


# --------------------------------------------------------------- class index


@dataclasses.dataclass
class ClassInfo:
    name: str
    path: str
    node: ast.ClassDef
    bases: Tuple[str, ...]
    state_names: Set[str]
    dynamic_states: bool  # add_state with a non-literal name anywhere
    host_counters: Set[str]
    host_only: bool  # sets _sharded_update_unsupported (never captured)
    fsu_false: bool = False  # declares a literal `full_state_update = False`
    #: None = this class defines no update(); else whether its update accepts
    #: any positional batch argument (the ML007 fusability signal)
    update_positional: Optional[bool] = None
    #: this class body defines a domain_contract() method (the ML013 signal)
    defines_contract: bool = False
    #: this class body defines an update() whose first batch param is `preds`
    #: and (by annotation, when one exists) consumes arrays rather than text
    update_takes_preds: bool = False
    #: class names constructed into ``self.<attr>`` in this class body (the
    #: candidates for child metrics)
    constructed: Set[str] = dataclasses.field(default_factory=set)


def _base_name(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript):  # Generic[T]-style bases
        return _base_name(node.value)
    return None


def _is_self_call(call: ast.Call, method: str) -> bool:
    func = call.func
    return (
        isinstance(func, ast.Attribute)
        and func.attr == method
        and isinstance(func.value, ast.Name)
        and func.value.id == "self"
    )


def _call_arg(call: ast.Call, pos: int, kw: str) -> Optional[ast.expr]:
    if len(call.args) > pos:
        return call.args[pos]
    for keyword in call.keywords:
        if keyword.arg == kw:
            return keyword.value
    return None


def _callee_name(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Name):
        return call.func.id
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return None


def _update_accepts_positional(fn: ast.FunctionDef) -> bool:
    """Whether an ``update`` def can receive a positional batch: any
    non-self positional-or-keyword/positional-only parameter, or ``*args``."""
    a = fn.args
    named = [p for p in list(a.posonlyargs) + list(a.args) if p.arg not in ("self", "cls")]
    return bool(named) or a.vararg is not None


def _constructed_into_self(node: ast.ClassDef) -> Set[str]:
    """Names of the classes called in ``self.<attr> = <Name>(...)`` (or a
    display of such calls) anywhere in the class body."""
    out: Set[str] = set()
    for stmt in ast.walk(node):
        if not isinstance(stmt, (ast.Assign, ast.AnnAssign)) or stmt.value is None:
            continue
        targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
        if not any(isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) and t.value.id == "self" for t in targets):
            continue
        for sub in ast.walk(stmt.value):
            if isinstance(sub, ast.Call):
                name = _callee_name(sub)
                if name:
                    out.add(name)
    return out


def _collect_class_info(path: str, node: ast.ClassDef) -> ClassInfo:
    state_names: Set[str] = set()
    dynamic = False
    host_counters: Set[str] = set()
    host_only = False
    fsu_false = False
    update_positional: Optional[bool] = None
    defines_contract = False
    update_takes_preds = False
    for item in node.body:
        if isinstance(item, ast.FunctionDef) and item.name == "update":
            update_positional = _update_accepts_positional(item)
            params = [p for p in list(item.args.posonlyargs) + list(item.args.args)
                      if p.arg not in ("self", "cls")]
            if params and params[0].arg == "preds":
                # an annotation of str/Sequence[str] marks a text metric —
                # guard contracts only make sense for tensor-valued preds
                ann = params[0].annotation
                ann_src = ast.unparse(ann) if ann is not None else None
                update_takes_preds = ann_src is None or any(
                    hint in ann_src for hint in ("Array", "ndarray", "Tensor")
                )
        elif isinstance(item, ast.FunctionDef) and item.name == "domain_contract":
            defines_contract = True
    for stmt in ast.walk(node):
        if isinstance(stmt, ast.Call) and _is_self_call(stmt, "add_state"):
            name_arg = _call_arg(stmt, 0, "name")
            if isinstance(name_arg, ast.Constant) and isinstance(name_arg.value, str):
                state_names.add(name_arg.value)
            else:
                dynamic = True
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            for tgt in targets:
                tgt_name = None
                if isinstance(tgt, ast.Name):
                    tgt_name = tgt.id  # class-level declaration
                elif isinstance(tgt, ast.Attribute) and isinstance(tgt.value, ast.Name) and tgt.value.id == "self":
                    tgt_name = tgt.attr  # instance-level (e.g. conditional in __init__)
                if tgt_name == "_sharded_update_unsupported":
                    value = stmt.value
                    if not (isinstance(value, ast.Constant) and value.value is None):
                        host_only = True
                elif tgt_name == "full_state_update":
                    value = stmt.value
                    if isinstance(value, ast.Constant) and value.value is False:
                        fsu_false = True
                elif tgt_name == "_host_counters" and stmt.value is not None:
                    for elt in getattr(stmt.value, "elts", []):
                        if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                            host_counters.add(elt.value)
    return ClassInfo(
        name=node.name,
        path=path,
        node=node,
        bases=tuple(b for b in (_base_name(base) for base in node.bases) if b),
        state_names=state_names,
        dynamic_states=dynamic,
        host_counters=host_counters,
        host_only=host_only,
        fsu_false=fsu_false,
        update_positional=update_positional,
        defines_contract=defines_contract,
        update_takes_preds=update_takes_preds,
        constructed=_constructed_into_self(node),
    )


class ClassIndex:
    """Package-wide class registry, resolved by simple class name.

    Name collisions (same class name in two modules) merge conservatively:
    states union, dynamic/host flags OR together — a ratchet linter prefers
    missing a finding over inventing one.
    """

    def __init__(self) -> None:
        self._by_name: Dict[str, List[ClassInfo]] = {}
        self.metric_names: Set[str] = set()

    def add_file(self, path: str, tree: ast.AST) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                self._by_name.setdefault(node.name, []).append(_collect_class_info(path, node))

    def finalize(self) -> None:
        # transitive closure of "inherits (by name) from Metric"
        names = {"Metric"}
        changed = True
        while changed:
            changed = False
            for name, infos in self._by_name.items():
                if name in names:
                    continue
                if any(b in names for info in infos for b in info.bases):
                    names.add(name)
                    changed = True
        self.metric_names = names

    def is_metric_class(self, name: str) -> bool:
        return name in self.metric_names

    def infos(self, name: str) -> List[ClassInfo]:
        return list(self._by_name.get(name, []))

    def _ancestry(self, info: ClassInfo) -> Iterator[ClassInfo]:
        seen: Set[int] = set()
        queue = [info]
        while queue:
            cur = queue.pop()
            if id(cur) in seen:
                continue
            seen.add(id(cur))
            yield cur
            for base in cur.bases:
                queue.extend(self._by_name.get(base, []))

    def resolved_states(self, info: ClassInfo) -> Tuple[Set[str], Set[str], bool, bool]:
        """(state_names, host_counters, dynamic_states, host_only) incl. ancestors."""
        states: Set[str] = set()
        counters: Set[str] = set()
        dynamic = False
        host_only = False
        for cur in self._ancestry(info):
            states |= cur.state_names
            counters |= cur.host_counters
            dynamic = dynamic or cur.dynamic_states
            host_only = host_only or cur.host_only
        return states, counters, dynamic, host_only

    def classes_in_file(self, path: str) -> List[ClassInfo]:
        return [info for infos in self._by_name.values() for info in infos if info.path == path]

    def declares_contract(self, info: ClassInfo) -> bool:
        """True when the class (or an ancestor) defines ``domain_contract``.
        The ``Metric`` base's contract-less default is excluded — "declares"
        means somebody registered real per-argument bounds."""
        return any(cur.defines_contract for cur in self._ancestry(info) if cur.name != "Metric")

    def claims_fsu_false(self, info: ClassInfo) -> bool:
        """True when the class (or a non-root ancestor) declares a literal
        ``full_state_update = False``. The ``Metric`` base's own default is
        excluded — "claims" means somebody opted the class in explicitly."""
        return any(cur.fsu_false for cur in self._ancestry(info) if cur.name != "Metric")

    def _wraps_children(self, info: ClassInfo) -> bool:
        """The class (or an ancestor) is a ``WrapperMetric`` or constructs a
        metric class into one of its own attributes."""
        for cur in self._ancestry(info):
            if cur.name in ("WrapperMetric", "CompositionalMetric"):
                return True
            if any(self.is_metric_class(c) and c != "Metric" for c in cur.constructed):
                return True
        return False

    def _info_ineligibility(self, info: ClassInfo) -> Optional[str]:
        states, counters, dynamic, host_only = self.resolved_states(info)
        if host_only:
            return "declares _sharded_update_unsupported (host-state update: its update cannot be captured)"
        if counters:
            return f"declares host-side counters {sorted(counters)} that cannot ride the fused device state carry"
        if not states and not dynamic:
            return "declares no registered states"
        if self._wraps_children(info):
            return "wraps child metrics; the fused state carry covers only the root registry"
        # first ancestry entry that defines update() decides the signature
        positional: Optional[bool] = None
        for cur in self._ancestry(info):
            if cur.update_positional is not None:
                positional = cur.update_positional
                break
        if positional is False:
            return (
                "update() accepts no positional batch arguments (kwargs-only"
                " signature) — the fused step passes the batch positionally"
            )
        return None

    def fusion_ineligible(self, name: str) -> Optional[str]:
        """Why a metric class named ``name`` cannot enter a fused plan
        (``parallel/fused.py``), or ``None`` when nothing is provable.

        The static mirror of the runtime ``fusion_ineligibility`` predicate:
        host-state updates (``_sharded_update_unsupported``), host-side
        counters, no registered state, child metrics, and kwargs-only
        ``update`` signatures. Name collisions and unknown ancestry resolve
        conservatively to eligible — a ratchet linter prefers missing a
        finding over inventing one.
        """
        infos = self._by_name.get(name, [])
        if not infos or not self.is_metric_class(name):
            return None
        reasons: Set[str] = set()
        for info in infos:
            reason = self._info_ineligibility(info)
            if reason is None:
                return None  # at least one definition of the name is eligible
            reasons.add(reason)
        return "; ".join(sorted(reasons)) if reasons else None


# ------------------------------------------------------------ taint analysis


def _annotation_mentions(node: Optional[ast.expr], needle: str) -> bool:
    if node is None:
        return False
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id == needle:
            return True
        if isinstance(sub, ast.Attribute) and sub.attr == needle:
            return True
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) and needle in sub.value:
            return True  # string ("from __future__") annotations
    return False


_CONTAINER_HINTS = ("Sequence", "List", "Tuple", "Dict", "Mapping", "Iterable", "list", "tuple", "dict")


def _is_tensor_annotation(node: Optional[ast.expr]) -> bool:
    """``Tensor``, ``torch.Tensor``, ``Optional[Tensor]`` or a ``Union`` of
    it — a tensor itself, not a container of tensors."""
    if node is None:
        return False
    src = ast.unparse(node)
    if "Tensor" not in src:
        return False
    return not any(f"{hint}[" in src for hint in _CONTAINER_HINTS)


def _fn_params(fn: ast.FunctionDef) -> List[ast.arg]:
    a = fn.args
    return list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)


def _data_params(fn: ast.FunctionDef) -> List[ast.arg]:
    return [p for p in _fn_params(fn) if p.arg not in ("self", "cls")][:2]


def is_host_path_fn(fn: ast.FunctionDef) -> bool:
    """True when a DATA parameter (one of the first two non-self params, the
    conventional preds/target slots) is annotated with ``str`` — string
    inputs cannot be device operands, so the body runs host-side by
    construction and ML002/ML004 do not apply. A ``str`` annotation on a
    later parameter is a mode flag (``reduction: str``), not proof of a host
    path: those functions stay checked."""
    return any(_annotation_mentions(p.annotation, "str") for p in _data_params(fn))


def _root_module(node: ast.expr) -> Optional[str]:
    """Leftmost name of a dotted expression: ``torch.linalg.norm`` -> ``torch``."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.value if not isinstance(node, ast.Call) else node.func
    return node.id if isinstance(node, ast.Name) else None


def _dotted(node: ast.expr) -> List[str]:
    """``torch.cuda.graph`` -> ``["torch", "cuda", "graph"]`` ([] when not a plain dotted name)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return []
    parts.append(node.id)
    return parts[::-1]


def _is_torch_call(call: ast.Call, *names: str) -> bool:
    """``torch.<name>(...)`` (or ``torch.<sub>.<name>``) for one of ``names``."""
    parts = _dotted(call.func)
    return len(parts) >= 2 and parts[0] == "torch" and parts[-1] in names


def _returns_tensor(call: ast.Call) -> bool:
    """A ``torch.``/``F.`` call that returns a tensor."""
    parts = _dotted(call.func)
    if not parts or parts[0] not in ("torch", "F"):
        return False
    if parts[0] == "F":
        return True
    if len(parts) >= 3 and parts[1] in _TORCH_HOST_MODULES:
        return False
    return len(parts) >= 2 and parts[1] not in _TORCH_HOST_FUNCS and parts[1] not in _TORCH_HOST_MODULES


class Taint:
    """Names/attributes in a function body that provably hold tensors.

    ``extra_names`` pre-taints additional parameters — the call-graph rules
    (ML011) use it to induce taint proven at a CALL SITE rather than by an
    annotation in this function's own signature."""

    def __init__(
        self,
        fn: ast.FunctionDef,
        self_states: Optional[Set[str]] = None,
        extra_names: Optional[Set[str]] = None,
    ) -> None:
        self.self_states = self_states or set()
        self.names: Set[str] = {
            p.arg for p in _fn_params(fn) if _is_tensor_annotation(p.annotation)
        }
        if extra_names:
            self.names |= set(extra_names)
        #: names bound to boolean tensors (masks) — boolean-mask indexing
        self.masks: Set[str] = set()
        # fixpoint over assignments; two sweeps catch the chains that occur
        # in practice (a = torch.f(x); b = a + 1; float(b))
        for _ in range(2):
            before = len(self.names) + len(self.masks)
            for stmt in _assignments(fn):
                if isinstance(stmt, ast.Assign) and self.is_tainted(stmt.value):
                    for tgt in stmt.targets:
                        self._taint_target(tgt, self.is_mask(stmt.value))
                elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                    if self.is_tainted(stmt.value) or _is_tensor_annotation(stmt.annotation):
                        self._taint_target(stmt.target, self.is_mask(stmt.value))
                elif isinstance(stmt, ast.AugAssign) and self.is_tainted(stmt.value):
                    self._taint_target(stmt.target, False)
            if len(self.names) + len(self.masks) == before:
                break

    def _taint_target(self, tgt: ast.expr, mask: bool) -> None:
        if isinstance(tgt, ast.Name):
            self.names.add(tgt.id)
            if mask:
                self.masks.add(tgt.id)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:
                self._taint_target(elt, False)

    def is_tainted(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False  # static under a capture — plain Python values
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return node.attr in self.self_states
            return self.is_tainted(node.value)
        if isinstance(node, ast.Call):
            if _returns_tensor(node):
                return True
            if isinstance(node.func, ast.Attribute):  # method on a tainted value
                if node.func.attr in _STATIC_METHODS or node.func.attr in ("item", "tolist", "numpy"):
                    return False
                return self.is_tainted(node.func.value)
            return False
        if isinstance(node, ast.BinOp):
            return self.is_tainted(node.left) or self.is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return not isinstance(node.op, ast.Not) and self.is_tainted(node.operand)
        if isinstance(node, ast.Subscript):
            return self.is_tainted(node.value)
        if isinstance(node, ast.IfExp):
            return self.is_tainted(node.body) or self.is_tainted(node.orelse)
        if isinstance(node, ast.Compare):
            # a comparison on a tensor is a tensor — bool(x == 0) syncs
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops):
                return False
            return self.is_tainted(node.left) or any(self.is_tainted(c) for c in node.comparators)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.is_tainted(elt) for elt in node.elts)
        return False

    def is_mask(self, node: ast.expr) -> bool:
        """A provably boolean tensor: a comparison of a tensor, ``isnan`` and
        friends, ``~``/``&``/``|`` of masks, ``.bool()``."""
        if isinstance(node, ast.Name):
            return node.id in self.masks
        if isinstance(node, ast.Compare):
            return self.is_tainted(node)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self.is_mask(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_mask(node.left) or self.is_mask(node.right)
        if isinstance(node, ast.Call):
            name = _callee_name(node)
            if _returns_tensor(node) and name in ("isnan", "isinf", "isfinite", "isclose", "logical_and",
                                                  "logical_or", "logical_not", "logical_xor", "isin", "eq", "ne",
                                                  "lt", "le", "gt", "ge", "isneginf", "isposinf", "signbit"):
                return True
            if isinstance(node.func, ast.Attribute) and self.is_tainted(node.func.value):
                return name in ("bool", "isnan", "isinf", "isfinite", "logical_not", "logical_and", "logical_or",
                                "eq", "ne", "lt", "le", "gt", "ge", "signbit")
        return False


# ------------------------------------------------------------- host regions


def _predicate_call(node: ast.expr, predicates: Set[str]) -> bool:
    return isinstance(node, ast.Call) and _callee_name(node) in predicates


def _device_test(test: ast.expr) -> Optional[bool]:
    """For a test of a tensor's device — ``x.device.type == "cpu"``,
    ``x.is_cuda``, their negations — whether it holds only on the CPU (True),
    only on a card (False); None for anything else. A CPU tensor is never
    captured, so a CPU-only branch is host path."""
    if isinstance(test, ast.Attribute) and test.attr == "is_cuda":
        return False
    if (isinstance(test, ast.Call) and isinstance(test.func, ast.Name) and test.func.id == "all"
            and len(test.args) == 1 and isinstance(test.args[0], (ast.GeneratorExp, ast.ListComp))):
        return True if _device_test(test.args[0].elt) is True else None  # every tensor on the CPU
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        inner = _device_test(test.operand)
        return None if inner is None else not inner
    if isinstance(test, ast.Compare) and len(test.ops) == 1:
        left, right = test.left, test.comparators[0]
        if not (isinstance(left, ast.Attribute) and left.attr == "type"
                and isinstance(left.value, ast.Attribute) and left.value.attr == "device"):
            return None
        if not (isinstance(right, ast.Constant) and right.value in ("cpu", "cuda")):
            return None
        equal = isinstance(test.ops[0], ast.Eq)
        if not equal and not isinstance(test.ops[0], ast.NotEq):
            return None
        return (right.value == "cpu") == equal
    return None


def _implies_concrete(test: ast.expr, predicates: Set[str]) -> bool:
    """``test`` holds only where values can be read on the host (an
    ``_is_concrete`` predicate, or a CPU-only device test)."""
    if _predicate_call(test, predicates) or _device_test(test) is True:
        return True
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        return any(_implies_concrete(v, predicates) for v in test.values)
    return False


def _implies_concrete_if_false(test: ast.expr, predicates: Set[str]) -> bool:
    """``not test`` holds only where values can be read on the host."""
    if _device_test(test) is False:
        return True
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _implies_concrete(test.operand, predicates)
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.Or):
        return any(_implies_concrete_if_false(v, predicates) for v in test.values)
    return False


def _exits(body: Sequence[ast.stmt]) -> bool:
    return bool(body) and isinstance(body[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


def concrete_predicates(tree: ast.Module) -> Set[str]:
    """``_is_concrete`` and the module's own helpers that return it in a
    conjunction (``return _is_concrete(x) and not _in_fused_step()``)."""
    names = set(_CONCRETE_PREDICATES)
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            returns = [s for s in _walk_no_nested_fns(node) if isinstance(s, ast.Return) and s.value is not None]
            if returns and all(_implies_concrete(r.value, names) for r in returns):
                names.add(node.name)
    return names


def _walk_device(fn: ast.FunctionDef, predicates: Set[str] = _CONCRETE_PREDICATES) -> Iterator[ast.AST]:
    """Walk a function body as a capture runs it: without nested def/class
    bodies (they run when called), and without the branches that run only
    where an ``_is_concrete`` predicate holds (host path by construction)."""

    def expr(node: ast.AST) -> Iterator[ast.AST]:
        stack: List[ast.AST] = [node]
        while stack:
            sub = stack.pop()
            yield sub
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(sub, ast.BoolOp) and isinstance(sub.op, ast.And):
                for value in sub.values:
                    stack.append(value)
                    if _implies_concrete(value, predicates):
                        break  # the operands after it run only where it holds
                continue
            if isinstance(sub, ast.IfExp):
                stack.append(sub.test)
                if not _implies_concrete(sub.test, predicates):
                    stack.append(sub.body)
                if not _implies_concrete_if_false(sub.test, predicates):
                    stack.append(sub.orelse)
                continue
            stack.extend(ast.iter_child_nodes(sub))

    def block(stmts: Sequence[ast.stmt]) -> Iterator[ast.AST]:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                yield stmt
                for dec in stmt.decorator_list:
                    yield from expr(dec)
                continue
            if isinstance(stmt, (ast.If, ast.While)):
                yield stmt
                yield from expr(stmt.test)
                if not _implies_concrete(stmt.test, predicates):
                    yield from block(stmt.body)
                if not _implies_concrete_if_false(stmt.test, predicates):
                    yield from block(stmt.orelse)
                if isinstance(stmt, ast.If) and _implies_concrete_if_false(stmt.test, predicates) and _exits(stmt.body):
                    return  # what follows runs only where the predicate holds
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                yield stmt
                yield from expr(stmt.target)
                yield from expr(stmt.iter)
                yield from block(stmt.body)
                yield from block(stmt.orelse)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                yield stmt
                for item in stmt.items:
                    yield from expr(item.context_expr)
                yield from block(stmt.body)
                continue
            if isinstance(stmt, ast.Try) or type(stmt).__name__ == "TryStar":
                yield stmt
                yield from block(stmt.body)
                for handler in stmt.handlers:
                    yield handler
                    yield from block(handler.body)
                yield from block(stmt.orelse)
                yield from block(stmt.finalbody)
                continue
            if type(stmt).__name__ == "Match":
                yield stmt
                yield from expr(stmt.subject)
                for case in stmt.cases:
                    yield from block(case.body)
                continue
            yield from expr(stmt)

    yield from block(fn.body)


def _walk_no_nested_fns(fn: ast.FunctionDef) -> List[ast.AST]:
    """The nodes of a function body without nested def/class bodies — nested
    closures are frequently captured bodies with their own rules of
    engagement. Cached on the node: every rule walks every body."""
    cached = getattr(fn, "_metriclint_walk", None)
    if cached is not None:
        return cached
    out: List[ast.AST] = []
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        out.append(node)
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))
    fn._metriclint_walk = out  # type: ignore[attr-defined]
    return out


def _tree_calls(tree: ast.AST) -> List[ast.Call]:
    """Every call expression of a module (cached on the tree)."""
    cached = getattr(tree, "_metriclint_calls", None)
    if cached is None:
        cached = [n for n in ast.walk(tree) if isinstance(n, ast.Call)]
        tree._metriclint_calls = cached  # type: ignore[attr-defined]
    return cached


def _assignments(fn: ast.FunctionDef) -> List[ast.stmt]:
    """Every (aug/ann) assignment in ``fn``, nested bodies included (cached)."""
    cached = getattr(fn, "_metriclint_assigns", None)
    if cached is None:
        cached = [n for n in ast.walk(fn) if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign))]
        fn._metriclint_assigns = cached  # type: ignore[attr-defined]
    return cached


# ----------------------------------------------------------------- the rules


def _self_attr_targets(stmt: ast.stmt) -> Iterator[Tuple[str, ast.AST]]:
    if isinstance(stmt, ast.Assign):
        targets: Sequence[ast.expr] = stmt.targets
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    else:
        return
    stack = list(targets)
    while stack:
        tgt = stack.pop()
        if isinstance(tgt, (ast.Tuple, ast.List)):
            stack.extend(tgt.elts)
        elif isinstance(tgt, ast.Attribute) and isinstance(tgt.value, ast.Name) and tgt.value.id == "self":
            yield tgt.attr, tgt


def check_ml001(info: "ClassInfo", index: ClassIndex) -> Iterator[Violation]:
    """Unregistered ``self.<attr>`` assignment inside ``update``."""
    states, counters, dynamic, _ = index.resolved_states(info)
    if dynamic:
        return  # state names are computed at runtime; nothing provable
    for item in info.node.body:
        if not (isinstance(item, ast.FunctionDef) and item.name == "update"):
            continue
        for stmt in _walk_no_nested_fns(item):
            if not isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                continue
            for attr, tgt in _self_attr_targets(stmt):
                if attr in states or attr in counters:
                    continue
                yield Violation(
                    "ML001", info.path, tgt.lineno, tgt.col_offset, f"{info.name}.update",
                    f"`self.{attr}` assigned in update() but never registered via add_state"
                    " (invisible to reset/snapshot; not part of the fused carry) —"
                    " register it or declare it in `_host_counters`",
                )


_CAPTURE = " — it syncs the stream and ends a CUDA-graph capture"


def _breaker(node: ast.Call, taint: Taint) -> Optional[str]:
    """Why ``node`` cannot be captured (a value-dependent output shape), or None."""
    func = node.func
    name = _callee_name(node)
    receiver = func.value if isinstance(func, ast.Attribute) else None
    torch_call = _is_torch_call(node, name or "")
    method = receiver is not None and not torch_call and taint.is_tainted(receiver)
    if name == "bincount" and (torch_call or method):
        return "`torch.bincount` reads its input's max on the host to size its output; use the port's `_bincount`"
    if name in ("nonzero", "argwhere") and (torch_call or method):
        return f"`{name}` sizes its output by the values; use a fixed-size mask and `torch.where`"
    if name == "where" and torch_call and len(node.args) == 1 and not node.keywords:
        return "one-argument `torch.where(c)` is `nonzero`: its output is sized by the values"
    if name in ("unique", "unique_consecutive") and (torch_call or method):
        return f"`{name}` sizes its output by the values"
    if name == "masked_select" and (torch_call or method):
        return "`masked_select` sizes its output by the mask's values; use `torch.where`"
    if name in ("tensor", "as_tensor", "asarray") and torch_call:
        device = next((kw.value for kw in node.keywords if kw.arg == "device"), None)
        data = node.args[0] if node.args else None
        if (device is not None and not (isinstance(device, ast.Constant) and device.value in (None, "cpu"))
                and not (data is not None and taint.is_tainted(data))):
            return f"`torch.{name}(..., device=...)` uploads host memory (a pageable copy)"
    if name in ("to", "cuda") and isinstance(receiver, ast.Call) and _is_torch_call(receiver, "tensor", "from_numpy", "as_tensor"):
        if name == "cuda" or node.args or any(kw.arg == "device" for kw in node.keywords):
            return f"`.{name}()` of a tensor just built on the host uploads host memory (a pageable copy)"
    if name == "repeat_interleave" and (torch_call or method):
        if any(kw.arg == "output_size" for kw in node.keywords):
            return None
        repeats = _call_arg(node, 1 if torch_call else 0, "repeats")
        if repeats is None and torch_call:
            return "one-argument `torch.repeat_interleave(r)` sizes its output by the values"
        if repeats is not None and taint.is_tainted(repeats):
            return "`repeat_interleave` with tensor repeats and no `output_size` reads the total on the host"
    return None


def _coercion_violations(
    fn: ast.FunctionDef, taint: Taint, path: str, scope: str, predicates: Set[str] = _CONCRETE_PREDICATES
) -> Iterator[Violation]:
    for node in _walk_device(fn, predicates):
        if isinstance(node, ast.Call):
            func = node.func
            if (
                isinstance(func, ast.Name)
                and func.id in ("float", "int", "bool")
                and len(node.args) == 1
                and not node.keywords
                and taint.is_tainted(node.args[0])
            ):
                yield Violation(
                    "ML002", path, node.lineno, node.col_offset, scope,
                    f"`{func.id}()` on a device tensor reads it on the host" + _CAPTURE
                    + "; keep the value on the device or read it only where `_is_concrete` holds",
                )
            elif (
                isinstance(func, ast.Attribute)
                and func.attr in ("item", "tolist", "cpu", "numpy")
                and not node.args
                and taint.is_tainted(func.value)
            ):
                yield Violation(
                    "ML002", path, node.lineno, node.col_offset, scope,
                    f"`.{func.attr}()` copies a device tensor to the host" + _CAPTURE
                    + "; keep the value on the device",
                )
            else:
                reason = _breaker(node, taint)
                if reason is not None:
                    yield Violation(
                        "ML002", path, node.lineno, node.col_offset, scope,
                        reason + _CAPTURE,
                    )
        elif isinstance(node, (ast.If, ast.While)):
            test = node.test
            if not isinstance(test, ast.BoolOp) and taint.is_tainted(test):
                yield Violation(
                    "ML002", path, node.lineno, node.col_offset, scope,
                    "truth-test of a device tensor (`if t:`) reads it on the host" + _CAPTURE
                    + "; use torch.where or a static condition",
                )
        elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load) and taint.is_tainted(node.value):
            index = node.slice
            parts = index.elts if isinstance(index, ast.Tuple) else [index]
            if any(taint.is_mask(p) for p in parts):
                yield Violation(
                    "ML002", path, node.lineno, node.col_offset, scope,
                    "boolean-mask indexing sizes its output by the mask's values" + _CAPTURE
                    + "; use torch.where or a fixed-size gather",
                )


def _numpy_violations(
    fn: ast.FunctionDef, taint: Taint, path: str, scope: str, predicates: Set[str] = _CONCRETE_PREDICATES
) -> Iterator[Violation]:
    for node in _walk_device(fn, predicates):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name) and func.value.id == "np"):
            continue
        if func.attr not in _TORCH_EQUIVALENTS:
            continue
        operands = list(node.args) + [kw.value for kw in node.keywords]
        if any(taint.is_tainted(arg) for arg in operands):
            yield Violation(
                "ML004", path, node.lineno, node.col_offset, scope,
                f"`np.{func.attr}` applied to a device tensor copies it to the host" + _CAPTURE
                + " (or raises for a CUDA tensor); use the torch op",
            )


def check_capture_fn(
    fn: ast.FunctionDef,
    path: str,
    scope: str,
    self_states: Optional[Set[str]] = None,
    predicates: Set[str] = _CONCRETE_PREDICATES,
) -> Iterator[Violation]:
    """ML002 + ML004 over one captured function/method body."""
    taint = Taint(fn, self_states=self_states)
    yield from _coercion_violations(fn, taint, path, scope, predicates)
    yield from _numpy_violations(fn, taint, path, scope, predicates)


def check_ml003(info: "ClassInfo", index: ClassIndex) -> Iterator[Violation]:
    for node in ast.walk(info.node):
        if not (isinstance(node, ast.Call) and _is_self_call(node, "add_state")):
            continue
        default = _call_arg(node, 1, "default")
        fx = _call_arg(node, 2, "dist_reduce_fx")
        fx_literal: object = None
        fx_is_literal = fx is None or isinstance(fx, ast.Constant)
        if isinstance(fx, ast.Constant):
            fx_literal = fx.value
        scope = f"{info.name}.add_state"
        if fx_is_literal and fx_literal is not None and fx_literal not in _VALID_REDUCTIONS:
            yield Violation(
                "ML003", info.path, node.lineno, node.col_offset, scope,
                f"dist_reduce_fx={fx_literal!r} is not a valid reduction"
                f" (one of {list(_VALID_REDUCTIONS)}, a callable, or None)",
            )
            continue
        if default is None:
            continue
        default_is_list = isinstance(default, (ast.List, ast.ListComp))
        if default_is_list and isinstance(default, ast.List) and default.elts:
            yield Violation(
                "ML003", info.path, node.lineno, node.col_offset, scope,
                "add_state default must be an EMPTY list (append/cat state) — a pre-filled"
                " list default is rejected by the runtime",
            )
        if fx_is_literal and default_is_list and fx_literal not in ("cat", None):
            yield Violation(
                "ML003", info.path, node.lineno, node.col_offset, scope,
                f"list default with dist_reduce_fx={fx_literal!r}: list states extend across"
                " ranks, so only 'cat'/None reductions are meaningful — an arithmetic"
                " reduction would silently concatenate instead of reducing",
            )
        array_literal = (
            isinstance(default, ast.Constant)
            or (isinstance(default, ast.Call) and _root_module(default.func) in ("torch", "np"))
        )
        if fx_is_literal and fx_literal == "cat" and array_literal:
            yield Violation(
                "ML003", info.path, node.lineno, node.col_offset, scope,
                "dist_reduce_fx='cat' with a tensor/scalar default: cat states should default"
                " to `[]` so per-batch appends keep their identity (a tensor default is"
                " concatenated INTO, changing shape every update)",
            )


def check_ml006(info: "ClassInfo", index: ClassIndex) -> Iterator[Violation]:
    """Unbounded ``cat`` list state on a metric claiming bounded behavior.

    A ``dist_reduce_fx="cat"`` list state grows without bound with
    data-dependent shapes — it needs a fixed capacity to be captured, and on
    a class that also claims ``full_state_update = False`` (the "my state
    folds cheaply" contract) the combination signals a metric that WANTS to
    be streaming but holds the whole stream. The bounded-memory sketch
    subsystem (``torchmetrics_tpu_torch/sketch``, ``dist_reduce_fx="merge"``)
    is the fix; pre-existing offenders are ratcheted in the baseline."""
    if not index.claims_fsu_false(info):
        return
    for node in ast.walk(info.node):
        if not (isinstance(node, ast.Call) and _is_self_call(node, "add_state")):
            continue
        default = _call_arg(node, 1, "default")
        fx = _call_arg(node, 2, "dist_reduce_fx")
        if not (isinstance(fx, ast.Constant) and fx.value == "cat"):
            continue
        if not isinstance(default, (ast.List, ast.ListComp)):
            continue
        yield Violation(
            "ML006", info.path, node.lineno, node.col_offset, f"{info.name}.add_state",
            "dist_reduce_fx='cat' list state on a metric claiming full_state_update=False:"
            " the state grows without bound and needs a fixed capacity to be captured —"
            " consider a bounded sketch state (torchmetrics_tpu_torch.sketch,"
            " dist_reduce_fx='merge'), e.g. SpearmanCorrCoef(num_bins=...)",
        )


def check_ml013(info: "ClassInfo", index: ClassIndex) -> Iterator[Violation]:
    """Float-prediction metric without a registered StateGuard contract.

    A class whose ``update`` (own or inherited) leads with a ``preds``
    parameter consumes model predictions — exactly the input family the
    serve plane guards with domain contracts (``Metric.domain_contract``,
    ``metric.py``). Without a ``domain_contract`` override anywhere in the
    ancestry, ``enable_guard()`` has nothing to mask/reject with, so the
    metric can only run the probe-less ``propagate`` policy. Pre-existing
    offenders are ratcheted in the baseline; new prediction metrics should
    ship a contract (see ``classification/stat_scores.py`` for the
    pattern)."""
    if index.declares_contract(info):
        return
    if not any(cur.update_takes_preds for cur in index._ancestry(info)):
        return
    yield Violation(
        "ML013", info.path, info.node.lineno, info.node.col_offset, info.name,
        "update() consumes float predictions but no domain_contract() is registered"
        " anywhere in the ancestry: enable_guard() cannot sanitize this metric's"
        " inputs — override domain_contract() with per-argument ArgSpec bounds"
        " (robustness/guard.py)",
    )


def check_ml005(info: "ClassInfo", index: ClassIndex) -> Iterator[Violation]:
    """Metric instances placed where ``_walk_metrics`` cannot see them.

    ``_walk_metrics`` recurses attributes through arbitrarily nested
    list/tuple/dict values; ``set``/``frozenset`` have no stable order —
    flag the construction site statically.
    """

    def metric_ctor_inside(node: ast.AST) -> Optional[ast.Call]:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                callee = _callee_name(sub)
                if callee and index.is_metric_class(callee) and callee != "Metric":
                    return sub
        return None

    for item in info.node.body:
        if not isinstance(item, ast.FunctionDef):
            continue
        for node in ast.walk(item):
            container: Optional[ast.AST] = None
            if isinstance(node, (ast.Set, ast.SetComp)):
                container = node
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in ("set", "frozenset")
            ):
                container = node
            if container is None:
                continue
            hit = metric_ctor_inside(container)
            if hit is not None:
                yield Violation(
                    "ML005", info.path, container.lineno, container.col_offset,
                    f"{info.name}.{item.name}",
                    "Metric constructed inside a set/frozenset — parallel/sharded.py:"
                    "_walk_metrics cannot traverse unordered containers, so this child is"
                    " invisible to the deep snapshot/reset/restore (silent state loss when"
                    " sharded); use a list, tuple, or dict",
                )


def check_ml007(path: str, tree: ast.Module, index: ClassIndex) -> Iterator[Violation]:
    """Fusion-ineligible metrics constructed inline in a ``MetricCollection``.

    The fused plan (``parallel/fused.py``, ``MetricCollection.fused()``)
    refuses members whose ``update`` cannot be captured positionally. This
    rule flags the same members at the CONSTRUCTION site with the static
    mirror of ``fusion_ineligibility`` (agreement pinned by
    ``tests/test_torch_lint.py``). Only inline constructor calls are visible
    statically; collections built from variables are the runtime report's
    job.
    """
    for node in _tree_calls(tree):
        if _callee_name(node) != "MetricCollection":
            continue
        seen: Set[Tuple[str, int, int]] = set()
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            for sub in ast.walk(arg):
                if not isinstance(sub, ast.Call):
                    continue
                cname = _callee_name(sub)
                if not cname or cname in ("MetricCollection", "Metric"):
                    continue
                reason = index.fusion_ineligible(cname)
                if reason is None:
                    continue
                key = (cname, sub.lineno, sub.col_offset)
                if key in seen:
                    continue
                seen.add(key)
                yield Violation(
                    "ML007", path, sub.lineno, sub.col_offset, f"MetricCollection[{cname}]",
                    f"{cname} is fusion-ineligible: {reason} — MetricCollection.fused() will"
                    " refuse this member (see parallel/fused.py fusion_report)",
                )


_FLOAT_DTYPE_ATTRS = ("float16", "float32", "float64", "bfloat16", "float_", "float", "double", "half")

#: tensor constructors whose ARGUMENTS become the tensor's values — a float
#: literal inside them proves a float key; a float inside any other call's
#: args (``bucketize(x, linspace(0.0, ...))`` bin edges) proves nothing about
#: the call's OUTPUT dtype, so those stay quiet
_VALUE_CTOR_ATTRS = ("asarray", "array", "tensor", "as_tensor", "stack", "cat", "concatenate", "full")

#: tensor methods that cast to a float dtype
_FLOAT_CAST_METHODS = ("float", "double", "half", "bfloat16")


def _mentions_float_dtype(node: ast.expr) -> bool:
    return any(
        isinstance(sub, ast.Attribute) and sub.attr in _FLOAT_DTYPE_ATTRS
        for sub in ast.walk(node)
    )


def _float_expr_evidence(node: ast.expr) -> Optional[str]:
    """Provable float-ness of a cohort-key expression — the static mirror of
    the runtime ``slice_key_reason`` integer-dtype check. Only constructs
    whose OUTPUT dtype is provably float count as evidence: value-level
    float literals (bare, or inside tensor constructors), true division,
    ``.to(float*)``/``.astype(float*)``/``.float()`` and ``dtype=float*``
    kwargs. Anything else stays quiet; the runtime check is the backstop."""
    if isinstance(node, ast.Constant) and isinstance(node.value, float):
        return "contains a float literal"
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.Div):
            return "contains a true division (float result)"
        return _float_expr_evidence(node.left) or _float_expr_evidence(node.right)
    if isinstance(node, ast.UnaryOp):
        return _float_expr_evidence(node.operand)
    if isinstance(node, (ast.List, ast.Tuple)):
        for elt in node.elts:
            evidence = _float_expr_evidence(elt)
            if evidence:
                return evidence
        return None
    if isinstance(node, ast.Call):
        func = node.func
        for kw in node.keywords:
            if kw.arg == "dtype":
                # an explicit dtype decides the output outright: float dtype
                # is evidence, any OTHER explicit dtype proves the output
                # integral regardless of float literals in the values — quiet
                return "passes an explicit float dtype" if _mentions_float_dtype(kw.value) else None
        if isinstance(func, ast.Attribute) and func.attr in ("astype", "to"):
            operands = list(node.args) + [kw.value for kw in node.keywords]
            if any(_mentions_float_dtype(arg) for arg in operands):
                return f"casts to an explicit float dtype (.{func.attr})"
            return None
        if isinstance(func, ast.Attribute) and func.attr in _FLOAT_CAST_METHODS and not node.args:
            return f"casts to a float dtype (.{func.attr}())"
        if isinstance(func, ast.Attribute) and func.attr in _VALUE_CTOR_ATTRS:
            for arg in node.args:
                evidence = _float_expr_evidence(arg)
                if evidence:
                    return evidence
        return None
    return None


def _walk_outside_int_casts(node: ast.expr) -> Iterator[ast.AST]:
    """Walk an expression without descending into ``int(...)`` calls — an
    explicit int cast makes whatever is inside a static python int, so
    float-ness evidence below it is moot (tensor-derivation is checked by a
    FULL walk separately: ``int(torch.unique(keys).numel())`` is still
    data-dependent sizing)."""
    stack: List[ast.AST] = [node]
    while stack:
        sub = stack.pop()
        yield sub
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Name)
            and sub.func.id == "int"
        ):
            continue
        stack.extend(ast.iter_child_nodes(sub))


def _table_size_evidence(node: ast.expr) -> Optional[str]:
    """Provable bad slice-table sizing. Two classes of evidence:

    - FLOAT sizing (the runtime ``slice_table_size_reason`` refuses it):
      non-int literals, or a true division not wrapped in ``int(...)``.
    - DATA-DEPENDENT sizing (tensor-derived —
      ``int(torch.unique(keys).numel())``): the runtime CANNOT see this (it
      receives a plain int), but the table is a fixed shape, so sizing it
      from data recaptures per run and makes cell indices unstable.

    Host-side ints (``torch.cuda.device_count() * 128``, ``int(n / 2)``)
    stay quiet."""
    if isinstance(node, ast.Constant):
        value = node.value
        if isinstance(value, bool) or not isinstance(value, int):
            return f"is the non-int literal {value!r} (the table is a fixed shape)"
        if value < 1:
            return f"is {value!r}; the table needs at least one cell"
        return None
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and _returns_tensor(sub):
            return "derives from a tensor value — data-dependent (dynamic-shape) sizing"
    for sub in _walk_outside_int_casts(node):
        if isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Div):
            return "uses true division (float result) — use // for integer sizing"
    return None


def check_ml008(path: str, tree: ast.Module, index: ClassIndex) -> Iterator[Violation]:
    """Sliced-plane contract violations at construction sites.

    The slice table (``parallel/sliced.py``) is a fixed shape keyed by
    hashed integer cohort keys: ``num_cells`` must be a static positive
    python int and cohort keys must be integer tensors. This rule flags
    provable violations at ``SlicedPlan(...)``/``.sliced(...)`` call sites,
    with the SAME predicates the runtime applies
    (``slice_table_size_reason``/``slice_key_reason``). Values the AST
    cannot prove stay quiet; the runtime check is the backstop.
    """
    for node in _tree_calls(tree):
        if _callee_name(node) not in ("SlicedPlan", "sliced"):
            continue
        num_cells = next((kw.value for kw in node.keywords if kw.arg == "num_cells"), None)
        if num_cells is not None:
            evidence = _table_size_evidence(num_cells)
            if evidence:
                yield Violation(
                    "ML008", path, num_cells.lineno, num_cells.col_offset,
                    "SlicedPlan.num_cells",
                    f"slice-table sizing num_cells {evidence} — the runtime"
                    " (slice_table_size_reason) refuses it; size with a static positive int",
                )
        example_keys = next((kw.value for kw in node.keywords if kw.arg == "example_keys"), None)
        if example_keys is not None:
            evidence = _float_expr_evidence(example_keys)
            if evidence:
                yield Violation(
                    "ML008", path, example_keys.lineno, example_keys.col_offset,
                    "SlicedPlan.example_keys",
                    f"cohort-key expression {evidence} — keys are hashed and compared for"
                    " exact equality, so the runtime (slice_key_reason) refuses float keys;"
                    " bucket or hash float features to ints",
                )


# ------------------------------------------------------------ ML014 / ML015


_SEQUENCE_HINTS = ("Sequence[", "List[", "Tuple[", "list[", "tuple[", "Iterable[")


def _computed_sequence(node: ast.expr) -> bool:
    """An expression that builds a dim sequence at run time (and so can be empty)."""
    if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
        return True
    if isinstance(node, (ast.Tuple, ast.List)):
        return any(isinstance(e, ast.Starred) for e in node.elts)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id in ("tuple", "list", "range", "sorted"):
        return True
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _computed_sequence(node.left) or _computed_sequence(node.right)
    if isinstance(node, ast.Subscript) and isinstance(node.slice, ast.Slice):
        return True
    return False


def _bindings(fn: ast.FunctionDef) -> Dict[str, List[ast.expr]]:
    out: Dict[str, List[ast.expr]] = {}
    for stmt in _walk_no_nested_fns(fn):
        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name):
                    out.setdefault(tgt.id, []).append(stmt.value)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None and isinstance(stmt.target, ast.Name):
            out.setdefault(stmt.target.id, []).append(stmt.value)
    return out


def _emptiness_tested(fn: ast.FunctionDef, name: str) -> bool:
    """``name`` is tested for emptiness somewhere in ``fn``: ``if not d``,
    ``if d``, ``len(d)``, ``d == ()`` in a test, or a conditional expression."""

    def tests(node: ast.expr) -> bool:
        if isinstance(node, ast.Name):
            return node.id == name
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            return tests(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(tests(v) for v in node.values)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) and sub.func.id == "len":
                if sub.args and isinstance(sub.args[0], ast.Name) and sub.args[0].id == name:
                    return True
            if isinstance(sub, ast.Compare):
                operands = [sub.left] + list(sub.comparators)
                if any(isinstance(o, ast.Name) and o.id == name for o in operands) and any(
                    isinstance(o, (ast.Tuple, ast.List)) and not o.elts for o in operands
                ):
                    return True
        return False

    for node in _walk_no_nested_fns(fn):
        test = getattr(node, "test", None) if isinstance(node, (ast.If, ast.IfExp, ast.While, ast.Assert)) else None
        if test is not None and tests(test):
            return True
    return False


def _reduction_dim(call: ast.Call, taint: Taint) -> Optional[ast.expr]:
    """The ``dim`` argument of a ``sum``/``mean``/... reduction call, or None."""
    name = _callee_name(call)
    if name not in _DIM_REDUCTIONS:
        return None
    torch_call = _is_torch_call(call, name)
    if not torch_call and not (isinstance(call.func, ast.Attribute) and taint.is_tainted(call.func.value)):
        return None
    for kw in call.keywords:
        if kw.arg in ("dim", "axis"):
            return kw.value
    pos = 1 if torch_call else 0
    return call.args[pos] if len(call.args) > pos else None


def _ml014(fn: ast.FunctionDef, path: str, scope: str, taint: Taint, calls: List[ast.Call]) -> Iterator[Violation]:
    """A reduction over a ``dim`` that is a computed sequence, unguarded.

    ``Tensor.sum(dim=())`` reduces every dim where ``jnp.sum(axis=())``
    reduces none (ROADMAP C3). A dim built at run time — a comprehension,
    ``tuple()``/``list()``/``range()``, a slice, a ``Sequence[int]``
    parameter — can be empty; the reduction is flagged unless an emptiness
    test of that value guards it in the same function
    (``functional/regression/csi.py``'s ``_count`` is the clean idiom)."""
    bindings = _bindings(fn)
    seq_params = {
        p.arg for p in _fn_params(fn)
        if p.annotation is not None and any(h in ast.unparse(p.annotation) for h in _SEQUENCE_HINTS)
    }
    for node in calls:
        dim = _reduction_dim(node, taint)
        if dim is None:
            continue
        if isinstance(dim, ast.Name):
            computed = dim.id in seq_params or any(_computed_sequence(v) for v in bindings.get(dim.id, []))
            if not computed or _emptiness_tested(fn, dim.id):
                continue
            what = f"`{dim.id}`"
        elif _computed_sequence(dim):
            what = f"`{ast.unparse(dim)}`"
        else:
            continue
        yield Violation(
            "ML014", path, node.lineno, node.col_offset, scope,
            f"`{_callee_name(node)}` over the computed dim {what}, which can be empty:"
            " torch reduces EVERY dim for dim=() where jnp reduces none — test it for"
            " emptiness first (functional/regression/csi.py `_count`)",
        )


def _ml015(taint: Taint, path: str, scope: str, calls: List[ast.Call]) -> Iterator[Violation]:
    """``torch.prod``/``Tensor.prod`` on a device tensor: its kernel compiles on first use."""
    for node in calls:
        if _callee_name(node) != "prod":
            continue
        if _is_torch_call(node, "prod") or (isinstance(node.func, ast.Attribute) and taint.is_tainted(node.func.value)):
            yield Violation(
                "ML015", path, node.lineno, node.col_offset, scope,
                "`prod` on a device tensor compiles its CUDA kernel at run time, the first time in a"
                " process (1-1.6 s on a first SSIM update) — multiply rows in a loop (`_prod_rows`)"
                " or take `math.prod` of static sizes on the host",
            )


def check_ml014_ml015(fn: ast.FunctionDef, path: str, scope: str, self_states: Optional[Set[str]] = None) -> Iterator[Violation]:
    """ML014 and ML015 over one function, captured or eager."""
    calls = [n for n in _walk_no_nested_fns(fn) if isinstance(n, ast.Call) and _callee_name(n) in _DIM_REDUCTIONS]
    if not calls:
        return
    taint = Taint(fn, self_states=self_states)
    yield from _ml014(fn, path, scope, taint, calls)
    yield from _ml015(taint, path, scope, calls)


# ------------------------------------------------------------- file checking


def _qualified_functions(tree: ast.Module) -> Iterator[Tuple[ast.FunctionDef, str, Optional[str]]]:
    """Every def of a module with its scope name and enclosing class."""

    def visit(body: Sequence[ast.stmt], prefix: str, cls: Optional[str]) -> Iterator[Tuple[ast.FunctionDef, str, Optional[str]]]:
        for node in body:
            if isinstance(node, ast.FunctionDef):
                yield node, prefix + node.name, cls
                yield from visit(node.body, prefix + node.name + ".", None)
            elif isinstance(node, ast.ClassDef):
                yield from visit(node.body, prefix + node.name + ".", node.name)

    yield from visit(tree.body, "", None)


def is_functional_update_kernel(fn: ast.FunctionDef) -> bool:
    """A module-level ``*_update`` function with a ``Tensor`` data parameter:
    the functional kernels a metric's ``update`` calls into the capture."""
    if is_host_path_fn(fn):
        return False
    return fn.name.endswith("_update") and any(_is_tensor_annotation(p.annotation) for p in _data_params(fn))


def is_captured_update(info: ClassInfo, index: ClassIndex) -> bool:
    """Whether a metric class's ``update`` is captured: the fused plan (and
    ``make_jit_update``) accepts the class by the ML007 predicate."""
    _states, _counters, _dynamic, host_only = index.resolved_states(info)
    return not host_only and index._info_ineligibility(info) is None


def check_file(path: str, tree: ast.Module, index: ClassIndex) -> List[Violation]:
    violations: List[Violation] = []
    predicates = concrete_predicates(tree)
    violations.extend(check_ml007(path, tree, index))
    violations.extend(check_ml008(path, tree, index))
    class_states: Dict[str, Set[str]] = {}
    for info in index.classes_in_file(path):
        if not index.is_metric_class(info.name):
            continue
        states, counters, dynamic, host_only = index.resolved_states(info)
        class_states[info.name] = states
        violations.extend(check_ml001(info, index))
        violations.extend(check_ml003(info, index))
        violations.extend(check_ml005(info, index))
        violations.extend(check_ml006(info, index))
        violations.extend(check_ml013(info, index))
        if not is_captured_update(info, index):
            continue  # never captured — host reads are the contract
        for item in info.node.body:
            if isinstance(item, ast.FunctionDef) and item.name == "update" and not is_host_path_fn(item):
                violations.extend(
                    check_capture_fn(item, path, f"{info.name}.update", self_states=states, predicates=predicates)
                )
    # functional update kernels: module-level ``*_update`` with tensor data
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and is_functional_update_kernel(node):
            violations.extend(check_capture_fn(node, path, node.name, predicates=predicates))
    # ML014/ML015: every function, captured or eager
    for fn, scope, cls in _qualified_functions(tree):
        states = class_states.get(cls) if cls else None
        violations.extend(check_ml014_ml015(fn, path, scope, states))
    return violations
