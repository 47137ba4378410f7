"""host-sync — the port's host-sync discipline (the reference's R3).

Every host synchronization stalls the launch pipeline: the host waits until
the card catches up, and the overlap the runtime worked for (the slot
cache's async uploads, the double-buffered schedule) is lost for that
step. The policy is the reference's: syncs happen only at *declared fence
points*, where the algorithm itself needs a host value (the router top-k
that drives expert streaming, the demand-upload fence, token emission,
logging at step boundaries), and nowhere else.

What waits for the card, on a value that may live on it:

* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, and ``.to(<host>)``
  without ``non_blocking=True``;
* ``torch.cuda.synchronize()``, ``Stream.synchronize()`` and
  ``Event.synchronize()`` (any ``.synchronize()``);
* ``float()``/``int()``/``bool()`` of a tensor, and a tensor as the test of
  an ``if``, ``while`` or ``assert``; ``torch.equal``/``torch.allclose``;
* ops whose output shape depends on the data, which read a count back
  before they return: ``nonzero``, ``masked_select``, ``unique``,
  ``torch.where(cond)``, ``repeat_interleave`` with tensor repeats, and
  indexing with a boolean mask;
* a blocking host->device copy of host data (``torch.tensor``/
  ``torch.as_tensor`` of host data with a device, ``.to(<device>)`` of a
  host tensor without ``non_blocking=True``): PyTorch copies from pageable
  memory and then waits for the copy (``torch.cuda.set_sync_debug_mode``
  reports it as a sync).

Taint: a value may live on the card when it comes from a ``torch.*`` call
(a factory only with a ``device=``), a method of such a value, or a call of
a scanned function that returns one (a fixed point over the graph, through
callables that a function builds and returns), or from a ``self.<attr>``
that some method of the class binds to one. Parameters are not tainted, as
in the reference.

Scope: ``src/repro_torch`` minus this package and ``examples/``; tests are
exempt. Functions reachable from a declared step entry are exempt here: a
sync there is ``capture-hazard``'s, as in-trace concretization is R1's in
the reference.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.callgraph import (CallGraph, ClassInfo, FuncInfo,
                                            call_attr_name)
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import rule
from repro_torch.analysis.source import ModuleSource

# (path suffix, qualname prefix, the reference fence it stands for,
#  reason) — declared host-sync fence points. Each maps to one of the
# reference's DECLARED_FENCES (src/repro/analysis/rules/host_sync.py); where
# the port has more than one for a reference fence, the reason says why.
# ShardedSlotRuntime inherits decode/prefill, so SlotStreamRuntime's fences
# cover the expert-parallel runtime too.
DECLARED_FENCES: Tuple[Tuple[str, str, str, str], ...] = (
    ("serving/slot_runtime.py", "SlotStreamRuntime.decode",
     "serving/slot_runtime.py::SlotStreamRuntime.decode",
     "router top-k must reach the host each step to drive expert "
     "streaming; the step's tokens and counts are read back at its end"),
    ("serving/slot_runtime.py", "SlotStreamRuntime.prefill",
     "serving/slot_runtime.py::SlotStreamRuntime.prefill",
     "prefill routing is read on host to warm the slot cache"),
    ("core/slot_cache.py", "ExpertSlotCache.fence",
     "core/slot_cache.py::ExpertSlotCache.fence",
     "the demand-upload fence is the one sanctioned blocking wait"),
    ("serving/engine.py", "TorchModelServer._route_iteration",
     "serving/engine.py::JaxModelServer._route_iteration",
     "token emission and router-count feedback are the serving loop's "
     "per-step fence"),
    ("serving/engine.py", "TorchModelServer._prefill",
     "serving/engine.py::JaxModelServer._route_iteration",
     "the port reads a joiner's first token and counts here; the reference "
     "does the same reads inline in _route_iteration"),
    ("serving/engine.py", "TorchModelServer._decode",
     "serving/engine.py::JaxModelServer._route_iteration",
     "the port reads the pooled step's tokens and counts (and waits on the "
     "step's timing event) here; the reference does the same reads inline "
     "in _route_iteration"),
    ("launch/serve.py", "main",
     "launch/serve.py::main",
     "CLI output marshalling happens after the measured region"),
    ("launch/serve.py", "serve",
     "launch/serve.py::main",
     "the port's main parses its flags and calls serve, which holds the "
     "reference main's body: the EAMC warm-up reads and the report"),
    ("launch/train.py", "main",
     "launch/train.py::main",
     "loss/grad-norm logging at step boundaries is an accepted sync"),
    ("launch/train.py", "train",
     "launch/train.py::main",
     "the port's main parses its flags and calls train, which holds the "
     "reference main's loop: loss/grad-norm logging at step boundaries"),
    ("train/loop.py", "train_loop",
     "train/loop.py::train_loop",
     "loss logging at step boundaries is an accepted sync"),
    ("train/loop.py", "to_batch",
     "train/loop.py::train_loop",
     "the batch upload at a step boundary (pageable numpy batches); the "
     "reference uploads inline in train_loop, the port in this helper that "
     "train_loop and launch/train.py::train share"),
)

# torch calls whose result is not a tensor (or not one on the card)
_TORCH_NON_TENSOR = frozenset({
    "device", "is_grad_enabled", "is_available", "get_device_properties",
    "device_count", "current_stream", "Stream", "Event", "promote_types",
    "finfo", "iinfo", "Generator", "get_device_name", "manual_seed",
    "set_num_threads", "is_tensor", "no_grad", "inference_mode",
    "enable_grad", "stream", "dtype", "Size", "get_default_dtype",
    "set_grad_enabled", "is_inference_mode_enabled", "is_floating_point",
    "set_sync_debug_mode", "get_sync_debug_mode", "empty_cache",
    "memory_allocated", "max_memory_allocated", "reset_peak_memory_stats",
    "synchronize", "equal", "allclose", "CheckpointPolicy", "ModuleList",
    "create_selective_checkpoint_contexts", "cudart",
    # torch.distributed's host-side queries and DTensor's placement types
    "is_initialized", "get_rank", "get_world_size", "get_backend",
    "Replicate", "Shard", "Partial", "init_device_mesh", "DeviceMesh",
})
# factories: on the card only when given a device
_FACTORIES = frozenset({
    "zeros", "ones", "empty", "full", "arange", "tensor", "as_tensor",
    "randn", "rand", "randint", "linspace", "eye", "empty_strided",
    "from_numpy", "frombuffer",
})
_LIKE = frozenset({"zeros_like", "ones_like", "empty_like", "full_like",
                   "rand_like", "randn_like"})
_META_ATTRS = frozenset({"shape", "dtype", "device", "ndim", "is_cuda",
                         "is_meta", "requires_grad", "layout", "is_leaf",
                         "grad_fn", "type", "placements", "device_mesh"})
_META_METHODS = frozenset({"dim", "size", "numel", "element_size",
                           "data_ptr", "stride", "is_contiguous",
                           "is_floating_point", "nelement", "storage_offset",
                           "get_device", "is_pinned", "untyped_storage",
                           "record_stream", "register_hook", "is_shard",
                           "is_replicate", "is_partial"})
_HOST_VALUE_METHODS = frozenset({"item", "tolist", "numpy"})
_D2H = frozenset({"item", "tolist", "cpu", "numpy"})
_COERCIONS = frozenset({"float", "int", "bool"})
_SHAPE_OPS = frozenset({"nonzero", "masked_select", "unique",
                        "unique_consecutive", "argwhere"})
_BOOL_METHODS = frozenset({"bool", "isfinite", "isnan", "isinf", "logical_not",
                           "logical_and", "logical_or", "eq", "ne", "lt",
                           "le", "gt", "ge"})

# kinds of value: on the card, a host tensor, or a parameter that may be
# either (or no tensor at all); joined in this order
DEV, HOST, MAYBE = "dev", "host", "maybe"
_RANK = {None: 0, HOST: 1, MAYBE: 2, DEV: 3}
# methods of containers and strings: a MAYBE receiver is not a tensor
_CONTAINER_METHODS = frozenset({
    "get", "items", "keys", "values", "pop", "setdefault", "index",
    "count", "copy", "split", "strip", "startswith", "endswith", "format",
    "join", "lower", "upper", "replace", "append", "extend", "update"})


def _path(node: ast.AST) -> Optional[str]:
    """Dotted path of a Name/Attribute/Subscript (the reference's
    ``donation._path``)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        b = _path(node.value)
        return f"{b}.{node.attr}" if b else None
    if isinstance(node, ast.Subscript):
        b = _path(node.value)
        if b is None:
            return None
        s = node.slice
        if isinstance(s, ast.Name):
            return f"{b}[{s.id}]"
        if isinstance(s, ast.Constant):
            return f"{b}[{s.value!r}]"
        return f"{b}[?]"
    if isinstance(node, ast.Starred):
        return _path(node.value)
    return None


def _linear_stmts(stmts):
    """Statements in order, compound bodies flattened (the reference's
    ``donation._linear_stmts``)."""
    for s in stmts:
        yield s
        for attr in ("body", "orelse", "finalbody"):
            inner = getattr(s, attr, None)
            if inner:
                yield from _linear_stmts(inner)
        for h in getattr(s, "handlers", ()) or ():
            yield from _linear_stmts(h.body)


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _is_true(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _is_cpu(node: Optional[ast.AST]) -> bool:
    """A device expression naming the host: 'cpu', torch.device('cpu')."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and call_attr_name(node.func) == "device" \
            and node.args:
        return _is_cpu(node.args[0])
    return False


def _is_dtype(node: ast.AST) -> bool:
    """torch.long, torch.float32, x.dtype, self.dtype: a dtype argument."""
    return isinstance(node, ast.Attribute) and (
        node.attr == "dtype" or (isinstance(node.value, ast.Name)
                                 and node.value.id == "torch"
                                 and node.attr != "device"))


def _to_target(call: ast.Call) -> Tuple[Optional[ast.AST], bool]:
    """(device argument of a ``.to(...)`` call or None, non_blocking)."""
    dev = _kw(call, "device")
    if dev is None and call.args and not _is_dtype(call.args[0]):
        dev = call.args[0]
    return dev, _is_true(_kw(call, "non_blocking"))


class Taint:
    """Per-function linear taint state: which paths may hold a tensor on
    the card (``dev``), a host tensor (``host``), a value of either kind
    or none (``maybe``: a parameter, with ``params``), or a boolean tensor;
    and which names hold a callable a scanned function built. A method of
    a ``maybe`` value (but a container's) is a tensor op."""

    def __init__(self, fi: FuncInfo, graph: CallGraph,
                 params: bool = False):
        self.fi = fi
        self.m = fi.module
        self.graph = graph
        self.kind: Dict[str, str] = dict.fromkeys(
            tensor_params(fi) if params else (), MAYBE)
        self.bools: Set[str] = set()
        self.callables: Dict[str, FuncInfo] = {}
        self.comp: Dict[str, str] = {}
        self.cls = graph.class_of(fi)
        self.cls_attrs = class_tensor_attrs(graph).get(
            self.cls.key(), {}) if self.cls is not None else {}

    # -- what a call runs ----------------------------------------------------
    def targets(self, call: ast.Call) -> List[FuncInfo]:
        func = call.func
        if isinstance(func, ast.Name) and func.id in self.callables:
            return [self.callables[func.id]]
        if isinstance(func, ast.Call):
            return [c for f in self.targets(func)
                    for c in [returned_callable(self.graph, f)] if c]
        return self.graph.resolve_target(self.m, func, self.fi,
                                         any_method=True)

    def torch_call(self, call: ast.Call) -> bool:
        return self.graph.is_torchish(self.m, call.func)

    # -- kinds -------------------------------------------------------------
    def of(self, e: Optional[ast.AST]) -> Optional[str]:
        """'dev', 'host', 'maybe' or None (not a tensor, or unknown)."""
        if e is None or isinstance(e, ast.Constant):
            return None
        if isinstance(e, ast.Name):
            return self.comp.get(e.id) or self.kind.get(e.id)
        if isinstance(e, ast.Attribute):
            if e.attr in _META_ATTRS:
                return None
            p = _path(e)
            if p in self.kind:
                return self.kind[p]
            if isinstance(e.value, ast.Name) and e.value.id == "self":
                return self.cls_attrs.get(e.attr)
            # a field of a tensor or of a tuple of them (.T, .grad,
            # topk's .indices)
            return self.of(e.value)
        if isinstance(e, ast.Subscript):
            p = _path(e)
            if p in self.kind:
                return self.kind[p]
            return self.of(e.value)
        if isinstance(e, ast.Call):
            return self._call_kind(e)
        if isinstance(e, ast.BinOp):
            return self._join(self.of(e.left), self.of(e.right))
        if isinstance(e, ast.UnaryOp):
            return self.of(e.operand)
        if isinstance(e, ast.Compare):
            if all(isinstance(o, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for o in e.ops):
                return None
            k = None
            for x in [e.left, *e.comparators]:
                k = self._join(k, self.of(x))
            return k
        if isinstance(e, ast.BoolOp):
            k = None
            for v in e.values:
                k = self._join(k, self.of(v))
            return k
        if isinstance(e, ast.IfExp):
            return self._join(self.of(e.body), self.of(e.orelse))
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            k = None
            for v in e.elts:
                k = self._join(k, self.of(v))
            return k
        if isinstance(e, ast.Dict):
            k = None
            for v in e.values:
                k = self._join(k, self.of(v))
            return k
        if isinstance(e, ast.Starred):
            return self.of(e.value)
        if isinstance(e, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
            with_comp = self._comp_scope(e)
            k = self.of(e.elt)
            self.comp = with_comp
            return k
        if isinstance(e, ast.DictComp):
            with_comp = self._comp_scope(e)
            k = self.of(e.value)
            self.comp = with_comp
            return k
        if isinstance(e, ast.NamedExpr):
            return self.of(e.value)
        return None

    @staticmethod
    def _join(a: Optional[str], b: Optional[str]) -> Optional[str]:
        return a if _RANK[a] >= _RANK[b] else b

    def _comp_scope(self, e) -> Dict[str, str]:
        """Bind a comprehension's targets to its iterables' kinds; returns
        the bindings to restore afterwards."""
        saved = dict(self.comp)
        for gen in e.generators:
            k = self.of(gen.iter)
            for n in ast.walk(gen.target):
                if isinstance(n, ast.Name):
                    if k:
                        self.comp[n.id] = k
                    else:
                        self.comp.pop(n.id, None)
        return saved

    def _call_kind(self, call: ast.Call) -> Optional[str]:
        func = call.func
        name = call_attr_name(func)
        if self.torch_call(call):
            if name in _TORCH_NON_TENSOR:
                return None
            if name in _FACTORIES:
                if name == "from_numpy":
                    return HOST
                dev = _kw(call, "device")
                if name == "as_tensor" and dev is None and call.args and \
                        self.of(call.args[0]) == DEV:
                    return DEV
                return DEV if dev is not None and not _is_cpu(dev) else HOST
            if name in _LIKE:
                return self.of(call.args[0]) if call.args else DEV
            kinds = [self.of(a) for a in call.args]
            if HOST in kinds and not ({DEV, MAYBE} & set(kinds)):
                return HOST
            return DEV
        if isinstance(func, ast.Attribute):
            if name in _HOST_VALUE_METHODS or name in _META_METHODS:
                return None
            recv = self.of(func.value)
            if name == "cpu":
                return HOST if recv else None
            if name == "pin_memory":
                return HOST
            if name == "cuda":
                return DEV
            if name == "to" and recv:
                dev, _ = _to_target(call)
                if dev is None:
                    return recv
                return HOST if _is_cpu(dev) else DEV
            if recv == MAYBE:
                return None if name in _CONTAINER_METHODS else DEV
            if recv:
                return recv
        if any(returns_tensor(self.graph, f) for f in self.targets(call)):
            return DEV
        return None

    def is_bool(self, e: ast.AST) -> bool:
        """Is ``e`` a boolean tensor on the card (a mask)?"""
        if isinstance(e, ast.Compare):
            return self.of(e) == DEV
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Invert):
            return self.is_bool(e.operand)
        if isinstance(e, ast.BinOp) and isinstance(
                e.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_bool(e.left) or self.is_bool(e.right)
        if isinstance(e, ast.Call) and call_attr_name(e.func) in \
                _BOOL_METHODS:
            return self.of(e) == DEV
        if isinstance(e, ast.Call) and _is_bool_dtype(_kw(e, "dtype")):
            return self.of(e) == DEV
        p = _path(e)
        return p is not None and p in self.bools

    # -- state updates ---------------------------------------------------
    def assign(self, targets, value: Optional[ast.AST]) -> None:
        if value is None:
            return
        for t in targets:
            if isinstance(t, (ast.Tuple, ast.List)) and \
                    isinstance(value, (ast.Tuple, ast.List)) and \
                    len(t.elts) == len(value.elts):
                for tt, vv in zip(t.elts, value.elts):
                    self.assign([tt], vv)
                continue
            k = self.of(value)
            b = self.is_bool(value)
            made = None
            if isinstance(value, ast.Call):
                made = next((c for f in self.targets(value)
                             for c in [returned_callable(self.graph, f)]
                             if c), None)
            for leaf in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                         else [t]):
                p = _path(leaf)
                if p is None:
                    continue
                if k:
                    self.kind[p] = k
                else:
                    self.kind.pop(p, None)
                if b:
                    self.bools.add(p)
                else:
                    self.bools.discard(p)
                if made is not None and isinstance(leaf, ast.Name):
                    self.callables[leaf.id] = made

    def loop_target(self, target: ast.AST, it: ast.AST) -> None:
        k = self.of(it)
        for n in ast.walk(target):
            if isinstance(n, ast.Name):
                if k:
                    self.kind[n.id] = k
                else:
                    self.kind.pop(n.id, None)


_NOT_TENSOR_ANNOTATIONS = frozenset({"int", "float", "bool", "str",
                                     "bytes", "dict", "list", "tuple"})


def tensor_params(fi: FuncInfo) -> List[str]:
    """The parameters of ``fi`` that may hold a tensor: all but ``self``,
    ``cls`` and ``ctx``, those annotated with anything but a tensor type,
    and those whose default is a number, string or bool."""
    a = fi.node.args
    pos = list(a.posonlyargs) + list(a.args)
    defaults = dict(zip([p.arg for p in pos[len(pos) - len(a.defaults):]],
                        a.defaults))
    defaults.update({p.arg: d for p, d in zip(a.kwonlyargs, a.kw_defaults)
                     if d is not None})
    out = []
    for p in pos + list(a.kwonlyargs):
        if p.arg in ("self", "cls", "ctx"):
            continue
        if p.annotation is not None and "Tensor" not in ast.unparse(
                p.annotation):
            continue
        d = defaults.get(p.arg)
        if isinstance(d, ast.Constant) and d.value is not None:
            continue
        out.append(p.arg)
    return out


def _is_bool_dtype(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == "bool"


# -- the detector shared with capture-hazard ---------------------------------

def hazards(expr: Optional[ast.AST], t: Taint
            ) -> Iterator[Tuple[ast.AST, str, str]]:
    """(node, kind, description) for each host sync in ``expr``: kind is
    'sync' (a device->host read or a wait), 'shape' (a data-dependent
    shape) or 'upload' (a blocking host->device copy of host data)."""
    if expr is None:
        return
    for node in ast.walk(expr):
        if isinstance(node, ast.Subscript):
            if t.of(node.value) == DEV and t.is_bool(node.slice):
                yield node, "shape", "indexing with a boolean mask"
            continue
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp,
                             ast.DictComp)):
            t._comp_scope(node)   # bind its targets for the nodes inside
            continue
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        name = call_attr_name(func)
        torchish = t.torch_call(node)
        if name == "synchronize":
            yield node, "sync", f"{_describe(func)}()"
        elif torchish and name in ("equal", "allclose") and any(
                t.of(a) == DEV for a in node.args):
            yield node, "sync", f"torch.{name}() on device values"
        elif isinstance(func, ast.Attribute) and not torchish and \
                name in _D2H and t.of(func.value) in (DEV, MAYBE):
            yield node, "sync", f".{name}() on device value " \
                                f"'{_describe(func.value)}'"
        elif isinstance(func, ast.Attribute) and not torchish and \
                name == "to":
            dev, nb = _to_target(node)
            recv = t.of(func.value)
            if dev is not None and not nb and recv in (DEV, MAYBE) and \
                    _is_cpu(dev):
                yield node, "sync", f".to('cpu') of device value " \
                                    f"'{_describe(func.value)}'"
            elif dev is not None and not nb and recv == HOST and \
                    not _is_cpu(dev):
                yield node, "upload", "blocking .to(<device>) of host " \
                                      f"tensor '{_describe(func.value)}'"
        elif isinstance(func, ast.Attribute) and not torchish and \
                name == "cuda" and t.of(func.value) == HOST and \
                not _is_true(_kw(node, "non_blocking")):
            yield node, "upload", "blocking .cuda() of host tensor " \
                                  f"'{_describe(func.value)}'"
        elif torchish and name in ("tensor", "as_tensor"):
            dev = _kw(node, "device")
            data = node.args[0] if node.args else None
            if dev is not None and not _is_cpu(dev) and \
                    t.of(data) != DEV and not isinstance(data, ast.Constant):
                yield node, "upload", f"torch.{name}() of host data onto " \
                                      "the device"
        elif isinstance(func, ast.Name) and func.id in _COERCIONS and \
                node.args and t.of(node.args[0]) == DEV:
            yield node, "sync", f"{func.id}() on device value " \
                                f"'{_describe(node.args[0])}'"
        elif name in _SHAPE_OPS and (
                (torchish and node.args and t.of(node.args[0]) != HOST) or
                (not torchish and isinstance(func, ast.Attribute)
                 and t.of(func.value) in (DEV, MAYBE))):
            yield node, "shape", f"{name}() (its output shape depends on " \
                                 "the data)"
        elif name == "where" and torchish and len(node.args) == 1:
            yield node, "shape", "torch.where(cond) (its output shape " \
                                 "depends on the data)"
        elif name == "repeat_interleave":
            reps = (node.args[1] if torchish and len(node.args) > 1
                    else node.args[0] if node.args else
                    _kw(node, "repeats"))
            if t.of(reps) == DEV:
                yield node, "shape", "repeat_interleave() with tensor " \
                                     "repeats (its output shape depends " \
                                     "on the data)"


def _describe(node: ast.AST) -> str:
    p = _path(node)
    return p if p is not None else ast.unparse(node)


def walk_function(fi: FuncInfo, graph: CallGraph, params: bool = False
                  ) -> Iterator[Tuple[ast.AST, str, str]]:
    """Walk ``fi``'s own statements in order (the reference's linear walk)
    and yield every hazard: (node, kind, description); kind 'test' is a
    tensor used as the test of an if/while/assert. ``params``: taint the
    parameters that may hold a tensor (``tensor_params``)."""
    t = Taint(fi, graph, params=params)
    nested = {id(c.node) for c in fi.children.values()}
    body = fi.node.body if isinstance(fi.node.body, list) else None
    if body is None:                                  # a lambda
        yield from hazards(fi.node.body, t)
        return
    for stmt in _linear_stmts(body):
        if id(stmt) in nested or isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                       ast.ClassDef)):
            continue
        t.comp = {}
        if isinstance(stmt, ast.Assign):
            yield from hazards(stmt.value, t)
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Subscript):
                    yield from hazards(tgt, t)
            t.assign(stmt.targets, stmt.value)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            yield from hazards(stmt.value, t)
            if stmt.value is not None and not isinstance(stmt,
                                                         ast.AugAssign):
                t.assign([stmt.target], stmt.value)
        elif isinstance(stmt, (ast.Expr, ast.Return)):
            yield from hazards(stmt.value, t)
        elif isinstance(stmt, (ast.If, ast.While)):
            yield from hazards(stmt.test, t)
            if t.of(stmt.test) == DEV:
                yield stmt.test, "test", (
                    "implicit bool() of device value "
                    f"'{_describe(stmt.test)}' in "
                    f"{'if' if isinstance(stmt, ast.If) else 'while'}")
        elif isinstance(stmt, ast.Assert):
            yield from hazards(stmt.test, t)
            if t.of(stmt.test) == DEV:
                yield stmt.test, "test", ("implicit bool() of device value "
                                          f"'{_describe(stmt.test)}' in "
                                          "assert")
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            yield from hazards(stmt.iter, t)
            t.loop_target(stmt.target, stmt.iter)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                yield from hazards(item.context_expr, t)


# -- graph-wide facts the taint needs (memoized on the graph) ----------------

def class_tensor_attrs(graph: CallGraph) -> Dict[str, Dict[str, str]]:
    """class key -> {attr: kind} for every ``self.<attr> = <tensor>`` in
    any method of the class (or of a base)."""
    _prepare(graph)
    return graph.cache["class_tensor_attrs"]          # type: ignore


def returns_tensor(graph: CallGraph, fi: FuncInfo) -> bool:
    """Whether ``fi`` may return a tensor on the card."""
    _prepare(graph)
    return fi.key() in graph.cache["tensor_returns"]  # type: ignore


def _prepare(graph: CallGraph) -> None:
    """Compute, once per graph, which functions return tensors (a fixed
    point of the per-function taint: the rounds stop when nothing is
    added) and which class attributes hold them: returns without the
    attributes, then the attributes, then returns again with them."""
    if "tensor_returns" in graph.cache:
        return
    graph.cache["class_tensor_attrs"] = {}
    graph.cache["tensor_returns"] = set()
    _returns_fixed_point(graph)
    graph.cache["class_tensor_attrs"] = _class_attrs(graph)
    _returns_fixed_point(graph)


def _returns_fixed_point(graph: CallGraph) -> None:
    found: Set[str] = graph.cache["tensor_returns"]   # type: ignore
    while True:
        before = len(found)
        for fi in graph.functions:
            if fi.key() not in found and _returns_dev(fi, graph):
                found.add(fi.key())
        if len(found) == before:
            return


def _class_attrs(graph: CallGraph) -> Dict[str, Dict[str, str]]:
    own: Dict[str, Dict[str, str]] = {}
    for fi in graph.functions:
        ci = graph.class_of(fi)
        if ci is None or isinstance(fi.node, ast.Lambda):
            continue
        t = Taint(fi, graph)
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self":
                    k = t.of(node.value)
                    if k:
                        own.setdefault(ci.key(), {})[tgt.attr] = k
    full: Dict[str, Dict[str, str]] = {}
    for cis in graph.classes.values():
        for ci in cis:
            merged: Dict[str, str] = {}
            for c in _mro(graph, ci):
                for a, k in own.get(c.key(), {}).items():
                    merged.setdefault(a, k)
            if merged:
                full[ci.key()] = merged
    return full


def _mro(graph: CallGraph, ci: ClassInfo) -> List[ClassInfo]:
    out, work = [], [ci]
    while work:
        c = work.pop(0)
        if c not in out:
            out.append(c)
            work.extend(graph.bases_of(c))
    return out


def _returns_dev(fi: FuncInfo, graph: CallGraph) -> bool:
    t = Taint(fi, graph)
    if isinstance(fi.node, ast.Lambda):
        return t.of(fi.node.body) == DEV
    nested = {id(c.node) for c in fi.children.values()}
    for stmt in _linear_stmts(fi.node.body):
        if id(stmt) in nested or isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        if isinstance(stmt, ast.Assign):
            t.assign(stmt.targets, stmt.value)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            t.assign([stmt.target], stmt.value)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            t.loop_target(stmt.target, stmt.iter)
        elif isinstance(stmt, ast.Return) and t.of(stmt.value) == DEV:
            return True
    return False


def returned_callable(graph: CallGraph, fi: FuncInfo) -> Optional[FuncInfo]:
    """The nested function ``fi`` builds and returns, if any (a maker such
    as ``make_train_step``)."""
    if isinstance(fi.node, ast.Lambda):
        return None
    for node in ast.walk(fi.node):
        if isinstance(node, ast.Return) and \
                isinstance(node.value, ast.Name) and \
                node.value.id in fi.children:
            return fi.children[node.value.id]
    return None


# -- fences --------------------------------------------------------------------

def fence_of(m: ModuleSource, fi: Optional[FuncInfo]
             ) -> Optional[Tuple[str, str, str, str]]:
    """The declared fence that covers ``fi`` (or an enclosing function)."""
    f = fi
    while f is not None:
        for fence in DECLARED_FENCES:
            suffix, qual = fence[0], fence[1]
            if m.relpath.endswith(suffix) and (
                    f.qualname == qual or f.qualname.startswith(qual + ".")):
                return fence
        f = f.parent
    return None


def in_scope(m: ModuleSource) -> bool:
    p = m.relpath
    return p.startswith("src/repro_torch") and \
        not p.startswith("src/repro_torch/analysis") and \
        not p.startswith("src/repro_torch/examples")


def enclosing_function(graph: CallGraph, relpath: str,
                       line: int) -> Optional[FuncInfo]:
    """The innermost scanned function of ``relpath`` whose body spans
    ``line`` (for attributing a sync the card reports to its source)."""
    best = None
    for fi in graph.functions:
        if fi.module.relpath != relpath:
            continue
        end = getattr(fi.node, "end_lineno", fi.lineno) or fi.lineno
        if fi.lineno <= line <= end and (
                best is None or fi.lineno >= best.lineno):
            best = fi
    return best


def site_verdict(graph: CallGraph, relpath: str,
                 line: int) -> Optional[str]:
    """'fence <qualname>: <reason>' when a declared fence covers the
    function whose body holds ``relpath:line``, else None (how
    ``chip_smoke.py`` holds a sync that the card reports)."""
    fi = enclosing_function(graph, relpath, line)
    fence = fence_of(fi.module, fi) if fi is not None else None
    return None if fence is None else f"fence {fence[1]}: {fence[3]}"


@rule("host-sync",
      "host synchronization (.item/.tolist/.cpu/.numpy, .synchronize, "
      "blocking copies, float/int/bool or a test of a device tensor, "
      "data-dependent shapes) outside a declared fence point")
def check_host_sync(modules: Sequence[ModuleSource],
                    graph: CallGraph) -> List[Finding]:
    findings: List[Finding] = []
    for fi in graph.functions:
        m = fi.module
        if not in_scope(m) or isinstance(fi.node, ast.Lambda):
            continue
        if graph.is_reachable(fi) or fence_of(m, fi) is not None:
            continue
        for node, kind, what in walk_function(fi, graph):
            findings.append(Finding(
                rule="host-sync", path=m.relpath, line=node.lineno,
                col=node.col_offset,
                message=f"{what} outside a declared fence point",
                hint="keep the value on the device, or add this location "
                     "to DECLARED_FENCES in repro_torch/analysis/rules/"
                     "host_sync.py with a reason",
                qualname=fi.qualname, code=m.line_text(node.lineno)))
    return findings
