"""The device-boundary graph: what a captured step holds, where the kernels
launch, and which functions carry a gradient through a kernel.

The port of ``repro.analysis.callgraph``. The reference's boundary is the
jit trace (``jax.jit``/``pallas_call``/``shard_map`` sites); the port runs
eagerly, so its boundary is declared instead, as policy in code
(``STEP_ENTRIES``, beside ``rules.host_sync.DECLARED_FENCES``). Built from
stdlib ``ast`` alone, across every scanned module:

* **step entries** — the functions that ROADMAP §1 item 4 will capture as
  CUDA graphs, each with the reference jit it stands for;
* **the step-reachable set** — functions reachable from an entry through
  resolved calls: locals, module scope and ``from``-imports exactly;
  ``module.func`` through an imported module; ``self.method`` through the
  class, its bases and the subclasses that override it; ``super().m``
  through the bases; ``Function.apply`` of a ``torch.autograd.Function``
  to its ``forward``/``backward``; ``obj.attr(...)`` to ``C.forward``
  where some method binds ``self.attr = C(...)`` (an ``nn.Module`` call);
  any other ``obj.method(...)`` only when one scanned method has that
  name. A function passed as a call argument (``checkpoint(self._block,
  ...)``) counts as called, and functions defined inside a reachable one
  are reachable;
* **kernel launch sites** — functions that call a handle returned by
  ``kernels/build.py::load``;
* **autograd Functions** — classes deriving ``torch.autograd.Function``.

Resolution is name-based and heuristic, as the reference's is: precise
enough to drive the port's rules, cheap enough to run on every push, and
emitted as a JSON artifact (``--capture-map``) so item 4 can read the
capture boundary without deriving it again.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.source import ModuleSource

# (path suffix, qualname, reason) — the step entries: what ROADMAP §1
# item 4 captures as CUDA graphs, each named after the reference jit it
# stands for. Everything reachable from one runs inside the capture.
STEP_ENTRIES: Tuple[Tuple[str, str, str], ...] = (
    ("models/model.py", "Model.serve_step",
     "one pooled decode step over the fixed pool: the reference jits it "
     "once (JaxModelServer._get_step_fn)"),
    ("models/model.py", "Model.prefill",
     "a right-padded prompt, once per bucket (the reference's "
     "_get_prefill_fn)"),
    ("models/model.py", "Model.forward",
     "the full-sequence forward of the EAMC warm-up and of training, "
     "jitted in the reference"),
    ("models/model.py", "Model.loss",
     "the training loss, inside the reference's jitted value_and_grad"),
    ("models/model.py", "Model._embed_step",
     "the streaming walk's embedding piece (the reference's slot_embed "
     "jit)"),
    ("models/model.py", "Model._decode_block_pre",
     "the streaming walk's per-layer pre piece, before the routed-id sync "
     "(the reference's slot_decode_pre jit)"),
    ("serving/slot_runtime.py", "SlotStreamRuntime._route",
     "the router top-k that ends the pre piece (inside the reference's "
     "slot_decode_pre jit)"),
    ("models/model.py", "Model._decode_block_post",
     "the per-layer post piece after the routed-id sync (the reference's "
     "slot_decode_post jit)"),
    ("models/model.py", "Model._apply_block_pre",
     "the streaming prefill's per-layer pre piece (the reference's "
     "slot_prefill_pre jit)"),
    ("models/model.py", "Model._apply_block_post",
     "the streaming prefill's per-layer post piece (the reference's "
     "slot_prefill_post jit)"),
    ("train/loop.py", "make_train_step.<locals>.train_step",
     "the training step: loss, backward and AdamW in place; the reference "
     "jits it (make_train_step). It donates nothing: opt_state is updated "
     "in place"),
)

# attribute-call names never resolved by the unique-method fallback
# (container, tensor and stdlib methods that would otherwise alias user
# code)
ATTR_RESOLVE_BLOCKLIST = frozenset({
    "get", "items", "keys", "values", "append", "extend", "add", "pop",
    "update", "copy", "clear", "remove", "insert", "count", "index",
    "join", "split", "strip", "startswith", "endswith", "format", "sort",
    "read", "write", "close", "sum", "mean", "max", "min", "all", "any",
    "reshape", "astype", "item", "flatten", "tolist", "setdefault",
    "squeeze", "transpose", "dot", "put", "fill", "exists", "resolve",
    "to", "float", "half", "long", "int", "bool", "view", "expand",
    "contiguous", "clone", "detach", "cpu", "cuda", "numpy", "copy_",
    "zero_", "fill_", "record", "wait", "synchronize", "apply", "run",
    "step", "load", "save", "forward", "backward", "sample", "reset",
    "stats", "size", "dim", "numel", "unsqueeze", "permute", "split",
    "chunk", "abs", "exp", "log", "sqrt", "mul", "add_", "mul_", "div",
})

TORCH_ROOTS = ("torch",)
NUMPY_ROOTS = ("numpy",)


def call_attr_name(func: ast.AST) -> str:
    """Last path component of a call target: torch.cuda.synchronize ->
    'synchronize'."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def base_name(node: ast.AST) -> str:
    """Leftmost Name of an attribute/subscript chain ('' if none)."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else ""


def dotted_name(relpath: str) -> str:
    """Module name of a scanned file: src/repro_torch/kernels/ops.py ->
    repro_torch.kernels.ops."""
    p = relpath[:-3] if relpath.endswith(".py") else relpath
    if p.endswith("/__init__"):
        p = p[:-len("/__init__")]
    if p.startswith("src/"):
        p = p[4:]
    return p.strip("/").replace("/", ".")


class FuncInfo:
    """One function/lambda definition with its lexical context."""

    def __init__(self, node, module: ModuleSource, qualname: str,
                 parent: Optional["FuncInfo"], class_name: str):
        self.node = node
        self.module = module
        self.qualname = qualname
        self.name = getattr(node, "name", "<lambda>")
        self.parent = parent
        self.class_name = class_name          # nearest enclosing class
        self.children: Dict[str, "FuncInfo"] = {}
        self.params = self._param_names(node)
        self.lineno = node.lineno

    @staticmethod
    def _param_names(node) -> Tuple[str, ...]:
        a = node.args
        names = [p.arg for p in
                 list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)]
        if a.vararg:
            names.append(a.vararg.arg)
        if a.kwarg:
            names.append(a.kwarg.arg)
        return tuple(names)

    @property
    def is_method(self) -> bool:
        return bool(self.class_name) and (
            self.parent is None or self.parent.class_name != self.class_name)

    def key(self) -> str:
        return f"{self.module.relpath}::{self.qualname}"

    def method_owner(self) -> Optional["FuncInfo"]:
        """The method this function is (or is nested in), if any."""
        f: Optional[FuncInfo] = self
        while f is not None:
            if f.is_method:
                return f
            f = f.parent
        return None


class ClassInfo:
    def __init__(self, node: ast.ClassDef, module: ModuleSource):
        self.node = node
        self.module = module
        self.name = node.name
        self.bases = [b for b in node.bases]
        self.methods: Dict[str, FuncInfo] = {}

    def key(self) -> str:
        return f"{self.module.relpath}::{self.name}"


class LaunchSite:
    """One call of a ``build.load`` handle: a kernel launch."""

    def __init__(self, fi: FuncInfo, kernel: str, call: ast.Call,
                 result: Optional[str]):
        self.fi = fi
        self.kernel = kernel
        self.call = call
        self.result = result          # the name the error code is bound to

    def to_json(self) -> dict:
        return {"path": self.fi.module.relpath, "qualname": self.fi.qualname,
                "line": self.call.lineno, "kernel": self.kernel,
                "error_code": self.result}


class _Collector(ast.NodeVisitor):
    """Collect every function/lambda/class in a module with lexical
    scoping (the reference's collector, classes recorded too)."""

    def __init__(self, module: ModuleSource, graph: "CallGraph"):
        self.module = module
        self.graph = graph
        self.scope: List[str] = []
        self.func_stack: List[FuncInfo] = []
        self.class_stack: List[ClassInfo] = []

    def _add(self, node) -> FuncInfo:
        name = getattr(node, "name", "<lambda>")
        qual = ".".join(self.scope + [name]) if self.scope else name
        parent = self.func_stack[-1] if self.func_stack else None
        cls = self.class_stack[-1].name if self.class_stack else ""
        fi = FuncInfo(node, self.module, qual, parent, cls)
        self.graph.functions.append(fi)
        self.graph.by_node[id(node)] = fi
        if parent is not None:
            parent.children.setdefault(fi.name, fi)
        elif not cls:
            self.graph.module_scope.setdefault(
                self.module.relpath, {}).setdefault(fi.name, fi)
        if fi.is_method:
            self.graph.methods.setdefault(fi.name, []).append(fi)
            self.class_stack[-1].methods.setdefault(fi.name, fi)
        return fi

    def _visit_func(self, node):
        fi = self._add(node)
        self.scope.append(fi.name)
        if not isinstance(node, ast.Lambda):
            self.scope.append("<locals>")
        self.func_stack.append(fi)
        self.generic_visit(node)
        self.func_stack.pop()
        if not isinstance(node, ast.Lambda):
            self.scope.pop()
        self.scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func
    visit_Lambda = _visit_func

    def visit_ClassDef(self, node):
        ci = ClassInfo(node, self.module)
        self.graph.classes.setdefault(node.name, []).append(ci)
        self.graph.class_by_node[id(node)] = ci
        if not self.func_stack and not self.class_stack:
            self.graph.module_classes.setdefault(
                self.module.relpath, {})[node.name] = ci
        self.scope.append(node.name)
        self.class_stack.append(ci)
        self.generic_visit(node)
        self.class_stack.pop()
        self.scope.pop()

    def visit_Assign(self, node):
        # name = lambda ...: bind the lambda under the name for resolution
        self.generic_visit(node)
        if isinstance(node.value, ast.Lambda) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            fi = self.graph.by_node.get(id(node.value))
            if fi is not None:
                tgt = node.targets[0].id
                if self.func_stack:
                    self.func_stack[-1].children.setdefault(tgt, fi)
                else:
                    self.graph.module_scope.setdefault(
                        self.module.relpath, {}).setdefault(tgt, fi)


class CallGraph:
    """Tree-wide device-boundary graph over a list of ModuleSources."""

    def __init__(self, modules: Sequence[ModuleSource]):
        self.modules = [m for m in modules if m.tree is not None]
        self.functions: List[FuncInfo] = []
        self.by_node: Dict[int, FuncInfo] = {}
        self.module_scope: Dict[str, Dict[str, FuncInfo]] = {}
        self.methods: Dict[str, List[FuncInfo]] = {}
        self.classes: Dict[str, List[ClassInfo]] = {}
        self.class_by_node: Dict[int, ClassInfo] = {}
        self.module_classes: Dict[str, Dict[str, ClassInfo]] = {}
        self.by_dotted: Dict[str, ModuleSource] = {}
        # per-module import info
        self.torch_aliases: Dict[str, Set[str]] = {}
        self.np_aliases: Dict[str, Set[str]] = {}
        self.mod_aliases: Dict[str, Dict[str, str]] = {}   # alias -> module
        self.from_names: Dict[str, Dict[str, Tuple[str, str]]] = {}
        # attr -> classes bound to self.<attr> = C(...) (nn.Module calls)
        self.module_attrs: Dict[str, List[ClassInfo]] = {}
        self.entries: List[Tuple[str, str, str, Optional[FuncInfo]]] = []
        self.reachable: Set[str] = set()                   # FuncInfo.key()
        self.reach_via: Dict[str, List[int]] = {}          # key -> entries
        self.launch_sites: List[LaunchSite] = []
        self.autograd_functions: List[ClassInfo] = []
        self.cache: Dict[str, object] = {}                 # rules' memo
        self._bases: Dict[str, List[ClassInfo]] = {}
        self._subs: Dict[str, List[ClassInfo]] = {}
        for m in self.modules:
            self.by_dotted[dotted_name(m.relpath)] = m
            _Collector(m, self).visit(m.tree)
        for m in self.modules:
            self._collect_imports(m)
        for m in self.modules:
            self._collect_module_attrs(m)
        self.autograd_functions = [
            ci for cis in self.classes.values() for ci in cis
            if any(call_attr_name(b) == "Function" for b in ci.bases)]
        self._resolve_entries()
        self._mark_reachable()
        for fi in self.functions:
            self._collect_launch_sites(fi)

    # -- imports -------------------------------------------------------------
    def _collect_imports(self, m: ModuleSource) -> None:
        ta, npa, mods, froms = set(), set(), {}, {}
        for node in ast.walk(m.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    root = a.name.split(".")[0]
                    alias = a.asname or root
                    if root in TORCH_ROOTS:
                        ta.add(alias)
                    elif root in NUMPY_ROOTS:
                        npa.add(alias)
                    else:
                        mods[alias] = a.name if a.asname else root
            elif isinstance(node, ast.ImportFrom) and node.module:
                root = node.module.split(".")[0]
                for a in node.names:
                    alias = a.asname or a.name
                    if root in TORCH_ROOTS:
                        ta.add(alias)
                    elif root in NUMPY_ROOTS:
                        npa.add(alias)
                    elif self.find_module(f"{node.module}.{a.name}"):
                        mods[alias] = f"{node.module}.{a.name}"
                    else:
                        froms[alias] = (node.module, a.name)
        self.torch_aliases[m.relpath] = ta
        self.np_aliases[m.relpath] = npa
        self.mod_aliases[m.relpath] = mods
        self.from_names[m.relpath] = froms

    def find_module(self, dotted: str) -> Optional[ModuleSource]:
        """The scanned module named ``dotted`` (or whose name ends with
        it, for trees scanned without their package root)."""
        if dotted in self.by_dotted:
            return self.by_dotted[dotted]
        for name, m in self.by_dotted.items():
            if dotted.endswith("." + name) or name.endswith("." + dotted):
                return m
        return None

    def is_torchish(self, m: ModuleSource, node: ast.AST) -> bool:
        """Is this a name in a torch module (``torch.cuda.synchronize``,
        ``F.one_hot``), not a method of a value?"""
        while isinstance(node, ast.Attribute):
            node = node.value
        return isinstance(node, ast.Name) and \
            node.id in self.torch_aliases.get(m.relpath, ())

    def is_numpyish(self, m: ModuleSource, node: ast.AST) -> bool:
        return base_name(node) in self.np_aliases.get(m.relpath, ())

    def module_of_alias(self, m: ModuleSource,
                        name: str) -> Optional[ModuleSource]:
        dotted = self.mod_aliases.get(m.relpath, {}).get(name)
        return self.find_module(dotted) if dotted else None

    def is_module_alias(self, m: ModuleSource, node: ast.AST,
                        suffix: str) -> bool:
        """Is ``node`` a Name bound to the scanned module whose name ends
        with ``suffix`` (e.g. 'kernels.build')?"""
        if not isinstance(node, ast.Name):
            return False
        dotted = self.mod_aliases.get(m.relpath, {}).get(node.id, "")
        return dotted == suffix or dotted.endswith("." + suffix)

    def from_import_of(self, m: ModuleSource, name: str) -> Tuple[str, str]:
        return self.from_names.get(m.relpath, {}).get(name, ("", ""))

    # -- classes -------------------------------------------------------------
    def resolve_class(self, m: ModuleSource,
                      node: ast.AST) -> Optional[ClassInfo]:
        """A class named by ``node`` in module ``m``: defined there,
        ``from``-imported, or ``module.Class``."""
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name):
            mod = self.module_of_alias(m, node.value.id)
            if mod is not None:
                return self.module_classes.get(mod.relpath, {}).get(node.attr)
            return None
        if not isinstance(node, ast.Name):
            return None
        own = self.module_classes.get(m.relpath, {}).get(node.id)
        if own is not None:
            return own
        src, name = self.from_import_of(m, node.id)
        if src:
            mod = self.find_module(src)
            if mod is not None:
                return self.module_classes.get(mod.relpath, {}).get(name)
        return None

    def bases_of(self, ci: ClassInfo) -> List[ClassInfo]:
        if ci.key() not in self._bases:
            out = []
            for b in ci.bases:
                bc = self.resolve_class(ci.module, b)
                if bc is not None and bc is not ci:
                    out.append(bc)
            self._bases[ci.key()] = out
        return self._bases[ci.key()]

    def lookup_method(self, ci: ClassInfo, name: str,
                      seen: Optional[Set[str]] = None
                      ) -> Optional[FuncInfo]:
        seen = seen if seen is not None else set()
        if ci.key() in seen:
            return None
        seen.add(ci.key())
        if name in ci.methods:
            return ci.methods[name]
        for b in self.bases_of(ci):
            got = self.lookup_method(b, name, seen)
            if got is not None:
                return got
        return None

    def subclasses_of(self, ci: ClassInfo) -> List[ClassInfo]:
        if ci.key() in self._subs:
            return self._subs[ci.key()]
        out: List[ClassInfo] = []
        work = [ci]
        while work:
            cur = work.pop()
            for cis in self.classes.values():
                for c in cis:
                    if c not in out and c is not ci and \
                            any(b is cur for b in self.bases_of(c)):
                        out.append(c)
                        work.append(c)
        self._subs[ci.key()] = out
        return out

    def class_of(self, fi: FuncInfo) -> Optional[ClassInfo]:
        owner = fi.method_owner()
        if owner is None:
            return None
        for ci in self.classes.get(owner.class_name, ()):
            if ci.module is owner.module and \
                    ci.methods.get(owner.name) is owner:
                return ci
        return None

    def _collect_module_attrs(self, m: ModuleSource) -> None:
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.Assign) or \
                    not isinstance(node.value, ast.Call):
                continue
            ci = self.resolve_class(m, node.value.func)
            if ci is None:
                continue
            for t in node.targets:
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id == "self":
                    lst = self.module_attrs.setdefault(t.attr, [])
                    if ci not in lst:
                        lst.append(ci)

    # -- call resolution -----------------------------------------------------
    def resolve_name(self, m: ModuleSource, name: str,
                     scope: Optional[FuncInfo]) -> Optional[FuncInfo]:
        f = scope
        while f is not None:
            if name in f.children:
                return f.children[name]
            f = f.parent
        mod = self.module_scope.get(m.relpath, {})
        if name in mod:
            return mod[name]
        src, orig = self.from_import_of(m, name)
        if src:
            target = self.find_module(src)
            if target is not None:
                return self.module_scope.get(target.relpath, {}).get(orig)
        return None

    def resolve_target(self, m: ModuleSource, func: ast.AST,
                       scope: Optional[FuncInfo],
                       any_method: bool = False) -> List[FuncInfo]:
        """The functions a call of ``func`` may run (empty when
        unresolved). ``any_method``: an ``obj.method`` that no rule below
        resolves gives every scanned method of that name (the taint's
        over-approximation) instead of only a unique one."""
        if isinstance(func, ast.Name):
            fi = self.resolve_name(m, func.id, scope)
            if fi is not None:
                return [fi]
            ci = self.resolve_class(m, func)
            if ci is not None:
                init = self.lookup_method(ci, "__init__")
                return [init] if init is not None else []
            return []
        if not isinstance(func, ast.Attribute):
            return []
        if self.is_torchish(m, func) or self.is_numpyish(m, func):
            return []
        recv, name = func.value, func.attr
        # module.func / module.Class
        if isinstance(recv, ast.Name):
            mod = self.module_of_alias(m, recv.id)
            if mod is not None:
                fi = self.module_scope.get(mod.relpath, {}).get(name)
                if fi is not None:
                    return [fi]
                ci = self.module_classes.get(mod.relpath, {}).get(name)
                init = self.lookup_method(ci, "__init__") if ci else None
                return [init] if init is not None else []
        # Class.method / Function.apply
        ci = self.resolve_class(m, recv)
        if ci is not None:
            if name == "apply" and ci in self.autograd_functions:
                return [f for f in (ci.methods.get("forward"),
                                    ci.methods.get("backward")) if f]
            fi = self.lookup_method(ci, name)
            return [fi] if fi is not None else []
        # self.method (and the overrides of subclasses)
        own = self.class_of(scope) if scope is not None else None
        if isinstance(recv, ast.Name) and recv.id == "self" and \
                own is not None:
            out = []
            fi = self.lookup_method(own, name)
            if fi is not None:
                out.append(fi)
            for sub in self.subclasses_of(own):
                over = sub.methods.get(name)
                if over is not None and over not in out:
                    out.append(over)
            if out:
                return out
        # super().method
        if isinstance(recv, ast.Call) and call_attr_name(recv.func) == \
                "super" and own is not None:
            for b in self.bases_of(own):
                fi = self.lookup_method(b, name)
                if fi is not None:
                    return [fi]
            return []
        # obj.attr(...) where self.attr = C(...): an nn.Module call
        if name in self.module_attrs:
            out = []
            for c in self.module_attrs[name]:
                fwd = self.lookup_method(c, "forward") or \
                    self.lookup_method(c, "__call__")
                if fwd is not None:
                    out.append(fwd)
            return out
        if name in ATTR_RESOLVE_BLOCKLIST:
            return []
        cands = self.methods.get(name, ())
        if len(cands) == 1 or any_method:
            return list(cands)
        return []

    def callees(self, fi: FuncInfo) -> List[FuncInfo]:
        """What ``fi``'s own body calls (or passes on as a callable),
        nested definitions excluded."""
        out: List[FuncInfo] = []
        m = fi.module
        nested = {id(c.node) for c in fi.children.values()}

        def add(fis):
            for f in fis:
                if f not in out:
                    out.append(f)

        def walk(node):
            for child in ast.iter_child_nodes(node):
                if id(child) in nested:
                    continue
                if isinstance(child, ast.Call):
                    add(self.resolve_target(m, child.func, fi))
                    for a in list(child.args) + [k.value for k in
                                                 child.keywords]:
                        if isinstance(a, (ast.Name, ast.Attribute)):
                            add(self._callable_ref(m, a, fi))
                walk(child)

        body = fi.node.body if isinstance(fi.node.body, list) \
            else [fi.node.body]
        for stmt in body:
            if isinstance(stmt, ast.Call):
                add(self.resolve_target(m, stmt.func, fi))
            walk(stmt)
        return out

    def _callable_ref(self, m: ModuleSource, node: ast.AST,
                      scope: FuncInfo) -> List[FuncInfo]:
        """A function passed by reference (``self._block``, ``run_fn``)."""
        if isinstance(node, ast.Name):
            fi = self.resolve_name(m, node.id, scope)
            return [fi] if fi is not None else []
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            own = self.class_of(scope)
            if own is not None:
                fi = self.lookup_method(own, node.attr)
                return [fi] if fi is not None else []
        return []

    # -- step entries and reachability ---------------------------------------
    def find_function(self, path_suffix: str,
                      qualname: str) -> Optional[FuncInfo]:
        for fi in self.functions:
            if fi.module.relpath.endswith(path_suffix) and \
                    fi.qualname == qualname:
                return fi
        return None

    def _resolve_entries(self) -> None:
        for suffix, qual, reason in STEP_ENTRIES:
            self.entries.append(
                (suffix, qual, reason, self.find_function(suffix, qual)))

    def _mark_reachable(self) -> None:
        work: List[Tuple[FuncInfo, int]] = [
            (fi, i) for i, (_, _, _, fi) in enumerate(self.entries)
            if fi is not None]
        seen: Set[Tuple[str, int]] = set()
        while work:
            fi, origin = work.pop()
            k = fi.key()
            if (k, origin) in seen:
                continue
            seen.add((k, origin))
            self.reachable.add(k)
            self.reach_via.setdefault(k, []).append(origin)
            for child in fi.children.values():
                work.append((child, origin))
            for callee in self.callees(fi):
                work.append((callee, origin))

    def is_reachable(self, fi: FuncInfo) -> bool:
        return fi.key() in self.reachable

    def entries_reaching(self, fi: FuncInfo) -> List[str]:
        return [self.entries[i][1] for i in self.reach_via.get(fi.key(), ())]

    # -- kernel launch sites -------------------------------------------------
    def _is_load_call(self, m: ModuleSource, node: ast.AST) -> bool:
        if not isinstance(node, ast.Call) or \
                call_attr_name(node.func) != "load":
            return False
        func = node.func
        if isinstance(func, ast.Attribute):
            return self.is_module_alias(m, func.value, "kernels.build")
        src, name = self.from_import_of(m, "load")
        return name == "load" and src.endswith("kernels.build")

    def _collect_launch_sites(self, fi: FuncInfo) -> None:
        m = fi.module
        handles: Dict[str, str] = {}
        nested = {id(c.node) for c in fi.children.values()}
        body = fi.node.body if isinstance(fi.node.body, list) \
            else [fi.node.body]
        nodes = []

        def walk(node):
            for child in ast.iter_child_nodes(node):
                if id(child) in nested:
                    continue
                nodes.append((node, child))
                walk(child)

        for stmt in body:
            nodes.append((None, stmt))
            walk(stmt)
        for _, node in nodes:
            if isinstance(node, ast.Assign) and \
                    self._is_load_call(m, node.value):
                arg = node.value.args[0] if node.value.args else None
                kernel = arg.value if isinstance(arg, ast.Constant) else "?"
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        handles[t.id] = str(kernel)
        if not handles:
            return
        for parent, node in nodes:
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id in handles:
                result = None
                if isinstance(parent, ast.Assign) and \
                        parent.value is node and \
                        len(parent.targets) == 1 and \
                        isinstance(parent.targets[0], ast.Name):
                    result = parent.targets[0].id
                self.launch_sites.append(
                    LaunchSite(fi, handles[node.func.id], node, result))

    # -- artifact ------------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "step_entries": [
                {"path": fi.module.relpath if fi else None,
                 "path_suffix": suffix, "qualname": qual,
                 "line": fi.lineno if fi else None, "reason": reason}
                for suffix, qual, reason, fi in self.entries],
            "step_reachable": {
                k: {"from": sorted({self.entries[i][1]
                                    for i in self.reach_via.get(k, ())})}
                for k in sorted(self.reachable)},
            "kernel_launch_sites": [s.to_json() for s in self.launch_sites],
            "autograd_functions": {
                ci.key(): sorted(ci.methods) for ci in
                sorted(self.autograd_functions, key=ClassInfo.key)},
        }
