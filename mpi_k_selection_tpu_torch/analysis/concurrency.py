"""Concurrency analysis (KSL015-KSL017): thread-reachability call graph,
per-class lock models, lock-discipline lint, and the static lock-order
graph.

The codebase runs real concurrent machinery — ``ksel-pipeline-*``
producer threads, the serve dispatch thread plus ``ThreadingHTTPServer``
request threads, monitor metric servers, and the process-wide
``FaultInjector`` — and the reference's only concurrency model was
``mpirun``'s process isolation. A shared-memory server needs the
discipline the MPI runtime gave for free, as a checkable contract:

- **KSL015** — guard consistency. A class (or module-global group) that
  owns a lock declares cross-thread intent; an attribute written under
  ``with self._lock:`` in one method establishes ``_lock`` as its
  *inferred guard*, and any other write / mutating call / iteration-read
  of that attribute outside the guard is a finding. Intent is
  declarable up front with ``# ksel: guarded-by[<lock-attr>]`` on the
  attribute's init line (the annotation then drives enforcement even
  before any locked write exists, and a stale annotation — naming a
  lock the class does not own — is itself a finding).
- **KSL016** — static lock-order graph. Every ``with <lock>:`` nested
  inside another lock's body (directly, or via a module-local call made
  while holding) contributes an acquired-while-holding edge; a cycle in
  the package-wide union graph is a potential deadlock, reported with
  both lock sites. The same graph is exported by
  ``python -m mpi_k_selection_tpu_torch.analysis --concurrency-report`` and cross-checked at runtime by
  the lock-order sanitizer (analysis/lockorder.py).
- **KSL017** — blocking call while holding a lock: ``Queue.get()`` /
  ``Event.wait()`` / ``Thread.join()`` without a timeout, socket
  ``recv``/``accept``, any ``sleep``, or a ``maybe_fault`` stall site
  lexically inside a lock-held region. A blocked lock holder stalls
  every thread behind that lock — and a ``maybe_fault`` stall under a
  lock turns an injected chaos delay into a whole-process convoy.

Scope and honesty bounds (mirroring the KSL001 family): all three rules
scan library code under ``mpi_k_selection_tpu_torch/`` only (tests poke
internals freely), analysis is module-local and lexical — a lock
released through an alias, or an attribute mutated through a local
variable bound to it, is out of scope (the runtime sanitizer is the
complementary dynamic check). Methods named ``*_locked`` follow the
repo convention "caller holds the lock": their accesses count as
guarded by the class's sole lock, and blocking calls inside them are
still flagged. ``queue.Queue`` / ``collections.deque`` /
``threading.Event`` attributes are self-synchronizing and are exempt
from guard inference and violation checks.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

from mpi_k_selection_tpu_torch.analysis.ast_rules import (
    _function_defs,
    _is_test_file,
    dotted_name,
)
from mpi_k_selection_tpu_torch.analysis.core import (
    Rule,
    SourceModule,
    iter_python_files,
    load_module,
    register,
)

# ---------------------------------------------------------------------------
# shared vocabulary

_GUARDED_BY_RE = re.compile(
    r"#\s*ksel(?:-torch)?:\s*guarded-by\[(?P<lock>[A-Za-z_][A-Za-z0-9_]*)\]"
)

#: Factory calls whose result is a lock object. ``threading.Condition``
#: lives here (not in the self-sync set): a Condition IS its lock —
#: ``with self._cond:`` guards state exactly like a Lock, ``guarded-by``
#: annotations may name it, and it participates in the lock-order graph
#: (the ingest pool's reorder sequencer is ordered against every other
#: package lock through it).
_LOCK_FACTORIES = {
    "threading.Lock", "threading.RLock", "Lock", "RLock",
    "threading.Condition", "Condition",
    "multiprocessing.Lock", "multiprocessing.RLock",
}

#: Factory calls whose result synchronizes itself — exempt from guard
#: inference AND from violation checks (their methods are atomic).
_SELF_SYNC_FACTORIES = {
    "queue.Queue", "Queue", "queue.SimpleQueue", "SimpleQueue",
    "queue.LifoQueue", "queue.PriorityQueue",
    "collections.deque", "deque",
    "threading.Event", "Event",
    "threading.Semaphore", "Semaphore",
    "threading.BoundedSemaphore", "threading.Barrier", "Barrier",
}

#: Attribute-name heuristic: ``with self._lock:`` identifies a lock even
#: when it was assigned from a parameter (obs/metrics.py hands every
#: metric the registry's lock).
_LOCKY_NAME = re.compile(r"lock", re.IGNORECASE)

#: Mutating container/collection methods (a call on a guarded attribute).
_MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "popleft", "popitem",
    "clear", "add", "discard", "update", "setdefault", "sort", "reverse",
    "appendleft", "move_to_end",
}

#: Reads that traverse the whole structure — torn mid-write they raise
#: (dict changed size during iteration) or return an inconsistent
#: snapshot; bare scalar reads stay out of scope (GIL-atomic).
_ITER_METHODS = {"items", "values", "keys"}

#: Methods exempt from guard-violation checks: the object is not shared
#: yet (or is being torn down single-threaded).
_EXEMPT_METHODS = {"__init__", "__new__", "__post_init__", "__del__"}

#: Blocking calls flagged under a held lock only when UNBOUNDED (no
#: positional timeout argument and no timeout=/block= keyword).
_BLOCKING_IF_UNBOUNDED = {"get", "join", "wait"}

#: Blocking calls flagged under a held lock regardless of arguments.
_BLOCKING_ALWAYS = {"recv", "accept", "sleep", "select"}

_THREAD_FACTORIES = {
    "threading.Thread", "Thread", "threading.Timer", "Timer",
}

_HANDLER_BASES = ("BaseHTTPRequestHandler",)
_SERVER_BASES = ("ThreadingHTTPServer", "ThreadingMixIn", "socketserver.ThreadingMixIn")


def _in_package(mod: SourceModule) -> bool:
    p = pathlib.Path(mod.path).resolve().as_posix()
    return "/mpi_k_selection_tpu_torch/" in p and not _is_test_file(mod)


def _pkg_relpath(mod: SourceModule) -> str:
    """Package-relative path (``mpi_k_selection_tpu_torch/...``) independent of
    the scan's cwd/root — the SAME normalization the runtime sanitizer's
    ``_creation_label`` applies, so static node sites and runtime lock
    labels join on identical strings no matter where the lint ran."""
    p = pathlib.Path(mod.path).resolve().as_posix()
    idx = p.rfind("mpi_k_selection_tpu_torch")
    return p[idx:] if idx >= 0 else mod.relpath


def _self_attr(node: ast.AST) -> str | None:
    """``X`` for a plain ``self.X`` attribute node, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _receiver_self_attr(node: ast.AST) -> str | None:
    """The underlying ``self.X`` of a receiver chain: ``self.X``,
    ``self.X[...]`` — the shapes a guarded-container mutation takes."""
    if isinstance(node, ast.Subscript):
        node = node.value
    return _self_attr(node)


def _own_scope_nodes(fn: ast.AST):
    """The nodes of ``fn``'s own lexical scope — nested defs/lambdas run
    later on their own terms and are skipped (the KSL014 discipline)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# per-class / per-module lock models


@dataclasses.dataclass
class Access:
    attr: str
    line: int
    kind: str  # "write" | "mutate" | "iter-read"
    held: tuple  # lock-attr names held lexically at the access
    method: str


@dataclasses.dataclass
class ClassModel:
    name: str
    line: int
    lock_attrs: dict  # lock attr -> definition line
    self_sync_attrs: set  # queue/deque/event attrs: exempt
    annotations: dict  # data attr -> (lock attr, annotation line)
    accesses: list  # list[Access] (self.* only)
    guards: dict = dataclasses.field(default_factory=dict)  # attr -> lock

    def sole_lock(self) -> str | None:
        return next(iter(self.lock_attrs)) if len(self.lock_attrs) == 1 else None


@dataclasses.dataclass
class LockNode:
    key: str  # stable graph identity
    name: str  # human form ("QueryBatcher._submit_lock")
    site: str  # "relpath:lineno" of the lock's definition (or first use)


@dataclasses.dataclass
class LockEdge:
    src: str  # LockNode.key
    dst: str
    mod: SourceModule
    line: int  # the inner acquisition (or call) site


@dataclasses.dataclass
class ModuleConcurrency:
    mod: SourceModule
    classes: dict  # class name -> ClassModel
    global_locks: dict  # NAME -> def line
    global_annotations: dict  # NAME -> (lock NAME, line)
    global_accesses: list  # list[Access] (module globals, via `global X`)
    global_guards: dict = dataclasses.field(default_factory=dict)
    lock_nodes: dict = dataclasses.field(default_factory=dict)  # key -> LockNode
    lock_edges: list = dataclasses.field(default_factory=list)
    blocking: list = dataclasses.field(default_factory=list)  # (line, msg)
    thread_roots: list = dataclasses.field(default_factory=list)  # qualnames
    thread_reachable: list = dataclasses.field(default_factory=list)


def _guarded_by_annotations(mod: SourceModule) -> dict:
    """``{lineno: lock_attr}`` for every guarded-by comment in the file."""
    out = {}
    for lineno, line in enumerate(mod.lines, start=1):
        m = _GUARDED_BY_RE.search(line)
        if m:
            out[lineno] = m.group("lock")
    return out


def _is_lock_factory(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and dotted_name(node.func) in _LOCK_FACTORIES


def _is_self_sync_factory(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and dotted_name(node.func) in _SELF_SYNC_FACTORIES
    )


def _field_default_factory(node: ast.AST) -> str:
    """Dotted name of ``dataclasses.field(default_factory=...)``'s
    factory, '' otherwise."""
    if isinstance(node, ast.Call) and dotted_name(node.func) in (
        "field", "dataclasses.field",
    ):
        for kw in node.keywords:
            if kw.arg == "default_factory":
                return dotted_name(kw.value)
    return ""


class _MethodWalker:
    """One lexical walk of a function/method body tracking the stack of
    held locks through ``with`` statements, collecting guarded-attribute
    accesses, lock-order edges, and blocking-while-holding calls."""

    def __init__(self, analyzer: "_ModuleAnalyzer", cls: ClassModel | None,
                 method_name: str, global_names: set):
        self.an = analyzer
        self.cls = cls
        self.method = method_name
        self.globals_declared = set(global_names)
        self.accesses: list[Access] = []
        self.global_accesses: list[Access] = []

    # -- lock resolution ---------------------------------------------------

    def _resolve_lock(self, expr: ast.AST):
        """LockNode (registered) for a with-context expression, or None
        when the expression is not a recognizable lock."""
        an = self.an
        attr = _self_attr(expr)
        if attr is not None and self.cls is not None:
            if attr in self.cls.lock_attrs or _LOCKY_NAME.search(attr):
                return an.class_lock_node(self.cls, attr), ("self", attr)
        if isinstance(expr, ast.Name):
            name = expr.id
            if name in an.module.global_locks or _LOCKY_NAME.search(name):
                return an.global_lock_node(name), ("global", name)
        if isinstance(expr, ast.Attribute) and _LOCKY_NAME.search(expr.attr):
            # <var>.X / <obj.path>.X — resolve by unique ownership of the
            # lock attr among this module's classes
            owners = [
                c for c in an.module.classes.values()
                if expr.attr in c.lock_attrs
            ]
            if len(owners) == 1:
                return an.class_lock_node(owners[0], expr.attr), (
                    "var", expr.attr
                )
            return an.anon_lock_node(expr.attr), ("var", expr.attr)
        return None

    # -- the walk ----------------------------------------------------------

    def walk(self, body, held):
        for node in body:
            self._visit(node, held)

    def _visit(self, node, held):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            # a nested def runs later, on an unknown thread, with no lock
            # lexically held — reset, but keep collecting its accesses
            inner = _MethodWalker(
                self.an, self.cls, self.method, self.globals_declared
            )
            body = node.body if not isinstance(node, ast.Lambda) else [
                ast.Expr(node.body)
            ]
            inner.walk(body, [])
            self.accesses.extend(inner.accesses)
            self.global_accesses.extend(inner.global_accesses)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in node.items:
                resolved = self._resolve_lock(item.context_expr)
                if resolved is not None:
                    lock_node, tag = resolved
                    for prev_node, _prev_tag in held + acquired:
                        if prev_node.key != lock_node.key:
                            self.an.add_edge(
                                prev_node, lock_node, item.context_expr.lineno
                            )
                    acquired.append((lock_node, tag))
                else:
                    self._visit_expr(item.context_expr, held)
                if item.optional_vars is not None:
                    self._visit_expr(item.optional_vars, held)
            self.walk(node.body, held + acquired)
            return
        self._record_statement(node, held)
        for child in ast.iter_child_nodes(node):
            self._visit(child, held)

    def _visit_expr(self, node, held):
        self._record_statement(node, held)
        for child in ast.iter_child_nodes(node):
            self._visit(child, held)

    # -- collection --------------------------------------------------------

    def _held_self(self, held) -> tuple:
        return tuple(
            tag[1] for _n, tag in held if tag[0] == "self"
        )

    def _held_global(self, held) -> tuple:
        return tuple(tag[1] for _n, tag in held if tag[0] == "global")

    def _add_access(self, attr, line, kind, held):
        if self.cls is None or attr is None:
            return
        if attr in self.cls.lock_attrs or attr in self.cls.self_sync_attrs:
            return
        a = Access(attr, line, kind, self._held_self(held), self.method)
        # a subscript-assign target walk yields both the Subscript and
        # its inner Attribute — record the access once
        if self.accesses and self.accesses[-1] == a:
            return
        self.accesses.append(a)

    def _add_global_access(self, name, line, kind, held):
        if name in self.globals_declared:
            self.global_accesses.append(
                Access(name, line, kind, self._held_global(held), self.method)
            )

    def _record_statement(self, node, held):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for t in targets:
                for el in ast.walk(t):
                    attr = _receiver_self_attr(el)
                    if attr is not None:
                        self._add_access(attr, node.lineno, "write", held)
                    if isinstance(el, ast.Name) and isinstance(
                        el.ctx, ast.Store
                    ):
                        self._add_global_access(
                            el.id, node.lineno, "write", held
                        )
                    # global containers mutated by subscript assignment
                    if isinstance(el, ast.Subscript) and isinstance(
                        el.value, ast.Name
                    ):
                        self._add_global_access(
                            el.value.id, node.lineno, "write", held
                        )
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                attr = _receiver_self_attr(t)
                if attr is not None:
                    self._add_access(attr, node.lineno, "write", held)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            attr = _self_attr(node.iter)
            if attr is not None:
                self._add_access(attr, node.lineno, "iter-read", held)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                attr = _self_attr(gen.iter)
                if attr is not None:
                    self._add_access(attr, node.lineno, "iter-read", held)
        elif isinstance(node, ast.Call):
            self._record_call(node, held)

    def _record_call(self, node: ast.Call, held):
        fn = node.func
        if isinstance(fn, ast.Attribute):
            if fn.attr in _MUTATORS:
                attr = _receiver_self_attr(fn.value)
                if attr is not None:
                    self._add_access(attr, node.lineno, "mutate", held)
                if isinstance(fn.value, ast.Name):
                    self._add_global_access(
                        fn.value.id, node.lineno, "mutate", held
                    )
            elif fn.attr in _ITER_METHODS:
                attr = _self_attr(fn.value)
                if attr is not None:
                    self._add_access(attr, node.lineno, "iter-read", held)
        if held:
            self._check_blocking(node, held)
        # interprocedural lock-order edges: a module-local call made
        # while holding propagates the callee's (transitive) acquisitions
        if held:
            callee = self._local_callee(node)
            if callee is not None:
                self.an.record_held_call(
                    [n for n, _t in held], callee, node.lineno
                )

    def _local_callee(self, node: ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in self.an.defs:
            return fn.id
        attr = _self_attr(fn)
        if attr is not None and attr in self.an.defs:
            return attr
        return None

    def _check_blocking(self, node: ast.Call, held):
        name = dotted_name(node.func)
        msg = None
        last = name.split(".")[-1] if name else ""
        if last in ("maybe_fault", "_maybe_fault"):
            msg = (
                f"`{last}()` (an injectable stall site) while holding "
                "a lock — a chaos stall under a lock convoys every "
                "thread behind it"
            )
        elif name == "time.sleep":
            msg = "`time.sleep()` while holding a lock"
        elif isinstance(node.func, ast.Attribute):
            meth = node.func.attr
            if isinstance(node.func.value, ast.Constant):
                return  # "sep".join(...) and friends
            if meth in _BLOCKING_ALWAYS:
                msg = f"blocking `.{meth}(...)` while holding a lock"
            elif meth in _BLOCKING_IF_UNBOUNDED:
                bounded = bool(node.args) or any(
                    kw.arg in ("timeout", "block") for kw in node.keywords
                )
                if not bounded:
                    msg = (
                        f"unbounded blocking `.{meth}()` (no timeout) "
                        "while holding a lock"
                    )
        if msg is not None:
            locks = ", ".join(
                f"`{n.name}`" for n, _t in held
            )
            self.an.module.blocking.append(
                (
                    node.lineno,
                    f"{msg} (held: {locks}) — release the lock before "
                    "blocking, or bound the wait with a timeout; a "
                    "blocked holder stalls every thread contending for "
                    "that lock (KSL016's runtime twin, "
                    "analysis/lockorder.py, would show the convoy)",
                )
            )


class _ModuleAnalyzer:
    """One pass over one module: builds the ClassModels, the lock graph
    fragment, the blocking-call list, and the thread-reachability sets."""

    def __init__(self, mod: SourceModule):
        self.mod = mod
        self.rel = _pkg_relpath(mod)
        self.defs = _function_defs(mod.tree)
        self.annotations = _guarded_by_annotations(mod)
        self.module = ModuleConcurrency(
            mod, classes={}, global_locks={}, global_annotations={},
            global_accesses=[],
        )
        self._held_calls = []  # (held lock nodes, callee name, line)
        self._fn_acquires: dict[str, set] = {}  # fn name -> lock keys
        self._fn_calls: dict[str, set] = {}  # fn name -> callee names
        self._analyze()

    # -- lock node registry ------------------------------------------------

    def _node(self, key, name, site_line) -> LockNode:
        node = self.module.lock_nodes.get(key)
        if node is None:
            node = LockNode(key, name, f"{self.rel}:{site_line}")
            self.module.lock_nodes[key] = node
        return node

    def class_lock_node(self, cls: ClassModel, attr: str) -> LockNode:
        line = cls.lock_attrs.get(attr, cls.line)
        return self._node(
            f"{self.rel}::{cls.name}.{attr}",
            f"{cls.name}.{attr}",
            line,
        )

    def global_lock_node(self, name: str) -> LockNode:
        line = self.module.global_locks.get(name, 1)
        return self._node(
            f"{self.rel}::{name}", name, line
        )

    def anon_lock_node(self, attr: str) -> LockNode:
        return self._node(
            f"{self.rel}::?.{attr}", f"?.{attr}", 1
        )

    def add_edge(self, src: LockNode, dst: LockNode, line: int) -> None:
        self.module.lock_edges.append(
            LockEdge(src.key, dst.key, self.mod, line)
        )

    def record_held_call(self, held_nodes, callee, line) -> None:
        self._held_calls.append((list(held_nodes), callee, line))

    # -- analysis ----------------------------------------------------------

    def _analyze(self) -> None:
        tree = self.mod.tree
        # module-level lock globals + guarded-by annotations on globals
        for node in tree.body:
            t = value = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                t, value = node.target, node.value
            if t is not None and isinstance(t, ast.Name):
                if _is_lock_factory(value):
                    self.module.global_locks[t.id] = node.lineno
                else:
                    ann = self.annotations.get(node.lineno)
                    if ann is not None:
                        self.module.global_annotations[t.id] = (
                            ann, node.lineno
                        )
        # classes: first collect every class's own lock/self-sync attrs,
        # then merge module-local BASE classes' attrs (obs/metrics.py's
        # _Metric hands its subclasses the registry lock — the `*_locked`
        # convention and guard inference must see inherited locks), then
        # walk methods
        class_nodes = [
            n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
        ]
        for node in class_nodes:
            self._collect_class_attrs(node)
        for _ in range(2):  # two rounds cover grandparent chains in order
            for node in class_nodes:
                cls = self.module.classes[node.name]
                for b in node.bases:
                    base = self.module.classes.get(
                        dotted_name(b).split(".")[-1]
                    )
                    if base is not None:
                        for attr, line in base.lock_attrs.items():
                            cls.lock_attrs.setdefault(attr, line)
                        cls.self_sync_attrs |= base.self_sync_attrs
        for node in class_nodes:
            cls = self.module.classes[node.name]
            for meth in self._class_methods(node):
                self._walk_function(meth, cls=cls)
            self._infer_guards(cls)
        # module-level functions (globals discipline + lock graph + KSL017)
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk_function(node, cls=None)
        self._close_interprocedural()
        self._thread_graph()

    def _class_methods(self, node: ast.ClassDef):
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield item

    def _collect_class_attrs(self, node: ast.ClassDef) -> None:
        cls = ClassModel(
            name=node.name, line=node.lineno, lock_attrs={},
            self_sync_attrs=set(), annotations={}, accesses=[],
        )
        # lock attrs + self-sync attrs + guarded-by annotations, from
        # every `self.X = ...` assignment and every dataclass field
        for item in node.body:
            if isinstance(item, ast.AnnAssign) and isinstance(
                item.target, ast.Name
            ):
                factory = (
                    _field_default_factory(item.value)
                    if item.value is not None
                    else ""
                )
                if factory in _LOCK_FACTORIES:
                    cls.lock_attrs[item.target.id] = item.lineno
                elif factory in _SELF_SYNC_FACTORIES:
                    cls.self_sync_attrs.add(item.target.id)
                else:
                    ann = self.annotations.get(item.lineno)
                    if ann is not None:
                        cls.annotations[item.target.id] = (ann, item.lineno)
        for meth in self._class_methods(node):
            for sub in ast.walk(meth):
                if isinstance(sub, ast.Assign):
                    for t in sub.targets:
                        attr = _self_attr(t)
                        if attr is None:
                            continue
                        if _is_lock_factory(sub.value):
                            cls.lock_attrs[attr] = sub.lineno
                        elif _is_self_sync_factory(sub.value):
                            cls.self_sync_attrs.add(attr)
                        elif (
                            isinstance(sub.value, ast.Name)
                            and _LOCKY_NAME.search(attr)
                        ):
                            # `self._lock = lock` — a lock handed in
                            cls.lock_attrs.setdefault(attr, sub.lineno)
                        else:
                            ann = self.annotations.get(sub.lineno)
                            if ann is not None:
                                cls.annotations[attr] = (ann, sub.lineno)
                elif isinstance(sub, ast.AnnAssign):
                    attr = _self_attr(sub.target)
                    if attr is not None and sub.value is not None:
                        if _is_lock_factory(sub.value):
                            cls.lock_attrs[attr] = sub.lineno
                        elif _is_self_sync_factory(sub.value):
                            cls.self_sync_attrs.add(attr)
                        else:
                            ann = self.annotations.get(sub.lineno)
                            if ann is not None:
                                cls.annotations[attr] = (ann, sub.lineno)
        self.module.classes[node.name] = cls

    def _walk_function(self, fn, cls: ClassModel | None) -> None:
        global_names = {
            n
            for sub in ast.walk(fn)
            if isinstance(sub, ast.Global)
            for n in sub.names
        }
        walker = _MethodWalker(self, cls, fn.name, global_names)
        held = []
        # repo convention: `*_locked` methods run under the caller's
        # lock — the class's sole lock when unambiguous
        if cls is not None and fn.name.endswith("_locked"):
            sole = cls.sole_lock()
            if sole is not None:
                held = [(self.class_lock_node(cls, sole), ("self", sole))]
        walker.walk(fn.body, held)
        if cls is not None:
            cls.accesses.extend(walker.accesses)
        self.module.global_accesses.extend(walker.global_accesses)
        # per-function acquisition/call sets for the interprocedural
        # closure — OWN scope only: a lock taken inside a nested def
        # belongs to the closure (which runs later, with nothing held),
        # not to this function (the same reset _MethodWalker applies)
        acquires = set()
        calls = set()
        for sub in _own_scope_nodes(fn):
            if isinstance(sub, (ast.With, ast.AsyncWith)):
                for item in sub.items:
                    resolved = walker._resolve_lock(item.context_expr)
                    if resolved is not None:
                        acquires.add(resolved[0].key)
            elif isinstance(sub, ast.Call):
                callee = walker._local_callee(sub)
                if callee is not None:
                    calls.add(callee)
        self._fn_acquires.setdefault(fn.name, set()).update(acquires)
        self._fn_calls.setdefault(fn.name, set()).update(calls)

    def _infer_guards(self, cls: ClassModel) -> None:
        votes: dict[str, dict[str, int]] = {}
        for a in cls.accesses:
            if a.kind in ("write", "mutate") and a.held:
                lock = a.held[-1]  # innermost
                votes.setdefault(a.attr, {}).setdefault(lock, 0)
                votes[a.attr][lock] += 1
        for attr, by_lock in votes.items():
            cls.guards[attr] = max(by_lock.items(), key=lambda kv: kv[1])[0]
        # annotations override / extend inference
        for attr, (lock, _line) in cls.annotations.items():
            cls.guards[attr] = lock

    def _close_interprocedural(self) -> None:
        """Transitive may-acquire closure over module-local calls, then
        edges for every call made while holding. Computed as a FIXPOINT
        (not a memoized DFS): mutually-recursive functions would truncate
        a recursive walk at the cycle cut and memoize the partial set,
        silently dropping edges — a false NEGATIVE in a deadlock
        detector."""
        closure: dict[str, set] = {
            f: set(acq) for f, acq in self._fn_acquires.items()
        }
        for f in self._fn_calls:
            closure.setdefault(f, set())
        changed = True
        while changed:
            changed = False
            for f, callees in self._fn_calls.items():
                s = closure[f]
                before = len(s)
                for callee in callees:
                    s |= closure.get(callee, set())
                if len(s) != before:
                    changed = True

        for held_nodes, callee, line in self._held_calls:
            for key in closure.get(callee, ()):
                for src in held_nodes:
                    if src.key != key:
                        self.module.lock_edges.append(
                            LockEdge(src.key, key, self.mod, line)
                        )
                        # the callee's nodes live in this module's registry
                        # already (resolve_lock registered them)

    # -- thread reachability ----------------------------------------------

    def _thread_graph(self) -> None:
        tree = self.mod.tree
        qual: dict[int, str] = {}  # id(def node) -> qualname
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                for meth in self._class_methods(node):
                    qual[id(meth)] = f"{node.name}.{meth.name}"
        for name, nodes in self.defs.items():
            for d in nodes:
                qual.setdefault(id(d), name)

        roots: list = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and dotted_name(
                node.func
            ) in _THREAD_FACTORIES:
                target = None
                for kw in node.keywords:
                    if kw.arg == "target":
                        target = kw.value
                if target is None and node.args:
                    # Timer(interval, function)
                    target = node.args[1] if len(node.args) > 1 else None
                if isinstance(target, ast.Name) and target.id in self.defs:
                    roots.extend(self.defs[target.id])
                else:
                    attr = _self_attr(target) if target is not None else None
                    if attr is not None and attr in self.defs:
                        roots.extend(self.defs[attr])
            elif isinstance(node, ast.ClassDef):
                base_names = [dotted_name(b) for b in node.bases]
                if any(
                    any(h in (b or "") for h in _HANDLER_BASES)
                    for b in base_names
                ):
                    roots.extend(
                        m for m in self._class_methods(node)
                        if m.name.startswith("do_")
                    )
                if any(
                    any(s in (b or "") for s in _SERVER_BASES)
                    for b in base_names
                ):
                    roots.extend(
                        m for m in self._class_methods(node)
                        if m.name in ("process_request_thread",)
                    )
        # closure over module-local Name refs and self.<m> refs
        reached: set[int] = set()
        frontier = list(roots)
        by_id = {}
        for name, nodes in self.defs.items():
            for d in nodes:
                by_id[id(d)] = d
        while frontier:
            fn = frontier.pop()
            if id(fn) in reached:
                continue
            reached.add(id(fn))
            for sub in ast.walk(fn):
                targets = []
                if isinstance(sub, ast.Name) and sub.id in self.defs:
                    targets = self.defs[sub.id]
                else:
                    attr = _self_attr(sub)
                    if attr is not None and attr in self.defs:
                        targets = self.defs[attr]
                for t in targets:
                    if id(t) not in reached:
                        frontier.append(t)
        self.module.thread_roots = sorted(
            {qual.get(id(r), getattr(r, "name", "?")) for r in roots}
        )
        self.module.thread_reachable = sorted(
            {qual.get(i, "?") for i in reached}
        )


# one analysis per module per scan (rules run back to back on the same
# SourceModule objects; the cache is keyed by object identity)
_CACHE: dict[int, ModuleConcurrency] = {}


def analyze_module(mod: SourceModule) -> ModuleConcurrency:
    got = _CACHE.get(id(mod))
    if got is None or got.mod is not mod:
        if len(_CACHE) > 4096:
            _CACHE.clear()
        got = _ModuleAnalyzer(mod).module
        _CACHE[id(mod)] = got
    return got


# ---------------------------------------------------------------------------
# KSL015 — guard consistency


@register
class GuardConsistency(Rule):
    id = "KSL015"
    title = (
        "guarded attribute accessed outside its lock (inferred or "
        "# ksel: guarded-by[...]), or a stale guarded-by annotation"
    )
    rationale = (
        "A class that owns a lock declares cross-thread intent; an "
        "attribute written under `with self._lock:` in one method and "
        "mutated or iterated bare in another is exactly the race class "
        "review keeps catching by hand (the PhaseTimer report() "
        "iteration this rule's first run flagged raises `dict changed "
        "size during iteration` when a producer thread lands a phase "
        "mid-report). Declare intent with `# ksel: guarded-by[<lock>]` "
        "on the attribute's init line; the rule enforces it everywhere "
        "and flags annotations whose lock the class does not own."
    )

    def check_module(self, mod: SourceModule):
        if not _in_package(mod):
            return
        mc = analyze_module(mod)
        for cls in mc.classes.values():
            # stale annotations first
            for attr, (lock, line) in cls.annotations.items():
                if lock not in cls.lock_attrs:
                    yield line, (
                        f"stale guarded-by annotation on `{cls.name}."
                        f"{attr}`: `{lock}` is not a lock attribute of "
                        f"`{cls.name}` (known locks: "
                        f"{sorted(cls.lock_attrs) or 'none'}) — fix the "
                        "annotation or add the lock"
                    )
            for a in cls.accesses:
                guard = cls.guards.get(a.attr)
                if guard is None or guard not in cls.lock_attrs:
                    continue
                if a.method in _EXEMPT_METHODS:
                    continue
                if guard in a.held:
                    continue
                how = {
                    "write": "written",
                    "mutate": "mutated",
                    "iter-read": "iterated",
                }[a.kind]
                src = (
                    "declared by its guarded-by annotation"
                    if a.attr in cls.annotations
                    else "inferred from its locked writes"
                )
                yield a.line, (
                    f"`{cls.name}.{a.attr}` {how} in `{a.method}` without "
                    f"holding `{guard}` ({src}) — another thread mutating "
                    "under the lock makes this access a torn read or a "
                    "lost update; hold the guard or snapshot under it"
                )
        # module globals
        for name, (lock, line) in mc.global_annotations.items():
            if lock not in mc.global_locks:
                yield line, (
                    f"stale guarded-by annotation on module global "
                    f"`{name}`: `{lock}` is not a module-level lock "
                    "in this file"
                )
        votes: dict[str, dict[str, int]] = {}
        for a in mc.global_accesses:
            if a.kind in ("write", "mutate") and a.held:
                votes.setdefault(a.attr, {}).setdefault(a.held[-1], 0)
                votes[a.attr][a.held[-1]] += 1
        guards = {
            attr: max(by.items(), key=lambda kv: kv[1])[0]
            for attr, by in votes.items()
        }
        for name, (lock, _line) in mc.global_annotations.items():
            if lock in mc.global_locks:
                guards[name] = lock
        for a in mc.global_accesses:
            guard = guards.get(a.attr)
            if guard is None or guard in a.held:
                continue
            how = {
                "write": "written",
                "mutate": "mutated",
                "iter-read": "iterated",
            }[a.kind]
            yield a.line, (
                f"module global `{a.attr}` {how} in `{a.method}` "
                f"without holding `{guard}` (its guard everywhere else) "
                "— take the lock or route through the guarded helper"
            )


# ---------------------------------------------------------------------------
# KSL016 — static lock-order cycles


def build_lock_graph(mods) -> tuple[dict, list]:
    """The package-wide union lock graph: ``(nodes, edges)`` with nodes
    keyed stably (``relpath::Class.attr`` / ``relpath::GLOBAL``) and
    edges as LockEdge records (src held while dst acquired)."""
    nodes: dict[str, LockNode] = {}
    edges: list[LockEdge] = []
    for mod in mods:
        if not _in_package(mod):
            continue
        mc = analyze_module(mod)
        nodes.update(mc.lock_nodes)
        edges.extend(mc.lock_edges)
    return nodes, edges


def cycles_from_pairs(pairs) -> list[list[str]]:
    """WITNESS cycles in a directed graph given as (src, dst) pairs —
    each reported once, rotated to its lexicographically-smallest node.
    The list is empty IFF the graph is acyclic (that emptiness is the
    gate property), and carries at least one witness per strongly-
    connected tangle — it is NOT an exhaustive simple-cycle enumeration
    (two cycles sharing nodes may surface one witness; fixing it and
    re-running the lint surfaces the next). The ONE cycle finder: the
    static KSL016 graph and the runtime sanitizer's observed graph
    (analysis/lockorder.py) both use it, so their cycle reporting can
    never diverge."""
    adj: dict[str, set] = {}
    for a, b in pairs:
        adj.setdefault(a, set()).add(b)
    cycles = []
    seen_keys = set()
    state: dict[str, int] = {}  # 0 unvisited / 1 on stack / 2 done
    stack: list[str] = []

    def dfs(u):
        state[u] = 1
        stack.append(u)
        for v in sorted(adj.get(u, ())):
            if state.get(v, 0) == 0:
                dfs(v)
            elif state.get(v) == 1:
                i = stack.index(v)
                cyc = stack[i:]
                rot = cyc.index(min(cyc))
                canon = tuple(cyc[rot:] + cyc[:rot])
                if canon not in seen_keys:
                    seen_keys.add(canon)
                    cycles.append(list(canon))
        stack.pop()
        state[u] = 2

    for u in sorted(adj):
        if state.get(u, 0) == 0:
            dfs(u)
    return cycles


def find_cycles(nodes: dict, edges: list) -> list[list[str]]:
    """Cycles in the static lock graph (LockEdge records)."""
    return cycles_from_pairs((e.src, e.dst) for e in edges)


@register
class LockOrderCycles(Rule):
    id = "KSL016"
    title = "cycle in the static acquired-while-holding lock-order graph"
    rationale = (
        "Two threads taking the same pair of locks in opposite orders is "
        "the classic deadlock; the static graph records every `with "
        "lockB:` nested (directly or through a module-local call) inside "
        "`with lockA:` as an edge A->B, and a cycle means some "
        "interleaving can deadlock — found at lint time, not in a hung "
        "prod server. The runtime sanitizer (analysis/lockorder.py) "
        "builds the same graph from the real concurrency tests and the "
        "gate asserts the two agree."
    )

    def check_tree(self, mods):
        nodes, edges = build_lock_graph(mods)
        edge_sites: dict[tuple, LockEdge] = {}
        for e in edges:
            edge_sites.setdefault((e.src, e.dst), e)
        for cyc in find_cycles(nodes, edges):
            pairs = list(zip(cyc, cyc[1:] + cyc[:1]))
            sites = []
            for a, b in pairs:
                e = edge_sites[(a, b)]
                sites.append(
                    f"{nodes[a].name} -> {nodes[b].name} at "
                    f"{_pkg_relpath(e.mod)}:{e.line}"
                )
            first = edge_sites[pairs[0]]
            yield first.mod, first.line, (
                "potential deadlock: lock-order cycle "
                + " ; ".join(sites)
                + " — impose one global acquisition order (or drop to a "
                "single lock); both sites must agree on which lock is "
                "outer"
            )


# ---------------------------------------------------------------------------
# KSL017 — blocking while holding


@register
class BlockingWhileHolding(Rule):
    id = "KSL017"
    title = (
        "blocking call (unbounded get/wait/join, socket recv/accept, "
        "sleep, maybe_fault stall) while holding a lock"
    )
    rationale = (
        "A lock holder that blocks — a `Queue.get()` with no timeout, an "
        "`Event.wait()`, a `Thread.join()`, a socket accept, a sleep, or "
        "an injectable `maybe_fault` stall — convoys every thread "
        "contending for that lock behind an unbounded wait, and pairs of "
        "such sites are how lock-order cycles actually hang. Bound the "
        "wait with a timeout or move it outside the critical section "
        "(the pattern serve/http.py's server_close already follows: "
        "swap the list under the lock, join outside it)."
    )

    def check_module(self, mod: SourceModule):
        if not _in_package(mod):
            return
        mc = analyze_module(mod)
        seen = set()
        for line, msg in mc.blocking:
            if (line, msg) in seen:
                continue
            seen.add((line, msg))
            yield line, msg


# ---------------------------------------------------------------------------
# the exported report (--concurrency-report)


def build_concurrency_report(paths, root=None, mods=None) -> dict:
    """Thread-reachability and lock-order graphs as one JSON-ready dict —
    the artifact ``--concurrency-report <path>`` writes and
    the runtime sanitizer's consistency check consumes. Pass ``mods``
    (an already-loaded SourceModule list, e.g. ``Report.modules``) to
    skip re-parsing the tree; ``paths`` is ignored then."""
    if mods is None:
        mods = []
        for f in iter_python_files(paths):
            try:
                mods.append(load_module(f, root=root))
            except SyntaxError:
                continue
    nodes, edges = build_lock_graph(mods)
    threads = {}
    guards = {}
    for mod in mods:
        if not _in_package(mod):
            continue
        mc = analyze_module(mod)
        if mc.thread_roots:
            threads[_pkg_relpath(mod)] = {
                "roots": mc.thread_roots,
                "reachable": mc.thread_reachable,
            }
        for cls in mc.classes.values():
            if cls.guards:
                guards[f"{_pkg_relpath(mod)}::{cls.name}"] = {
                    attr: lock for attr, lock in sorted(cls.guards.items())
                }
    edge_list = sorted(
        {
            (e.src, e.dst, f"{_pkg_relpath(e.mod)}:{e.line}")
            for e in edges
        }
    )
    return {
        "threads": threads,
        "lock_graph": {
            "nodes": {
                k: {"name": n.name, "site": n.site}
                for k, n in sorted(nodes.items())
            },
            "edges": [
                {"src": a, "dst": b, "site": s} for a, b, s in edge_list
            ],
            "cycles": find_cycles(nodes, edges),
        },
        "guards": guards,
    }
