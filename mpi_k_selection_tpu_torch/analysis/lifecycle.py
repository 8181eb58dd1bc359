"""Resource-lifecycle dataflow pass (KSL019-KSL021): prove every acquire
reaches its release on every path.

The repo's leak discipline was entirely runtime before this module: the
conftest fixtures fail any test that leaks a ``ksel-*`` thread, a staged
ring slot (``live_staged_keys()``) or a ``ksel-spill-*`` dir, and the
runtime ledger (obs/ledger.py) measures byte leaks after the fact. This
pass is the static complement — a per-function CFG (branches, loops,
try/except/finally, with-blocks, early returns) plus an ownership/escape
analysis over the package's resource protocols
(mpi_k_selection_tpu_torch/resource_protocols.py, the SAME registry the
conftest fixtures match against), proving at lint time that:

- **KSL019** — a ``stage_keys``/``stage_device_keys`` result reaches
  ``StagedKeys.release()`` (or ``release_staged``) on every CFG path, or
  provably escapes into a sanctioned owner: the executor/window FIFO
  (``push`` — released at bundle finish), the pipeline queue
  (``put``/``_put`` — close() drains and releases), or the caller
  (``return``/``yield``).
- **KSL020** — an internally-constructed ``SpillStore`` / generation
  writer (``new_generation()``) / ``TemporaryDirectory``/``mkdtemp``
  reaches its cleanup (``close``/``abort``/``commit``/``cleanup``) on
  every exit path INCLUDING the raise edges, unless returned or handed
  to a caller-owned store.
- **KSL021** — a constructed ``threading.Thread`` with a ``ksel-`` name
  reaches ``join()`` on all exits or is registered with a tracked
  supervisor (the conftest-recognized owner slots: ``_thread``,
  ``_serve_thread``, ``_req_threads``). An UNSTARTED Thread object holds
  no OS resources, so the obligation arms at ``.start()``.

Ownership transfers the lexical analysis cannot see are declarable with
``# ksel: owner[<site>]`` on the transferring line; ``<site>`` must name
a registered owner (resource_protocols.OWNER_SITES), and an annotation
on a line where no tracked resource moves — or naming an unknown site —
is itself a finding (the ``guarded-by`` staleness contract applied to
ownership; audit findings report under KSL019, the umbrella lifecycle
rule).

Engine semantics (a may-leak abstract interpretation, not a full path
enumeration):

- The state maps local names to live resources. Branch joins take the
  UNION (a resource alive on any incoming path is may-live), so "exists
  a path to this exit where the resource is still live" is exactly what
  a finding claims.
- Every statement that contains a call (or is a ``raise``/``assert``)
  contributes an exception edge carrying its post-state; edges route to
  the enclosing ``try``'s handlers (a broad handler absorbs them; typed
  handlers also propagate — the type may not match), through every
  ``finally``, and ultimately to the function's exception exit.
- ``isinstance(r, T)`` / ``r is None`` / ``r is not None`` tests narrow
  the state per branch using the protocol's type vocabulary — the
  ``if isinstance(keys, StagedKeys): keys.release()`` unwind idiom
  proves clean, not "conditionally released".
- Rebinding (or ``del``-ing) a name whose resource is still live —
  including across a loop back edge, the loop-carried-acquire class —
  leaks the old resource and is reported at the rebind site.
- Acquires are recognized THROUGH immediately-invoked wrappers
  (``retry_call(lambda: stage_keys(...), ...)`` — the staging-retry
  idiom), and interprocedurally one hop: a module-local function that
  returns a live resource is itself an acquire site for its callers'
  single-name assignments.
- ``with`` context managers auto-release their managed resource
  (``with SpillStore(...) as s:`` is the sanctioned scoped form).

Honesty bounds (mirroring the KSL015 family): analysis is lexical and
module-local; aliasing (``r2 = r``), resources carried in containers
(``[stage_keys(c) for c in ...]``), tuple-unpacked acquire returns, and
cross-object flows are out of scope — the runtime conftest fixtures are
the complementary dynamic check. Library code only; tests poke
lifecycles freely.
"""

from __future__ import annotations

import ast
import dataclasses
import re

from mpi_k_selection_tpu_torch import resource_protocols as _rp
from mpi_k_selection_tpu_torch.analysis.ast_rules import dotted_name
from mpi_k_selection_tpu_torch.analysis.concurrency import _in_package, _pkg_relpath
from mpi_k_selection_tpu_torch.analysis.core import (
    Rule,
    SourceModule,
    iter_python_files,
    load_module,
    register,
)

_OWNER_RE = re.compile(
    r"#\s*ksel(?:-torch)?:\s*owner\[(?P<site>[A-Za-z_][A-Za-z0-9_.]*)\]"
)

#: Calls that run their function argument IMMEDIATELY and return its
#: result — an acquire inside their lambda argument is an acquire of the
#: call's result (the staging-retry idiom, faults/policy.py:retry_call).
_IMMEDIATE_WRAPPERS = frozenset({"retry_call"})

#: Receiver-method names that add their argument to a container.
_CONTAINER_ADDERS = frozenset({"append", "add", "appendleft"})

_KSEL_NAME_RE = re.compile(r"ksel-|THREAD_PREFIX|THREAD_NAME")

#: Calls that cannot realistically raise — without this, the sanctioned
#: narrow-then-release unwind (``if isinstance(keys, StagedKeys):
#: keys.release()``) would itself spawn an exception edge carrying the
#: still-live resource out of the handler.
_NO_RAISE_BUILTINS = frozenset(
    {"isinstance", "issubclass", "len", "id", "type", "callable"}
)


@dataclasses.dataclass(frozen=True)
class Protocol:
    """One resource family's lifecycle vocabulary (see
    resource_protocols.py for the canonical constants)."""

    kind: str
    rule: str
    noun: str
    acquire_calls: frozenset
    release_methods: frozenset
    release_funcs: frozenset
    owner_calls: frozenset
    owner_attrs: frozenset
    types: frozenset
    armed_at_acquire: bool
    remedy: str


PROTOCOLS = (
    Protocol(
        kind="staged",
        rule="KSL019",
        noun="staged key buffer",
        acquire_calls=_rp.STAGED_ACQUIRE_CALLS,
        release_methods=_rp.STAGED_RELEASE_METHODS,
        release_funcs=_rp.STAGED_RELEASE_FUNCS,
        owner_calls=_rp.STAGED_OWNER_CALLS,
        owner_attrs=frozenset(),
        types=_rp.STAGED_TYPES,
        armed_at_acquire=True,
        remedy=(
            "release() it (or release_staged), hand it to a sanctioned "
            "owner (executor/window push, the pipeline queue, return it "
            "to the caller), or declare the transfer with "
            "`# ksel: owner[<site>]`"
        ),
    ),
    Protocol(
        kind="spill",
        rule="KSL020",
        noun="spill store/writer/temp dir",
        acquire_calls=_rp.SPILL_ACQUIRE_CALLS,
        release_methods=_rp.SPILL_RELEASE_METHODS,
        release_funcs=_rp.SPILL_RELEASE_FUNCS,
        owner_calls=_rp.SPILL_OWNER_CALLS,
        owner_attrs=_rp.SPILL_OWNER_ATTRS,
        types=_rp.SPILL_TYPES,
        armed_at_acquire=True,
        remedy=(
            "close()/abort()/commit()/cleanup() it on every exit path "
            "(try/finally, or an except-release-raise unwind), return "
            "it, or declare the transfer with `# ksel: owner[<site>]`"
        ),
    ),
    Protocol(
        kind="thread",
        rule="KSL021",
        noun="ksel- worker thread",
        acquire_calls=_rp.THREAD_ACQUIRE_CALLS,
        release_methods=_rp.THREAD_RELEASE_METHODS,
        release_funcs=_rp.THREAD_RELEASE_FUNCS,
        owner_calls=_rp.THREAD_OWNER_CALLS,
        owner_attrs=_rp.THREAD_OWNER_ATTRS,
        types=_rp.THREAD_TYPES,
        armed_at_acquire=False,  # arms at .start(): no OS thread before
        remedy=(
            "join() it on every exit, register it with a tracked "
            "supervisor slot (self._thread / _serve_thread / a tracked "
            "_req_threads list), or declare the transfer with "
            "`# ksel: owner[<site>]`"
        ),
    ),
)

_ALL_RELEASE_FUNCS = frozenset().union(*(p.release_funcs for p in PROTOCOLS))


@dataclasses.dataclass
class Resource:
    """One tracked acquisition, bound to a local name."""

    var: str
    proto: Protocol
    line: int
    func: str
    armed: bool


def _last_seg(name: str) -> str:
    return name.split(".")[-1] if name else ""


def _expr_nodes(root):
    """Own-scope expression nodes: nested lambdas/defs run later and are
    skipped (release/escape effects inside them are not this
    statement's)."""
    stack = [root]
    while stack:
        node = stack.pop()
        if node is None:
            continue
        if isinstance(node, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _own_stmt_nodes(stmt):
    """Own-scope nodes of a statement (for may-raise detection) — nested
    defs/lambdas don't execute here."""
    stack = [stmt]
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _names_in(expr) -> set:
    """Plain Name identifiers referenced in an expression's own scope
    (lambda default values ARE evaluated at the call site, so walk
    lambda args' defaults but not bodies — handled by _expr_nodes plus
    an explicit defaults walk)."""
    out = set()
    stack = [expr]
    while stack:
        node = stack.pop()
        if node is None:
            continue
        if isinstance(node, ast.Lambda):
            # default values evaluate NOW (the `lambda hk=keys: ...`
            # binding idiom); the body runs later
            stack.extend(node.args.defaults)
            stack.extend(d for d in node.args.kw_defaults if d is not None)
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, ast.Name):
            out.add(node.id)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _merge(*states):
    """Union join: live in the merge iff live in ANY incoming state
    (may-leak semantics). ``None`` entries (dead paths) are skipped;
    returns None when every path is dead."""
    live = [s for s in states if s is not None]
    if not live:
        return None
    out: dict = {}
    for s in live:
        for var, r in s.items():
            prev = out.get(var)
            if prev is None or (not prev.armed and r.armed):
                out[var] = r
    return out


def _outcomes():
    return {
        "fall": None,
        "returns": [],
        "raises": [],
        "breaks": [],
        "continues": [],
    }


class _FunctionLifecycle:
    """One function's abstract interpretation."""

    def __init__(self, an: "_ModuleLifecycleAnalyzer", fn, qualname: str):
        self.an = an
        self.fn = fn
        self.qual = qualname
        # (var, line, proto) -> set of leaking exit kinds
        self.leaks: dict = {}
        self.returns_resource: Protocol | None = None

    # -- entry point -------------------------------------------------------

    def run(self) -> None:
        out = self._seq(self.fn.body, {})
        if out["fall"] is not None:
            self._exit_leaks(out["fall"], "fall-through return")
        for s in out["returns"]:
            self._exit_leaks(s, "return")
        for s in out["raises"]:
            self._exit_leaks(s, "exception")
        self._emit_leaks()

    def _exit_leaks(self, state, kind: str) -> None:
        for r in state.values():
            if r.armed:
                self.leaks.setdefault((r.var, r.line, r.proto), set()).add(kind)

    def _emit_leaks(self) -> None:
        for (var, line, proto), kinds in sorted(
            self.leaks.items(), key=lambda kv: (kv[0][1], kv[0][0])
        ):
            paths = ", ".join(sorted(kinds))
            self.an.finding(
                line,
                proto.rule,
                f"{proto.noun} `{var}` acquired in `{self.qual}` never "
                f"reaches its release on the {paths} path(s) — "
                f"{proto.remedy}",
            )

    # -- statement sequencing ----------------------------------------------

    def _seq(self, stmts, state):
        out = _outcomes()
        cur = dict(state)
        alive = True
        for st in stmts:
            if not alive:
                break
            res = self._stmt(st, cur)
            for k in ("returns", "raises", "breaks", "continues"):
                out[k].extend(res[k])
            cur = res["fall"]
            if cur is None:
                alive = False
        out["fall"] = cur if alive else None
        return out

    def _may_raise(self, node) -> bool:
        for n in _own_stmt_nodes(node):
            if isinstance(n, (ast.Raise, ast.Assert)):
                return True
            if isinstance(n, ast.Call) and (
                _last_seg(dotted_name(n.func)) not in _NO_RAISE_BUILTINS
            ):
                return True
        return False

    def _simple(self, node, state):
        """Shared tail for simple statements: owner annotations applied,
        then an exception edge when the statement can raise."""
        self._apply_owner_annotation(node, state)
        out = _outcomes()
        out["fall"] = state
        if self._may_raise(node):
            out["raises"].append(dict(state))
        return out

    # -- the dispatcher ----------------------------------------------------

    def _stmt(self, node, state):
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            out = _outcomes()
            out["fall"] = state
            return out
        if isinstance(node, ast.Return):
            if node.value is not None:
                self._effects(node.value, state, node)
                self._escape_names(node.value, state, "caller", node.lineno)
            self._apply_owner_annotation(node, state)
            out = _outcomes()
            out["returns"].append(dict(state))
            return out
        if isinstance(node, ast.Raise):
            if node.exc is not None:
                self._effects(node.exc, state, node)
            self._apply_owner_annotation(node, state)
            out = _outcomes()
            out["raises"].append(dict(state))
            return out
        if isinstance(node, ast.Break):
            out = _outcomes()
            out["breaks"].append(dict(state))
            return out
        if isinstance(node, ast.Continue):
            out = _outcomes()
            out["continues"].append(dict(state))
            return out
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            return self._assign(node, state)
        if isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id in state:
                    self._overwrite(state.pop(t.id), node.lineno, "del")
            return self._simple(node, state)
        if isinstance(node, ast.If):
            return self._if(node, state)
        if isinstance(node, (ast.While,)):
            return self._while(node, state)
        if isinstance(node, (ast.For, ast.AsyncFor)):
            return self._for(node, state)
        if isinstance(node, ast.Try):
            return self._try(node, state)
        if isinstance(node, (ast.With, ast.AsyncWith)):
            return self._with(node, state)
        if isinstance(node, (ast.Expr, ast.Assert)):
            pre = dict(state)
            self._effects(
                node.value if isinstance(node, ast.Expr) else node.test,
                state,
                node,
            )
            self._apply_owner_annotation(node, state)
            out = _outcomes()
            out["fall"] = state
            if self._may_raise(node):
                # the exception edge keeps the optimistic releases and
                # escapes, but rolls back ARMING: a `t.start()` that
                # raises never created the OS thread, so the obligation
                # never armed on that path
                edge = dict(state)
                for var, old in pre.items():
                    cur = edge.get(var)
                    if cur is not None and cur.armed and not old.armed:
                        edge[var] = old
                out["raises"].append(edge)
            return out
        # Pass, Import, Global, Nonlocal, ...
        return self._simple(node, state)

    # -- assignment / acquisition -------------------------------------------

    def _assign(self, node, state):
        value = node.value
        if value is None:  # a bare annotation (`x: int`) binds nothing
            return self._simple(node, state)
        self._effects(value, state, node)
        # the statement's exception edge carries the PRE-BIND state: if
        # the acquire call itself raises, nothing was ever bound, so
        # there is nothing to release (without this, every bare
        # `store = SpillStore(...)` would be an "exception path" leak)
        pre = dict(state)
        proto = self._find_acquire(value)
        targets = (
            node.targets if isinstance(node, ast.Assign) else [node.target]
        )
        # a live resource VALUE stored somewhere: `obj.attr = r`
        value_res = (
            state.get(value.id)
            if isinstance(value, ast.Name) and value.id in state
            else None
        )
        for t in targets:
            if isinstance(t, ast.Name):
                if t.id in state:
                    self._overwrite(state.pop(t.id), node.lineno, "rebound")
                if proto is not None:
                    self._acquire(t.id, proto, node.lineno, state)
            elif isinstance(t, ast.Attribute):
                attr = t.attr
                if proto is not None or value_res is not None:
                    p = proto if proto is not None else value_res.proto
                    line = node.lineno
                    if attr in p.owner_attrs:
                        self._record_escape(
                            value_res.var if value_res else "<new>",
                            p, line, f"owner attribute `{attr}`",
                        )
                        if value_res is not None:
                            state.pop(value_res.var, None)
                    elif self._annotated_site(node) is not None:
                        site = self._annotated_site(node)
                        self._use_annotation(node, state)
                        if site not in _rp.OWNER_SITES:
                            self.an.finding(
                                line,
                                "KSL019",
                                f"`# ksel: owner[{site}]` names an "
                                "unregistered owner site (registered: "
                                f"{sorted(_rp.OWNER_SITES)}) — register it "
                                "in resource_protocols.OWNER_SITES or fix "
                                "the name",
                            )
                        self._record_escape(
                            value_res.var if value_res else "<new>",
                            p, line, f"declared owner `{site}`",
                        )
                        if value_res is not None:
                            state.pop(value_res.var, None)
                    else:
                        self.an.finding(
                            line,
                            p.rule,
                            f"{p.noun} escapes into attribute `{attr}`, "
                            "which is not a sanctioned owner slot "
                            f"(tracked owners: "
                            f"{sorted(p.owner_attrs) or 'none'}) — "
                            "register the slot in resource_protocols.py "
                            "(and join/clean it on the owner's close "
                            "path) or declare the transfer with "
                            "`# ksel: owner[<site>]`",
                        )
                        if value_res is not None:
                            state.pop(value_res.var, None)
            elif isinstance(t, (ast.Tuple, ast.List)):
                # tuple-unpack: rebinding live names still leaks; a
                # tuple-carried acquire is out of scope (honesty bound)
                for el in ast.walk(t):
                    if isinstance(el, ast.Name) and el.id in state:
                        self._overwrite(
                            state.pop(el.id), node.lineno, "rebound"
                        )
        self._apply_owner_annotation(node, state)
        out = _outcomes()
        out["fall"] = state
        if self._may_raise(node):
            out["raises"].append(pre)
        return out

    def _find_acquire(self, expr) -> Protocol | None:
        """The protocol acquired by evaluating ``expr``, looking through
        immediately-invoked wrappers (retry_call lambdas) and
        conditional expressions."""
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            last = _last_seg(dotted_name(node.func))
            proto = self._match_acquire_name(last, node)
            if proto is not None:
                return proto
        return None

    def _match_acquire_name(self, last, call) -> Protocol | None:
        for proto in PROTOCOLS:
            if last not in proto.acquire_calls:
                continue
            # interprocedural hop: module-local acquire-returning fns
            if proto.kind == "thread" and not self._ksel_thread(call):
                continue
            return proto
        extra = self.an.extra_acquirers.get(last)
        if extra is not None and isinstance(call.func, ast.Name):
            return extra
        return None

    def _ksel_thread(self, call) -> bool:
        for kw in call.keywords:
            if kw.arg == "name":
                seg = self.an.mod.segment(kw.value)
                return bool(_KSEL_NAME_RE.search(seg or ""))
        return False

    def _acquire(self, var, proto, line, state) -> None:
        state[var] = Resource(var, proto, line, self.qual, proto.armed_at_acquire)
        self.an.acquires.append(
            {
                "kind": proto.kind,
                "rule": proto.rule,
                "var": var,
                "line": line,
                "function": self.qual,
            }
        )

    def _overwrite(self, res: Resource, line: int, how: str) -> None:
        if not res.armed:
            return
        self.an.finding(
            line,
            res.proto.rule,
            f"`{res.var}` ({res.proto.noun} acquired at line {res.line} "
            f"in `{self.qual}`) is {how} while still live — the previous "
            f"acquisition can no longer be released; {res.proto.remedy}",
        )

    # -- expression effects: releases, escapes, arming -----------------------

    def _effects(self, expr, state, stmt) -> None:
        if expr is None:
            return
        for node in _expr_nodes(expr):
            if isinstance(node, (ast.Yield, ast.YieldFrom)):
                if node.value is not None:
                    self._escape_names(
                        node.value, state, "caller", node.lineno
                    )
                continue
            if not isinstance(node, ast.Call):
                continue
            fname = dotted_name(node.func)
            last = _last_seg(fname)
            recv = (
                node.func.value
                if isinstance(node.func, ast.Attribute)
                else None
            )
            recv_name = recv.id if isinstance(recv, ast.Name) else None
            # r.release() / store.close() / writer.abort() / t.join()
            if recv_name is not None and recv_name in state:
                res = state[recv_name]
                if node.func.attr in res.proto.release_methods:
                    self._release(res, node.lineno, state)
                    continue
                if res.proto.kind == "thread" and node.func.attr == "start":
                    # replace, never mutate: state snapshots on earlier
                    # edges/branches share Resource objects, and arming
                    # in place would arm them retroactively
                    state[recv_name] = dataclasses.replace(res, armed=True)
                    continue
            # release_staged(r)-style helpers
            if last in _ALL_RELEASE_FUNCS:
                for name in _names_in_call_args(node):
                    res = state.get(name)
                    if res is not None and last in res.proto.release_funcs:
                        self._release(res, node.lineno, state)
                continue
            # sanctioned owner calls: win.push(r), q.put(r), self._put(r)
            arg_names = _names_in_call_args(node)
            tracked = [state[n] for n in arg_names if n in state]
            if tracked:
                attr_or_last = (
                    node.func.attr
                    if isinstance(node.func, ast.Attribute)
                    else last
                )
                for res in tracked:
                    if attr_or_last in res.proto.owner_calls:
                        self._record_escape(
                            res.var, res.proto, node.lineno,
                            f"owner call `{attr_or_last}`",
                        )
                        state.pop(res.var, None)
                    elif (
                        attr_or_last in _CONTAINER_ADDERS
                        and isinstance(node.func, ast.Attribute)
                        and self._receiver_owner_attr(node.func.value, res)
                    ):
                        self._record_escape(
                            res.var, res.proto, node.lineno,
                            "owner container "
                            f"`{self._receiver_owner_attr(node.func.value, res)}`",
                        )
                        state.pop(res.var, None)

    @staticmethod
    def _receiver_owner_attr(recv, res: Resource):
        """`_req_threads` for ``self._req_threads.append(t)`` when that
        attribute is a sanctioned owner slot of the resource's protocol."""
        if isinstance(recv, ast.Attribute) and recv.attr in res.proto.owner_attrs:
            return recv.attr
        return None

    def _release(self, res: Resource, line: int, state) -> None:
        self.an.releases.append(
            {
                "kind": res.proto.kind,
                "var": res.var,
                "line": line,
                "acquired_line": res.line,
                "function": self.qual,
            }
        )
        state.pop(res.var, None)

    def _record_escape(self, var, proto, line, to) -> None:
        self.an.escapes.append(
            {
                "kind": proto.kind,
                "var": var,
                "line": line,
                "to": to,
                "function": self.qual,
            }
        )

    def _escape_names(self, expr, state, to, line) -> None:
        for name in _names_in(expr):
            res = state.get(name)
            if res is not None:
                self._record_escape(res.var, res.proto, line, to)
                state.pop(name, None)
                if to == "caller" and self.returns_resource is None:
                    self.returns_resource = res.proto

    # -- owner annotations ---------------------------------------------------

    def _annotated_site(self, node):
        return self.an.owner_ann.get(getattr(node, "lineno", None))

    def _use_annotation(self, node, state) -> None:
        self.an.ann_used.add(node.lineno)

    def _apply_owner_annotation(self, node, state) -> None:
        """A `# ksel: owner[<site>]` on a statement's first line
        transfers every tracked resource referenced by the statement to
        the named site (which must be registered)."""
        line = getattr(node, "lineno", None)
        site = self.an.owner_ann.get(line)
        if site is None:
            return
        names = _names_in(node) & set(state)
        if not names:
            return
        self.an.ann_used.add(line)
        if site not in _rp.OWNER_SITES:
            self.an.finding(
                line,
                "KSL019",
                f"`# ksel: owner[{site}]` names an unregistered owner "
                "site (registered: "
                f"{sorted(_rp.OWNER_SITES)}) — register it in "
                "resource_protocols.OWNER_SITES or fix the name",
            )
        for name in sorted(names):
            res = state.pop(name)
            self._record_escape(
                res.var, res.proto, line, f"declared owner `{site}`"
            )

    # -- compound statements -------------------------------------------------

    def _if(self, node, state):
        self._effects(node.test, state, node)
        self._apply_owner_annotation(node, state)
        out = _outcomes()
        if self._may_raise(node.test):
            out["raises"].append(dict(state))
        t_state, e_state = self._narrow(node.test, state)
        b1 = self._seq(node.body, t_state)
        b2 = self._seq(node.orelse, e_state)
        for k in ("returns", "raises", "breaks", "continues"):
            out[k].extend(b1[k])
            out[k].extend(b2[k])
        out["fall"] = _merge(b1["fall"], b2["fall"])
        return out

    def _while(self, node, state):
        self._effects(node.test, state, node)
        out = _outcomes()
        if self._may_raise(node.test):
            out["raises"].append(dict(state))
        then_state, else_state = self._narrow(node.test, state)
        b1 = self._seq(node.body, dict(then_state))
        back = _merge(b1["fall"], *b1["continues"])
        entry2 = _merge(then_state, back)
        b2 = self._seq(node.body, dict(entry2)) if entry2 is not None else b1
        for k in ("returns", "raises"):
            out[k].extend(b1[k])
            out[k].extend(b2[k])
        infinite = (
            isinstance(node.test, ast.Constant) and bool(node.test.value)
        )
        exits = list(b2["breaks"])
        if not infinite:
            exits.append(else_state)
            exits.append(_merge(b2["fall"], *b2["continues"]))
        if node.orelse:
            oe = self._seq(node.orelse, _merge(*exits) or {})
            for k in ("returns", "raises", "breaks", "continues"):
                out[k].extend(oe[k])
            out["fall"] = oe["fall"]
        else:
            out["fall"] = _merge(*exits) if exits else None
        return out

    def _for(self, node, state):
        self._effects(node.iter, state, node)
        out = _outcomes()
        if self._may_raise(node.iter):
            out["raises"].append(dict(state))

        def bind_target(s):
            for el in ast.walk(node.target):
                if isinstance(el, ast.Name) and el.id in s:
                    self._overwrite(s.pop(el.id), node.lineno, "rebound")

        entry = dict(state)
        bind_target(entry)
        b1 = self._seq(node.body, dict(entry))
        back = _merge(b1["fall"], *b1["continues"])
        entry2 = _merge(entry, back)
        if entry2 is not None:
            entry2 = dict(entry2)
            bind_target(entry2)  # the loop-carried rebind check
            b2 = self._seq(node.body, entry2)
        else:
            b2 = b1
        for k in ("returns", "raises"):
            out[k].extend(b1[k])
            out[k].extend(b2[k])
        exits = list(b2["breaks"]) + [
            dict(state), _merge(b2["fall"], *b2["continues"])
        ]
        if node.orelse:
            oe = self._seq(node.orelse, _merge(*exits) or {})
            for k in ("returns", "raises", "breaks", "continues"):
                out[k].extend(oe[k])
            out["fall"] = oe["fall"]
        else:
            out["fall"] = _merge(*exits)
        return out

    def _with(self, node, state):
        out = _outcomes()
        for item in node.items:
            self._effects(item.context_expr, state, node)
            # a context-managed acquire (`with SpillStore() as s:`) is
            # the sanctioned scoped form — __exit__ releases on every
            # path, so it is never ADDED to the state; OTHER live
            # resources still ride the context expressions' raise edges
        self._apply_owner_annotation(node, state)
        if any(self._may_raise(item.context_expr) for item in node.items):
            out["raises"].append(dict(state))
        body = self._seq(node.body, state)
        for k in ("returns", "raises", "breaks", "continues"):
            out[k].extend(body[k])
        out["fall"] = body["fall"]
        return out

    def _try(self, node, state):
        body = self._seq(node.body, state)
        raise_entry = _merge(*body["raises"]) if body["raises"] else None
        out = _outcomes()
        handler_falls = []
        broad = False
        for h in node.handlers:
            broad = broad or self._is_broad(h)
            if raise_entry is None:
                continue
            ho = self._seq(h.body, dict(raise_entry))
            for k in ("returns", "raises", "breaks", "continues"):
                out[k].extend(ho[k])
            handler_falls.append(ho["fall"])
        # else-clause runs on the body's normal fall
        if node.orelse and body["fall"] is not None:
            oe = self._seq(node.orelse, body["fall"])
            for k in ("returns", "raises", "breaks", "continues"):
                out[k].extend(oe[k])
            normal_fall = oe["fall"]
        else:
            normal_fall = body["fall"]
        for k in ("returns", "breaks", "continues"):
            out[k].extend(body[k])
        # an exception may dodge every TYPED handler; only a broad
        # handler (bare / Exception / BaseException) absorbs the edge
        if raise_entry is not None and (not node.handlers or not broad):
            out["raises"].append(dict(raise_entry))
        pre_fall = _merge(normal_fall, *handler_falls)
        if not node.finalbody:
            out["fall"] = pre_fall
            return out
        # finally: applied to every outcome
        final_out = _outcomes()

        def through_finally(s):
            if s is None:
                return None
            f = self._seq(node.finalbody, dict(s))
            for k in ("returns", "raises", "breaks", "continues"):
                final_out[k].extend(f[k])
            return f["fall"]

        final_out["fall"] = through_finally(pre_fall)
        for k in ("returns", "raises", "breaks", "continues"):
            for s in out[k]:
                fs = through_finally(s)
                if fs is not None:
                    final_out[k].append(fs)
        return final_out

    @staticmethod
    def _is_broad(handler: ast.ExceptHandler) -> bool:
        if handler.type is None:
            return True
        types = (
            handler.type.elts
            if isinstance(handler.type, ast.Tuple)
            else [handler.type]
        )
        return any(
            _last_seg(dotted_name(t)) in ("Exception", "BaseException")
            for t in types
        )

    # -- branch narrowing ----------------------------------------------------

    def _narrow(self, test, state):
        then, els = dict(state), dict(state)
        self._narrow_into(test, then, els)
        return then, els

    def _narrow_into(self, test, then, els) -> None:
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            self._narrow_into(test.operand, els, then)
            return
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
            # every conjunct narrows the then-branch; the else branch
            # stays unnarrowed (any conjunct may have failed)
            for v in test.values:
                self._narrow_into(v, then, dict(els))
            return
        if (
            isinstance(test, ast.Call)
            and _last_seg(dotted_name(test.func)) == "isinstance"
            and len(test.args) == 2
            and isinstance(test.args[0], ast.Name)
        ):
            var = test.args[0].id
            res = then.get(var) or els.get(var)
            if res is None:
                return
            tnames = {
                _last_seg(dotted_name(t))
                for t in (
                    test.args[1].elts
                    if isinstance(test.args[1], ast.Tuple)
                    else [test.args[1]]
                )
            }
            if tnames & res.proto.types:
                # tracked value IS of the protocol type: the else branch
                # never sees it
                els.pop(var, None)
            else:
                then.pop(var, None)
            return
        if (
            isinstance(test, ast.Compare)
            and len(test.ops) == 1
            and isinstance(test.left, ast.Name)
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None
        ):
            var = test.left.id
            if isinstance(test.ops[0], ast.Is):
                then.pop(var, None)  # tracked resource is never None
            elif isinstance(test.ops[0], ast.IsNot):
                els.pop(var, None)


def _names_in_call_args(call: ast.Call) -> set:
    out = set()
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        out |= _names_in(arg)
    return out


# ---------------------------------------------------------------------------
# module orchestration


@dataclasses.dataclass
class ModuleLifecycle:
    mod: SourceModule
    findings: set  # {(line, rule, message)}
    acquires: list
    releases: list
    escapes: list
    annotations: list  # [{"line", "site", "used"}]


class _ModuleLifecycleAnalyzer:
    def __init__(self, mod: SourceModule):
        self.mod = mod
        self.rel = _pkg_relpath(mod)
        self._findings: set = set()
        self.acquires: list = []
        self.releases: list = []
        self.escapes: list = []
        self.ann_used: set = set()
        self.extra_acquirers: dict = {}
        in_string = mod.string_literal_lines()
        self.owner_ann = {
            lineno: m.group("site")
            for lineno, line in enumerate(mod.lines, start=1)
            if lineno not in in_string
            for m in [_OWNER_RE.search(line)]
            if m is not None
        }
        # pass 1: discover module-local acquire-returning functions
        returns = self._run_all()
        if returns:
            # pass 2: their single-name-assignment callers are acquirers
            self.extra_acquirers = returns
            self._reset()
            self._run_all()
        self._audit_annotations()

    def _reset(self) -> None:
        self._findings.clear()
        self.acquires.clear()
        self.releases.clear()
        self.escapes.clear()
        self.ann_used.clear()

    def finding(self, line, rule, message) -> None:
        self._findings.add((line, rule, message))

    def _functions(self):
        """Every function def with a qualname (Class.method for methods,
        bare name elsewhere — matching the concurrency pass)."""
        qual: dict[int, str] = {}
        for node in ast.walk(self.mod.tree):
            if isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        qual[id(item)] = f"{node.name}.{item.name}"
        for node in ast.walk(self.mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node, qual.get(id(node), node.name)

    def _run_all(self) -> dict:
        returns: dict = {}
        for fn, qualname in self._functions():
            w = _FunctionLifecycle(self, fn, qualname)
            w.run()
            if w.returns_resource is not None:
                returns[fn.name] = w.returns_resource
        return returns

    def _audit_annotations(self) -> None:
        for line, site in sorted(self.owner_ann.items()):
            if line in self.ann_used:
                continue
            known = site in _rp.OWNER_SITES
            detail = (
                "no tracked resource moves on this line"
                if known
                else f"unregistered site (registered: {sorted(_rp.OWNER_SITES)})"
            )
            self.finding(
                line,
                "KSL019",
                f"stale `# ksel: owner[{site}]` annotation: {detail} — "
                "drop the annotation or fix the transfer (the guarded-by "
                "staleness contract, applied to ownership)",
            )

    @staticmethod
    def _dedupe(records: list) -> list:
        """The loop fixpoint walks bodies twice; the report carries each
        site once."""
        seen, out = set(), []
        for r in records:
            key = tuple(sorted(r.items()))
            if key not in seen:
                seen.add(key)
                out.append(r)
        return out

    def result(self) -> ModuleLifecycle:
        annotations = [
            {
                "line": line,
                "site": site,
                "used": line in self.ann_used,
            }
            for line, site in sorted(self.owner_ann.items())
        ]
        return ModuleLifecycle(
            self.mod,
            self._findings,
            self._dedupe(self.acquires),
            self._dedupe(self.releases),
            self._dedupe(self.escapes),
            annotations,
        )


# one analysis per module per scan (rules run back to back on the same
# SourceModule objects; keyed by object identity like the concurrency
# pass's cache)
_CACHE: dict[int, ModuleLifecycle] = {}


def analyze_lifecycle(mod: SourceModule) -> ModuleLifecycle:
    got = _CACHE.get(id(mod))
    if got is None or got.mod is not mod:
        if len(_CACHE) > 4096:
            _CACHE.clear()
        got = _ModuleLifecycleAnalyzer(mod).result()
        _CACHE[id(mod)] = got
    return got


# ---------------------------------------------------------------------------
# the rules


class _LifecycleRule(Rule):
    def check_module(self, mod: SourceModule):
        if not _in_package(mod):
            return
        lc = analyze_lifecycle(mod)
        for line, rule, message in sorted(lc.findings):
            if rule == self.id:
                yield line, message


@register
class StagedBufferLifecycle(_LifecycleRule):
    id = "KSL019"
    title = (
        "staged key buffer (stage_keys/stage_device_keys) not released "
        "or escaped to a sanctioned owner on every CFG path; also the "
        "owner-annotation staleness audit"
    )
    rationale = (
        "A StagedKeys ring slot pins a device buffer (and often a "
        "StagingPool host buffer) until release(); a path that drops one "
        "— an exception edge out of the producer, a rebound loop "
        "variable — leaks exactly the memory the multi-tenant budgeting "
        "work needs to account, and the runtime fixture only sees it "
        "when a test happens to walk that path. This pass proves the "
        "discipline on EVERY path at lint time; the first whole-repo run "
        "found the producer's outer exception handler dropping the "
        "chunk in hand (streaming/pipeline.py, fixed with a release on "
        "the raise edge + a regression test)."
    )


@register
class SpillLifecycle(_LifecycleRule):
    id = "KSL020"
    title = (
        "internally-constructed SpillStore/generation writer/temp dir "
        "not cleaned up (close/abort/commit/cleanup) on every exit path "
        "including raise edges"
    )
    rationale = (
        "An internally-created spill store owns a ksel-spill-* directory "
        "holding up to ~2N key bytes; a writer owns an uncommitted "
        "generation. An exit path that skips close()/abort() strands "
        "that disk — the conftest dir fixture catches it only on paths "
        "tests actually take, and a long-lived server leaks until "
        "restart. The first whole-repo run found the CLI building its "
        "--spill=force store BEFORE entering the try whose finally "
        "closes it (a chaos-armed constructor failure stranded the dir; "
        "fixed by hoisting the try)."
    )


@register
class ThreadLifecycle(_LifecycleRule):
    id = "KSL021"
    title = (
        "started ksel-named thread neither join()ed on every exit nor "
        "registered with a tracked supervisor slot"
    )
    rationale = (
        "Every package worker thread carries the ksel- prefix precisely "
        "so the conftest fixture can fail tests that leak one; a START "
        "site whose thread object reaches no join and no supervisor "
        "slot (ChunkPipeline._thread, the servers' _serve_thread / "
        "_req_threads) has no close path AT ALL — the leak is "
        "structural, not a missed branch. Unstarted Thread objects hold "
        "no OS resources, so the obligation arms at .start(); the "
        "supervisor slots are the same registry "
        "(resource_protocols.THREAD_OWNER_ATTRS) the runtime fixture "
        "vocabulary comes from."
    )


# ---------------------------------------------------------------------------
# the exported report (--lifecycle-report)


def build_lifecycle_report(paths, root=None, mods=None) -> dict:
    """The package ownership graph as one JSON-ready dict — acquire
    sites, release sites and escape edges per module, the owner-site
    registry, and the annotation ledger. Paths are package-relative
    (``mpi_k_selection_tpu_torch/...``) and cwd-independent, exactly like the
    concurrency report. Pass ``mods`` (an already-loaded SourceModule
    list, e.g. ``Report.modules``) to skip re-parsing."""
    if mods is None:
        mods = []
        for f in iter_python_files(paths):
            try:
                mods.append(load_module(f, root=root))
            except SyntaxError:
                continue
    resources: dict = {}
    annotations: dict = {}
    for mod in mods:
        if not _in_package(mod):
            continue
        lc = analyze_lifecycle(mod)
        rel = _pkg_relpath(mod)
        if lc.acquires or lc.releases or lc.escapes:
            resources[rel] = {
                "acquires": lc.acquires,
                "releases": lc.releases,
                "escapes": lc.escapes,
            }
        if lc.annotations:
            annotations[rel] = lc.annotations
    return {
        "resources": resources,
        "annotations": annotations,
        "owners": {
            "sites": dict(sorted(_rp.OWNER_SITES.items())),
            "thread_owner_attrs": sorted(_rp.THREAD_OWNER_ATTRS),
            "staged_owner_calls": sorted(_rp.STAGED_OWNER_CALLS),
            "spill_owner_attrs": sorted(_rp.SPILL_OWNER_ATTRS),
        },
        "prefixes": {
            "threads": list(_rp.THREAD_PREFIXES),
            "spill_dirs": _rp.SPILL_DIR_PREFIX,
            "flight_files": _rp.FLIGHT_FILE_PREFIX,
        },
    }
