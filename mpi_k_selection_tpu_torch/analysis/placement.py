"""Device-placement dataflow pass (KSL022-KSL024), in torch's vocabulary
(counterpart of ``mpi_k_selection_tpu/analysis/placement.py``).

The streamed descent's discipline: staged chunk *j* lives on
``devices[j % p]``, a bucket's kernels launch on the bucket's own card,
and spill replay re-stages every record onto its recorded slot. This
pass proves it statically over an abstract **placement lattice** per
value:

    ``unknown``      no information (bottom; joins absorb it)
    ``none``         explicitly no placement (the uncommitted default)
    ``host``         a host-side value (``.cpu()``, ``.numpy()``, ``.item()``)
    ``device(slot)`` on one slot expression
    ``slots``        a resolved device tuple (resolve_stream_devices)
    ``round-robin``  slots indexed by chunk position (``devs[j % p]``)
    ``inherited``    a device chunk's own device
    ``top``          conflicting placements met (the finding state)

seeded at the placement sources (``stage_chunk(c, dtype, device)``,
``.to(<device>)``, ``.cuda(<index>)``, ``resolve_stream_devices``,
``.device`` reads) and propagated through assignments, one
interprocedural hop and container round-trips, loop bodies walked twice.

The torch crossing vocabulary (resource_protocols.py): ``.to(<device>)``
(a ``device=`` keyword, or a first argument that names a device, not a
dtype), ``.cuda()``, ``.cpu()``, ``.numpy()``, ``.item()``, ``.tolist()``
and ``copy_(..., non_blocking=...)``.

The rules:

- **KSL022** — dispatch-device mismatch: one kernel wrapper call
  consuming operands from two slots, a ``top`` placement reaching a
  dispatch, or a resolved device tuple dropped under a condition on the
  tuple itself; also the ``# ksel-torch: placed-on[...]`` audit.
- **KSL023** — unsanctioned transfer: a crossing in streaming/, serve/,
  monitor/, ops/ or parallel/ at a module outside
  ``resource_protocols.SANCTIONED_TRANSFER_SITES``.
- **KSL024** — placement nondeterminism: a device target that depends on
  a clock, thread identity, randomness or set iteration order.

Declared intent rides ``# ksel-torch: placed-on[<slot-expr>] -- why`` on
the site line; it overrides the verdict there and is audited: on a line
with no dispatch, crossing or device target it is itself a finding.

KSC105 (analysis/contracts.py) joins :func:`static_census` with the
recorded slot streams.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

from mpi_k_selection_tpu_torch import resource_protocols as _rp
from mpi_k_selection_tpu_torch.analysis.ast_rules import (
    _function_defs,
    dotted_name,
)
from mpi_k_selection_tpu_torch.analysis.concurrency import _in_package, _pkg_relpath
from mpi_k_selection_tpu_torch.analysis.core import Rule, SourceModule, register

_PKG = "mpi_k_selection_tpu_torch"


def _scoped_relpath(mod: SourceModule) -> str:
    """``streaming/pipeline.py``-style path (the package segment
    stripped) — the key form of ``SANCTIONED_TRANSFER_SITES`` and the
    join key against KSC104's census module paths."""
    rel = _pkg_relpath(mod)
    return rel.split("/", 1)[1] if rel.startswith(_PKG + "/") else rel

# ---------------------------------------------------------------------------
# the lattice

_PLACED_KINDS = frozenset({"device", "slots", "round-robin", "inherited"})
_DROPPABLE = frozenset({"none", "host", "unknown"})


@dataclasses.dataclass(frozen=True)
class Placement:
    """One lattice point. ``slot`` is the source text of the slot (or
    tuple) expression; ``reason`` explains a ``top``."""

    kind: str
    slot: str = ""
    reason: str = ""

    def show(self) -> str:
        return f"{self.kind}({self.slot})" if self.slot else self.kind


UNKNOWN = Placement("unknown")
NONE = Placement("none")
HOST = Placement("host")
INHERITED = Placement("inherited")


def join(a: Placement, b: Placement) -> Placement:
    """Lattice join. ``unknown`` is bottom and ``none`` (no explicit
    placement) folds optimistically into a placed value — the
    *conditional* drop of a placed value is judged separately with the
    condition in hand (see ``_FunctionPlacement._merge_cond``), so the
    plain join stays optimistic and the pass stays quiet on the
    sanctioned depth-gated host paths."""
    if a == b:
        return a
    for x, y in ((a, b), (b, a)):
        if x.kind == "top":
            return x
        if x.kind == "unknown":
            return y
    for x, y in ((a, b), (b, a)):
        if x.kind == "none":
            return y
    return Placement("top", reason=f"{a.show()} vs {b.show()}")


# ---------------------------------------------------------------------------
# `# ksel: placed-on[<slot-expr>] -- why` annotations

_PLACED_RE = re.compile(
    r"#\s*ksel(?:-torch)?:\s*placed-on\[(?P<slot>[^\]]+)\]"
    r"(?:\s*--\s*(?P<why>.*\S))?"
)


def _names_in(node) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


# ---------------------------------------------------------------------------
# the per-function engine


class _FunctionPlacement:
    """Abstract interpretation of one function body over the placement
    lattice. ``record=False`` is the pass-1 walk that only computes the
    function's return placement (the interprocedural seed); pass 2
    re-runs with the module's placed-returning functions in ``extra``
    and records sites + findings."""

    def __init__(self, owner: "_ModulePlacement", fn, extra, record: bool):
        self.o = owner
        self.fn = fn
        self.extra = extra
        self.record = record
        self.env: dict[str, Placement] = {}
        self.defs: dict[str, ast.expr] = {}
        self.return_placement = UNKNOWN

    def run(self):
        self._seq(self.fn.body)
        return self

    # -- statements ---------------------------------------------------------

    def _seq(self, body):
        for st in body:
            self._stmt(st)

    def _stmt(self, st):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # analyzed as their own functions
        if isinstance(st, ast.Assign):
            v = self._eval(st.value)
            for t in st.targets:
                self._bind(t, v, st.value)
        elif isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self._bind(st.target, self._eval(st.value), st.value)
        elif isinstance(st, ast.AugAssign):
            self._eval(st.value)  # x += e never re-places x
        elif isinstance(st, (ast.Return,)):
            if st.value is not None:
                self.return_placement = join(
                    self.return_placement, self._eval(st.value)
                )
        elif isinstance(st, ast.Expr):
            self._eval(st.value)
        elif isinstance(st, ast.If):
            self._eval(st.test)
            before = dict(self.env)
            self._seq(st.body)
            after_body = self.env
            self.env = dict(before)
            self._seq(st.orelse)
            after_else = self.env
            merged = {}
            for name in set(after_body) | set(after_else):
                merged[name] = self._merge_cond(
                    after_body.get(name, UNKNOWN),
                    after_else.get(name, UNKNOWN),
                    st.test,
                )
            self.env = merged
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            self._eval(st.iter)
            tv = UNKNOWN
            if isinstance(st.iter, ast.Name):  # iterating a container
                tv = self.env.get(st.iter.id + "@contents", UNKNOWN)
            for _sweep in (0, 1):  # twice: loop-carried slots converge
                self._bind(st.target, tv, None)
                self._seq(st.body)
            self._seq(st.orelse)
        elif isinstance(st, ast.While):
            self._eval(st.test)
            for _sweep in (0, 1):
                self._seq(st.body)
            self._seq(st.orelse)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                v = self._eval(item.context_expr)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, v, item.context_expr)
            self._seq(st.body)
        elif isinstance(st, ast.Try):
            self._seq(st.body)
            for h in st.handlers:
                if h.name:
                    self.env[h.name] = UNKNOWN
                self._seq(h.body)
            self._seq(st.orelse)
            self._seq(st.finalbody)
        elif isinstance(st, (ast.Raise, ast.Assert, ast.Delete)):
            for c in ast.iter_child_nodes(st):
                if isinstance(c, ast.expr):
                    self._eval(c)
        # pass/break/continue/global/import: nothing placed moves

    def _bind(self, target, placement: Placement, value_node):
        if isinstance(target, ast.Name):
            self.env[target.id] = placement
            if value_node is not None:
                self.defs[target.id] = value_node
        elif isinstance(target, (ast.Tuple, ast.List)):
            elts = (
                value_node.elts
                if isinstance(value_node, (ast.Tuple, ast.List))
                and len(value_node.elts) == len(target.elts)
                else None
            )
            for i, t in enumerate(target.elts):
                if elts is not None:
                    self._bind(t, self._eval(elts[i]), elts[i])
                else:
                    self._bind(t, UNKNOWN, None)
        elif isinstance(target, ast.Attribute):
            d = dotted_name(target)
            if d:
                self.env[d] = placement
        elif isinstance(target, ast.Starred):
            self._bind(target.value, UNKNOWN, None)
        # subscript targets don't re-place their base

    # -- conditional drops ---------------------------------------------------

    def _merge_cond(self, a: Placement, b: Placement, test) -> Placement:
        """Join two branch placements under ``test``. Dropping a placed
        value to None/host on one branch is sanctioned only when the
        condition is placement-independent (a depth knob, the raw
        ``devices`` argument) — a condition that depends on the resolved
        placement itself (``len(devs) > 1``) is the single-device
        silent-host-fallback bug class and joins to ``top``."""
        placed, other = (a, b) if a.kind in _PLACED_KINDS else (b, a)
        if (
            placed.kind in _PLACED_KINDS
            and other.kind in _DROPPABLE
            and other.kind != "unknown"
            and test is not None
            and self._cond_depends_on_placed(test)
        ):
            return Placement(
                "top",
                slot=placed.slot,
                reason=(
                    f"resolved placement {placed.show()} is dropped under a "
                    "condition that depends on the placement itself — gate "
                    "the host path on a placement-independent knob "
                    "(pipeline depth, the raw devices argument) instead"
                ),
            )
        return join(a, b)

    def _cond_depends_on_placed(self, test) -> bool:
        for name in _names_in(test):
            if self.env.get(name, UNKNOWN).kind in _PLACED_KINDS:
                return True
            rhs = self.defs.get(name)  # one hop: `multi = len(devs) > 1 ...`
            if rhs is not None:
                for m in _names_in(rhs):
                    if self.env.get(m, UNKNOWN).kind in _PLACED_KINDS:
                        return True
        return False

    # -- expressions ---------------------------------------------------------

    def _txt(self, node) -> str:
        seg = self.o.mod.segment(node)
        if seg:
            return " ".join(seg.split())
        try:
            return ast.unparse(node)
        except Exception:  # pragma: no cover - unparse is total on exprs
            return "<expr>"

    def _eval(self, node) -> Placement:
        if node is None:
            return UNKNOWN
        if isinstance(node, ast.Constant):
            return NONE if node.value is None else UNKNOWN
        if isinstance(node, ast.Name):
            return self.env.get(node.id, UNKNOWN)
        if isinstance(node, ast.Attribute):
            self._eval(node.value)
            d = dotted_name(node)
            if d and d in self.env:
                return self.env[d]
            if node.attr == "device":  # StagedKeys.device / array.device
                return Placement("device", slot=self._txt(node))
            return UNKNOWN
        if isinstance(node, ast.Subscript):
            base = self._eval(node.value)
            self._eval(node.slice)
            if base.kind == "slots":
                self._check_nondet(node.slice, "slot index")
                idx = self._txt(node.slice)
                kind = "round-robin" if "%" in idx else "device"
                return Placement(kind, slot=self._txt(node))
            return UNKNOWN
        if isinstance(node, ast.IfExp):
            self._eval(node.test)
            return self._merge_cond(
                self._eval(node.body), self._eval(node.orelse), node.test
            )
        if isinstance(node, (ast.Tuple, ast.List)):
            placed = [
                p for p in (self._eval(e) for e in node.elts)
                if p.kind in _PLACED_KINDS
            ]
            # a tuple carries its single placed element's slot through a
            # container round-trip; a mixed tuple (the devs tuple itself)
            # is not a placement conflict
            if placed and all(p == placed[0] for p in placed):
                return placed[0]
            return UNKNOWN
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.BoolOp):
            for v in node.values:
                self._eval(v)
            return UNKNOWN
        for c in ast.iter_child_nodes(node):
            if isinstance(c, ast.expr):
                self._eval(c)
        return UNKNOWN

    def _kwnode(self, node, *names):
        for kw in node.keywords:
            if kw.arg in names:
                return kw.value
        return None

    def _call(self, node: ast.Call) -> Placement:
        name = dotted_name(node.func) or ""
        last = name.rsplit(".", 1)[-1]
        if isinstance(node.func, ast.Attribute):
            last = node.func.attr
            if not name:  # a method of a call's result: ``t.cpu().numpy()``
                self._eval(node.func.value)
        argp = [self._eval(a) for a in node.args]
        kwp = {}
        for kw in node.keywords:
            v = self._eval(kw.value)
            if kw.arg:
                kwp[kw.arg] = v

        if last in _rp.SLOT_RESOLVER_CALLS:
            return Placement("slots", slot=self._txt(node))
        if last in _rp.INHERIT_STAGE_CALLS:
            return INHERITED
        if last in _rp.STAGE_CALLS:
            tgt = node.args[2] if len(node.args) > 2 else self._kwnode(node, "device")
            return self._target(tgt)
        crossing = crossing_call(node)
        if crossing is not None:
            self._site_crossing(node, crossing)
            if last in _rp.TRANSFER_PUT_METHODS:
                tgt = transfer_target(node)
                return NONE if tgt is None else self._target(tgt)
            return HOST
        if last in _rp.DISPATCH_CALLS:
            self._site_dispatch(node, last, argp, kwp, mismatch=True)
            return UNKNOWN
        if last in _rp.DEVICE_THREADING_CALLS:
            self._site_dispatch(node, last, argp, kwp, mismatch=False)
            return UNKNOWN
        if isinstance(node.func, ast.Attribute):
            recv = dotted_name(node.func.value)
            if recv:  # container round-trips keep the pushed slot
                if last in ("push", "put", "_put", "append", "appendleft", "add"):
                    if argp:
                        key = recv + "@contents"
                        self.env[key] = join(self.env.get(key, UNKNOWN), argp[0])
                    return UNKNOWN
                if last in ("pop", "popleft", "get", "drain", "peek"):
                    return self.env.get(recv + "@contents", UNKNOWN)
        if last in self.extra:  # the one interprocedural hop
            return self.extra[last]
        return UNKNOWN

    def _target(self, tgt_node) -> Placement:
        """Placement of a device-target expression (stage_keys' device
        argument, a ``.to``/``.cuda`` target, a threading call's devices=)."""
        if tgt_node is None:
            return NONE
        self._check_nondet(tgt_node, "device target")
        p = self._eval(tgt_node)
        if p.kind in _PLACED_KINDS or p.kind == "top":
            return p
        if isinstance(tgt_node, ast.Constant) and tgt_node.value is None:
            return NONE
        return Placement("device", slot=self._txt(tgt_node))

    # -- site checks ---------------------------------------------------------

    def _site_crossing(self, node, name):
        if not self.record:
            return
        self.o.note_site(node.lineno)
        rel = _scoped_relpath(self.o.mod)
        sanctioned = rel in _rp.SANCTIONED_TRANSFER_SITES
        self.o.crossing_sites.append(
            {"line": node.lineno, "call": name, "sanctioned": sanctioned}
        )
        if not sanctioned:
            self.o.emit(
                node.lineno,
                "KSL023",
                f"`{name}` host<->device crossing at {rel}, which is not a "
                "sanctioned transfer site — route the transfer through the "
                "staging boundary (streaming/pipeline.py) or register the "
                "module in resource_protocols.SANCTIONED_TRANSFER_SITES "
                "with a written reason",
            )

    def _site_dispatch(self, node, name, argp, kwp, *, mismatch: bool):
        if not self.record:
            return
        self.o.note_site(node.lineno)
        operands = list(argp)
        for k in ("device", "devices"):
            if k in kwp:
                operands.append(kwp[k])
        slots = sorted(
            {p.slot for p in operands if p.kind in ("device", "round-robin")}
        )
        self.o.dispatch_sites.append(
            {
                "line": node.lineno,
                "call": name,
                "kind": "dispatch" if mismatch else "threading",
                "slots": slots,
            }
        )
        if mismatch and len(slots) > 1:
            self.o.emit(
                node.lineno,
                "KSL022",
                f"`{name}` dispatch consumes operands placed on different "
                f"slots ({', '.join(slots)}) — one program dispatch, one "
                "device; thread the bucket's own slot",
            )
        for p in operands:
            if p.kind == "top":
                self.o.emit(
                    node.lineno,
                    "KSL022",
                    f"`{name}` consumes a conflicting placement: {p.reason}",
                )

    def _check_nondet(self, expr, context: str):
        if not self.record:
            return
        self.o.note_site(getattr(expr, "lineno", self.fn.lineno))

        def scan(e, hop_left):
            for sub in ast.walk(e):
                if isinstance(sub, ast.Call):
                    dn = dotted_name(sub.func) or ""
                    ln = dn.rsplit(".", 1)[-1]
                    if dn in _rp.NONDET_PLACEMENT_CALLS or (
                        ln in ("get_ident", "current_thread", "urandom",
                               "uuid1", "uuid4")
                    ):
                        self.o.emit(
                            getattr(sub, "lineno", expr.lineno),
                            "KSL024",
                            f"{context} depends on `{dn or ln}` — device "
                            "choice must be a pure function of chunk index, "
                            "an explicit knob or a recorded slot, or spill "
                            "replay cannot re-stage deterministically",
                        )
                    elif dn in _rp.UNORDERED_CONSTRUCTORS:
                        self.o.emit(
                            getattr(sub, "lineno", expr.lineno),
                            "KSL024",
                            f"{context} drawn from a `{dn}` — set/dict "
                            "iteration order is no contract; a device index "
                            "must come from an ordered, recorded source",
                        )
                elif isinstance(sub, ast.Name) and hop_left:
                    rhs = self.defs.get(sub.id)
                    if rhs is not None and rhs is not e:
                        scan(rhs, hop_left - 1)

        scan(expr, 1)


# ---------------------------------------------------------------------------
# the per-module analyzer


class _ModulePlacement:
    def __init__(self, mod: SourceModule):
        self.mod = mod
        self.findings: set[tuple[int, str, str]] = set()
        self.dispatch_sites: list[dict] = []
        self.crossing_sites: list[dict] = []
        self.annotations: dict[int, tuple[str, str]] = {}
        self.site_lines: set[int] = set()
        in_string = mod.string_literal_lines()
        for i, text in enumerate(mod.lines, start=1):
            if i in in_string:
                continue
            m = _PLACED_RE.search(text)
            if m:
                self.annotations[i] = (
                    m.group("slot").strip(),
                    (m.group("why") or "").strip(),
                )

    def note_site(self, line: int):
        self.site_lines.add(line)

    def emit(self, line: int, rule: str, message: str):
        if line in self.annotations:
            return  # declared placement overrides; audited below
        self.findings.add((line, rule, message))

    def run(self) -> "_ModulePlacement":
        fns = [
            fn for defs in _function_defs(self.mod.tree).values() for fn in defs
        ]
        returns: dict[str, Placement] = {}
        for fn in fns:  # pass 1: placed-returning functions
            eng = _FunctionPlacement(self, fn, {}, record=False).run()
            if eng.return_placement.kind in _PLACED_KINDS:
                returns[fn.name] = eng.return_placement
        for fn in fns:  # pass 2: sites + findings, with the hop seeded
            _FunctionPlacement(self, fn, returns, record=True).run()
        self._audit_annotations()
        return self

    def _audit_annotations(self):
        for line, (slot, _why) in sorted(self.annotations.items()):
            if line not in self.site_lines:
                self.findings.add(
                    (
                        line,
                        "KSL022",
                        f"stale `# ksel: placed-on[{slot}]`: no dispatch, "
                        "crossing or device-target expression on this line "
                        "— placement annotations must sit on the site they "
                        "sanction",
                    )
                )


_CACHE: dict[int, _ModulePlacement] = {}


def analyze_placement(mod: SourceModule) -> _ModulePlacement:
    key = id(mod)
    hit = _CACHE.get(key)
    if hit is None:
        if len(_CACHE) > 4096:  # pragma: no cover - bound, not a policy
            _CACHE.clear()
        hit = _CACHE[key] = _ModulePlacement(mod).run()
    return hit


# ---------------------------------------------------------------------------
# scope, the torch crossing vocabulary and the KSL007 source model

_SCOPED_PACKAGES = ("streaming", "serve", "monitor", "ops", "parallel")


def _in_scope(mod: SourceModule) -> bool:
    if not _in_package(mod):
        return False
    return _scoped_relpath(mod).split("/", 1)[0] in _SCOPED_PACKAGES


def _names_a_device(node) -> bool:
    """Whether the first argument of ``.to(...)`` names a device (not a
    dtype or another tensor): a device string, ``torch.device(...)``, a
    ``.device`` read, or a name or subscript of a name that says ``dev``."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.split(":")[0] in ("cuda", "cpu", "meta")
    if isinstance(node, ast.Call):
        return (dotted_name(node.func) or "").endswith("device")
    if isinstance(node, ast.Attribute):
        return node.attr == "device"
    if isinstance(node, ast.Subscript):
        node = node.value
    return isinstance(node, ast.Name) and "dev" in node.id.lower() and "dtype" not in node.id.lower()


def transfer_target(node: ast.Call):
    """The device expression of a ``.to(...)`` / ``.cuda(...)`` call, or
    None (``.cuda()`` with no index)."""
    for kw in node.keywords:
        if kw.arg in _rp.PUT_TARGET_KWARGS:
            return kw.value
    if node.args and (node.func.attr == "cuda" or _names_a_device(node.args[0])):
        return node.args[0]
    return None


def crossing_call(node: ast.Call):
    """The crossing a call makes (``.cpu()``, ``.to(device)``, ...) in
    the torch vocabulary, or None."""
    if not isinstance(node.func, ast.Attribute):
        return None
    last = node.func.attr
    if last in _rp.CROSSING_METHODS:
        return f".{last}()"
    if last == "to" and transfer_target(node) is not None:
        return ".to(device)"
    if last == "copy_" and any(kw.arg == "non_blocking" for kw in node.keywords):
        return ".copy_(non_blocking)"
    return None


def untargeted_puts(mod: SourceModule):
    """``(line, call)`` for every transfer to a card without an explicit
    device index: ``.cuda()`` with no argument, and ``.to("cuda")`` /
    ``.to(torch.device("cuda"))`` — the tensor lands on the thread's
    current card, whatever slot the chunk was dealt (KSL007's subject)."""
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
            continue
        if node.func.attr not in _rp.TRANSFER_PUT_METHODS:
            continue
        tgt = transfer_target(node)
        if node.func.attr == "cuda" and tgt is None:
            yield node.lineno, ".cuda()"
        elif tgt is not None and _bare_cuda(tgt):
            yield node.lineno, f".{node.func.attr}({ast.unparse(tgt)})"


def _bare_cuda(node) -> bool:
    if isinstance(node, ast.Call) and (dotted_name(node.func) or "").endswith("device") and len(node.args) == 1:
        node = node.args[0]
    return isinstance(node, ast.Constant) and node.value == "cuda"


# ---------------------------------------------------------------------------
# the rules


class _PlacementRule(Rule):
    def check_module(self, mod: SourceModule):
        if not _in_scope(mod):
            return
        result = analyze_placement(mod)
        for line, rule, message in sorted(result.findings):
            if rule == self.id:
                yield line, message


@register
class DispatchDeviceMismatch(_PlacementRule):
    id = "KSL022"
    title = "program dispatch with mismatched or dropped device placement"
    rationale = (
        "The streaming discipline is one bucket, one slot, one program: "
        "staged chunk j commits to devices[j % p] and every program the "
        "bucket feeds launches on that slot. A kernel wrapper given "
        "operands from two slots either raises or needs a silent "
        "cross-card copy mid-pass (the transfer KSC104's census "
        "forbids); a resolved device tuple dropped under a condition "
        "that depends on the tuple itself (`devs if len(devs) > 1 else "
        "None`) silently host-folds an explicitly requested single "
        "device — the caller asked for a placement and got the default. "
        "Declared intent rides `# ksel-torch: placed-on[<slot>]` and is "
        "audited for staleness like owner[]/guarded-by[]."
    )


@register
class UnsanctionedTransfer(_PlacementRule):
    id = "KSL023"
    title = "host<->device crossing outside the sanctioned transfer registry"
    rationale = (
        "Every legitimate host<->device crossing in the streaming/serve/"
        "monitor/ops/parallel vertical lives at a named site: the "
        "staging boundary (streaming/pipeline.py), the executor's "
        "readbacks (streaming/executor.py), the gloo collectives "
        "(parallel/). A .cpu()/.item()/.to(device) anywhere else is "
        "how mid-pass transfers and host syncs sneak in — "
        "the static, path-sensitive generalization of KSL007, keyed on "
        "resource_protocols.SANCTIONED_TRANSFER_SITES so the registry "
        "is one importable table, not a rule's private list."
    )


@register
class PlacementNondeterminism(_PlacementRule):
    id = "KSL024"
    title = "device choice data-dependent on a nondeterministic source"
    rationale = (
        "Spill replay re-stages every record onto its recorded slot, and "
        "recovery is bit-identical only because device choice is a pure "
        "function of chunk index, explicit knobs and recorded slots. A "
        "device target derived from a clock, thread identity, randomness "
        "or set/dict iteration order makes placement unreproducible: the "
        "replay lands on different cards than the pass it replays, "
        "and the flight recorder's "
        "device_slot stream stops describing reality."
    )


# ---------------------------------------------------------------------------
# the exported placement graph


def build_placement_report(paths, root=None, mods=None) -> dict:
    """The placement graph the ``--placement-report`` flag exports:
    per-module dispatch/threading/crossing sites, the annotation ledger
    (with justifications), the sanctioned-transfer registry and the
    lattice vocabulary — package-relative, cwd-independent."""
    from mpi_k_selection_tpu_torch.analysis.core import iter_python_files, load_module

    if mods is None:
        mods = []
        for f in iter_python_files(paths):
            try:
                mods.append(load_module(f, root=root))
            except SyntaxError:
                continue
    placements: dict[str, dict] = {}
    annotations: list[dict] = []
    for mod in mods:
        if not _in_scope(mod):
            continue
        result = analyze_placement(mod)
        rel = _scoped_relpath(mod)
        if result.dispatch_sites or result.crossing_sites:
            placements[rel] = {
                "dispatch_sites": sorted(
                    result.dispatch_sites, key=lambda s: s["line"]
                ),
                "crossing_sites": sorted(
                    result.crossing_sites, key=lambda s: s["line"]
                ),
            }
        for line, (slot, why) in sorted(result.annotations.items()):
            annotations.append(
                {
                    "path": rel,
                    "line": line,
                    "slot": slot,
                    "justification": why,
                    "used": line in result.site_lines,
                }
            )
    return {
        "lattice": [
            "unknown", "none", "host", "device(slot)", "slots",
            "round-robin", "inherited", "top",
        ],
        "placements": placements,
        "annotations": annotations,
        "sanctioned_transfers": dict(_rp.SANCTIONED_TRANSFER_SITES),
        "rules": ["KSL022", "KSL023", "KSL024"],
    }


# ---------------------------------------------------------------------------
# the static half of KSC105 (analysis/contracts.py)


def static_census():
    """(crossing sites by package-relative module, the dispatch names the
    pass saw) over the port's package."""
    from mpi_k_selection_tpu_torch.analysis.core import iter_python_files, load_module

    pkg_root = pathlib.Path(__file__).resolve().parent.parent
    crossings: dict[str, list[dict]] = {}
    dispatch_names: set[str] = set()
    for f in iter_python_files([pkg_root]):
        try:
            mod = load_module(f, root=pkg_root.parent)
        except SyntaxError:
            continue
        if not _in_scope(mod):
            continue
        result = analyze_placement(mod)
        rel = _scoped_relpath(mod)
        if result.crossing_sites:
            crossings[rel] = list(result.crossing_sites)
        dispatch_names.update(s["call"] for s in result.dispatch_sites if s["kind"] == "dispatch")
        # a wrapper named by reference (an alias, a table) is a live use too
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Name, ast.Attribute)):
                name = (dotted_name(node) or "").rsplit(".", 1)[-1]
                if name in _rp.DISPATCH_CALLS:
                    dispatch_names.add(name)
    return crossings, dispatch_names
