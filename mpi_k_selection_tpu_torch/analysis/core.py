"""Rule framework: findings, suppressions, the registry, and the driver
(counterpart of ``mpi_k_selection_tpu/analysis/core.py``).

The engine is stdlib-only (``ast``), so the lint gate runs wherever the
package can be read; the contract checks (contracts.py) import torch and
are skipped with ``contracts=False``.

Suppression syntax. Two analyzers lint this repository: the JAX
package's and this one, and each audits the suppressions it reads for
staleness. A rule whose meaning both share (:data:`SHARED_RULES`) is
suppressed by either form below; every other rule of this analyzer only
by the ``ksel-torch`` form, which the JAX package's parser does not read:

- ``# ksel-torch: noqa[KSL011] -- why`` — suppress that rule on this line;
  everything after ``--`` is the recorded justification;
- ``# ksel: noqa[KSL004] -- why`` — the JAX package's form: use it only
  where both analyzers fire (a raw clock anywhere), else the JAX audit
  reports it as stale;
- ``# ksel-torch: noqa[KSL013,KSL009] -- reason`` — several rules;
- ``# ksel-torch: noqa-file[KSL005] -- reason`` — the whole file.

A suppressed finding still appears in the JSON report (``suppressed:
true`` with its justification), so the gate's artifact is also the
ledger of accepted exceptions.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

_NOQA_RE = re.compile(
    r"#\s*ksel(?P<torch>-torch)?:\s*noqa(?P<scope>-file)?\[(?P<rules>[A-Z0-9_,\s]+)\]"
    r"(?:\s*--\s*(?P<why>(?:(?!#\s*ksel).)*?))?\s*(?=#\s*ksel|$)"
)

#: Rules whose meaning this analyzer shares with the JAX package's (the
#: same code shape is a finding in both): the JAX package's ``# ksel:``
#: suppressions count for them. The rest read only ``# ksel-torch:``.
SHARED_RULES = frozenset(
    {"KSL000", "KSL004", "KSL005", "KSL008", "KSL009", "KSL012", "KSL013", "KSL015", "KSL016",
     "KSL017", "KSL018", "KSL019", "KSL020", "KSL021"}
)



@dataclasses.dataclass
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str
    line: int
    message: str
    suppressed: bool = False
    justification: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}: {self.rule}{tag} {self.message}"


class SourceModule:
    """A parsed source file plus its suppression table."""

    def __init__(self, path: str, relpath: str, text: str):
        self.path = path
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        # line -> {rule -> justification}; rule "" means all rules
        self.line_noqa: dict[int, dict[str, str]] = {}
        self.file_noqa: dict[str, str] = {}
        self.file_noqa_lines: dict[str, int] = {}
        for lineno, line in enumerate(self.lines, start=1):
            for m in _NOQA_RE.finditer(line):
                rules = [r.strip() for r in m.group("rules").split(",") if r.strip()]
                if not m.group("torch"):
                    rules = [r for r in rules if r in SHARED_RULES]
                why = (m.group("why") or "").strip()
                if m.group("scope"):
                    for r in rules:
                        self.file_noqa[r] = why
                        self.file_noqa_lines[r] = lineno
                else:
                    table = self.line_noqa.setdefault(lineno, {})
                    for r in rules:
                        table[r] = why

    def string_literal_lines(self) -> set[int]:
        """Line numbers carrying string constants (docstrings, fixture
        sources, ``.replace`` arguments) — a noqa-shaped comment INSIDE
        one is text, not a suppression, so the staleness audit skips
        those lines (a true suppression sharing a line with a string
        merely dodges the audit, never enforcement)."""
        out: set[int] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                end = node.end_lineno or node.lineno
                out.update(range(node.lineno, end + 1))
        return out

    def suppression(self, rule: str, line: int) -> str | None:
        """Justification string when ``rule`` is suppressed at ``line``
        (empty string = suppressed without justification), else None."""
        table = self.line_noqa.get(line)
        if table is not None and rule in table:
            return table[rule]
        if rule in self.file_noqa:
            return self.file_noqa[rule]
        return None

    def segment(self, node: ast.AST) -> str:
        """Source text of ``node`` (used for token-level heuristics)."""
        return ast.get_source_segment(self.text, node) or ""


class Rule:
    """Base AST rule. Subclasses set the class attributes and implement
    either :meth:`check_module` (per-file) or :meth:`check_tree`
    (whole-scan rules like the tier-1 membership audit)."""

    id: str = ""
    title: str = ""
    rationale: str = ""

    def check_module(self, mod: SourceModule):
        """Yield ``(line, message)`` violations for one file."""
        return ()

    def check_tree(self, mods: list[SourceModule]):
        """Yield ``(mod, line, message)`` violations for the whole scan."""
        return ()


_REGISTRY: dict[str, Rule] = {}


def register(cls):
    """Class decorator adding a rule to the global registry."""
    inst = cls()
    if not inst.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if inst.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {inst.id}")
    _REGISTRY[inst.id] = inst
    return cls


def all_rules() -> dict[str, Rule]:
    return dict(_REGISTRY)


@dataclasses.dataclass
class Report:
    findings: list[Finding]
    files: list[str]
    checks_run: list[str]
    #: suppressions whose rule RAN on this scan but no
    #: longer fires at that location — stale ledger entries (the gate
    #: warns; see dead_suppressions() below)
    dead_suppressions: list = dataclasses.field(default_factory=list)
    #: the parsed SourceModules of this scan — NOT serialized; lets the
    #: CLI hand the already-loaded tree to build_concurrency_report
    #: instead of re-parsing every file
    modules: list = dataclasses.field(default_factory=list, repr=False)

    @property
    def unsuppressed(self) -> list[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def exit_code(self) -> int:
        return 1 if self.unsuppressed else 0


_SKIP_DIRS = {
    "__pycache__", "build", "dist", "node_modules", "venv",
    "site-packages",
}


def _skip_part(part: str) -> bool:
    """Directory components the scan never descends into: caches, build
    output, virtualenvs (a scan of ``.`` must not lint site-packages),
    and every dot-directory (.git, .venv, .tox, .claude, ...)."""
    return (
        part in _SKIP_DIRS
        or part.endswith(".egg-info")
        or (part.startswith(".") and part not in (".", ".."))
    )


def iter_python_files(paths) -> list[pathlib.Path]:
    out: list[pathlib.Path] = []
    for p in paths:
        p = pathlib.Path(p)
        if p.is_file() and p.suffix == ".py":
            out.append(p)
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                # judge only the components BELOW the given root, so a
                # scan rooted inside a dot-directory still works
                if not any(_skip_part(part) for part in f.relative_to(p).parts):
                    out.append(f)
    # dedupe, stable order
    seen, uniq = set(), []
    for f in out:
        r = f.resolve()
        if r not in seen:
            seen.add(r)
            uniq.append(f)
    return uniq


def load_module(path, root=None) -> SourceModule:
    path = pathlib.Path(path)
    try:
        rel = str(path.resolve().relative_to(pathlib.Path(root or ".").resolve()))
    except ValueError:
        rel = str(path)
    return SourceModule(str(path), rel, path.read_text())


def _selected(rule_id: str, select, ignore) -> bool:
    if select is not None and not any(rule_id.startswith(s) for s in select):
        return False
    if ignore is not None and any(rule_id.startswith(s) for s in ignore):
        return False
    return True


def run_analysis(
    paths,
    *,
    select=None,
    ignore=None,
    contracts: bool = True,
    root=None,
    mods=None,
) -> Report:
    """Run every selected rule (and, with ``contracts=True``, every torch
    contract check, contracts.py) over ``paths``. Returns a :class:`Report`; the gate
    semantics are ``report.exit_code`` (1 iff any unsuppressed finding).

    ``mods`` is an optional pre-parsed :class:`SourceModule` list (the
    analysis/modcache.py shared set): when given, ``paths`` is not
    re-walked or re-parsed — the whole-repo gate tests hand the four
    passes ONE parsed tree. KSL000 (syntax errors) can only arise from
    the parse loop, so callers passing ``mods`` vouch the set parsed."""
    findings: list[Finding] = []
    checks_run: list[str] = []
    if mods is not None:
        mods = list(mods)
        files = [m.path for m in mods]
        return _run_rules(
            mods, files, findings, checks_run, select, ignore, contracts
        )
    files = iter_python_files(paths)
    mods = []
    for f in files:
        try:
            mods.append(load_module(f, root=root))
        except SyntaxError as e:
            # KSL000 honors --select/--ignore like any rule: an unparseable
            # vendored file is excludable (`--ignore KSL000`) without
            # dropping it from the scan paths — a noqa cannot apply since
            # the suppression table needs a parse
            if _selected("KSL000", select, ignore):
                findings.append(
                    Finding("KSL000", str(f), e.lineno or 1, f"syntax error: {e.msg}")
                )
    return _run_rules(mods, files, findings, checks_run, select, ignore, contracts)


def _run_rules(mods, files, findings, checks_run, select, ignore, contracts) -> Report:
    def emit(rule_id: str, mod: SourceModule, line: int, message: str):
        why = mod.suppression(rule_id, line)
        findings.append(
            Finding(
                rule_id,
                mod.relpath,
                line,
                message,
                suppressed=why is not None,
                justification=why or "",
            )
        )

    for rule_id, rule in sorted(_REGISTRY.items()):
        if not _selected(rule_id, select, ignore):
            continue
        checks_run.append(rule_id)
        for mod in mods:
            for line, message in rule.check_module(mod):
                emit(rule_id, mod, line, message)
        for mod, line, message in rule.check_tree(mods):
            emit(rule_id, mod, line, message)

    if contracts:
        from mpi_k_selection_tpu_torch.analysis.contracts import CONTRACT_CHECKS

        for check in CONTRACT_CHECKS:
            if not _selected(check.id, select, ignore):
                continue
            checks_run.append(check.id)
            findings.extend(check.run("cpu"))

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    dead = _dead_suppressions(mods, findings, checks_run)
    return Report(findings, [str(f) for f in files], checks_run, dead, mods)


def _dead_suppressions(mods, findings, checks_run) -> list[dict]:
    """Stale ``# ksel-torch: noqa[...]`` entries (and ``# ksel:`` ones of
    :data:`SHARED_RULES`): the named rule RAN on this
    scan yet produced no (suppressed) finding at the suppression's
    location — the justification ledger is carrying a dead exception.
    Rules that were deselected are skipped (their silence proves
    nothing); so are non-KSL ids, which have no line-anchored findings
    to judge (contract checks deselect via ``--ignore`` instead)."""
    ran = set(checks_run)
    out: list[dict] = []
    for mod in mods:
        in_string = mod.string_literal_lines()
        live_lines = {
            (f.rule, f.line)
            for f in findings
            if f.path == mod.relpath and f.suppressed
        }
        live_rules = {rule for rule, _line in live_lines}
        for line, table in sorted(mod.line_noqa.items()):
            if line in in_string:
                continue  # noqa-shaped text inside a string literal
            for rule, why in sorted(table.items()):
                if rule not in ran or not rule.startswith("KSL"):
                    continue
                if (rule, line) not in live_lines:
                    out.append(
                        {
                            "path": mod.relpath,
                            "line": line,
                            "rule": rule,
                            "justification": why,
                            "scope": "line",
                        }
                    )
        for rule, why in sorted(mod.file_noqa.items()):
            if mod.file_noqa_lines.get(rule, 0) in in_string:
                continue
            if rule not in ran or not rule.startswith("KSL"):
                continue
            if rule not in live_rules:
                out.append(
                    {
                        "path": mod.relpath,
                        "line": mod.file_noqa_lines.get(rule, 1),
                        "rule": rule,
                        "justification": why,
                        "scope": "file",
                    }
                )
    return out
