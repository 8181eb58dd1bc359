"""AST lint rules (KSL004-KSL018) of the port's analyzer: the JAX
package's rules (``mpi_k_selection_tpu/analysis/ast_rules.py``) pointed at
``mpi_k_selection_tpu_torch/``, and, where a rule names JAX calls, in
torch's vocabulary. docs/TORCH_ANALYSIS.md holds the catalog.

- Unchanged in meaning: KSL000 (core.py), KSL004, KSL005 (over
  ``tests/test_torch_*.py``), KSL008, KSL009, KSL012, KSL013 and KSL018
  (against the port's event table).
- In torch's vocabulary: KSL007 (a ``.to``/``.cuda`` without a device
  index under streaming/), KSL010 (``torch.compile``/``torch.jit.*`` in
  serve/ outside serve/registry.py), KSL011 (``.cpu()``/``.numpy()``/
  ``.tolist()`` of a subscript under streaming/ outside executor.py) and
  KSL014 (two kernel wrappers on one staged chunk).
- With no counterpart, and not registered: KSL001 (host syncs reachable
  from jit), KSL002 (x64 narrowing in ``jnp.asarray``), KSL003 (the f64
  TPU shells) and KSL006 (jax version shims).

The rules are module-local by design, as the JAX package's are.
"""

from __future__ import annotations

import ast
import pathlib
import re
import subprocess
import sys

from mpi_k_selection_tpu_torch import resource_protocols as _rp
from mpi_k_selection_tpu_torch.analysis.core import Rule, SourceModule, register

# ---------------------------------------------------------------------------
# shared AST helpers


def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` for Name/Attribute chains, '' for anything else."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _function_defs(tree: ast.AST) -> dict[str, list[ast.AST]]:
    """Every (possibly nested) function def in the module, by bare name."""
    defs: dict[str, list[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)
    return defs


def _path_endswith(mod: SourceModule, *suffixes: str) -> bool:
    """Exemption matching on the RESOLVED absolute path, so a scan
    invoked from inside the package (cwd-relative 'timing.py') still
    recognizes utils/timing.py — relpath depends on the caller's cwd."""
    p = pathlib.Path(mod.path).resolve().as_posix()
    return p.endswith(suffixes)


def _is_test_file(mod: SourceModule) -> bool:
    """Library-path rules skip test files: tests poke internals freely
    (staging to a hand-picked device, reading a count mid-pass). Tests stay
    in scope for KSL004 (no raw clocks) and KSL005 (tier-1 membership, a
    tests-only rule)."""
    p = pathlib.Path(mod.path).resolve()
    return p.name.startswith("test_") or "tests" in p.parts or p.name == "conftest.py"


# ---------------------------------------------------------------------------
# KSL004 — raw clocks outside the timing helpers


@register
class RawClockOutsideTiming(Rule):
    id = "KSL004"
    title = "raw time.time/perf_counter outside utils/timing + utils/profiling"
    rationale = (
        "Raw clock pairs around CUDA launches measure the launch, not the "
        "work (a launch returns before the card finishes). "
        "utils/timing.time_fn blocks on the result tree; "
        "utils/profiling.PhaseTimer owns phase wall-clock. Bench code with "
        "a methodological reason to read clocks inline (the differential "
        "perturb-chain) carries a written noqa."
    )

    _CLOCKS = {
        "time.time",
        "time.perf_counter",
        "time.monotonic",
        "time.process_time",
        "timeit.default_timer",
    }
    _ALLOWED = ("utils/timing.py", "utils/profiling.py")

    def check_module(self, mod: SourceModule):
        if _path_endswith(mod, *self._ALLOWED):
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and dotted_name(node.func) in self._CLOCKS:
                yield node.lineno, (
                    f"`{dotted_name(node.func)}()` — use utils/timing.time_fn "
                    "(device-sync semantics) or utils/profiling.PhaseTimer"
                )


# ---------------------------------------------------------------------------
# KSL005 — tier-1 membership audit (generalized tests/test_marker_audit.py)


@register
class Tier1Membership(Rule):
    id = "KSL005"
    title = "port test file neither tier-1-collected nor explicitly slow-marked"
    rationale = (
        "The tier-1 gate runs `pytest -m 'not slow'`. A test file whose "
        "tests all carry an implicit skip (bad collection, module-level "
        "gating, a forgotten pytestmark) silently falls out of that gate. "
        "Every tests/test_*.py must contribute at least one collected test "
        "or contain an explicit pytest.mark.slow opt-out. This analyzer "
        "audits the port's files, tests/test_torch_*.py, in one collection "
        "of those files (the JAX package's audits every test file)."
    )

    PATTERN = "test_torch_*.py"

    def collect_offenders(self, tests_dir: pathlib.Path) -> list[pathlib.Path]:
        """Offending test files under ``tests_dir`` — the single
        implementation behind both this rule and the historical
        tests/test_marker_audit.py (now a thin wrapper)."""
        files = sorted(tests_dir.glob(self.PATTERN))
        if not files:
            return []
        out = subprocess.run(
            [
                sys.executable, "-m", "pytest", "--collect-only", "-q",
                "-m", "not slow", "--continue-on-collection-errors",
                "-p", "no:cacheprovider", *map(str, files),
            ],
            capture_output=True,
            text=True,
            cwd=tests_dir.parent,
        )
        collected = {
            pathlib.Path(line.split("::")[0]).name
            for line in out.stdout.splitlines()
            if "::" in line
        }
        if not collected:
            raise RuntimeError(
                f"tier-1 collection produced nothing:\n{out.stdout}\n{out.stderr}"
            )
        return [
            f
            for f in files
            if f.name not in collected
            and not re.search(r"pytest\.mark\.slow\b", f.read_text())
        ]

    def check_tree(self, mods):
        by_dir: dict[pathlib.Path, list[SourceModule]] = {}
        for mod in mods:
            p = pathlib.Path(mod.path)
            if p.match(self.PATTERN) and p.parent.name == "tests":
                by_dir.setdefault(p.parent.resolve(), []).append(mod)
        for tests_dir, dir_mods in sorted(by_dir.items()):
            mod_by_name = {pathlib.Path(m.path).name: m for m in dir_mods}
            for offender in self.collect_offenders(tests_dir):
                mod = mod_by_name.get(offender.name)
                if mod is None:
                    continue  # offender outside the scanned set
                yield mod, 1, (
                    f"{offender.name} contributes no test to the tier-1 "
                    "selection (-m 'not slow') and has no pytest.mark.slow "
                    "opt-out — it silently fell out of the gate"
                )


# ---------------------------------------------------------------------------
# KSL007 — a transfer to a card in streaming/ without a device index


@register
class StreamingDevicePutWithoutDevice(Rule):
    id = "KSL007"
    title = "a .to(...)/.cuda() in streaming/ without an explicit device index"
    rationale = (
        "A bare `.cuda()` (or `.to('cuda')`) lands the tensor on the "
        "thread's current card — card 0 for a fresh producer thread. The "
        "multi-device staged ingest deals chunks round-robin over "
        "`devices`; a staging call that drops the index silently lands "
        "every staged bucket on one card while the others idle through "
        "the pass, with no error — the bug class the `devices` knob exists "
        "to prevent. Every transfer to a card under streaming/ names its "
        "target: the chunk's slot, an indexed device, or the stream's "
        "resolved device."
    )

    def check_module(self, mod: SourceModule):
        p = pathlib.Path(mod.path).resolve().as_posix()
        if "/streaming/" not in p or _is_test_file(mod):
            return
        from mpi_k_selection_tpu_torch.analysis.placement import untargeted_puts

        for line, name in untargeted_puts(mod):
            yield line, (
                f"`{name}` without an explicit device index — staged "
                "buckets silently pile onto the current card; pass the "
                "chunk's round-robin slot"
            )


# ---------------------------------------------------------------------------
# KSL008 — raw file writes in streaming/ outside the spill store API


@register
class StreamingRawFileWrite(Rule):
    id = "KSL008"
    title = "raw file write in streaming/ outside the spill store API"
    rationale = (
        "streaming/spill.py is the ONE sanctioned file-writing surface "
        "under streaming/: its records carry the (chunk_index, bucket, "
        "dtype, device) key, a CRC32, and a lifecycle (generations dropped "
        "eagerly, stores removed on every exit path — the leaked-dir test "
        "fixture). A raw `open(..., 'w')`/`np.save`/`.tofile` in the "
        "streaming layer dodges all three: no replay keying (the "
        "chunk->device determinism contract breaks silently), no checksum "
        "(a truncated write feeds the descent wrong survivors instead of "
        "raising SpillRecordError), and no cleanup discipline (temp files "
        "outlive the pass). Route every write through "
        "SpillStore/SpillWriter."
    )

    # call names that write files outright
    _WRITE_CALLS = {
        "np.save", "np.savez", "np.savez_compressed",
        "numpy.save", "numpy.savez", "numpy.savez_compressed",
        "np.memmap", "numpy.memmap",
        "pickle.dump", "shutil.copyfile", "shutil.copy", "shutil.copy2",
    }
    # method names that write files on their receiver (ndarray.tofile,
    # Path.write_bytes/write_text)
    _WRITE_METHODS = {"tofile", "write_bytes", "write_text"}
    _OPEN_NAMES = {"open", "io.open", "os.fdopen"}
    _WRITE_MODE = re.compile(r"[wax+]")

    def _open_writes(self, call: ast.Call, mode_pos: int) -> bool:
        """True when an ``open``-family call provably (or possibly) opens
        for writing: a constant mode containing w/a/x/+, or a NON-constant
        mode (can't prove read-only). A missing/constant read mode passes.
        ``mode_pos`` is the mode's positional index — 1 for the builtin
        ``open(path, mode)``, 0 for the receiver-qualified
        ``Path(...).open(mode)``."""
        mode = None
        if len(call.args) > mode_pos:
            mode = call.args[mode_pos]
        for kw in call.keywords:
            if kw.arg == "mode":
                mode = kw.value
        if mode is None:
            return False  # bare open(path) = read
        if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
            return bool(self._WRITE_MODE.search(mode.value))
        return True  # dynamic mode: cannot prove it reads

    def check_module(self, mod: SourceModule):
        p = pathlib.Path(mod.path).resolve().as_posix()
        if "/streaming/" not in p or _is_test_file(mod):
            return
        if p.endswith("streaming/spill.py"):
            return  # the sanctioned writer
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name in self._WRITE_CALLS:
                yield node.lineno, (
                    f"`{name}` writes a file outside the spill store API — "
                    "route it through SpillStore/SpillWriter "
                    "(streaming/spill.py) so it gets record keying, "
                    "checksums and cleanup"
                )
            elif (
                (name in self._OPEN_NAMES and self._open_writes(node, 1))
                or (
                    # receiver-qualified .open() — Path(p).open('wb') and
                    # friends; the mode is the FIRST argument there
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "open"
                    and name not in self._OPEN_NAMES
                    and self._open_writes(node, 0)
                )
            ):
                yield node.lineno, (
                    f"`{name or '.open'}` with a write mode outside the "
                    "spill store API — route it through "
                    "SpillStore/SpillWriter (streaming/spill.py) so it "
                    "gets record keying, checksums and cleanup"
                )
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in self._WRITE_METHODS
            ):
                yield node.lineno, (
                    f"`.{node.func.attr}(...)` writes a file outside the "
                    "spill store API — route it through "
                    "SpillStore/SpillWriter (streaming/spill.py)"
                )


# ---------------------------------------------------------------------------
# KSL009 — print/logging telemetry in library code


@register
class PrintLoggingTelemetry(Rule):
    id = "KSL009"
    title = "print/logging telemetry in library code — route through obs"
    rationale = (
        "Library telemetry that goes to stdout/stderr is invisible to "
        "every structured consumer — the bench records, the CLI's JSON "
        "mode (a stray print corrupts the `--json` stream callers parse), "
        "the metrics registry, and the event sinks — and unconditional "
        "`logging` calls pay string formatting on hot streaming paths "
        "whether anyone listens or not. Library code under "
        "mpi_k_selection_tpu_torch/ reports through the obs subsystem "
        "(obs/events.py sinks, obs/metrics.py registry) or raises/warns; "
        "the CLI and the reporters (cli.py, __main__.py, "
        "analysis/reporters.py, utils/timing.py's reference-style result "
        "printer) are the sanctioned human-facing output surfaces."
    )

    # CLI and reporter surfaces: human-facing output is their JOB
    _EXEMPT = (
        "cli.py",
        "__main__.py",
        "analysis/reporters.py",
        "utils/timing.py",
    )
    _LOG_METHODS = {
        "debug", "info", "warning", "warn", "error", "critical",
        "exception", "log",
    }
    _LOG_RECEIVERS = {"logging", "logger", "log"}

    def check_module(self, mod: SourceModule):
        p = pathlib.Path(mod.path).resolve().as_posix()
        if "/mpi_k_selection_tpu_torch/" not in p or _is_test_file(mod):
            return
        if _path_endswith(mod, *self._EXEMPT):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name == "print":
                yield node.lineno, (
                    "`print()` telemetry in library code — emit an obs "
                    "event or metric (mpi_k_selection_tpu_torch/obs/) so "
                    "structured consumers see it, or raise/warn for "
                    "error conditions (CLI and reporters are exempt)"
                )
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in self._LOG_METHODS
                and name.split(".")[0] in self._LOG_RECEIVERS
            ):
                yield node.lineno, (
                    f"`{name}()` logging telemetry in library code — "
                    "route it through the obs registry/sinks "
                    "(mpi_k_selection_tpu_torch/obs/) so bench records and "
                    "JSON consumers can read it (CLI and reporters are "
                    "exempt)"
                )
            elif name == "logging.getLogger":
                yield node.lineno, (
                    "`logging.getLogger()` in library code — the obs "
                    "subsystem (events/metrics/trace) is this package's "
                    "telemetry channel; loggers here end up emitting "
                    "unstructured text no consumer reads"
                )


# ---------------------------------------------------------------------------
# KSL010 — per-request compilation in serve/ handler paths


@register
class ServeHandlerCompile(Rule):
    id = "KSL010"
    title = "torch.compile/torch.jit in serve/ outside the registry's program cache"
    rationale = (
        "The query server answers many small requests over long-lived "
        "resident datasets; a `torch.compile` or `torch.jit.*` call on a "
        "handler path builds a FRESH compiled callable per request, so "
        "every request pays the compile and no cache ever hits — the "
        "accidental-recompile latency cliff, invisible in tests that issue "
        "one query. Compiled or cached programs under serve/ are built "
        "ONCE in serve/registry.py and reused through its keyed "
        "ProgramCache; handler code (server, batcher, lanes, tiers, http) "
        "dispatches through cached programs only."
    )

    _SANCTIONED = ("serve/registry.py",)

    def _is_compile(self, node) -> bool:
        name = dotted_name(node)
        return name == "torch.compile" or name.startswith("torch.jit.")

    def check_module(self, mod: SourceModule):
        p = pathlib.Path(mod.path).resolve().as_posix()
        if "/serve/" not in p or _is_test_file(mod):
            return
        if _path_endswith(mod, *self._SANCTIONED):
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and self._is_compile(node.func):
                yield node.lineno, (
                    f"`{dotted_name(node.func)}` builds a compiled callable "
                    "on a serve/ handler path — every request recompiles; "
                    "build it once in serve/registry.py and dispatch through "
                    "the keyed ProgramCache"
                )
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    if self._is_compile(dec):
                        yield node.lineno, (
                            f"`@{dotted_name(dec)}` on `{node.name}` in "
                            "serve/ — compiled programs belong in "
                            "serve/registry.py's ProgramCache, not on "
                            "handler paths"
                        )


# ---------------------------------------------------------------------------
# KSL011 — eager device gathers on streaming chunk-consume paths


@register
class StreamingEagerDeviceGather(Rule):
    id = "KSL011"
    title = ".cpu()/.numpy()/.tolist() of an indexed tensor in streaming/ outside executor.py"
    rationale = (
        "`kv[m].cpu()` (or `.numpy()` / `.tolist()` of a masked or indexed "
        "tensor) at chunk-consume time blocks the consumer on a "
        "device-to-host sync PER CHUNK: a boolean gather's output shape "
        "is data-dependent, so it materializes eagerly, and a p-wide "
        "in-flight window degrades toward serial on exactly the biggest "
        "reads. The executor (streaming/executor.py) is the one sanctioned "
        "home for the readback: its consumers compact on the card and read "
        "the survivors when the in-flight window pops. Any other read of "
        "a subscript in the streaming layer brings the serialization back."
    )

    _SYNC_METHODS = {"cpu", "numpy", "tolist"}
    _SANCTIONED = ("streaming/executor.py",)

    def check_module(self, mod: SourceModule):
        p = pathlib.Path(mod.path).resolve().as_posix()
        if "/streaming/" not in p or _is_test_file(mod):
            return
        if _path_endswith(mod, *self._SANCTIONED):
            return  # the readback surface
        for node in ast.walk(mod.tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in self._SYNC_METHODS
                and isinstance(node.func.value, ast.Subscript)
            ):
                yield node.lineno, (
                    f"`.{node.func.attr}()` of an indexed/masked tensor on a "
                    "streaming chunk path — an eager per-chunk device-to-host "
                    "gather; read it through the executor's consumers "
                    "(streaming/executor.py), which read when the in-flight "
                    "window pops"
                )


# ---------------------------------------------------------------------------
# KSL012 — silent broad excepts in the resilience layers; raw time.sleep


@register
class SilentSwallowOrRawSleep(Rule):
    id = "KSL012"
    title = (
        "silent broad except in streaming//serve//faults/, or time.sleep "
        "outside the injectable sleeper"
    )
    rationale = (
        "The resilience vertical (faults/, docs/ROBUSTNESS.md) classifies "
        "failures: transients are retried, spill corruption takes the "
        "re-read/rebuild ladder, overload sheds — and every action emits a "
        "typed FaultEvent. A bare `except:`/`except Exception:` that "
        "neither re-raises nor even LOOKS at the exception swallows a "
        "failure none of that machinery ever sees: the descent keeps "
        "running on corrupt state, or a server thread dies silently — the "
        "MPI_Abort posture's evil twin. Separately, a raw `time.sleep` "
        "hard-codes real waiting into backoff/stall paths, making the "
        "seeded chaos grid minutes-slow and untestable; "
        "faults/sleeper.py's injectable Sleeper is the one sanctioned "
        "wait surface (the waiting twin of KSL004's clock discipline)."
    )

    _BROAD = {"Exception", "BaseException"}
    _SCOPED = ("/streaming/", "/serve/", "/faults/")
    _SLEEPER = ("faults/sleeper.py",)

    def _is_broad(self, handler: ast.ExceptHandler) -> bool:
        if handler.type is None:
            return True
        types = (
            handler.type.elts
            if isinstance(handler.type, ast.Tuple)
            else [handler.type]
        )
        return any(
            dotted_name(t).split(".")[-1] in self._BROAD for t in types
        )

    def check_module(self, mod: SourceModule):
        p = pathlib.Path(mod.path).resolve().as_posix()
        if _is_test_file(mod):
            return
        if "/mpi_k_selection_tpu_torch/" in p and not _path_endswith(
            mod, *self._SLEEPER
        ):
            for node in ast.walk(mod.tree):
                if (
                    isinstance(node, ast.Call)
                    and dotted_name(node.func) == "time.sleep"
                ):
                    yield node.lineno, (
                        "`time.sleep()` outside faults/sleeper.py — route "
                        "waiting through the injectable Sleeper "
                        "(RetryPolicy backoff, chaos stalls) so tests and "
                        "the seeded harness can virtualize it"
                    )
        if not any(seg in p for seg in self._SCOPED):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler) or not self._is_broad(node):
                continue
            # sanctioned handling: re-raising (incl. conditionally), or
            # binding the exception and actually using it (transporting
            # it to another thread, mapping it to a status/typed error,
            # emitting it) — "silent" means the exception VALUE is dropped
            if any(isinstance(x, ast.Raise) for x in ast.walk(node)):
                continue
            if node.name and any(
                isinstance(x, ast.Name) and x.id == node.name
                for stmt in node.body
                for x in ast.walk(stmt)
            ):
                continue
            yield node.lineno, (
                "broad except swallows the failure (no re-raise, and the "
                "exception value is never used): the resilience layers "
                "must retry, rebuild, shed, or surface a typed error — "
                "and emit a FaultEvent — never drop a failure on the "
                "floor (faults/, docs/ROBUSTNESS.md)"
            )


# ---------------------------------------------------------------------------
# KSL013 — unbounded metric label cardinality


@register
class UnboundedMetricLabels(Rule):
    id = "KSL013"
    title = (
        "metric labels= value derived from a loop variable "
        "(per-chunk/per-request cardinality)"
    )
    rationale = (
        "A metrics-registry label whose VALUE comes from a loop variable "
        "— a chunk index, a request id, a raw observation — mints one "
        "fresh (name, labels) series per iteration: the registry (and "
        "any Prometheus server scraping it) grows without bound, "
        "exposition cost grows with it, and per-series aggregates "
        "become meaningless (every series holds one point). Labels must "
        "partition over CLOSED sets (a device slot, a tier, a phase, a "
        "quantile); unbounded dimensions belong in the metric VALUE "
        "(a counter/histogram observation) or the event stream "
        "(obs/events.py), which is built for per-occurrence records. "
        "Bounded-in-practice loop sources (PhaseTimer phase names) "
        "carry a written noqa in the ledger."
    )

    _METRIC_METHODS = {"counter", "gauge", "histogram"}

    def _loop_targets(self, node) -> set[str]:
        """Names bound by a for-loop target or comprehension generator."""
        names: set[str] = set()
        if isinstance(node, (ast.For, ast.AsyncFor)):
            for sub in ast.walk(node.target):
                if isinstance(sub, ast.Name):
                    names.add(sub.id)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                for sub in ast.walk(gen.target):
                    if isinstance(sub, ast.Name):
                        names.add(sub.id)
        return names

    def _label_value_exprs(self, call: ast.Call):
        """The expressions that become label VALUES: the values of a
        ``labels={...}`` dict literal. Non-literal labels arguments (a
        name built elsewhere) are out of scope — tracing them needs
        dataflow this rule does not attempt."""
        for kw in call.keywords:
            if kw.arg == "labels" and isinstance(kw.value, ast.Dict):
                yield from kw.value.values

    def _walk(self, node, loop_names: set[str]):
        """Recursive walk tracking which names are loop-bound at each
        point. Function/lambda boundaries RESET the set (a parameter is
        the caller's choice, not an iteration — `phase=` style labels
        stay legal); for-loops and comprehension generators extend it
        for everything they enclose."""
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            loop_names = set()
        else:
            targets = self._loop_targets(node)
            if targets:
                loop_names = loop_names | targets
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in self._METRIC_METHODS
        ):
            for vexpr in self._label_value_exprs(node):
                hit = sorted(
                    {
                        n.id
                        for n in ast.walk(vexpr)
                        if isinstance(n, ast.Name) and n.id in loop_names
                    }
                )
                if hit:
                    yield node.lineno, (
                        f"metric label value derived from loop "
                        f"variable(s) {', '.join(hit)} — one fresh "
                        "series per iteration is unbounded label "
                        "cardinality; partition labels over a closed "
                        "set and put per-occurrence data in the "
                        "metric value or the obs event stream"
                    )
        for child in ast.iter_child_nodes(node):
            yield from self._walk(child, loop_names)

    def check_module(self, mod: SourceModule):
        p = pathlib.Path(mod.path).resolve().as_posix()
        if "/mpi_k_selection_tpu_torch/" not in p or _is_test_file(mod):
            return
        seen: set[tuple[int, str]] = set()
        for lineno, msg in self._walk(mod.tree, set()):
            key = (lineno, msg)
            if key not in seen:
                seen.add(key)
                yield lineno, msg


# ---------------------------------------------------------------------------
# KSL014 — multiple device programs consuming one staged bucket per pass


@register
class MultiProgramStagedConsume(Rule):
    id = "KSL014"
    title = (
        "several kernel wrappers launched against one staged bucket in "
        "streaming/ outside executor.py's consumers"
    )
    rationale = (
        "The sweep kernel (ops/cuda/sweep_ingest.py) computes every part "
        "a streamed pass needs from ONE read of a staged bucket. A chunk "
        "read by SEVERAL kernel wrappers per pass — a histogram here, a "
        "count there — multiplies the pass's memory traffic by the launch "
        "count. streaming/executor.py owns the one sanctioned bundle of "
        "consumers, each one launch; a second wrapper call on the same "
        "staged buffer elsewhere in the streaming layer brings the read "
        "amplification back. Route new per-chunk device work through the "
        "executor's consumers."
    )

    #: The kernel wrappers (resource_protocols.DISPATCH_CALLS), matched on
    #: the last dotted segment: two of them against one staged variable in
    #: one function is the read-amplification class.
    _DISPATCHERS = _rp.DISPATCH_CALLS
    _SANCTIONED = ("streaming/executor.py",)

    @staticmethod
    def _base_name(node: ast.AST):
        """Root Name of a Name/Attribute chain (``staged`` from
        ``staged.data``); None for anything without a stable base."""
        while isinstance(node, ast.Attribute):
            node = node.value
        return node.id if isinstance(node, ast.Name) else None

    @staticmethod
    def _own_nodes(fn: ast.AST):
        """The nodes belonging to ``fn``'s own scope — nested function
        defs are their own scopes and are skipped (each is visited as its
        own function by check_module)."""
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def check_module(self, mod: SourceModule):
        p = pathlib.Path(mod.path).resolve().as_posix()
        if "/streaming/" not in p or _is_test_file(mod):
            return
        if _path_endswith(mod, *self._SANCTIONED):
            return  # the executor owns the sanctioned bundle
        for defs in _function_defs(mod.tree).values():
            for fn in defs:
                by_base: dict[str, list[tuple[int, str]]] = {}
                for node in self._own_nodes(fn):
                    if not isinstance(node, ast.Call):
                        continue
                    name = dotted_name(node.func).split(".")[-1]
                    if name not in self._DISPATCHERS:
                        continue
                    for arg in list(node.args) + [
                        kw.value for kw in node.keywords
                    ]:
                        base = self._base_name(arg)
                        if base is not None:
                            by_base.setdefault(base, []).append(
                                (node.lineno, name)
                            )
                            break
                for base, calls in by_base.items():
                    for lineno, name in sorted(calls)[1:]:
                        yield lineno, (
                            f"`{name}` dispatches another ingest program "
                            f"against staged chunk `{base}` "
                            f"({len(calls)} programs in this function — "
                            "each one re-reads the whole staged bucket); "
                            "route the work through streaming/executor.py"
                            "'s consumers (FusedIngestConsumer reads a "
                            "bucket in ONE launch)"
                        )


# ---------------------------------------------------------------------------
# KSL018 — obs event types live in obs/events.py AND in the documented
# event catalog (docs/TORCH_ANALYSIS.md), both directions


@register
class ObsEventCatalog(Rule):
    id = "KSL018"
    title = (
        "obs event type defined outside obs/events.py, or out of sync "
        "with the docs/TORCH_ANALYSIS.md event-schema table"
    )
    rationale = (
        "The typed event stream is a consumer contract: sinks, "
        "check_stream_invariants, the flight recorder's debug bundle "
        "and every postmortem reader key on the documented `kind` "
        "catalog (docs/TORCH_ANALYSIS.md). An event type declared beside "
        "its emitter dodges the one home consumers import "
        "(obs/events.py), and a type added there without its schema row "
        "— or a schema row whose type was renamed away — drifts the "
        "catalog exactly like the rule-id table PR 12's doc-drift gate "
        "covers. This rule is that gate extended to the event schema, "
        "both directions."
    )

    _EVENTS_FILE = "obs/events.py"

    @staticmethod
    def _event_classes(mod: SourceModule):
        """``(classdef, kind or None)`` for every event TYPE in ``mod``:
        a frozen dataclass with at least one base class carrying a
        ``kind`` class attribute (the ObsEvent idiom). The base-less
        ``ObsEvent`` root itself is not an emitted type and is skipped;
        ``kind`` is the string literal when one is assigned."""
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef) or not node.bases:
                continue
            frozen = False
            for dec in node.decorator_list:
                if not isinstance(dec, ast.Call):
                    continue
                if dotted_name(dec.func).split(".")[-1] != "dataclass":
                    continue
                for kw in dec.keywords:
                    if (
                        kw.arg == "frozen"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is True
                    ):
                        frozen = True
            if not frozen:
                continue
            kind = None
            has_kind = False
            for stmt in node.body:
                target = None
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    target = stmt.target.id
                elif isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "kind"
                    for t in stmt.targets
                ):
                    target = "kind"
                if target != "kind":
                    continue
                has_kind = True
                value = getattr(stmt, "value", None)
                if isinstance(value, ast.Constant) and isinstance(
                    value.value, str
                ):
                    kind = value.value
            if has_kind:
                out.append((node, kind))
        return out

    @staticmethod
    def _documented_kinds(doc_text: str) -> set[str]:
        """First-column backticked kinds of the event-schema table: the
        rows between the '## Event schema' heading and the next '## '."""
        kinds: set[str] = set()
        in_section = False
        for line in doc_text.splitlines():
            if line.startswith("## "):
                in_section = line.lower().startswith("## event schema")
                continue
            if not in_section:
                continue
            m = re.match(r"\|\s*`([^`]+)`\s*\|", line)
            if m:
                kinds.add(m.group(1))
        return kinds

    def check_module(self, mod: SourceModule):
        p = pathlib.Path(mod.path).resolve().as_posix()
        if "/mpi_k_selection_tpu_torch/" not in p or _is_test_file(mod):
            return
        if not _path_endswith(mod, self._EVENTS_FILE):
            for node, kind in self._event_classes(mod):
                yield node.lineno, (
                    f"obs event type `{node.name}` (kind "
                    f"{kind!r}) defined outside obs/events.py — event "
                    "types live in the ONE module consumers import, "
                    "next to their schema row (docs/TORCH_ANALYSIS.md)"
                )
            return
        # the catalog half: events.py's kinds <-> the schema table rows.
        # The docs root sits two levels above obs/ (repo layout and the
        # fixture trees alike); a tree without the doc only exercises
        # the location half above.
        doc = pathlib.Path(mod.path).resolve().parents[2] / "docs" / "TORCH_ANALYSIS.md"
        if not doc.is_file():
            return
        documented = self._documented_kinds(doc.read_text())
        defined: dict[str, tuple] = {}
        for node, kind in self._event_classes(mod):
            if kind is not None:
                defined[kind] = (node.lineno, node.name)
        for kind, (lineno, name) in sorted(defined.items()):
            if kind not in documented:
                yield lineno, (
                    f"event type `{name}` (kind {kind!r}) has no row in "
                    "docs/TORCH_ANALYSIS.md's event-schema table — every "
                    "emitted kind is documented, both directions"
                )
        for kind in sorted(documented - set(defined)):
            yield 1, (
                f"docs/TORCH_ANALYSIS.md documents event kind {kind!r} "
                "but obs/events.py defines no event type with it — "
                "stale schema row (renamed or removed type)"
            )
