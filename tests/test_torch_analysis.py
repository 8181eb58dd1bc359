"""The port's analyzer (``mpi_k_selection_tpu_torch/analysis/``) against the
JAX package's, and the gate over the port.

- The engine and the CLI: exit codes 0/1/2, the JAX driver's flags, and a
  JSON report whose keys are the JAX analyzer's.
- Parity: on the fixture sources of ``tests/test_analysis.py``,
  ``test_concurrency.py`` and ``test_lifecycle.py`` (read from their ASTs,
  not imported), the rules whose meaning both analyzers share give the same
  ``(rule, line, suppressed)`` set in both, each run over its own package's
  path. The staging call is ``stage_chunk`` in the port; the port's copy of
  a fixture names it so, line for line.
- The torch-vocabulary rules (KSL007, KSL010, KSL011, KSL014, KSL022-024)
  on samples written under ``tmp_path``.
- The gate: no unsuppressed finding and no stale suppression over the
  port, and the doc-drift check of docs/TORCH_ANALYSIS.md's rule table.

Samples live in strings and are written under ``tmp_path``: the JAX gate
lints every ``.py`` of the repository.
"""

from __future__ import annotations

import ast
import json
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest

from mpi_k_selection_tpu_torch.analysis import (
    CONTRACT_CHECKS,
    all_rules,
    render_json,
    run_analysis,
    shared_modules,
)
from mpi_k_selection_tpu_torch.analysis.__main__ import main

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = "mpi_k_selection_tpu_torch"
SHARED = ("KSL004", "KSL008", "KSL009", "KSL012", "KSL013", "KSL015", "KSL016", "KSL017", "KSL019", "KSL020", "KSL021")


def _lint(tmp_path, source, name, **kwargs):
    f = tmp_path / name
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(source))
    kwargs.setdefault("contracts", False)
    return run_analysis([f], **kwargs)


def _hits(report):
    return {(f.rule, f.line) for f in report.unsuppressed}


# ---------------------------------------------------------------------------
# the engine and the CLI

CLEAN = "def f(x):\n    return x + 1\n"
DIRTY = "import time\n\n\ndef f():\n    return time.perf_counter()\n"


def test_cli_exit_codes_and_json(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text(CLEAN)
    dirty = tmp_path / "dirty.py"
    dirty.write_text(DIRTY)
    assert main(["--no-contracts", str(clean)]) == 0
    assert main(["--no-contracts", str(dirty)]) == 1
    capsys.readouterr()
    assert main(["--no-contracts", "--json", "--output", str(tmp_path / "r.json"), str(dirty)]) == 1
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads((tmp_path / "r.json").read_text())
    assert [(f["rule"], f["line"]) for f in printed["findings"]] == [("KSL004", 5)]
    assert printed["exit_code"] == 1 and printed["unsuppressed"] == 1
    with pytest.raises(SystemExit) as e:
        main(["--no-such-flag"])
    assert e.value.code == 2


def test_cli_select_ignore_and_list(tmp_path, capsys):
    dirty = tmp_path / "dirty.py"
    dirty.write_text(DIRTY)
    assert main(["--no-contracts", "--select", "KSL009", str(dirty)]) == 0
    assert main(["--no-contracts", "--ignore", "KSL004", str(dirty)]) == 0
    capsys.readouterr()
    assert main(["--list-rules"]) == 0
    listed = {line.split()[0] for line in capsys.readouterr().out.splitlines()}
    assert listed == set(all_rules()) | {c.id for c in CONTRACT_CHECKS}


def test_cli_reports_and_placement_flag(tmp_path, capsys):
    src = tmp_path / PORT / "streaming" / "mod.py"
    src.parent.mkdir(parents=True)
    src.write_text(
        "import threading\n\n\nclass C:\n    def __init__(self):\n        self._lock = threading.Lock()\n"
        "        self.n = 0\n\n    def bump(self):\n        with self._lock:\n            self.n += 1\n"
    )
    conc, life, place = (tmp_path / f"{n}.json" for n in ("c", "l", "p"))
    rc = main([
        "--no-contracts", "--placement", "--concurrency-report", str(conc), "--lifecycle-report", str(life),
        "--placement-report", str(place), str(src),
    ])
    assert rc == 0
    report = json.loads(conc.read_text())
    assert set(report) == {"threads", "lock_graph", "guards"}
    assert report["guards"] == {f"{PORT}/streaming/mod.py::C": {"n": "_lock"}}
    assert set(json.loads(life.read_text())) == {"annotations", "owners", "prefixes", "resources"}
    assert json.loads(place.read_text())["rules"] == ["KSL022", "KSL023", "KSL024"]
    out = capsys.readouterr().out
    assert "KSL022" in out and "KSL004" not in out  # --placement runs the placement rules only


def test_json_report_keys_equal_the_jax_analyzers(tmp_path):
    from mpi_k_selection_tpu.analysis import render_json as jax_render
    from mpi_k_selection_tpu.analysis import run_analysis as jax_run

    dirty = tmp_path / "dirty.py"
    dirty.write_text(DIRTY)
    ours = json.loads(render_json(run_analysis([dirty], contracts=False)))
    theirs = json.loads(jax_render(jax_run([dirty], contracts=False)))
    assert set(ours) == set(theirs)
    assert set(ours["findings"][0]) == set(theirs["findings"][0])
    assert ours["findings"] == theirs["findings"]


def test_suppression_forms(tmp_path):
    """``# ksel-torch:`` suppresses any rule; the JAX form only the shared
    rules; a stale ``ksel-torch`` suppression is reported, and a JAX-form
    one of a torch-only rule is not read at all."""
    src = (
        "import time\n"
        "t0 = time.time()  # ksel-torch: noqa[KSL004] -- a raw clock kept on purpose\n"
        "t1 = time.time()  # ksel: noqa[KSL004] -- the JAX form counts for a shared rule\n"
        "x = 1  # ksel-torch: noqa[KSL004] -- stale\n"
        "y = 2  # ksel: noqa[KSL011] -- a torch-only rule: not read\n"
        "t2 = time.time()  # ksel: noqa[KSL009] -- other rule  # ksel-torch: noqa[KSL004] -- both forms\n"
    )
    report = _lint(tmp_path, src, "mod.py")
    assert report.unsuppressed == []
    assert [(f.line, f.justification) for f in report.findings] == [
        (2, "a raw clock kept on purpose"), (3, "the JAX form counts for a shared rule"), (6, "both forms"),
    ]
    assert [(d["line"], d["rule"]) for d in report.dead_suppressions] == [(4, "KSL004"), (6, "KSL009")]


# ---------------------------------------------------------------------------
# parity with the JAX analyzer on its own fixtures

FIXTURE_FILES = ("test_analysis.py", "test_concurrency.py", "test_lifecycle.py")
FIXTURE_NAME = re.compile(r"^KSL0(04|08|09|12|13|15|16|17|19|20|21)_[A-Z_0-9]+$")


def _fixtures():
    out = []
    for name in FIXTURE_FILES:
        tree = ast.parse((REPO / "tests" / name).read_text())
        for node in tree.body:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and FIXTURE_NAME.match(node.targets[0].id)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
            ):
                out.append((node.targets[0].id, textwrap.dedent(node.value.value)))
    return out


FIXTURES = _fixtures()


def _as_port(source: str) -> str:
    return re.sub(r"\bstage_(device_)?keys\b", "stage_chunk", source)


@pytest.mark.parametrize("sub", ("streaming", "serve"))
def test_shared_rules_match_the_jax_analyzer_on_its_fixtures(tmp_path, sub):
    from mpi_k_selection_tpu.analysis import run_analysis as jax_run

    assert len(FIXTURES) >= 30, [n for n, _ in FIXTURES]
    jax_files, port_files = [], []
    for name, src in FIXTURES:
        for pkg, text, files in (("mpi_k_selection_tpu", src, jax_files), (PORT, _as_port(src), port_files)):
            f = tmp_path / pkg / sub / f"{name.lower()}.py"
            f.parent.mkdir(parents=True, exist_ok=True)
            f.write_text(text)
            files.append(f)

    def books(report):
        return sorted((pathlib.Path(f.path).name, f.rule, f.line, f.suppressed) for f in report.findings)

    theirs = books(jax_run(jax_files, contracts=False, select=list(SHARED)))
    ours = books(run_analysis(port_files, contracts=False, select=list(SHARED)))
    fired = {"KSL012", "KSL015", "KSL016", "KSL017", "KSL019", "KSL020"} | ({"KSL008"} if sub == "streaming" else set())
    assert {r for _, r, _, _ in theirs} >= fired
    assert ours == theirs


# ---------------------------------------------------------------------------
# the rules in torch's vocabulary

KSL007_POSITIVE = """
def stage(c, devs, j):
    a = c.cuda()
    b = c.to("cuda")
    return a, b
"""
KSL007_NEGATIVE = """
import torch


def stage(c, devs, j, device):
    a = c.to(devs[j % len(devs)], non_blocking=True)
    b = c.cuda(1)
    d = c.to(device)
    return a, b, d, c.to(torch.int64)
"""


def test_ksl007(tmp_path):
    one = dict(select=["KSL007"])
    assert _hits(_lint(tmp_path, KSL007_POSITIVE, f"{PORT}/streaming/a.py", **one)) == {("KSL007", 3), ("KSL007", 4)}
    assert _hits(_lint(tmp_path, KSL007_NEGATIVE, f"{PORT}/streaming/b.py", **one)) == set()
    assert _hits(_lint(tmp_path, KSL007_POSITIVE, f"{PORT}/ops/c.py", **one)) == set()


KSL010_POSITIVE = """
import torch


@torch.compile
def handler(x):
    return torch.jit.script(x)
"""


def test_ksl010(tmp_path):
    hits = _hits(_lint(tmp_path, KSL010_POSITIVE, f"{PORT}/serve/server.py"))
    assert hits == {("KSL010", 6), ("KSL010", 7)}  # the decorated def, the call
    assert _hits(_lint(tmp_path, KSL010_POSITIVE, f"{PORT}/serve/registry.py")) == set()


KSL011_POSITIVE = """
def consume(kv, m):
    return kv[m].cpu(), kv[:3].numpy(), kv[m].tolist(), kv.cpu()
"""


def test_ksl011(tmp_path):
    report = _lint(tmp_path, KSL011_POSITIVE, f"{PORT}/streaming/chunked.py", select=["KSL011"])
    assert [f.message.split("`")[1] for f in report.unsuppressed] == [".cpu()", ".numpy()", ".tolist()"]
    assert _hits(_lint(tmp_path, KSL011_POSITIVE, f"{PORT}/streaming/executor.py", select=["KSL011"])) == set()


KSL014_POSITIVE = """
def consume(staged):
    h = radix_histogram(staged.data, shift=0, radix_bits=4)
    c = match_counts(staged.data, resolved_bits=4, prefixes=p)
    return h, c
"""
KSL014_NEGATIVE = """
def consume(staged, other):
    return sweep_ingest(staged.data, staged.n_valid), sweep_ingest(other.data, other.n_valid)
"""


def test_ksl014(tmp_path):
    assert _hits(_lint(tmp_path, KSL014_POSITIVE, f"{PORT}/streaming/x.py", select=["KSL014"])) == {("KSL014", 4)}
    assert _hits(_lint(tmp_path, KSL014_NEGATIVE, f"{PORT}/streaming/y.py", select=["KSL014"])) == set()


PLACEMENT_POSITIVE = """
import random
import time


def run(c, chunks, devices):
    devs = resolve_stream_devices(devices)
    a = c.to(devs[0])
    b = c.to(devs[1])
    sweep_ingest(a, b)
    host = c.cpu()
    d = c.to(devs[int(time.time()) % len(devs)])
    e = c.to(devs[random.randrange(2)])
    return host, d, e
"""


def test_placement_rules(tmp_path):
    hits = _hits(_lint(tmp_path, PLACEMENT_POSITIVE, f"{PORT}/serve/p.py", select=["KSL022", "KSL023", "KSL024"]))
    assert ("KSL022", 10) in hits
    assert {("KSL023", n) for n in (8, 9, 11, 12, 13)} <= hits
    assert {("KSL024", 12), ("KSL024", 13)} <= hits


def test_placed_on_annotation_and_its_audit(tmp_path):
    src = (
        "def run(c, devs):\n"
        "    return c.to(devs[1])  # ksel-torch: placed-on[devs[1]] -- the caller's slot\n"
        "x = 1  # ksel-torch: placed-on[devs[0]] -- stale: no site here\n"
    )
    report = _lint(tmp_path, src, f"{PORT}/serve/q.py", select=["KSL022", "KSL023"])
    assert _hits(report) == {("KSL022", 3)}


# ---------------------------------------------------------------------------
# the gate over the port


def test_port_gate_no_findings_no_stale_suppressions():
    report = run_analysis([REPO / PORT], root=REPO, contracts=False, mods=shared_modules([REPO / PORT], root=REPO))
    assert report.unsuppressed == [], "\n".join(f.render() for f in report.unsuppressed)
    assert report.dead_suppressions == [], report.dead_suppressions
    assert [f.render() for f in report.findings if f.suppressed and not f.justification] == []
    assert len(report.files) > 80


def test_rule_catalog_matches_docs():
    registered = set(all_rules()) | {c.id for c in CONTRACT_CHECKS} | {"KSL000"}
    doc = (REPO / "docs" / "TORCH_ANALYSIS.md").read_text()
    documented = set(re.findall(r"^\| (KS[LC]\d{3}) \|", doc, re.MULTILINE))
    assert documented == registered
    not_ported = {"KSL001", "KSL002", "KSL003", "KSL006"}
    assert not (not_ported & registered)
    assert all(r in doc for r in not_ported)


def test_version_and_prefixes_come_from_the_registry():
    import mpi_k_selection_tpu
    from mpi_k_selection_tpu import resource_protocols as jax_rp

    import mpi_k_selection_tpu_torch as kt
    from mpi_k_selection_tpu_torch import resource_protocols as rp
    from mpi_k_selection_tpu_torch.monitor import monitor
    from mpi_k_selection_tpu_torch.obs import flight
    from mpi_k_selection_tpu_torch.serve import batcher
    from mpi_k_selection_tpu_torch.streaming import pipeline, spill

    assert "__version__" in kt.__all__ and kt.__version__ == mpi_k_selection_tpu.__version__
    assert spill.SPILL_DIR_PREFIX is rp.SPILL_DIR_PREFIX
    assert pipeline.THREAD_NAME_PREFIX is rp.PIPELINE_THREAD_PREFIX
    assert batcher.SERVE_THREAD_PREFIX is rp.SERVE_THREAD_PREFIX
    assert flight.FLIGHT_FILE_PREFIX is rp.FLIGHT_FILE_PREFIX
    assert monitor.MONITOR_THREAD_PREFIX is rp.MONITOR_THREAD_PREFIX
    assert rp.RESOURCE_PREFIXES == jax_rp.RESOURCE_PREFIXES and rp.OWNER_SITES == jax_rp.OWNER_SITES


def test_module_runs_without_jax():
    code = (
        "import sys, runpy\n"
        "sys.argv = ['analysis', '--no-contracts', '--select', 'KSL004', 'mpi_k_selection_tpu_torch/analysis']\n"
        "try:\n"
        "    runpy.run_module('mpi_k_selection_tpu_torch.analysis', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'mpi_k_selection_tpu')]\n"
        "assert rc == 0 and not bad, (rc, bad)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
    assert out.stdout.strip().endswith("ok")
