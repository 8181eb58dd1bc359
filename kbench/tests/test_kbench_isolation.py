"""The benchmark measures the port alone: no run loads JAX or the JAX
package, whose name the port's begins with."""

import ast
import pathlib
import subprocess
import sys

import pytest

from kbench import harness, manifest

ROOT = manifest.ROOT


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("mpi_k_selection_tpu_torch", "mpi_k_selection_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not set(harness.forbidden_modules()) & {"mpi_k_selection_tpu_torch", "jaxtyping", "flaxen"}
    for name, top in (("mpi_k_selection_tpu.api", "mpi_k_selection_tpu"), ("jaxlib.xla_client", "jaxlib")):
        monkeypatch.setitem(sys.modules, name, sys)
        assert top in harness.forbidden_modules()


def test_a_runs_set_up_loads_no_forbidden_module():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from kbench import harness, manifest\n"
        "m = manifest.load()\n"
        "for w in m['workloads']:\n"
        "    c = manifest.Cell(m, w['name'])\n"
        "    c.config.update(n=1 << 15, batch=64, width=4096, ring=2)\n"
        "    c.params.pop('expect_algorithm', None)\n"
        "    assert harness.run_cell(c, 3, 0.05, device='cpu')['correct']\n"
        "print(harness.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix() for p in manifest.PKG.rglob("*.py")
                                        if "__pycache__" not in p.parts))
def test_no_file_imports_jax_or_the_port_helpers(path):
    # a freed cache leaves the allocator in a state that slows later calls (PERF.md, row 5)
    assert "empty_cache" not in (ROOT / path).read_text() or path.startswith("kbench/tests/")
    for mod in _imports(ROOT / path):
        top = mod.split(".", 1)[0]
        assert top not in harness.FORBIDDEN, (path, mod)
        # the port is the system under test: its plain kernels, oracles and tests are not the yardstick
        assert not mod.endswith("_plain") and top != "tests" and ".oracle" not in mod, (path, mod)
        if path.startswith("kbench/reference/") or path in ("kbench/keyorder.py", "kbench/work.py",
                                                           "kbench/gen.py", "kbench/stats.py"):
            assert top != "mpi_k_selection_tpu_torch", (path, mod)


def test_the_command_fails_without_the_port(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files
    the command exits non-zero and prints no result."""
    import shutil

    shutil.copytree(manifest.PKG, tmp_path / "kbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / manifest.MANIFEST, tmp_path / manifest.MANIFEST)
    out = subprocess.run([sys.executable, "kbench/run.py", "--workload", "keys-i32-1g.select", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
