"""The PyTorch port stands alone: no file of ``mpi_k_selection_tpu_torch``
and no line of ``chip_smoke.py`` imports JAX or the JAX package, and
importing the port (its distributed, backend, native, sketch and monitor
modules too) loads neither, builds no kernel or native library and starts
no process group."""

import ast
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "mpi_k_selection_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "mpi_k_selection_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.lineno, node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None)) in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield node.lineno, str(node.args[0].value)


def test_port_and_chip_smoke_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10 and files[-1].exists()
    bad = [
        f"{f.relative_to(REPO)}:{line}: {mod}"
        for f in files
        for line, mod in _imports(f)
        if _forbidden(mod)
    ]
    assert bad == []


def test_scanner_catches_a_jax_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import numpy\nimport jax.numpy as jnp\nfrom mpi_k_selection_tpu.ops import radix\n"
        "import mpi_k_selection_tpu_torch\nimportlib.import_module('jax')\n"
    )
    assert [m for _, m in _imports(probe) if _forbidden(m)] == [
        "jax.numpy", "mpi_k_selection_tpu.ops", "jax",
    ]


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    code = (
        "import sys\n"
        "import mpi_k_selection_tpu_torch, mpi_k_selection_tpu_torch.cli\n"
        "import mpi_k_selection_tpu_torch.backends.cuda\n"
        "import mpi_k_selection_tpu_torch.backends.seq, mpi_k_selection_tpu_torch.backends.mpi\n"
        "import mpi_k_selection_tpu_torch.parallel.multihost, mpi_k_selection_tpu_torch.buffer\n"
        "import mpi_k_selection_tpu_torch.parallel.sketch, mpi_k_selection_tpu_torch.streaming.sketch\n"
        "import mpi_k_selection_tpu_torch.monitor.monitor\n"
        "from mpi_k_selection_tpu_torch.native import loader\n"
        "from mpi_k_selection_tpu_torch.ops.cuda import build\n"
        "import torch.distributed as dist\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'mpi_k_selection_tpu')]\n"
        "assert not bad, bad\n"
        "assert not build._libs and loader._lib is None and not dist.is_initialized()\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_fault_harness_flight_recorder_and_cli_monitor_load_no_jax(tmp_path):
    """The fault harness (``faults/*``), the flight recorder
    (``obs/flight.py``), a chaos run with its debug bundle and the CLI's
    ``monitor`` path with its Prometheus server run without loading JAX or
    the JAX package."""
    files = sorted((PORT / "faults").glob("*.py")) + [PORT / "obs" / "flight.py", PORT / "monitor" / "monitor.py"]
    assert len(files) == 7 and not [m for f in files for _, m in _imports(f) if _forbidden(m)]
    code = (
        "import sys\n"
        "import mpi_k_selection_tpu_torch.faults, mpi_k_selection_tpu_torch.obs.flight\n"
        "from mpi_k_selection_tpu_torch import cli\n"
        f"assert cli.main(['monitor', '--buckets', '2', '--chunk-elems', '512', '--device', 'cpu',"
        f" '--prometheus-port', '0']) == 0\n"
        f"assert cli.main(['--streaming', '--n', '20000', '--chunk-elems', '4096', '--device', 'cpu', '--spill',"
        f" 'force', '--spill-dir', {str(tmp_path)!r}, '--chaos', '7', '--check', '--debug-bundle',"
        f" {str(tmp_path / 'b.json')!r}]) == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'mpi_k_selection_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["b.json"]


def test_serve_and_cli_serve_load_no_jax(tmp_path):
    """The query server (``serve/*``) imports no JAX, and the CLI's
    ``serve --device cpu --port 0 --quit-after 1``, answering one query,
    runs without loading JAX or the JAX package."""
    files = sorted((PORT / "serve").glob("*.py"))
    assert len(files) == 8 and not [m for f in files for _, m in _imports(f) if _forbidden(m)]
    port_file = tmp_path / "port"
    code = (
        "import json, sys, threading, time, urllib.request\n"
        "from mpi_k_selection_tpu_torch import cli\n"
        "rc = []\n"
        f"argv = ['serve', '--device', 'cpu', '--n', '4096', '--port', '0', '--port-file', {str(port_file)!r},"
        " '--quit-after', '1']\n"
        "t = threading.Thread(target=lambda: rc.append(cli.main(argv)))\n"
        "t.start()\n"
        "import pathlib\n"
        f"p = pathlib.Path({str(port_file)!r})\n"
        "for _ in range(1200):\n"
        "    if p.exists() and p.read_text():\n"
        "        break\n"
        "    time.sleep(0.05)\n"
        "body = json.dumps({'dataset': 'default', 'op': 'kselect', 'k': 1, 'tier': 'exact'}).encode()\n"
        "req = urllib.request.Request(f'http://127.0.0.1:{p.read_text()}/v1/query', data=body, method='POST')\n"
        "with urllib.request.urlopen(req, timeout=60) as r:\n"
        "    answer = json.loads(r.read())['answers'][0]\n"
        "t.join(60)\n"
        "assert rc == [0] and answer['exact'] and answer['tier'] == 'exact', (rc, answer)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'mpi_k_selection_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_the_analyzer_loads_no_jax():
    """The port's analyzer, imported and run as ``python -m
    mpi_k_selection_tpu_torch.analysis --help``, loads neither JAX nor the
    JAX package (its analyzer included)."""
    files = sorted((PORT / "analysis").glob("*.py")) + [PORT / "resource_protocols.py", PORT / "version.py"]
    assert len(files) >= 12 and not [m for f in files for _, m in _imports(f) if _forbidden(m)]
    code = (
        "import sys, runpy\n"
        "import mpi_k_selection_tpu_torch.analysis\n"
        "from mpi_k_selection_tpu_torch.analysis import contracts, lockorder, placement\n"
        "sys.argv = ['analysis', '--help']\n"
        "try:\n"
        "    runpy.run_module('mpi_k_selection_tpu_torch.analysis', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'mpi_k_selection_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok") and "--no-contracts" in out.stdout


#: Names of the JAX subpackages' ``__all__`` that the port does not export,
#: each with the reason: they name the JAX package's XLA / Pallas machinery.
TPU_ONLY_NAMES = {
    "streaming": {
        "DEFAULT_DEFERRED": "the eager / deferred choice of XLA dispatch; the port always defers on CUDA events",
        "resolve_deferred": "the same XLA dispatch choice",
        "DEFAULT_FUSED": "the Pallas / XLA-fusion ingest tiers; the port runs one sweep kernel a chunk",
        "FUSED_MODES": "the same ingest tiers",
        "FUSED_TIERS": "the same ingest tiers",
        "validate_fused": "the same ingest tiers",
        "resolve_fused": "the same ingest tiers",
        "kernel_tier_available": "whether the Pallas tier compiles on this backend",
        "stage_device_keys": "pads a chunk already on a device to a power-of-two bucket, as XLA compiles a "
                             "program per shape; the port stages every chunk at its own length",
    },
    "ops": {},
    "utils": {},
}


def _jax_all(sub: str) -> list:
    """The ``__all__`` of ``mpi_k_selection_tpu/<sub>/__init__.py``, read
    with ast (nothing of the JAX package is imported)."""
    tree = ast.parse((REPO / "mpi_k_selection_tpu" / sub / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    raise AssertionError(f"no __all__ in mpi_k_selection_tpu/{sub}/__init__.py")


def test_subpackages_export_the_jax_names():
    """``streaming``, ``ops`` and ``utils`` export every name of the JAX
    subpackage's ``__all__`` (``ops.topk`` the function, as there), or the
    name is in ``TPU_ONLY_NAMES`` with its reason; importing them loads no
    JAX and builds no kernel."""
    listed = {}
    for sub, skip in TPU_ONLY_NAMES.items():
        names = _jax_all(sub)
        assert len(names) == {"streaming": 29, "ops": 5, "utils": 3}[sub]
        assert set(skip) <= set(names) and all(skip.values())
        listed[sub] = [n for n in names if n not in skip]
    code = (
        "import importlib, sys\n"
        f"listed = {listed!r}\n"
        "for sub, names in listed.items():\n"
        "    mod = importlib.import_module('mpi_k_selection_tpu_torch.' + sub)\n"
        "    missing = [n for n in names if n not in mod.__all__ or not hasattr(mod, n)]\n"
        "    assert not missing, (sub, missing)\n"
        "from mpi_k_selection_tpu_torch import ops\n"
        "from mpi_k_selection_tpu_torch.ops.cuda import build\n"
        "assert callable(ops.topk) and ops.topk.__name__ == 'topk' and not build._libs\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'mpi_k_selection_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
