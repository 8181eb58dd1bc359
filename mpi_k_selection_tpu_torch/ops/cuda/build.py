"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file exposes a plain C interface (no PyTorch headers),
so one ``nvcc`` call builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<stem>-<hash>.so csrc/<stem>.cu

The library goes into the package's ``_build/`` directory at first use, its
name carrying a hash of the source, so an edited source is never served by
a stale library; the ``ptxas`` report (registers, shared memory, spills)
is kept beside it as ``lib<stem>-<hash>.log`` (:func:`build_log`). Sources
build in parallel, one ``nvcc`` each. Nothing here runs when the package
is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _target(src: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_log(lib: pathlib.Path) -> str:
    """The ``nvcc``/``ptxas`` output that built ``lib``."""
    return lib.with_suffix(".log").read_text()


def build_all(stems=None) -> dict[str, pathlib.Path]:
    """Build every source (or those named in ``stems``) that has no current
    library yet, all ``nvcc`` processes at once; return stem -> library."""
    srcs = sorted(SRC_DIR.glob("*.cu"))
    if stems is not None:
        srcs = [s for s in srcs if s.stem in stems]
    out = {s.stem: _target(s) for s in srcs}
    todo = [s for s in srcs if not out[s.stem].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for src in todo:
        tmp = out[src.stem].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        # log first, then the library: a library on disk always has its log
        tmp.with_suffix(".logtmp").write_text(log)
        os.replace(tmp.with_suffix(".logtmp"), out[src.stem].with_suffix(".log"))
        os.replace(tmp, out[src.stem])  # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built on first use."""
    lib = _libs.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([stem])[stem]))
        _libs[stem] = lib
    return lib
