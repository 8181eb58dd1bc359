"""Build the native runtime: ``python -m mpi_k_selection_tpu_torch.native.build``.

One ``g++`` call turns this package's ``kselect_native.cpp`` into
``_build/libkselect_native-<hash>.so`` in the port's package, the hash
covering the source and the flags, so an edited source is never served
by a stale library. The loader (loader.py) calls :func:`build` lazily at
first use; an explicit build is needed only to see the compiler's output.
Nothing here runs when the package is imported.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import sys

_DIR = pathlib.Path(__file__).resolve().parent
SOURCES = [_DIR / "kselect_native.cpp"]
BUILD_DIR = _DIR.parent / "_build"
COMPILE_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall"]


def lib_path() -> pathlib.Path:
    """Where the library of the current sources and flags lives."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for s in SOURCES:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libkselect_native-{h.hexdigest()[:16]}.so"


def build(force: bool = False, quiet: bool = True) -> pathlib.Path:
    """Compile the shared library unless the current one exists; return
    its path. Concurrent builders agree: each writes a file of its own and
    renames it into place."""
    out = lib_path()
    if out.exists() and not force:
        return out
    gxx = shutil.which("g++") or shutil.which("clang++")
    if gxx is None:
        raise RuntimeError("no C++ compiler found (need g++ or clang++)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(
        [gxx, *COMPILE_FLAGS, *[str(s) for s in SOURCES], "-o", str(tmp)], capture_output=True, text=True
    )
    if res.returncode != 0:
        raise RuntimeError(f"native build failed:\n{res.stderr}")
    os.replace(tmp, out)
    if not quiet:
        print(f"built {out}")  # ksel: noqa[KSL009] -- opt-in build-tool progress line (quiet=False only from the __main__ entry), not runtime telemetry
    return out


if __name__ == "__main__":
    build(force="--force" in sys.argv, quiet=False)
