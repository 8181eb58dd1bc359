"""Session-scoped shared parsed-module cache (counterpart of the JAX
package's ``analysis/modcache.py``).

``shared_modules`` parses a tree once and hands every pass the SAME
:class:`~mpi_k_selection_tpu_torch.analysis.core.SourceModule` list, so
the per-module analyzer caches (concurrency's, lifecycle's, placement's,
keyed by ``id(mod)``) hit across the gate tests instead of recomputing.

The cache key is (resolved scan paths, root); the value is guarded by a
per-file (path, mtime_ns, size) fingerprint, so an edited file
invalidates the whole set.
"""

from __future__ import annotations

import os
import pathlib

from mpi_k_selection_tpu_torch.analysis.core import iter_python_files, load_module


_CACHE: dict[tuple, tuple] = {}


def _fingerprint(files) -> tuple:
    out = []
    for f in files:
        try:
            st = os.stat(f)
        except OSError:  # racing delete: treat as changed
            out.append((str(f), -1, -1))
            continue
        out.append((str(f), st.st_mtime_ns, st.st_size))
    return tuple(out)


def shared_modules(paths, *, root=None) -> list:
    """The parsed :class:`SourceModule` list for ``paths`` — cached
    across calls (and across the four gate test files) until any file's
    (mtime, size) changes. An unparseable file RAISES here rather than
    being silently dropped: a gate fed a shared set must never scan a
    quietly-smaller tree than the uncached path would (KSL000's
    scan-the-broken-file-anyway semantics stay with ``run_analysis``'s
    own parse loop, which fixture tests exercise without the cache)."""
    key = (
        tuple(sorted(str(pathlib.Path(p).resolve()) for p in paths)),
        str(pathlib.Path(root).resolve()) if root is not None else None,
    )
    files = iter_python_files(paths)
    fp = _fingerprint(files)
    hit = _CACHE.get(key)
    if hit is not None and hit[0] == fp:
        return hit[1]
    mods = [load_module(f, root=root) for f in files]
    _CACHE[key] = (fp, mods)
    return mods


def clear() -> None:
    """Drop the cache (tests that synthesize trees under one path)."""
    _CACHE.clear()
