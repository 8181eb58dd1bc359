"""Runtime lock-order sanitizer, the dynamic half of the KSL016 contract
(counterpart of ``mpi_k_selection_tpu/analysis/lockorder.py``).

An opt-in harness that wraps ``threading.Lock`` / ``threading.RLock``
construction with a recording proxy: every successful acquisition is
appended to a per-thread held-list, and each acquisition made while other
locks are held records *acquired-while-holding* edges — the graph the
static pass (analysis/concurrency.py:build_lock_graph) derives from the
source, observed here from real interleavings (the pipelined descent, a
server session). ``find_cycles`` checks the observed graph is acyclic and
``check_consistency`` finds edges whose reverse the static graph commits
to. On exit the window publishes its graph as :data:`LAST_OBSERVED`,
which a flight bundle carries as its ``lock_order`` section
(obs/flight.py).

Labels: a tracked lock is labeled by the first package-owned stack frame
at its construction (``mpi_k_selection_tpu_torch/<path>:<line>``), the
definition line the static graph records as the node's ``site``, so the
two graphs join with no name mapping. Locks made outside the package are
labeled ``ext:<file>:<line>`` and take part in edge recording but not in
the package's acyclicity.

Scope and honesty bounds:

- Only locks CONSTRUCTED inside the window are tracked. The package's
  module-level locks (the staging pool, the fault injector's active slot,
  the native loader, the flight recorder's dump list) predate any window,
  so :meth:`LockOrderSanitizer.patch_package_locks` swaps them for tracked
  proxies labeled with their static node keys, and restores them on exit.
- Two lock OBJECTS sharing one creation-site label (per-request locks)
  cannot be ordered by label: such an edge is counted in
  ``same_label_pairs`` instead of a self-loop.
- ``threading.Condition``'s waiter locks come from
  ``_thread.allocate_lock`` directly, so Condition/Event/Queue internals
  do not pollute the graph; their *mutex* (a ``threading.Lock()``) IS
  tracked.
"""

from __future__ import annotations

import json
import sys
import threading

_PKG_MARKER = "mpi_k_selection_tpu_torch"

#: The most recent sanitizer window's observed graph (``to_dict()``
#: form), published at window exit — the flight recorder's debug bundle
#: (obs/flight.py) embeds it as the ``lock_order`` section when a
#: sanitizer ran in this process. ``None`` until one has.
LAST_OBSERVED: dict | None = None


def _creation_label() -> str:
    """Label for a lock created right now: the first stack frame inside
    the package (``<relpath from package root>:<line>``), else the first
    frame outside this module/threading, as ``ext:<file>:<line>``."""
    f = sys._getframe(2)
    fallback = None
    while f is not None:
        fn = f.f_code.co_filename.replace("\\", "/")
        if _PKG_MARKER in fn:
            idx = fn.rindex(_PKG_MARKER)
            return f"{fn[idx:]}:{f.f_lineno}"
        if fallback is None and not fn.endswith(
            ("analysis/lockorder.py", "threading.py", "queue.py", "dataclasses.py")
        ):
            fallback = f"ext:{fn.rsplit('/', 1)[-1]}:{f.f_lineno}"
        f = f.f_back
    return fallback or "ext:?"


class TrackedLock:
    """Proxy around a real lock primitive that reports successful
    acquisitions/releases to its sanitizer. Supports the full Lock/RLock
    protocol the stdlib relies on (``Condition`` works with a tracked
    mutex via the generic release/acquire fallback paths)."""

    def __init__(self, inner, sanitizer: "LockOrderSanitizer", label: str):
        # reentrancy needs no flag: _on_acquire's identity check handles
        # a re-acquire of the same object for Lock and RLock alike
        self._inner = inner
        self._san = sanitizer
        self.label = label

    def acquire(self, blocking=True, timeout=-1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._san._on_acquire(self)
        return ok

    def release(self):
        self._san._on_release(self)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # RLock plumbing threading.Condition probes for -------------------------

    def _is_owned(self):
        inner = getattr(self._inner, "_is_owned", None)
        if inner is not None:
            return inner()
        # plain-lock fallback (mirrors threading.Condition's own)
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _release_save(self):
        # full release regardless of depth: purge our bookkeeping first
        self._san._on_release_full(self)
        inner = getattr(self._inner, "_release_save", None)
        if inner is not None:
            return inner()
        self._inner.release()
        return None

    def _acquire_restore(self, state):
        inner = getattr(self._inner, "_acquire_restore", None)
        if inner is not None:
            inner(state)
        else:
            self._inner.acquire()
        self._san._on_acquire(self)

    def __repr__(self):
        return f"<TrackedLock {self.label} wrapping {self._inner!r}>"


class LockOrderSanitizer:
    """Context manager arming the tracked-lock factories and collecting
    the runtime acquired-while-holding graph. Reentrant acquisition of
    one lock never records a self-edge; edges between distinct objects
    sharing a label go to :attr:`same_label_pairs`."""

    def __init__(self):
        # bookkeeping runs under a REAL lock (created before patching)
        self._state_lock = threading.Lock()
        self._local = threading.local()
        self.edges: dict = {}  # (src_label, dst_label) -> count
        self.same_label_pairs: dict = {}  # label -> count
        self.labels: set = set()
        self.threads_seen: set = set()
        self._saved = None
        self._module_patches: list = []

    # -- factory patching --------------------------------------------------

    def _make_lock(self):
        return TrackedLock(self._real_lock(), self, _creation_label())

    def _make_rlock(self):
        return TrackedLock(self._real_rlock(), self, _creation_label())

    def __enter__(self) -> "LockOrderSanitizer":
        if self._saved is not None:
            raise RuntimeError("LockOrderSanitizer is not reentrant")
        self._saved = (threading.Lock, threading.RLock)
        self._real_lock, self._real_rlock = self._saved
        threading.Lock = self._make_lock
        threading.RLock = self._make_rlock
        return self

    def __exit__(self, *exc):
        threading.Lock, threading.RLock = self._saved
        self._saved = None
        for obj, attr, original in self._module_patches:
            setattr(obj, attr, original)
        self._module_patches.clear()
        # publish the observed graph for postmortem consumers (the flight
        # recorder's debug bundle); single assignment, last window wins
        global LAST_OBSERVED
        LAST_OBSERVED = self.to_dict()
        return False

    def wrap_existing(self, obj, attr: str, label: str) -> None:
        """Swap an already-constructed lock living at ``obj.attr`` for a
        tracked proxy (restored on exit). Callers must name attributes
        that are looked up per use (module globals, instance attrs) —
        captured references keep the raw lock."""
        original = getattr(obj, attr)
        if isinstance(original, TrackedLock):  # already wrapped
            return
        setattr(obj, attr, TrackedLock(original, self, label))
        self._module_patches.append((obj, attr, original))

    def patch_package_locks(self) -> None:
        """Wrap the package's module-level locks (created at import time,
        before any sanitizer window) with labels equal to their static
        lock-graph node keys, so the consistency check joins them too."""
        # faults/__init__.py re-exports a FUNCTION named `inject`, which
        # shadows the submodule on attribute-style imports — resolve the
        # module objects through importlib
        import importlib

        _inj = importlib.import_module("mpi_k_selection_tpu_torch.faults.inject")
        _ld = importlib.import_module("mpi_k_selection_tpu_torch.native.loader")
        _pl = importlib.import_module("mpi_k_selection_tpu_torch.streaming.pipeline")
        _fl = importlib.import_module("mpi_k_selection_tpu_torch.obs.flight")

        self.wrap_existing(
            _pl.STAGING_POOL, "_lock",
            "mpi_k_selection_tpu_torch/streaming/pipeline.py::StagingPool._lock",
        )
        self.wrap_existing(_inj, "_ACTIVE_LOCK", "mpi_k_selection_tpu_torch/faults/inject.py::_ACTIVE_LOCK")
        self.wrap_existing(_ld, "_lock", "mpi_k_selection_tpu_torch/native/loader.py::_lock")
        self.wrap_existing(_fl, "_DUMPED_LOCK", "mpi_k_selection_tpu_torch/obs/flight.py::_DUMPED_LOCK")

    # -- bookkeeping -------------------------------------------------------

    def _held(self) -> list:
        held = getattr(self._local, "held", None)
        if held is None:
            held = []
            self._local.held = held
        return held

    def _on_acquire(self, lock: TrackedLock) -> None:
        held = self._held()
        for entry in held:
            if entry[0] is lock:
                entry[1] += 1  # reentrant re-acquire: no edge, no new hold
                return
        new_edges = []
        same_label = []
        for other, _depth in held:
            if other.label == lock.label:
                same_label.append(other.label)
            else:
                new_edges.append((other.label, lock.label))
        held.append([lock, 1])
        # identity via the C-level get_ident(): current_thread() would
        # CONSTRUCT a _DummyThread (Event -> another tracked lock ->
        # recursive _on_acquire) for not-yet-registered threads — a
        # self-deadlock on _state_lock
        ident = threading.get_ident()
        with self._state_lock:
            self.labels.add(lock.label)
            self.threads_seen.add(ident)
            for e in new_edges:
                self.edges[e] = self.edges.get(e, 0) + 1
            for lab in same_label:
                self.same_label_pairs[lab] = (
                    self.same_label_pairs.get(lab, 0) + 1
                )

    def _on_release(self, lock: TrackedLock) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                held[i][1] -= 1
                if held[i][1] <= 0:
                    del held[i]
                return

    def _on_release_full(self, lock: TrackedLock) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                del held[i]
                return

    # -- analysis ----------------------------------------------------------

    @staticmethod
    def _is_package_label(label: str) -> bool:
        return label.startswith(_PKG_MARKER)

    def _snapshot(self) -> tuple:
        """One consistent copy of the mutable state (workload threads may
        still be recording while an observer reads — KSL015)."""
        with self._state_lock:
            return (
                dict(self.edges),
                dict(self.same_label_pairs),
                set(self.labels),
                set(self.threads_seen),
            )

    def package_edges(self) -> list:
        """Observed edges with BOTH endpoints package-owned — the
        subgraph the acyclicity and consistency contracts cover."""
        edges, _, _, _ = self._snapshot()
        return sorted(
            (a, b, n)
            for (a, b), n in edges.items()
            if self._is_package_label(a) and self._is_package_label(b)
        )

    def find_cycles(self, *, package_only: bool = True) -> list:
        from mpi_k_selection_tpu_torch.analysis.concurrency import cycles_from_pairs

        pairs = (
            [(a, b) for a, b, _n in self.package_edges()]
            if package_only
            else list(self._snapshot()[0])
        )
        return cycles_from_pairs(pairs)

    def assert_acyclic(self) -> None:
        cycles = self.find_cycles(package_only=True)
        if cycles:
            raise AssertionError(
                "runtime lock-order cycle(s) observed: "
                + " ; ".join(" -> ".join(c + [c[0]]) for c in cycles)
            )

    def check_consistency(self, static_graph: dict) -> list:
        """Direction conflicts between the observed order and the static
        KSL016 graph (analysis/concurrency.py:build_concurrency_report's
        ``lock_graph``): a runtime edge A->B conflicts when the static
        graph orders the same two locks B->A. Locks are joined on the
        static node ``site`` (``relpath:lineno``) or the node key itself
        (module-global proxies are labeled with their keys directly);
        runtime labels with no static counterpart are skipped — the
        static pass is module-local and lexical, so the runtime graph is
        allowed to see MORE, never the reverse of what the static graph
        committed to."""
        site_to_key = {}
        for key, node in static_graph["nodes"].items():
            site_to_key[node["site"]] = key
            site_to_key[key] = key
        static_edges = {
            (e["src"], e["dst"]) for e in static_graph["edges"]
        }
        conflicts = []
        edges, _, _, _ = self._snapshot()
        for (a, b), n in sorted(edges.items()):
            ka, kb = site_to_key.get(a), site_to_key.get(b)
            if ka is None or kb is None:
                continue
            if (kb, ka) in static_edges and (ka, kb) not in static_edges:
                conflicts.append(
                    {
                        "runtime": [a, b],
                        "static": [kb, ka],
                        "count": n,
                    }
                )
        return conflicts

    def to_dict(self) -> dict:
        edges, same_label, labels, threads = self._snapshot()
        return {
            "labels": sorted(labels),
            "edges": [
                {"src": a, "dst": b, "count": n}
                for (a, b), n in sorted(edges.items())
            ],
            "package_edges": [
                {"src": a, "dst": b, "count": n}
                for a, b, n in self.package_edges()
            ],
            "same_label_pairs": dict(sorted(same_label.items())),
            "threads_seen": sorted(threads),
            "cycles": self.find_cycles(package_only=True),
        }

    def to_json(self, indent=2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)
