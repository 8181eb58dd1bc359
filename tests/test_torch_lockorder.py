"""The port's lock-order sanitizer (``analysis/lockorder.py``) against the
JAX package's, and the flight bundle's ``lock_order`` section.

An inverted pair of locks is caught as a cycle; the window publishes its
graph as ``LAST_OBSERVED`` and a flight bundle carries it; the graph's
format (``to_dict``) equals the JAX sanitizer's on the same two-lock
scenario; the package's module-level locks are wrapped and restored; and
a pipelined streamed median and a server session under one sanitizer
observe no cycle and no direction conflict with the port's static lock
graph.
"""

from __future__ import annotations

import pathlib
import threading

import numpy as np
import pytest

import mpi_k_selection_tpu_torch as kt
from mpi_k_selection_tpu_torch.analysis import LockOrderSanitizer, build_concurrency_report, lockorder
from mpi_k_selection_tpu_torch.obs import Observability
from mpi_k_selection_tpu_torch.obs.flight import build_bundle

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "mpi_k_selection_tpu_torch"


@pytest.fixture(autouse=True)
def _restore_last_observed():
    """A window publishes its graph process-wide; later tests in this
    worker expect the state before it (no sanitizer ran)."""
    import sys

    name = "mpi_k_selection_tpu.analysis.lockorder"
    saved = lockorder.LAST_OBSERVED, getattr(sys.modules.get(name), "LAST_OBSERVED", None)
    yield
    lockorder.LAST_OBSERVED = saved[0]
    if name in sys.modules:
        sys.modules[name].LAST_OBSERVED = saved[1]


# the scenario runs as code of its own file name, so both packages'
# sanitizers label its locks alike (``ext:two_locks.py:<line>``)
SCENARIO = compile(
    "def take_pair(x, y):\n"
    "    with x:\n"
    "        with y:\n"
    "            pass\n"
    "\n"
    "\n"
    "def scenario(sanitizer_cls, threading):\n"
    "    with sanitizer_cls() as san:\n"
    "        a = threading.Lock()\n"
    "        b = threading.Lock()\n"
    "        take_pair(a, b)\n"
    "        t = threading.Thread(target=take_pair, args=(b, a))\n"
    "        t.start()\n"
    "        t.join(timeout=10)\n"
    "    return san, a, b\n",
    "two_locks.py", "exec",
)


def _scenario(sanitizer_cls):
    """Two locks taken in one order, then in the other on a second thread."""
    space = {}
    exec(SCENARIO, space)
    return space["scenario"](sanitizer_cls, threading)


def test_inverted_pair_is_a_cycle():
    san, a, b = _scenario(LockOrderSanitizer)
    cycles = san.find_cycles(package_only=False)
    assert len(cycles) == 1 and sorted(cycles[0]) == sorted({a.label, b.label})
    assert (a.label, b.label) == ("ext:two_locks.py:9", "ext:two_locks.py:10")  # made outside the package
    san.assert_acyclic()  # the package's subgraph holds neither


def test_last_observed_is_published_and_a_bundle_carries_it():
    san, _, _ = _scenario(LockOrderSanitizer)
    assert lockorder.LAST_OBSERVED == san.to_dict()
    bundle = build_bundle(Observability.collecting(flight=True), reason="test")
    assert bundle["lock_order"] == san.to_dict()
    assert len(bundle["lock_order"]["edges"]) == 2


def test_graph_format_equals_the_jax_sanitizers():
    from mpi_k_selection_tpu.analysis.lockorder import LockOrderSanitizer as JaxSanitizer

    ours = _scenario(LockOrderSanitizer)[0].to_dict()
    theirs = _scenario(JaxSanitizer)[0].to_dict()
    assert set(ours) == set(theirs)
    for d in (ours, theirs):
        d.pop("threads_seen")
    assert ours == theirs
    assert ours["edges"][0].keys() == {"src", "dst", "count"}


def test_package_locks_are_wrapped_and_restored():
    import importlib

    from mpi_k_selection_tpu_torch.native import loader
    from mpi_k_selection_tpu_torch.obs import flight
    from mpi_k_selection_tpu_torch.streaming import pipeline

    inj = importlib.import_module("mpi_k_selection_tpu_torch.faults.inject")  # the package re-exports a function
    before = (pipeline.STAGING_POOL._lock, inj._ACTIVE_LOCK, loader._lock, flight._DUMPED_LOCK)
    with LockOrderSanitizer() as san:
        san.patch_package_locks()
        wrapped = (pipeline.STAGING_POOL._lock, inj._ACTIVE_LOCK, loader._lock, flight._DUMPED_LOCK)
        assert all(isinstance(w, lockorder.TrackedLock) for w in wrapped)
        assert wrapped[0].label == "mpi_k_selection_tpu_torch/streaming/pipeline.py::StagingPool._lock"
    assert (pipeline.STAGING_POOL._lock, inj._ACTIVE_LOCK, loader._lock, flight._DUMPED_LOCK) == before


def test_not_reentrant():
    with LockOrderSanitizer() as san:
        with pytest.raises(RuntimeError, match="not reentrant"):
            san.__enter__()


def test_sanitized_descent_and_server_agree_with_the_static_graph():
    """A two-slot pipelined streamed median and a coalescing server
    session under one sanitizer: package edges observed, no cycle, no
    conflict with the static graph, and the answers NumPy's."""
    from mpi_k_selection_tpu_torch.serve import KSelectServer

    rng = np.random.default_rng(0)
    chunks = [rng.integers(-(2**31), 2**31 - 1, 1 << 13, dtype=np.int64).astype(np.int32) for _ in range(6)]
    x = np.concatenate(chunks)
    want = np.sort(x)
    with LockOrderSanitizer() as san:
        san.patch_package_locks()
        v = kt.kselect_streaming(chunks, x.size // 2, device="cpu", devices=2, pipeline_depth=2)
        srv = KSelectServer(window=0.002)
        try:
            srv.add_dataset("x", x, device="cpu")
            got = []

            def client(i):
                got.extend((k, srv.kselect("x", k, tier="exact").value) for k in (1 + i, x.size // 2 + i))

            ts = [threading.Thread(target=client, args=(i,)) for i in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
        finally:
            srv.close()
    assert int(v) == want[x.size // 2 - 1]
    assert sorted(got) == sorted((k, want[k - 1]) for i in range(4) for k in (1 + i, x.size // 2 + i))
    assert san.package_edges() and san.find_cycles() == []
    static = build_concurrency_report([PKG], root=REPO)["lock_graph"]
    assert san.check_consistency(static) == []
