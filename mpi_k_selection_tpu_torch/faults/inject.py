"""The fault injector: executes a :class:`~mpi_k_selection_tpu_torch.
faults.plan.FaultPlan` at the real failure surfaces (counterpart of
``mpi_k_selection_tpu/faults/inject.py``).

The streamed paths carry cheap hook points (:func:`maybe_fault`: one
module-global ``is None`` test when no harness is armed) where real faults
strike: the chunk pull, the staging of a chunk to its slot, spill record
writes and reads. Arming a plan (:func:`inject`, a context manager) arms
those hooks process-wide. The injector counts occurrences and attempts a
site under a lock (the producer thread and the consumer both reach it),
fires the scheduled kinds (transient raises, stalls through the sleeper,
corruption and truncation of the record file on disk, so the spill store's
own CRC and size checks trip, and ENOSPC), and logs every firing in
``fired`` (and as a FaultEvent when an obs bundle is attached).

One injector at a time: the occurrence counters are process-global state,
and two overlapping plans would see interleaved counts neither was seeded
for, so nesting raises.
"""

from __future__ import annotations

import contextlib
import errno as _errno
import os
import threading

from mpi_k_selection_tpu_torch.errors import SpillRecordError, TransientError
from mpi_k_selection_tpu_torch.faults.plan import FaultPlan, FaultSpec
from mpi_k_selection_tpu_torch.faults.sleeper import resolve_sleeper
from mpi_k_selection_tpu_torch.obs.wiring import fault_event


class FaultInjector:
    """Executes one plan. :meth:`check` and :meth:`maybe_fault` are the hook
    points' API; :meth:`wrap_chunk_source` arms a chunk source with the
    plan's ``"source"`` specs. ``fired`` is the log of firings in order
    (dicts of site, kind, index and attempt)."""

    def __init__(self, plan: FaultPlan, *, sleeper=None, obs=None):
        if not isinstance(plan, FaultPlan):
            raise ValueError(f"expected a FaultPlan, got {plan!r}")
        self.plan = plan
        self.sleeper = resolve_sleeper(sleeper)
        self.obs = obs
        self._lock = threading.Lock()
        self._site_calls: dict[str, int] = {}  # ksel: guarded-by[_lock] (auto-index a site)
        self._attempts: dict[tuple, int] = {}  # ksel: guarded-by[_lock] ((site, index) -> tries)
        self.fired: list[dict] = []  # ksel: guarded-by[_lock]
        self._by_key: dict[tuple, list] = {}
        for s in plan.specs:
            # later specs of one (site, index) add to the earlier ones' attempts
            self._by_key.setdefault((s.site, s.index), []).append(s)

    def check(self, site: str, index: int | None = None) -> FaultSpec | None:
        """Advance the (site, index) attempt counter and return the spec
        scheduled for this attempt, if any. ``index=None`` numbers the
        site's calls in order."""
        with self._lock:
            if index is None:
                index = self._site_calls.get(site, 0)
                self._site_calls[site] = index + 1
            key = (site, int(index))
            attempt = self._attempts.get(key, 0)
            self._attempts[key] = attempt + 1
            for spec in self._by_key.get(key, ()):
                if attempt in spec.attempts:
                    self.fired.append({"site": site, "kind": spec.kind, "index": int(index), "attempt": attempt})
                    fault_event(self.obs, spec.site, "inject", fault_kind=spec.kind, index=int(index),
                                attempt=attempt, counter="faults.injected", labels={"site": spec.site})
                    return spec
        return None

    def maybe_fault(self, site: str, index: int | None = None, path=None):
        """Fire the fault scheduled for this call, if any. ``"raise"``
        raises :class:`TransientError`, ``"enospc"`` ``OSError(ENOSPC)``,
        ``"corrupt"`` :class:`SpillRecordError` (a transient bad read);
        ``"stall"`` sleeps through the sleeper and returns; the persistent
        kinds (``"corrupt_disk"``, ``"truncate"``) damage the file at
        ``path`` and return, so the reader's own checks fail as they would
        on real damage."""
        spec = self.check(site, index)
        if spec is None:
            return None
        if spec.kind == "stall":
            self.sleeper.sleep(spec.arg)
            return spec
        if spec.kind == "raise":
            raise TransientError(f"injected transient fault at {site}[{spec.index}]")
        if spec.kind == "enospc":
            raise OSError(_errno.ENOSPC, f"injected ENOSPC at {site}[{spec.index}]")
        if spec.kind == "corrupt":
            raise SpillRecordError(f"injected transient checksum mismatch at {site}[{spec.index}]")
        if path is not None:
            apply_disk_fault(path, spec.kind)
        return spec

    def wrap_chunk_source(self, src):
        """A replayable chunk source armed with the plan's ``"source"``
        specs: pulling chunk *i* calls ``maybe_fault("source", i)`` first,
        so a scheduled raise or stall strikes before the chunk exists. The
        wrapped source stays replayable; the attempt counters persist
        across its invocations, which is what lets a retry or a later pass
        see the chunk recover."""
        injector = self

        def wrapped():
            it = iter(src())

            def gen():
                i = 0
                while True:
                    injector.maybe_fault("source", i)
                    try:
                        chunk = next(it)
                    except StopIteration:
                        return
                    yield chunk
                    i += 1

            return gen()

        return wrapped


def apply_disk_fault(path: str, kind: str) -> None:
    """Damage one spill record file for good: ``"corrupt_disk"`` flips the
    file's last byte (in the checksummed payload: the header is at the
    front), ``"truncate"`` cuts the file in half. Either makes the record's
    own validation raise :class:`SpillRecordError` on every later read."""
    size = os.path.getsize(path)
    if kind == "truncate":
        os.truncate(path, size // 2)
        return
    if kind == "corrupt_disk":
        if size == 0:  # pragma: no cover - a record always has a header
            return
        with open(path, "r+b") as f:
            f.seek(size - 1)
            b = f.read(1)
            f.seek(size - 1)
            f.write(bytes([b[0] ^ 0xFF]))
        return
    raise ValueError(f"not a disk fault kind: {kind!r}")  # pragma: no cover


_ACTIVE: FaultInjector | None = None  # ksel: guarded-by[_ACTIVE_LOCK] (writes; the hook point reads it bare)
_ACTIVE_LOCK = threading.Lock()


def active_injector() -> FaultInjector | None:
    """The armed injector, or None (no harness: every hook point is one
    ``is None`` test)."""
    return _ACTIVE


def maybe_fault(site: str, index: int | None = None, path=None):
    """The hook point library code calls: nothing without an armed
    injector, else :meth:`FaultInjector.maybe_fault`."""
    inj = _ACTIVE
    if inj is None:
        return None
    return inj.maybe_fault(site, index, path=path)


@contextlib.contextmanager
def inject(plan_or_injector, *, sleeper=None, obs=None):
    """Arm a plan (or a built injector) process-wide for the body of the
    ``with`` block, yielding the injector (its ``fired`` log is the
    evidence afterwards). One injector at a time: nesting raises. The
    hooks are disarmed on every exit."""
    global _ACTIVE
    if isinstance(plan_or_injector, FaultInjector):
        if sleeper is not None or obs is not None:
            # dropping them would make a "virtual" chaos run sleep for
            # real, or lose every inject event: refuse instead
            raise ValueError("pass sleeper=/obs= to FaultInjector(...) itself; inject() does not rewire a "
                             "pre-built injector")
        inj = plan_or_injector
    else:
        inj = FaultInjector(plan_or_injector, sleeper=sleeper, obs=obs)
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a fault injector is already active; nested inject() is not supported (occurrence "
                               "counters are process-global)")
        _ACTIVE = inj
    try:
        yield inj
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = None
