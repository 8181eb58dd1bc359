"""The telemetry plumbing the streamed passes share (counterpart of
``mpi_k_selection_tpu/obs/wiring.py``): the timer and recorder wiring,
each chunk's ingest observation, the window-occupancy handle, the
per-pass gauges, and ``fault_event``, the one FaultEvent emission shape.

Every helper is a host observation and a no-op when ``obs`` (or its
channel) is None; none reads a device value.
"""

from __future__ import annotations

from mpi_k_selection_tpu_torch.obs.events import ChunkEvent, FaultEvent


def fault_event(obs, site: str, action: str, *, exc=None, fault_kind=None, index=None, attempt: int = 0,
                counter=None, labels=None):
    """The one FaultEvent emission shape, shared by the injector
    (``action="inject"``), the retry policies and the descent's recovery
    ladder, so the error rendering (``"TypeName: message"``, empty for an
    injection) and the event / metric pairing cannot drift between call
    sites. ``counter`` (with ``labels``) names the metric bumped beside the
    event. A no-op when ``obs`` is None."""
    if obs is None:
        return
    obs.emit(FaultEvent(site=site, action=action, fault_kind=fault_kind, index=index, attempt=attempt,
                        error="" if exc is None else f"{type(exc).__name__}: {exc}"))
    if counter is not None and obs.metrics is not None:
        obs.metrics.counter(counter, labels=labels).inc()


def staged_slot(keys, devs=None):
    """The round-robin slot a staged chunk landed on: the index of its
    card in the pass's ingest tuple, recorded by the producer when it
    staged the chunk (streaming/pipeline.py), or None (no ``devices``,
    or not staged to a slot). The one chunk -> device mapping the later
    passes' spill records and the chunk events share. The slot is kept at
    staging, never read back from the tensor: a tensor on ``cpu:1``
    reports ``cpu``."""
    from mpi_k_selection_tpu_torch.streaming.pipeline import StagedKeys

    return keys.device_slot if isinstance(keys, StagedKeys) else None


class _FanoutHistogram:
    """Observes into several histograms at once: the unlabeled
    ``inflight.occupancy`` and its per-phase twin."""

    __slots__ = ("_hists",)

    def __init__(self, hists):
        self._hists = tuple(hists)

    def observe(self, value) -> None:
        for h in self._hists:
            h.observe(value)


def window_occupancy(obs, phase: str | None = None):
    """The in-flight window's occupancy histogram when metrics are on:
    ``inflight.occupancy``, and ``inflight.occupancy{phase=...}`` beside
    it when the caller names its pass (``descent`` | ``collect`` |
    ``certificate`` | ``sketch`` | ``monitor``)."""
    if obs is None or obs.metrics is None:
        return None
    base = obs.metrics.histogram("inflight.occupancy")
    if phase is None:
        return base
    return _FanoutHistogram((base, obs.metrics.histogram("inflight.occupancy", labels={"phase": phase})))


def bucket_read(obs, phase: str, staged, programs: int = 1):
    """Count ``programs`` launches reading one staged chunk, at dispatch:
    ``ingest.bucket_reads{phase}`` and its byte twin
    ``ingest.bucket_read_bytes{phase}`` (the chunk's staged bytes times
    ``programs``). Every part of a chunk's pass is one launch of the sweep
    kernel, so the port counts one read a chunk a pass: ``fused`` for a
    histogram with the spill tee, ``histogram``, ``collect`` (every spec in
    one launch), ``certificate``, ``sketch`` and ``monitor``. The JAX
    package's unfused tiers count two (a spill pass, the certificate and
    sketch pairs) or one a spec (the collect). No-op when metrics are
    off."""
    if obs is None or obs.metrics is None:
        return
    nbytes = staged.data.numel() * staged.data.element_size() * int(programs)
    lab = {"phase": phase}
    obs.metrics.counter("ingest.bucket_reads", labels=lab).inc(int(programs))
    obs.metrics.counter("ingest.bucket_read_bytes", labels=lab).inc(nbytes)


def resolved_bits_gauge(obs, pass_label, bits) -> None:
    """``ingest.resolved_bits{pass}``: the key bits resolved after a
    histogram pass (the width schedule's progress). The labels are the
    descent's pass indices, at most one a key bit. No-op when metrics are
    off."""
    if obs is None or obs.metrics is None:
        return
    obs.metrics.gauge(
        "ingest.resolved_bits",
        labels={"pass": str(pass_label)},  # ksel: noqa[KSL013] -- pass indices, bounded by key bits / min digit width
    ).set(int(bits))


def ingest_workers_gauge(obs, workers) -> None:
    """``ingest.workers``: the resolved ``ingest_workers`` of a run (1: the
    one producer; more: the pooled host data plane, streaming/pipeline.py).
    No-op when metrics are off."""
    if obs is None or obs.metrics is None:
        return
    obs.metrics.gauge("ingest.workers").set(int(workers))


class _FanRecorder:
    """Forwards every finished span to several recorders (the trace
    recorder and the flight ring observe the same phases)."""

    __slots__ = ("_targets",)

    def __init__(self, targets):
        self._targets = tuple(targets)

    def record(self, name, t0, t1, args=None) -> None:
        for r in self._targets:
            r.record(name, t0, t1, args)


def span_recorder(obs):
    """The recorder an instrumented run's PhaseTimer feeds: the trace
    channel, the flight ring, a fan to both, or None when neither is on."""
    if obs is None:
        return None
    targets = [r for r in (obs.trace, obs.flight) if r is not None]
    if len(targets) < 2:
        return targets[0] if targets else None
    return _FanRecorder(targets)


def attach_timer(obs, timer):
    """``(timer, restore)``: with span recording on (the trace channel, the
    flight ring or both), every phase needs a PhaseTimer to timestamp it,
    so one is made when the caller passed none, and the recorder is
    attached to a caller's timer that has none.
    ``restore()`` detaches a recorder this call attached to the caller's
    timer; run it on every exit, so a timer reused by later calls without
    telemetry stops feeding this run's recorder."""
    recorder = span_recorder(obs)
    if recorder is None:
        return timer, lambda: None
    if timer is None:
        from mpi_k_selection_tpu_torch.utils.profiling import PhaseTimer

        return PhaseTimer(recorder=recorder), lambda: None
    if timer.recorder is None:
        timer.recorder = recorder

        def _restore(t=timer):
            t.recorder = None

        return timer, _restore
    return timer, lambda: None


def chunk_event(obs, pass_index, chunk_index, keys, kdt, devs=None):
    """One chunk's ingest observation: a :class:`ChunkEvent` and the
    ``ingest.chunks`` / ``ingest.bytes`` counters of its slot (``device``
    label: the slot index, ``"default"`` for a chunk the producer staged
    with no ``devices``, ``"host"`` for one it did not stage to a slot),
    plus ``ingest.staged_bytes``. Host ints only: the size and the slot
    were fixed when the chunk was staged."""
    from mpi_k_selection_tpu_torch.streaming.pipeline import StagedKeys

    staged = isinstance(keys, StagedKeys) and keys.staged
    slot = staged_slot(keys, devs)
    n = int(keys.size)
    nbytes = n * kdt.itemsize if kdt is not None else 0
    obs.emit(ChunkEvent(pass_index=pass_index, chunk_index=chunk_index, n=n, nbytes=nbytes, device_slot=slot,
                        staged=staged))
    if obs.metrics is not None:
        dev = str(slot) if slot is not None else ("default" if staged else "host")
        lab = {"device": dev}
        obs.metrics.counter("ingest.chunks", labels=lab).inc()
        obs.metrics.counter("ingest.bytes", labels=lab).inc(nbytes)
        if staged:
            obs.metrics.counter("ingest.staged_bytes").inc(keys.data.numel() * keys.data.element_size())
