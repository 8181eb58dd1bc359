"""Typed exceptions of the port (counterpart of ``mpi_k_selection_tpu/errors.py``).

The reference signals every failure as a process exit (``MPI_Abort``,
``TODO-kth-problem-cgm.c:58``); a library needs typed errors so callers can
tell "this machine cannot run it" from "the run failed".
"""

from __future__ import annotations


class NativeUnavailableError(RuntimeError):
    """The native (C++) runtime cannot be built or loaded on this machine,
    e.g. for want of a C++ compiler. Environmental, not a bug: any other
    exception from the native backend is a real failure."""


class SpillError(RuntimeError):
    """Misuse of the streaming spill store (streaming/spill.py): reading an
    empty/closed store, writing after commit, and similar lifecycle errors."""


class SpillRecordError(SpillError):
    """A spill record on disk failed validation — missing file, truncated
    header/payload, or a checksum/metadata mismatch. Raised BEFORE any key
    reaches a histogram: a corrupt spill cache must fail loudly, never feed
    the descent silently wrong survivors."""


class SpillCapacityError(SpillError):
    """The spill store ran out of disk (ENOSPC) in a mode that cannot
    degrade: ``spill="force"`` and caller-owned stores asked for the spill
    explicitly, so a silent fallback to the replay path would hide a real
    capacity problem. ``spill="auto"`` descents degrade to the replay of
    the last good generation instead of raising this (with a
    RuntimeWarning)."""


class TransientError(RuntimeError):
    """A failure the caller believes is retryable: a chunk-source hiccup,
    a staging transfer blip. The resilience policies
    (faults/policy.py:RetryPolicy) retry exactly this class (plus
    ``ConnectionError``/``TimeoutError``) with bounded backoff; anything
    else propagates at once, because retrying a logic error repeats it.
    The fault-injection harness raises this for its ``"raise"`` fault
    kind, so injected transients take the recovery path real ones take."""


class RetryExhaustedError(RuntimeError):
    """A :class:`~mpi_k_selection_tpu_torch.faults.RetryPolicy` ran out of
    attempts: the operation kept failing with transient errors past
    ``max_attempts``. Carries ``site`` (which operation) and ``attempts``;
    the last underlying error rides ``__cause__``."""

    def __init__(self, message: str, *, site: str = "", attempts: int = 0):
        super().__init__(message)
        self.site = site
        self.attempts = attempts
