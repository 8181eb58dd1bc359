"""Typed exceptions of the port (counterpart of ``mpi_k_selection_tpu/errors.py``).

The reference signals every failure as a process exit (``MPI_Abort``,
``TODO-kth-problem-cgm.c:58``); a library needs typed errors so callers can
tell "this machine cannot run it" from "the run failed". The JAX package's
``TransientError`` and ``RetryExhaustedError`` come with the fault layer
(ROADMAP Queue 1 item 4).
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
