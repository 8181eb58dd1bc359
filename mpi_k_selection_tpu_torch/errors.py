"""Typed exceptions of the port (counterpart of ``mpi_k_selection_tpu/errors.py``).

The reference signals every failure as a process exit (``MPI_Abort``,
``TODO-kth-problem-cgm.c:58``); a library needs typed errors so callers can
tell "this machine cannot run it" from "the run failed". The other classes
of the JAX package's module come with the slices that raise them.
"""

from __future__ import annotations


class NativeUnavailableError(RuntimeError):
    """The native (C++) runtime cannot be built or loaded on this machine,
    e.g. for want of a C++ compiler. Environmental, not a bug: any other
    exception from the native backend is a real failure."""
