"""Python driver for the native multi-process CGM runtime (mpi backend)."""

from __future__ import annotations

import numpy as np

from mpi_k_selection_tpu_torch import config


def kselect_full(x, k: int, *, num_procs: int = 4, c: int | None = None):
    """Exact k-th smallest (1-indexed) via the native forked-rank CGM runtime.

    Returns ``(answer, rounds, elapsed_s, found_early)``; ``elapsed_s`` is
    the runtime's own clock around its rounds. ``c`` is the CGM coarseness
    constant (reference default 500, ``TODO-kth-problem-cgm.c:44``).
    """
    from mpi_k_selection_tpu_torch.native import loader

    lib = loader.get_lib()
    if lib is None:
        from mpi_k_selection_tpu_torch.errors import NativeUnavailableError

        raise NativeUnavailableError(
            "the native runtime is unavailable (no C++ compiler?); "
            "build it with `python -m mpi_k_selection_tpu_torch.native.build`"
        )
    x = np.asarray(x)
    if x.dtype != np.int32:
        raise ValueError(f"the mpi backend operates on int32 (reference C int), got {x.dtype}")
    if c is None:
        c = config.REFERENCE_C
    answer, rounds, elapsed, found = lib.cgm_kselect(x, k, num_procs=num_procs, c=c)
    return np.int32(answer), rounds, elapsed, found


def kselect(x, k: int, *, num_procs: int = 4, c: int | None = None, **_ignored):
    """Like :func:`kselect_full` but returns just the answer."""
    answer, _, _, _ = kselect_full(x, k, num_procs=num_procs, c=c)
    return answer
