"""Deterministic fault injection and the resilience policies
(counterpart of ``mpi_k_selection_tpu/faults/``).

- **Injection** (plan.py, inject.py, sleeper.py): a seeded, frozen
  :class:`FaultPlan`, replayable from one integer, executed by a
  :class:`FaultInjector` at the real failure surfaces (the chunk pull, the
  staging of a chunk to its card, spill record writes and reads), with
  stalls through the injectable sleeper and real damage to record files on
  disk, so the spill store's own CRC32 and size checks trip as they would
  in the wild. Armed by the :func:`inject` context manager, from tests or
  the CLI's ``--chaos``.
- **Policies** (policy.py): :class:`RetryPolicy` (bounded attempts,
  exponential backoff through a :class:`Sleeper`), :func:`retry_call` (in
  place) and :func:`resilient_source` (the mid-pass re-pull of a
  replayable source). Pass-level recovery (re-running a streamed pass, the
  corrupt-record re-read / rebuild ladder, the ENOSPC downgrade) lives
  with the descent (streaming/chunked.py) and takes its bounds from these
  policies.

Every fault, retry and downgrade emits a typed
:class:`~mpi_k_selection_tpu_torch.obs.events.FaultEvent` and bumps the
``faults.*`` counters, and a recovered run answers the same bits as a run
without faults. Only the transient classes are retried: a CUDA error, a
kernel that fails to build or launch, or running out of device memory
propagates untouched.
"""

from __future__ import annotations

from mpi_k_selection_tpu_torch.errors import RetryExhaustedError, SpillCapacityError, TransientError
from mpi_k_selection_tpu_torch.faults.inject import (
    FaultInjector,
    active_injector,
    apply_disk_fault,
    inject,
    maybe_fault,
)
from mpi_k_selection_tpu_torch.faults.plan import FAULT_KINDS, FAULT_SITES, FaultPlan, FaultSpec
from mpi_k_selection_tpu_torch.faults.policy import (
    DEFAULT_RETRY,
    DEFAULT_RETRYABLE,
    RetryPolicy,
    resilient_source,
    resolve_retry,
    retry_call,
)
from mpi_k_selection_tpu_torch.faults.sleeper import (
    DEFAULT_SLEEPER,
    RealSleeper,
    Sleeper,
    VirtualSleeper,
    resolve_sleeper,
)

__all__ = [
    "DEFAULT_RETRY",
    "DEFAULT_RETRYABLE",
    "DEFAULT_SLEEPER",
    "FAULT_KINDS",
    "FAULT_SITES",
    "FaultInjector",
    "FaultPlan",
    "FaultSpec",
    "RealSleeper",
    "RetryExhaustedError",
    "RetryPolicy",
    "Sleeper",
    "SpillCapacityError",
    "TransientError",
    "VirtualSleeper",
    "active_injector",
    "apply_disk_fault",
    "inject",
    "maybe_fault",
    "resilient_source",
    "resolve_retry",
    "resolve_sleeper",
    "retry_call",
]
