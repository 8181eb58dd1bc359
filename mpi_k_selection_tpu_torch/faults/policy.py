"""Resilience policies: bounded retry with injectable backoff
(counterpart of ``mpi_k_selection_tpu/faults/policy.py``).

The streamed paths classify failures and retry exactly the transient
class, :class:`~mpi_k_selection_tpu_torch.errors.TransientError` plus
``ConnectionError`` and ``TimeoutError`` by default, with bounded
exponential backoff through the injectable sleeper (faults/sleeper.py).
Everything else propagates at once: a logic error, a CUDA error, a kernel
that fails to build or launch, ``torch.cuda.OutOfMemoryError``. Retrying
those would repeat them, or hide the device behind a plain fallback.

Two shapes of retry live here:

- :func:`retry_call`: retry one operation in place (the staging of a
  chunk, whose host buffer is still in hand);
- :func:`resilient_source`: the mid-pass re-pull of a replayable chunk
  source: a transient error while pulling chunk *i* calls the source
  again, skips the *i* chunks already consumed and resumes the pass
  without restarting it (the descent's replay-stability checks fail
  loudly if the re-pull drifts).

Exhaustion raises the typed :class:`~mpi_k_selection_tpu_torch.errors.
RetryExhaustedError` with the last failure as ``__cause__``, after the
flight recorder's one automatic dump. Pass-level recovery (re-running a
whole pass, the corrupt-record ladder, the ENOSPC downgrade) lives with
the descent (streaming/chunked.py:``_recover_pass``), which takes its
attempt bound and backoff from this module's policy.
"""

from __future__ import annotations

import dataclasses

from mpi_k_selection_tpu_torch.errors import RetryExhaustedError, TransientError
from mpi_k_selection_tpu_torch.faults.sleeper import resolve_sleeper
from mpi_k_selection_tpu_torch.obs import flight as _flight
from mpi_k_selection_tpu_torch.obs.wiring import fault_event

#: The exception classes the default policy treats as transient. Narrow on
#: purpose: RuntimeError and ValueError are logic errors (and CUDA errors
#: are RuntimeErrors), SpillRecordError has its own re-read / rebuild
#: ladder, and OSError at large would swallow ENOSPC, which has its own
#: downgrade.
DEFAULT_RETRYABLE = (TransientError, ConnectionError, TimeoutError)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry. ``max_attempts`` counts every try (3 = one and two
    retries); the backoff before retry *r* (1-based) is ``min(backoff_base
    * 2**(r-1), backoff_max)`` seconds through ``sleeper`` (None = the
    real sleeper; tests pass a VirtualSleeper)."""

    max_attempts: int = 3
    backoff_base: float = 0.05
    backoff_max: float = 2.0
    retryable: tuple = DEFAULT_RETRYABLE
    sleeper: object = None

    def __post_init__(self):
        if int(self.max_attempts) < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.backoff_base < 0 or self.backoff_max < 0:
            raise ValueError("backoff bounds must be >= 0")

    def is_retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, tuple(self.retryable))

    def backoff(self, retry: int) -> float:
        """Seconds to wait before retry number ``retry`` (1-based)."""
        return min(self.backoff_base * (2.0 ** max(0, retry - 1)), self.backoff_max)

    def sleep(self, retry: int) -> None:
        resolve_sleeper(self.sleeper).sleep(self.backoff(retry))


#: The default: 3 attempts, 50 ms doubling backoff capped at 2 s. The
#: streamed entry points' ``retry=None`` resolves here.
DEFAULT_RETRY = RetryPolicy()


def resolve_retry(retry):
    """The ``retry`` knob: None or ``"default"`` -> :data:`DEFAULT_RETRY`,
    ``"off"`` or False -> None (fail on the first transient), a
    :class:`RetryPolicy` passes through."""
    if retry is None or retry == "default":
        return DEFAULT_RETRY
    if retry == "off" or retry is False:
        return None
    if isinstance(retry, RetryPolicy):
        return retry
    raise ValueError(f"retry must be None, 'default', 'off', or a RetryPolicy, got {retry!r}")


def _emit_retry(obs, site, retry, exc) -> None:
    fault_event(obs, site, "retry", exc=exc, attempt=retry, counter="faults.retries", labels={"site": site})


def _exhausted(obs, message: str, site: str, policy: RetryPolicy) -> RetryExhaustedError:
    """The typed exhaustion, after the flight recorder's one automatic
    dump (a no-op without one; it never raises)."""
    exhausted = RetryExhaustedError(message, site=site, attempts=policy.max_attempts)
    _flight.auto_dump(obs, "retry-exhausted", exc=exhausted)
    return exhausted


def retry_call(fn, policy: RetryPolicy | None, *, site: str, obs=None):
    """``fn()`` under ``policy``: a transient failure is retried in place
    with backoff, up to ``policy.max_attempts`` tries, then
    :class:`RetryExhaustedError` (the last failure as ``__cause__``).
    ``policy=None`` is a plain call."""
    if policy is None:
        return fn()
    last = None
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except BaseException as e:
            if not policy.is_retryable(e):
                raise
            last = e
            retry = attempt + 1
            if retry >= policy.max_attempts:
                break
            _emit_retry(obs, site, retry, e)
            policy.sleep(retry)
    raise _exhausted(obs, f"{site}: still failing after {policy.max_attempts} attempts ({type(last).__name__}: "
                          f"{last})", site, policy) from last


def resilient_source(src, policy: RetryPolicy | None, *, obs=None):
    """A replayable chunk source with mid-pass re-pull: a transient error
    while pulling chunk *i* calls ``src()`` again, skips the *i* chunks
    this pass already consumed and resumes, without restarting the pass.
    The budget is per incident: a successful pull resets it, so isolated
    transients on a long stream never add up to an exhaustion, and
    failures while skipping count against the same incident. A re-pull
    that ends before the chunks already consumed raises (the source is not
    replay-stable). ``policy=None`` returns ``src`` unchanged. For
    replayable sources only: a one-shot stream cannot be called again (the
    spill store's generation 0 is its recovery)."""
    if policy is None:
        return src

    def wrapped():
        def gen():
            it = iter(src())
            i = 0  # chunks handed downstream
            retries = 0

            def absorb(e, doing: str) -> None:
                """One failure against the incident's budget: re-raise a
                non-retryable one, raise the typed exhaustion past the
                budget, else emit the retry event and back off."""
                nonlocal retries
                if not policy.is_retryable(e):
                    raise e
                retries += 1
                if retries >= policy.max_attempts:
                    raise _exhausted(obs, f"chunk source: {doing} still failing after {policy.max_attempts} "
                                          f"attempts ({type(e).__name__}: {e})", "source", policy) from e
                _emit_retry(obs, "source", retries, e)
                policy.sleep(retries)

            while True:
                try:
                    chunk = next(it)
                except StopIteration:
                    return
                except BaseException as e:
                    absorb(e, f"pulling chunk {i}")
                    it = iter(src())  # re-pull, skipping the chunks already consumed
                    skipped = 0
                    while skipped < i:
                        try:
                            next(it)
                            skipped += 1
                        except StopIteration:
                            raise RuntimeError(
                                f"chunk source is not replay-stable: the re-pulled stream ended after {skipped} "
                                f"chunks, {i} were already consumed"
                            ) from e
                        except BaseException as e2:
                            absorb(e2, "the re-pull")
                            it = iter(src())
                            skipped = 0
                    continue
                yield chunk
                i += 1
                retries = 0  # the incident is over: the next chunk gets a whole budget

        return gen()

    return wrapped
