"""Injectable sleepers: the one place of the port that waits
(counterpart of ``mpi_k_selection_tpu/faults/sleeper.py``).

Every backoff and injected stall in the package goes through a
:class:`Sleeper`, so tests and the seeded chaos harness can replace real
waiting with a recorded, deterministic no-op: a retry ladder that slept
through its exponential backoff would turn the chaos grid into a
minutes-long suite and make every timing assertion flaky.
"""

from __future__ import annotations

import threading
import time


class Sleeper:
    """Sleeper protocol: ``sleep(seconds)`` blocks (or pretends to) for the
    requested duration. Implementations are thread-safe: retry policies
    sleep on producer threads and on the caller's thread alike."""

    def sleep(self, seconds: float) -> None:  # pragma: no cover - protocol
        raise NotImplementedError


class RealSleeper(Sleeper):
    """Sleeps for real: the package default (:data:`DEFAULT_SLEEPER`)."""

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class VirtualSleeper(Sleeper):
    """Records every requested sleep without blocking: the test and chaos
    form. ``slept`` holds the durations in call order, so backoff
    schedules stay assertable while the chaos grid runs at full speed."""

    def __init__(self):
        self._lock = threading.Lock()
        self.slept: list[float] = []  # ksel: guarded-by[_lock]

    def sleep(self, seconds: float) -> None:
        with self._lock:
            self.slept.append(float(seconds))

    @property
    def total(self) -> float:
        """The seconds a RealSleeper would have waited."""
        with self._lock:
            return sum(self.slept)


#: The package default: real waiting. Policies and injectors resolve a
#: ``sleeper=None`` knob to this.
DEFAULT_SLEEPER = RealSleeper()


def resolve_sleeper(sleeper) -> Sleeper:
    """``None`` -> :data:`DEFAULT_SLEEPER`; anything with a ``sleep``
    callable passes through; anything else is refused."""
    if sleeper is None:
        return DEFAULT_SLEEPER
    if callable(getattr(sleeper, "sleep", None)):
        return sleeper
    raise ValueError(f"sleeper must expose a sleep(seconds) method, got {sleeper!r}")
