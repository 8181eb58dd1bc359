"""Seeded fault plans: deterministic, replayable fault schedules
(counterpart of ``mpi_k_selection_tpu/faults/plan.py``).

A :class:`FaultPlan` is a frozen schedule, "fail occurrence *i* of site S
on attempt *j* with fault kind K", that the injector (faults/inject.py)
executes at the real hook points: the chunk pull, the staging of a chunk
to its card, spill record writes and reads. The same plan replays the
same faults, and :meth:`FaultPlan.seeded` derives one from a single
integer with NumPy's ``default_rng``, so a seed names the same specs in
this package and in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: Every fault kind the injector executes:
#:
#: - ``"raise"``: raise :class:`~mpi_k_selection_tpu_torch.errors.
#:   TransientError` (the retryable class) at the hook point;
#: - ``"stall"``: a slow producer or medium: sleep ``arg`` seconds through
#:   the injectable sleeper, then go on;
#: - ``"corrupt"``: a transient bad read: the spill reader raises
#:   SpillRecordError for the matching attempt only (a re-read sees the
#:   intact bytes);
#: - ``"corrupt_disk"``: flip one payload byte on disk (persistent): the
#:   record's CRC32 check fails on this and every later read;
#: - ``"truncate"``: cut the record file in half on disk (persistent): the
#:   payload-size check fails from then on;
#: - ``"enospc"``: raise ``OSError(errno.ENOSPC)`` at the write hook.
FAULT_KINDS = ("raise", "stall", "corrupt", "corrupt_disk", "truncate", "enospc")

#: The hook points a spec can target:
#:
#: - ``"source"``: pulling chunk ``index`` from a wrapped chunk source
#:   (faults/inject.py:``wrap_chunk_source``);
#: - ``"stage"``: staging the ``index``-th chunk a pipelined pass stages to
#:   a slot (streaming/pipeline.py, the JAX package's staging rule);
#: - ``"spill.write"``: appending record ``index`` of a generation
#:   (streaming/spill.py:``SpillWriter.append_prepared``; counts restart
#:   with each generation, so attempt *j* of record *i* is its write in
#:   the *j*-th generation, or re-run, that reaches it);
#: - ``"spill.read"``: reading the record of chunk index ``index``
#:   (streaming/spill.py:``_read_record``);
#: - ``"serve.dispatch"``: the query server's dispatch round ``index``
#:   (serve/batcher.py, outside the per-group isolation, so a raise takes
#:   the supervisor's restart path).
FAULT_SITES = ("source", "stage", "spill.write", "spill.read", "serve.dispatch")

#: The kinds that apply at each site (checked when a spec is built, so a
#: typo fails at construction, not by never firing).
_SITE_KINDS = {
    "source": ("raise", "stall"),
    "stage": ("raise", "stall"),
    "spill.write": ("raise", "enospc"),
    "spill.read": ("raise", "corrupt", "corrupt_disk", "truncate"),
    "serve.dispatch": ("raise",),
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: occurrence ``index`` of ``site`` fails on each
    attempt number in ``attempts`` (0-based; the injector counts how many
    times the occurrence has been tried) with fault ``kind``; ``arg`` is
    the kind's parameter (a stall's seconds).

    The attempt counter spans the whole run: a chunk re-pulled by a retry,
    a record re-read by the recovery ladder and a chunk replayed by a later
    radix pass all advance it, so ``attempts=(0,)`` is "fail the first
    touch, recover on the next" and ``attempts=tuple(range(99))`` a hard
    failure that exhausts any policy."""

    site: str
    index: int
    kind: str
    attempts: tuple = (0,)
    arg: float = 0.0

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {self.site!r}; choose from {FAULT_SITES}")
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; choose from {FAULT_KINDS}")
        if self.kind not in _SITE_KINDS[self.site]:
            raise ValueError(
                f"fault kind {self.kind!r} does not apply at site {self.site!r} (valid: {_SITE_KINDS[self.site]})"
            )
        if self.index < 0:
            raise ValueError(f"fault index must be >= 0, got {self.index}")
        atts = tuple(int(a) for a in self.attempts)
        if not atts or any(a < 0 for a in atts):
            raise ValueError(f"attempts must be a non-empty tuple of ints >= 0, got {self.attempts!r}")
        object.__setattr__(self, "attempts", atts)
        object.__setattr__(self, "index", int(self.index))
        object.__setattr__(self, "arg", float(self.arg))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable fault schedule, built from specs or derived from a seed
    (:meth:`seeded`). It is pure data: executing it is the injector's job,
    so one plan can drive many runs."""

    specs: tuple = ()
    seed: int | None = None

    def __post_init__(self):
        specs = tuple(self.specs)
        for s in specs:
            if not isinstance(s, FaultSpec):
                raise ValueError(f"FaultPlan specs must be FaultSpec, got {s!r}")
        object.__setattr__(self, "specs", specs)

    def for_site(self, site: str) -> tuple:
        return tuple(s for s in self.specs if s.site == site)

    @classmethod
    def seeded(cls, seed: int, *, n_chunks: int = 8, faults: int = 3,
               sites: tuple = ("source", "stage", "spill.read"), recoverable: bool = True,
               stall_seconds: float = 0.001) -> "FaultPlan":
        """A deterministic plan from one integer: ``faults`` specs drawn
        over ``sites``, each at an occurrence index in ``[0, n_chunks)``
        with a kind valid at its site. With ``recoverable`` (the default)
        every spec fails one attempt, a first-touch transient that the
        default RetryPolicy or the spill recovery ladder absorbs;
        ``recoverable=False`` makes every spec but a stall fail every
        attempt. The same seed gives the same plan, in this package and
        in the JAX package."""
        rng = np.random.default_rng(int(seed))
        specs = []
        for _ in range(int(faults)):
            site = sites[int(rng.integers(len(sites)))]
            kinds = _SITE_KINDS[site]
            kind = kinds[int(rng.integers(len(kinds)))]
            index = int(rng.integers(max(1, int(n_chunks))))
            # a stall needs no recovery: it stays single-shot always
            attempts = (0,) if recoverable or kind == "stall" else tuple(range(99))
            specs.append(FaultSpec(site=site, index=index, kind=kind, attempts=attempts,
                                   arg=stall_seconds if kind == "stall" else 0.0))
        return cls(specs=tuple(specs), seed=int(seed))
