"""Latency tiers of the query server: ``sketch``, ``exact``, ``auto``.

- ``"sketch"`` answers at once from the dataset's resident
  :class:`~mpi_k_selection_tpu_torch.streaming.sketch.RadixSketch`: a
  point estimate that always carries its exact bounds (``rank_bounds``
  with the true ranks ``lo < k <= hi``, ``value_bounds`` bracketing the
  true order statistic, ``rank_error_bound = hi - lo``). It needs a
  resident sketch and raises :class:`QueryError` otherwise.
- ``"exact"`` runs the real selection (the lane's shared-pass walk or
  cached sort for a resident tensor, the sketch-seeded streamed descent for
  a stream dataset): the bits of ``api.kselect``.
- ``"auto"`` answers from the sketch when it pins every rank of the
  request (its resolved key interval, clamped to the observed extremes, is
  one key: ``RadixSketch.pin``), and escalates the whole request to the
  exact tier otherwise. A pinned answer is exact by construction, so auto
  answers always equal exact ones bit for bit.

Host logic only: sketch reads are NumPy over the resident pyramid, and
nothing here launches or builds a kernel.
"""

from __future__ import annotations

import dataclasses

from mpi_k_selection_tpu_torch.serve.errors import QueryError

TIERS = ("sketch", "exact", "auto")


@dataclasses.dataclass(frozen=True)
class RankAnswer:
    """One rank query's answer. ``tier`` is the tier that answered
    (``"sketch"`` or ``"exact"``); ``exact`` is True when the value is the
    true order statistic bit for bit (always for the exact tier; for a
    sketch answer when the sketch pinned it). Sketch answers carry the
    three bound fields, exact ones None (the value is its own proof)."""

    k: int
    value: object
    tier: str
    exact: bool
    rank_bounds: tuple | None = None
    value_bounds: tuple | None = None
    rank_error_bound: int | None = None
    escalated: bool = False

    def as_dict(self) -> dict:
        """JSON-ready form (NumPy scalars become Python numbers)."""
        out = {
            "k": int(self.k),
            "value": _jsonable(self.value),
            "tier": self.tier,
            "exact": bool(self.exact),
            "escalated": bool(self.escalated),
        }
        if self.rank_bounds is not None:
            out["rank_bounds"] = [int(b) for b in self.rank_bounds]
        if self.value_bounds is not None:
            out["value_bounds"] = [_jsonable(v) for v in self.value_bounds]
        if self.rank_error_bound is not None:
            out["rank_error_bound"] = int(self.rank_error_bound)
        return out


def _jsonable(v):
    item = getattr(v, "item", None)
    return item() if item is not None else v


def validate_tier(tier: str) -> str:
    if tier not in TIERS:
        raise QueryError(f"unknown tier {tier!r}; choose from {TIERS}")
    return tier


def sketch_answers(ds, ks) -> list[RankAnswer]:
    """Sketch-tier answers for every rank in ``ks``: point estimates with
    their exact bounds (one ``RadixSketch.describe`` a rank)."""
    sk = require_sketch(ds)
    out = []
    for k in ks:
        k = int(k)
        lo, hi, v_lo, v_hi, pinned = sk.describe(k)
        out.append(
            RankAnswer(
                k=k,
                value=pinned if pinned is not None else v_lo,
                tier="sketch",
                exact=pinned is not None,
                rank_bounds=(lo, hi),
                value_bounds=(v_lo, v_hi),
                rank_error_bound=hi - lo,
            )
        )
    return out


def auto_pins(ds, ks) -> bool:
    """Whether the resident sketch pins every rank in ``ks``: the auto
    tier's stay-on-sketch test (no sketch never pins)."""
    if ds.sketch is None:
        return False
    return all(ds.sketch.pin(int(k)) is not None for k in ks)


def require_sketch(ds):
    if ds.sketch is None:
        raise QueryError(
            f"dataset {ds.dataset_id!r} has no resident sketch; register "
            "with sketch=True or query tier='exact'"
        )
    return ds.sketch
