"""Seeded input generators (NumPy only) — the port's own copy of
``mpi_k_selection_tpu/utils/datagen.py``, byte-identical output for the
same arguments, so both packages select over the very same data.

The reference uses two *different, unseeded* C ``rand()`` streams — the
sequential program (``kth-problem-seq.c:26-28``, pattern
``i + rand() - rand()%i``) and the CGM program (``TODO-kth-problem-cgm.c:10-17``,
``rand() % 99999999 + 1``) — so its two answers are never directly comparable
(SURVEY.md §4). This module fixes that: one seeded NumPy generator feeds all
backends, so exact-match checks ``tpu == mpi == seq`` are meaningful.

Patterns provided (reference provenance in parens):

- ``uniform``     — ``rand() % 99999999 + 1`` analogue (``TODO-…:15``)
- ``seqlike``     — the ``i + rand() - rand()%i`` arithmetic of
  ``kth-problem-seq.c:27`` reproduced with NumPy arithmetic (values clipped to
  the dtype instead of tolerating the reference's signed-overflow UB)
- ``descending``  — the commented-out adversarial generator ``TODO-…:67-68``
- ``sequential``  — the commented-out ascending generator ``TODO-…:69-70``
- ``equal``       — all-equal stress input (exercises the duplicate/E>1 path
  of the exact-hit test at ``TODO-…:194``)
- ``normal`` / ``funiform`` — float workloads for the top-k configs
  (MoE router logits, beam-search scores; BASELINE.md)
"""

from __future__ import annotations

import numpy as np

PATTERNS = (
    "uniform",
    "seqlike",
    "descending",
    "sequential",
    "equal",
    "normal",
    "funiform",
)


def generate(
    n: int,
    *,
    pattern: str = "uniform",
    seed: int = 0,
    dtype=np.int32,
    batch: tuple[int, ...] = (),
) -> np.ndarray:
    """Generate a seeded input array of shape ``(*batch, n)``."""
    dtype = np.dtype(dtype)
    rng = np.random.default_rng(seed)
    shape = (*batch, n)
    if pattern == "uniform":
        if dtype.kind in "iu":
            hi = min(99_999_999, np.iinfo(dtype).max - 1)
            out = rng.integers(1, hi + 1, size=shape, dtype=np.int64)
        else:
            out = rng.uniform(1.0, 99_999_999.0, size=shape)
    elif pattern == "seqlike":
        i = np.arange(n, 0, -1, dtype=np.int64)
        i = np.broadcast_to(i, shape)
        r1 = rng.integers(0, 2**31, size=shape, dtype=np.int64)
        r2 = rng.integers(0, 2**31, size=shape, dtype=np.int64)
        out = i + r1 - r2 % np.maximum(i, 1)
    elif pattern == "descending":
        out = np.broadcast_to(np.arange(n, 0, -1, dtype=np.int64), shape)
    elif pattern == "sequential":
        out = np.broadcast_to(np.arange(1, n + 1, dtype=np.int64), shape)
    elif pattern == "equal":
        out = np.full(shape, 42, dtype=np.int64)
    elif pattern == "normal":
        out = rng.standard_normal(size=shape)
    elif pattern == "funiform":
        out = rng.uniform(-1.0, 1.0, size=shape)
    else:
        raise ValueError(f"unknown pattern {pattern!r}; choose from {PATTERNS}")
    if dtype.kind in "iu":
        if np.dtype(np.result_type(out)).kind == "f":
            out = np.rint(out)
        # narrow-dtype casts clip rather than wrap (module policy: no
        # silent modular sawtooth in "adversarial" monotone patterns)
        info = np.iinfo(dtype)
        out = np.clip(out, info.min, info.max)
    return np.ascontiguousarray(out.astype(dtype))


def adversarial_fixtures(n: int, dtype=np.int32, seed: int = 0):
    """The SURVEY.md §4 adversarial fixture set: (name, array) pairs."""
    fixtures = []
    for pattern in ("uniform", "seqlike", "descending", "sequential", "equal"):
        fixtures.append((pattern, generate(n, pattern=pattern, seed=seed, dtype=dtype)))
    dtype = np.dtype(dtype)
    if dtype.kind in "iu":
        info = np.iinfo(dtype)
        rng = np.random.default_rng(seed + 1)
        extremes = rng.choice(
            np.array([info.min, info.min + 1, -1, 0, 1, info.max - 1, info.max], dtype=dtype)
            if dtype.kind == "i"
            else np.array([0, 1, info.max - 1, info.max], dtype=dtype),
            size=n,
        )
        fixtures.append(("extremes", extremes.astype(dtype)))
    else:
        rng = np.random.default_rng(seed + 1)
        specials = rng.choice(
            np.array([0.0, -0.0, 1.5, -1.5, np.finfo(dtype).max, np.finfo(dtype).min], dtype=dtype),
            size=n,
        )
        fixtures.append(("extremes", specials.astype(dtype)))
    return fixtures
