"""Sequential CPU oracle backend (``--backend=seq``).

Ground truth for every other backend, reproducing the reference's
sequential program: sort ascending, answer = element ``k-1`` for 1-indexed
k (``kth-problem-seq.c:32-33``). The port's copy of
``mpi_k_selection_tpu/backends/seq.py``, on the host, in NumPy:

- :func:`kselect` — ``np.partition`` (introselect), the fast oracle: the
  same answer as sort-then-index for every input. When the native runtime
  is built (native/), large int32/int64/float32/float64 arrays go to
  ``std::nth_element``, the compiled equivalent of the reference's C
  oracle; without it, NumPy answers.
- :func:`kselect_sort` — literal sort-then-index, the reference algorithm
  (the tests cross-check the partition path with it).
"""

from __future__ import annotations

import numpy as np

NAME = "seq"


def _native():
    from mpi_k_selection_tpu_torch.native import loader

    return loader.get_lib()


def kselect(x: np.ndarray, k: int):
    """Exact k-th smallest (1-indexed)."""
    x = np.asarray(x).ravel()
    n = x.size
    if not 1 <= k <= n:
        raise ValueError(f"k={k} out of range [1, {n}]")
    lib = _native() if n >= 1 << 16 else None
    if lib is not None:
        result = lib.nth_element(x, k)
        if result is not None:
            return result
    return np.partition(x, k - 1)[k - 1]


def kselect_sort(x: np.ndarray, k: int):
    """Literal reference algorithm: full sort then index (kth-problem-seq.c:32-33)."""
    x = np.asarray(x).ravel()
    if not 1 <= k <= x.size:
        raise ValueError(f"k={k} out of range [1, {x.size}]")
    return np.sort(x, kind="stable")[k - 1]


def topk(x: np.ndarray, k: int, *, largest: bool = True):
    """Top-k along the last axis; returns (values, indices) sorted by rank."""
    x = np.asarray(x)
    d = x.shape[-1]
    if not 1 <= k <= d:
        raise ValueError(f"k={k} out of range [1, {d}]")
    # no negation tricks: ``-x`` wraps for unsigned dtypes and INT_MIN
    if largest:
        part = np.argpartition(x, d - k, axis=-1)[..., d - k :]
        vals = np.take_along_axis(x, part, axis=-1)
        order = np.argsort(vals, axis=-1, kind="stable")[..., ::-1]
    else:
        part = np.argpartition(x, k - 1, axis=-1)[..., :k]
        vals = np.take_along_axis(x, part, axis=-1)
        order = np.argsort(vals, axis=-1, kind="stable")
    idx = np.take_along_axis(part, order, axis=-1)
    return np.take_along_axis(x, idx, axis=-1), idx


def median(x: np.ndarray):
    """Lower median (k = n//2), the reference's median operating point."""
    x = np.asarray(x).ravel()
    return kselect(x, max(1, x.size // 2))
