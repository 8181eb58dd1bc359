"""CUDA backend — single-device selection.

The single-device half of ``mpi_k_selection_tpu/backends/tpu.py``: the
planner names the algorithm, and selection runs on one device. The
distributed half (a process group over several cards) is not ported yet.
"""

from __future__ import annotations

from mpi_k_selection_tpu_torch import api
from mpi_k_selection_tpu_torch.ops import topk as _topk

NAME = "cuda"


def plan(n: int, algorithm: str = "auto") -> str:
    """The algorithm a selection of ``n`` elements runs (api's rule)."""
    return api.resolve_algorithm(algorithm, n)


def kselect(x, k: int, *, algorithm: str = "auto", device=None, **kwargs):
    """Exact k-th smallest (1-indexed) on one device."""
    return api.kselect(x, k, algorithm=algorithm, device=device, **kwargs)


def median(x, *, device=None, **kwargs):
    return api.median(x, device=device, **kwargs)


def kselect_many(x, ks, *, device=None, **kwargs):
    """Exact k-th smallest for every k in ``ks`` on one device."""
    return api.kselect_many(x, ks, device=device, **kwargs)


def quantiles(x, qs, *, device=None, **kwargs):
    """Exact nearest-rank quantiles on one device."""
    return api.quantiles(x, qs, device=device, **kwargs)


def batched_kselect(x, k, *, device=None):
    """Per-row exact k-th smallest along the last axis on one device."""
    return api.batched_kselect(x, k, device=device)


def batched_median(x, *, device=None):
    return api.batched_median(x, device=device)


def kselect_streaming(source, k: int, **kwargs):
    """Exact k-th smallest over a replayable chunk source, each chunk
    staged on one device in turn."""
    return api.kselect_streaming(source, k, **kwargs)


def topk(x, k: int, *, device=None, **kwargs):
    """Top-k along the last axis (values, int64 indices) on one device."""
    return _topk.topk(x, k, device=device, **kwargs)
