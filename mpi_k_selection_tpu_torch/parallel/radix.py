"""Distributed radix k-selection over a mesh — the flagship path.

Counterpart of ``mpi_k_selection_tpu/parallel/radix.py``, the replacement
for the reference's whole CGM protocol (``TODO-kth-problem-cgm.c:103-293``).
Each rank keeps its shard on its device and never sends an element:

- a pass is the single-device pass (ops/radix.py:``_Descent``: the
  histogram kernel on the shard) with one ``all_reduce`` of the local
  histogram between the count and the bucket walk — the analogue of the
  reference's ``MPI_Allreduce(leg, 3, SUM)`` (``TODO-…:190``), a fixed
  number of passes instead of O(log N) rounds;
- the bucket walk runs on every rank on the reduced counts, so every rank
  holds the same prefix (the reference's rank-0 weighted median and
  ``MPI_Bcast``, ``:139-168``, are implicit);
- the cutover ladder reads the reduced population of the chosen bucket
  (the same on every rank, so every rank takes the same branch); its
  collect gathers each rank's ``(K, budget)`` candidates, padded with the
  order-maximum, in one ``all_gather`` and picks from the union in key
  order — the reference's sequential finish (``:122``, ``:236-280``) with
  the survivors named by their radix prefix.

Counts are int64 on every rank and in every reduction, so a bucket of
more than 2^31 keys over the ranks stays exact.
"""

from __future__ import annotations

import torch

from mpi_k_selection_tpu_torch.obs.events import DistributedSelectEvent
from mpi_k_selection_tpu_torch.ops.radix import _Descent, _select_key_on_prep, _select_many_on_prep, resolve_cutover
from mpi_k_selection_tpu_torch.parallel import mesh as mesh_lib
from mpi_k_selection_tpu_torch.utils import debug as _debug, dtypes as _dt


def _shard_descent(x, mesh, radix_bits):
    """``(prepared descent, shard tensor)`` for this rank: the shard as
    :func:`~mpi_k_selection_tpu_torch.parallel.mesh.shard_1d` cuts it, the
    histograms reduced and the candidates gathered over ``mesh``."""
    shard = mesh_lib.shard_1d(x, mesh).block

    def gather(cand):  # (K, B) per rank -> (K, size * B)
        g = mesh.all_gather(cand)
        return g.permute(1, 0, 2).reshape(cand.shape[0], -1)

    prep = _Descent(  # ksel: noqa[KSL003] -- no f64 approximation exists in the port (native f64 bitcasts)
        shard, radix_bits, reduce=mesh.all_reduce, gather=gather, n_total=shard.numel() * mesh.size
    )
    return prep, shard


def _check_budget(cutover_budget: int) -> None:
    if cutover_budget < 1:
        raise ValueError(f"cutover_budget={cutover_budget} must be >= 1")


def distributed_radix_select(
    x,
    k,
    *,
    mesh=None,
    radix_bits: int | None = None,
    cutover: int | str | None = "auto",
    cutover_budget: int = 8192,
    obs=None,
) -> torch.Tensor:
    """Exact k-th smallest (1-indexed) of the global ``x`` over ``mesh``
    (default: every rank of the started group, on a CUDA card); every
    rank calls it with the same ``x`` (or its own
    :class:`~mpi_k_selection_tpu_torch.parallel.mesh.Shard` of it) and
    gets the answer, a 0-d tensor on its device.

    ``cutover`` / ``cutover_budget`` as in ops/radix.py:radix_select, the
    schedule resolved on the padded global size. The sentinel pads carry
    the order-maximal key, so a collected pad sorts after every real
    candidate (or ties it exactly, and then the value is right either
    way). ``obs`` (obs/:``Observability``) records the resolved dispatch
    (ranks, radix_bits, cutover schedule) as one ``distributed.select``
    event on this rank."""
    mesh = mesh_lib.make_mesh() if mesh is None else mesh
    mesh_lib.require_distributed(mesh)
    _check_budget(cutover_budget)
    n = mesh_lib.global_size(x)
    _debug.check_concrete_k(k, n)
    prep, shard = _shard_descent(x, mesh, radix_bits)
    if obs is not None:
        ncut = resolve_cutover(cutover, prep.n_total, prep.total_bits, prep.radix_bits, cutover_budget)
        obs.emit(DistributedSelectEvent(
            n=int(n), queries=1, n_devices=int(mesh.size), radix_bits=int(prep.radix_bits),
            cutover_passes=None if ncut is None else int(ncut), dtype=str(shard.dtype).removeprefix("torch."),
        ))
    kk = torch.as_tensor(k, dtype=torch.int64, device=mesh.device).reshape(1).clamp(1, n)
    ans = _select_key_on_prep(prep, kk, cutover=cutover, cutover_budget=cutover_budget)
    return _dt.from_sortable_bits(ans, shard.dtype).reshape(())


def distributed_radix_select_many(
    x,
    ks,
    *,
    mesh=None,
    radix_bits: int | None = None,
    cutover: int | str | None = "auto",
    cutover_budget: int = 8192,
) -> torch.Tensor:
    """Exact k-th smallest of the global ``x`` for every (1-indexed) k in
    ``ks`` over ``mesh``, in ``ks`` order and shape (a scalar k: shape
    (1,)). The prefix-free pass is one histogram and one ``all_reduce``
    for every query; each later pass reads the shard once for all K
    queries (the multi-prefix kernel) and reduces the (K, 2^radix_bits)
    counts in one ``all_reduce``; the ladder tests the largest query
    population and collects for all K at once."""
    mesh = mesh_lib.make_mesh() if mesh is None else mesh
    mesh_lib.require_distributed(mesh)
    _check_budget(cutover_budget)
    n = mesh_lib.global_size(x)
    _debug.check_concrete_ks(ks, n)
    prep, shard = _shard_descent(x, mesh, radix_bits)
    ks_t = torch.as_tensor(ks, dtype=torch.int64, device=mesh.device)
    shape = ks_t.shape if ks_t.dim() else (1,)
    kk = ks_t.reshape(-1).clamp(1, n)
    if kk.numel() == 0:
        return torch.empty(shape, dtype=shard.dtype, device=mesh.device)
    ans = _select_many_on_prep(prep, kk, cutover=cutover, cutover_budget=cutover_budget)
    return _dt.from_sortable_bits(ans, shard.dtype).reshape(shape)
