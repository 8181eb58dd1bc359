"""Distributed selection over a mesh of ranks (a ``torch.distributed``
process group, one process per rank; parallel/mesh.py)."""

from mpi_k_selection_tpu_torch.parallel.cgm import distributed_cgm_select
from mpi_k_selection_tpu_torch.parallel.mesh import Mesh, Shard, make_mesh, require_distributed, shard_1d
from mpi_k_selection_tpu_torch.parallel.multihost import run_ranks
from mpi_k_selection_tpu_torch.parallel.radix import distributed_radix_select, distributed_radix_select_many
from mpi_k_selection_tpu_torch.parallel.sketch import dcn_merge_sketch, distributed_sketch
from mpi_k_selection_tpu_torch.parallel.topk import distributed_topk

DISTRIBUTED_ALGORITHMS = ("radix", "cgm")


def distributed_kselect(x, k, *, algorithm: str = "radix", mesh=None, **kwargs):
    """Exact k-th smallest of ``x`` over ``mesh`` (every rank of the group
    by default). ``algorithm='radix'`` is the flagship fixed-round path;
    ``'cgm'`` is the reference-parity weighted-median iteration."""
    if algorithm == "radix":
        return distributed_radix_select(x, k, mesh=mesh, **kwargs)
    if algorithm == "cgm":
        return distributed_cgm_select(x, k, mesh=mesh, **kwargs)
    raise ValueError(f"unknown distributed algorithm {algorithm!r}; choose from {DISTRIBUTED_ALGORITHMS}")


__all__ = [
    "DISTRIBUTED_ALGORITHMS",
    "Mesh",
    "Shard",
    "dcn_merge_sketch",
    "distributed_cgm_select",
    "distributed_kselect",
    "distributed_radix_select",
    "distributed_radix_select_many",
    "distributed_sketch",
    "distributed_topk",
    "make_mesh",
    "require_distributed",
    "run_ranks",
    "shard_1d",
]
